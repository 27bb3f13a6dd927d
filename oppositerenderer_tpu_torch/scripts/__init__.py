"""Command-line measurement scripts of the port, each run as ``python -m
oppositerenderer_tpu_torch.scripts.<name>``."""
