"""The plain reference that decides ``correct``: PyTorch written from the
estimators the configurations state, independent of the program. It
imports nothing of the program and nothing of the benchmark's harness,
reads its scenes from ``reference/scenes/``, draws its own random
numbers, and is compared with the program as a second estimate of the
same expectation (``harness/compare.py``)."""
