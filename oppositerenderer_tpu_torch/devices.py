"""The device the port's entry points use when the caller names none.

The counterpart of ``oppositerenderer_tpu/devices.py``, which picks the
JAX package's accelerator. The port renders on the CUDA card: every entry
point that builds tensors (scenes, cameras, lights, films, atlases, the
``interop`` converters) takes ``device=None`` to mean the card, through
:func:`resolve_device`. Without a card that raises: the CPU, where the
kernels' plain versions run, is used only when the caller asks for it
with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a ``torch.device``; None is the CUDA card, and raises
    ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port renders on the card by default; pass "
            'device="cpu" to run the plain PyTorch versions on the CPU')
    return torch.device("cuda")
