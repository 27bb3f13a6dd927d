"""The cards a run uses: that they are there and what they are, and
which modules the run must not have loaded."""
from __future__ import annotations

import subprocess
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "oppositerenderer_tpu")


class NoCard(RuntimeError):
    """The cell asks for more CUDA cards than the machine has."""


def require(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark measures the card and "
                     "never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA cards, the machine has "
                     f"{torch.cuda.device_count()}")


def power_limit() -> str | None:
    """``nvidia-smi``'s power limit of the first card, or None where it
    cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def describe(device: torch.device, count: int) -> dict:
    """The result line's ``device``, before its peak is known."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "power_limit": power_limit()}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
