"""Threefry-2x32 on CUDA tensors: one launch of ``csrc/rng.cu`` a call.

It replaces no TPU kernel: the JAX package's threefry is XLA's fused
operation. ``core/rng.py`` holds the plain version, 32-bit words in int64
tensors and about 175 aten operations a call, and calls these wrappers
for CUDA tensors:

* :func:`threefry_draw`: a ``LaneSampler`` draw, float32 ``[N, cols]``;
* :func:`threefry_words`: ``threefry2x32`` on words that broadcast to 0-d
  or 1-d (``fold_in``, ``fold_in_range``, ``iteration_key`` on device
  keys and data), two int64 tensors;
* :func:`threefry_uniform`: ``rng.uniform``'s flat form, float32 ``[n]``.

Each takes a key word as a Python int (passed at the launch) or an int64
tensor on the card read there, so a step whose keys are device tensors
reads nothing from the host and captures into a CUDA graph. Each checks
its operands and launches, or raises: CPU tensors never reach it (the
plain version runs for them). Each counts its launches in ``launches``.
"""
from __future__ import annotations

import torch

from . import cuda_build


def _device_of(devices) -> torch.device:
    """The one CUDA device of ``devices`` (an index-less one agrees with
    any); raises for a CPU device or for two."""
    devs = {torch.device(d) for d in devices}
    indexed = {d for d in devs if d.index is not None}
    if any(d.type != "cuda" for d in devs) or len(indexed) > 1:
        raise ValueError(f"the threefry kernel takes tensors on one CUDA "
                         f"device; got {sorted(map(str, devs))}")
    return next(iter(indexed or devs))


def _operand(x, name: str, n: int | None = None):
    """(pointer, value, stride) of a word operand: a Python int passes as
    its value; an int64 tensor, 0-d (stride 0) or contiguous 1-d (stride
    1, of length ``n`` where given), as its pointer."""
    if not torch.is_tensor(x):
        return None, int(x) & 0xFFFFFFFF, 0
    if x.dtype != torch.int64 or x.dim() > 1 or (
            x.dim() == 1 and not x.is_contiguous()):
        raise ValueError(f"{name} must be an int, a 0-d int64 tensor or a "
                         f"contiguous 1-d one; got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.dim() == 1 and n is not None and x.shape[0] != n:
        raise ValueError(f"{name} has {x.shape[0]} words, not {n}")
    return x, 0, x.dim()


def threefry_draw(lanes: torch.Tensor, k0, k1, counter: int,
                  cols: int) -> torch.Tensor:
    """float32 ``[N, cols]``: lane ``l``'s blocks ``(lanes[l], counter +
    j)`` under the key ``(k0, k1)`` (ints, 0-d tensors or ``[N]``
    per-lane words), block j giving column 2j its first word and 2j + 1
    its second, each as ``(bits >> 8) * 2**-24``."""
    if not torch.is_tensor(lanes) or lanes.dtype != torch.int64 \
            or lanes.dim() != 1 or not lanes.is_contiguous():
        raise ValueError("lanes must be a contiguous [N] int64 tensor")
    if int(cols) < 1:
        raise ValueError(f"a draw takes at least one column, got {cols}")
    n = lanes.shape[0]
    ops = (_operand(k0, "k0", n), _operand(k1, "k1", n))
    dev = _device_of([lanes.device] + [p.device for p, _, _ in ops
                                       if p is not None])
    out = torch.empty((n, int(cols)), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    cuda_build.launch_on(dev, "threefry_draw", lanes, n, *ops[0], *ops[1],
                         int(counter), int(cols), out)
    threefry_draw.launches += 1
    return out


def threefry_words(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """``threefry2x32(k0, k1, x0, x1)`` for words that are ints, 0-d int64
    tensors or 1-d ones of one length, at least one a tensor: the two
    output words as int64 tensors of the broadcast shape, in ``[0,
    2**32)``."""
    words = (k0, k1, x0, x1)
    lengths = {w.shape[0] for w in words if torch.is_tensor(w) and w.dim()}
    if len(lengths) > 1:
        raise ValueError(f"1-d words of lengths {sorted(lengths)} do not "
                         "broadcast")
    n = lengths.pop() if lengths else None
    ops = [_operand(w, name, n) for w, name in zip(words,
                                                   ("k0", "k1", "x0", "x1"))]
    devices = [p.device for p, _, _ in ops if p is not None]
    if not devices:
        raise ValueError("threefry_words takes at least one tensor word")
    dev = _device_of(devices)
    shape = () if n is None else (n,)
    out = torch.empty((2,) + shape, dtype=torch.int64, device=dev)
    if n != 0:
        cuda_build.launch_on(dev, "threefry_words",
                             *[a for op in ops for a in op], n or 1, out)
        threefry_words.launches += 1
    return out[0], out[1]


def threefry_uniform(k0, k1, n: int, device) -> torch.Tensor:
    """float32 ``[n]``: ``jax.random.uniform(key, (n,))`` under the key
    ``(k0, k1)`` (ints or 0-d tensors on ``device``)."""
    ops = (_operand(k0, "k0"), _operand(k1, "k1"))
    if any(p is not None and p.dim() for p, _, _ in ops):
        raise ValueError("uniform takes one key: 0-d words")
    dev = _device_of([device] + [p.device for p, _, _ in ops
                                 if p is not None])
    out = torch.empty((int(n),), dtype=torch.float32, device=dev)
    if n:
        cuda_build.launch_on(dev, "threefry_uniform", ops[0][0], ops[0][1],
                             ops[1][0], ops[1][1], int(n), out)
        threefry_uniform.launches += 1
    return out


threefry_draw.launches = 0
threefry_words.launches = 0
threefry_uniform.launches = 0
