"""The packet node-step microbenchmark: the counterpart of the kernel of
``scripts/packet_kernel_exp.py``, with each of its ``--variant``s.

A synthetic version of B5's packet step. G tiles of 1024 rays (``o``, ``d``
[G, 3, 8, 128] f32; ray ``s * 128 + l``) walk STEPS nodes of a table
[R, 128] f32. Per tile: ``inv = 1 / where(|d| < 1e-12, 1e-12, d)``,
``best`` starts at 1e30 and the node at ``(g * 40503) % R``. Each step
reads the node's row and, for each child c in order, slab-tests every ray
against the bounds at columns 6c .. 6c+5 (``tn`` = max over the axes of
min(t0, t1), ``tf`` = min of the max); a ray hits if ``tn <= tf`` and
``tn < best``, and then ``best = min(best, tn + 1)``. ``nxt`` counts the
hits over the tile's 1024 rays and 8 children; the next node is
``(node * 5 + 1 + nxt % 2) % R``. The output is ``best`` [G, 8, 128].

The variants (``VARIANTS``, the JAX script's names) change what the TPU
variants change. ``vmem_smem``, ``hbm_vmem``, ``hbm_smem`` and
``noscalar`` move the row by another path and give ``scalar``'s result.
``fixedrow`` slab-tests the tile's first row every step; ``dmaonly`` only
loads the row (``best += 1e-9`` a step, ``nxt = row[0] > 1e30``);
``noreduce`` takes ``nxt = 0``; ``onereduce`` takes ``nxt`` = the max
over the tile's rays of their 8-bit hit masks (bit c: child c).

For CUDA tensors :func:`packet_steps` launches the hand-written kernel of
``csrc/packet_exp.cu`` (``packet_steps`` for ``scalar``,
``packet_steps_variant`` for the others; one or two CTAs a tile, as
:func:`cluster_size` says) and raises if the launch fails; for CPU
tensors it runs :func:`plain_packet_steps`, the same loop in plain
PyTorch, vectorised over the tiles. A flipped hit changes a tile's node
chain, so the two agree bit for bit. The wrapper counts its launches in
``packet_steps.launches``.
"""
from __future__ import annotations

import torch

from .cuda_build import launch, library

RAYS = 1024           # rays a tile, as [8, 128]
WIDTH = 128           # floats a table row
CHILDREN = 8
NODE_MULT = 40503     # a tile's first node is (g * NODE_MULT) % R
BIG = 1e30
# node * 5 + 2 and g * NODE_MULT stay in int32, as in the TPU kernel
MAX_ROWS = (2 ** 31 - 3) // 5
MAX_TILES = (2 ** 31 - 1) // NODE_MULT
# the JAX script's --variant choices, in its order: the kernel's ids
VARIANTS = ("scalar", "vmem_smem", "hbm_vmem", "hbm_smem", "fixedrow",
            "dmaonly", "noreduce", "onereduce", "noscalar")
# the variants that only move the row another way: scalar's result
SCALAR_RESULT = ("scalar", "vmem_smem", "hbm_vmem", "hbm_smem", "noscalar")


def _check(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
           steps: int, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    g = o.shape[0] if o.dim() else 0
    for name, a, shape in (("table", table, (table.shape[0], WIDTH)),
                           ("o", o, (g, 3, 8, 128)), ("d", d, (g, 3, 8, 128))):
        if a.device != o.device:
            raise ValueError(f"{name} is on {a.device}, o on {o.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < table.shape[0] <= MAX_ROWS:
        raise ValueError(f"the table needs 1 to {MAX_ROWS} rows, got "
                         f"{table.shape[0]}")
    if g > MAX_TILES:
        raise ValueError(f"at most {MAX_TILES} tiles, got {g}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def plain_packet_steps(table: torch.Tensor, o: torch.Tensor,
                       d: torch.Tensor, steps: int,
                       variant: str = "scalar") -> torch.Tensor:
    """The kernel's loop in plain PyTorch, every tile at once (``node`` is
    a [G] tensor): best [G, 8, 128] f32."""
    _check(table, o, d, steps, variant)
    g, rows = o.shape[0], table.shape[0]
    best = torch.full((g, 8, 128), BIG, dtype=torch.float32, device=o.device)
    if variant == "dmaonly":   # no slab test; the chain leaves best alone
        for _ in range(steps):
            best = best + 1e-9
        return best
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]                   # [G, 8, 128]
    inv = torch.reciprocal(torch.where(d.abs() < 1e-12, 1e-12, d))
    ix, iy, iz = inv[:, 0], inv[:, 1], inv[:, 2]
    node = (torch.arange(g, dtype=torch.int64, device=o.device)
            * NODE_MULT) % rows
    first = table[node, :6 * CHILDREN][:, :, None, None]     # [G, 48, 1, 1]
    for _ in range(steps):
        b = (first if variant == "fixedrow"
             else table[node, :6 * CHILDREN][:, :, None, None])
        nxt = torch.zeros(g, dtype=torch.int64, device=o.device)
        mask = torch.zeros_like(best, dtype=torch.int64)
        for c in range(CHILDREN):
            t0x = (b[:, 6 * c + 0] - ox) * ix
            t0y = (b[:, 6 * c + 1] - oy) * iy
            t0z = (b[:, 6 * c + 2] - oz) * iz
            t1x = (b[:, 6 * c + 3] - ox) * ix
            t1y = (b[:, 6 * c + 4] - oy) * iy
            t1z = (b[:, 6 * c + 5] - oz) * iz
            tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                             torch.minimum(t0y, t1y)),
                               torch.minimum(t0z, t1z))
            tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                             torch.maximum(t0y, t1y)),
                               torch.maximum(t0z, t1z))
            hit = (tn <= tf) & (tn < best)
            best = torch.where(hit, torch.minimum(best, tn + 1.0), best)
            if variant == "onereduce":
                mask = mask | (hit.long() << c)
            elif variant != "noreduce":
                nxt = nxt + hit.sum(dim=(1, 2))
        if variant == "onereduce":
            nxt = mask.amax(dim=(1, 2))
        node = (node * 5 + 1 + nxt % 2) % rows
    return best


def cluster_size(tiles: int, device) -> int:
    """The CTAs a tile takes in a kernel launch of ``tiles`` tiles on the
    CUDA ``device``: 2 when 2 * tiles fit the card's SMs, else 1. The
    kernel library applies the rule from the device's SM count."""
    with torch.cuda.device(device):
        n = library().packet_steps_cluster(tiles)
    if n < 0:
        raise RuntimeError(f"packet_steps_cluster failed with cudaError "
                           f"{-n}")
    return n


def packet_steps(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                 steps: int, variant: str = "scalar") -> torch.Tensor:
    """best [G, 8, 128] f32 after ``steps`` node steps of every tile in
    ``variant``: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check(table, o, d, steps, variant)
    if o.device.type == "cpu":
        return plain_packet_steps(table, o, d, steps, variant)
    if table.data_ptr() % 16:
        raise ValueError("the kernel copies table rows 16 bytes at a time: "
                         "the table must start on a 16-byte boundary")
    best = torch.empty((o.shape[0], 8, 128), dtype=torch.float32,
                       device=o.device)
    if o.shape[0] == 0:
        return best
    args = (table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
            o.shape[0], steps, best.data_ptr())
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        # scalar keeps the entry point of the first design, so that this
        # wrapper can launch an older build's kernel (chip_smoke.py's
        # parent comparison)
        if variant == "scalar":
            launch("packet_steps", *args, stream)
        else:
            launch("packet_steps_variant", *args, VARIANTS.index(variant),
                   stream)
    packet_steps.launches += 1
    return best


packet_steps.launches = 0
