"""The packet node-step microbenchmark: the counterpart of the kernel of
``scripts/packet_kernel_exp.py`` (its default ``scalar`` variant).

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

For CUDA tensors :func:`packet_steps` launches the hand-written kernel of
``csrc/packet_exp.cu`` (one 1024-thread block a tile) and raises if the
launch fails; for CPU tensors it runs :func:`plain_packet_steps`, the
same loop in plain PyTorch, vectorised over the tiles. A flipped hit
changes a tile's node chain, so the two agree bit for bit. The wrapper
counts its launches in ``packet_steps.launches``.
"""
from __future__ import annotations

import torch

from .cuda_build import launch

RAYS = 1024           # rays a tile, as [8, 128]
WIDTH = 128           # floats a table row
CHILDREN = 8
NODE_MULT = 40503     # a tile's first node is (g * NODE_MULT) % R
BIG = 1e30
# node * 5 + 2 and g * NODE_MULT stay in int32, as in the TPU kernel
MAX_ROWS = (2 ** 31 - 3) // 5
MAX_TILES = (2 ** 31 - 1) // NODE_MULT


def _check(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
           steps: int) -> None:
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
                       d: torch.Tensor, steps: int) -> torch.Tensor:
    """The kernel's loop in plain PyTorch, every tile at once (``node`` is
    a [G] tensor): best [G, 8, 128] f32."""
    _check(table, o, d, steps)
    g, rows = o.shape[0], table.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]                   # [G, 8, 128]
    inv = torch.reciprocal(torch.where(d.abs() < 1e-12, 1e-12, d))
    ix, iy, iz = inv[:, 0], inv[:, 1], inv[:, 2]
    best = torch.full((g, 8, 128), BIG, dtype=torch.float32, device=o.device)
    node = (torch.arange(g, dtype=torch.int64, device=o.device)
            * NODE_MULT) % rows
    for _ in range(steps):
        b = table[node, :6 * CHILDREN][:, :, None, None]     # [G, 48, 1, 1]
        nxt = torch.zeros(g, dtype=torch.int64, device=o.device)
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
            nxt = nxt + hit.sum(dim=(1, 2))
        node = (node * 5 + 1 + nxt % 2) % rows
    return best


def packet_steps(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                 steps: int) -> torch.Tensor:
    """best [G, 8, 128] f32 after ``steps`` node steps of every tile: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(table, o, d, steps)
    if o.device.type == "cpu":
        return plain_packet_steps(table, o, d, steps)
    best = torch.empty((o.shape[0], 8, 128), dtype=torch.float32,
                       device=o.device)
    if o.shape[0] == 0:
        return best
    with torch.cuda.device(o.device):
        launch("packet_steps", table.data_ptr(), table.shape[0],
               o.data_ptr(), d.data_ptr(), o.shape[0], steps,
               best.data_ptr(), torch.cuda.current_stream().cuda_stream)
    packet_steps.launches += 1
    return best


packet_steps.launches = 0
