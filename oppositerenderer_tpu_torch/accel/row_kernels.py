"""Fixed-order row sums: the backward of the per-lane table-row gather.

It replaces no TPU kernel. The integrators read per-lane rows of the
material and light tables (``MaterialTable.row``, ``LightTable.row``,
VCM's emitter gather), ``table[idx]`` for every lane. Where a field
requires grad, that gather's backward sums the lanes' cotangents into the
rows they read, ``out[m] = sum of g[i] over idx[i] = m``. Autograd's own
backward, aten's ``index_put_(accumulate=True)``, sorts the indices and
then sums each run of equal ones serially: with 262,144 lanes over a few
rows a call took about 30 ms and the gradient step 96% of its time in it
(H100 80GB HBM3). The work is bounded by the bytes, N * (8 + 4C): 1.6 us
at 3.35 TB/s for N = 262,144, C = 3.

For CUDA tensors :func:`sum_rows` launches the hand-written kernel of
``csrc/rows.cu`` (built and loaded by ``cuda_build``): a grid that walks
each lane once, sums the lanes of one row in a warp by shuffles and adds
them into the warp's own copy of the table in shared memory, then adds
the copies and the blocks' partial tables in a fixed order. It has no
atomics, so two calls give the same bits and a replayed gradient equals
its eager call. It takes C of 1 to 4 and M * C up to
:data:`MAX_TABLE_FLOATS`, and raises beyond. For CPU tensors it runs
:func:`sum_rows_plain`, aten's accumulate, which is what autograd gives:
the CPU gradients are those of ``table[idx]`` bit for bit. The wrapper
counts its kernel launches in ``sum_rows.launches``.
"""
from __future__ import annotations

import math

import torch

from . import cuda_build

MAX_CHANNELS = 4
# the kernel's four warp copies of the [M, C] table in the block's opt-in
# 227 KB of shared memory (sm_90)
MAX_TABLE_FLOATS = 232448 // (4 * 4)


def sum_rows_plain(idx: torch.Tensor, g: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """[rows, *g.shape[1:]]: the rows of ``g`` summed by ``idx`` (aten's
    accumulate)."""
    out = torch.zeros((rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    return out.index_put_((idx,), g, accumulate=True)


def sum_rows(idx: torch.Tensor, g: torch.Tensor, rows: int) -> torch.Tensor:
    """``out[m] = sum of g[i] over idx[i] = m`` for ``idx`` [N] int64 and
    ``g`` [N, ...] float32: [rows, *g.shape[1:]]. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if g.device.type == "cpu":
        return sum_rows_plain(idx, g, rows)
    if idx.dim() != 1 or idx.dtype != torch.int64 or g.shape[:1] != idx.shape:
        raise ValueError(f"idx must be [N] int64 and g [N, ...]; got idx "
                         f"{tuple(idx.shape)} {idx.dtype}, g "
                         f"{tuple(g.shape)}")
    if g.dtype != torch.float32 or g.device != idx.device:
        raise ValueError(f"g must be float32 on idx's device; got {g.dtype} "
                         f"on {g.device}, idx on {idx.device}")
    n, c = idx.shape[0], math.prod(g.shape[1:])
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the row kernel takes 1 to {MAX_CHANNELS} values "
                         f"a row, got {c}")
    if rows * c > MAX_TABLE_FLOATS:
        raise ValueError(f"a table of {rows} x {c} floats exceeds the row "
                         f"kernel's {MAX_TABLE_FLOATS} (its four warp copies "
                         "fill the block's shared memory)")
    out = torch.empty((rows,) + tuple(g.shape[1:]), dtype=torch.float32,
                      device=g.device)
    if n == 0:
        return out.zero_()
    blocks = cuda_build.library().sum_rows_blocks(n)
    part = torch.empty(blocks * rows * c, dtype=torch.float32,
                       device=g.device)
    cuda_build.launch_on(g.device, "sum_rows", idx.contiguous(),
                         g.contiguous(), n, rows, c, part, out)
    sum_rows.launches += 1
    return out


sum_rows.launches = 0
