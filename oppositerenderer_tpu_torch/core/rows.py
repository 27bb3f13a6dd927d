"""Per-lane rows of a parameter table, ``table[idx]``, with the backward
of ``accel/row_kernels.sum_rows``.

:func:`take_rows` is the gather that ``MaterialTable.row``,
``LightTable.row`` and VCM's emitter gather make for every field. A field
that requires grad, while grad is enabled, goes through
:class:`GatherRows`, whose backward sums the lanes' cotangents into their
rows by the fixed-order row kernel on the card and by aten's accumulate
on the CPU (the gradient autograd gives ``table[idx]``, bit for bit).
Every other field, and every field in a render, is the plain indexing.
"""
from __future__ import annotations

import torch


class GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from ..accel.row_kernels import sum_rows
        idx, = ctx.saved_tensors
        flat = idx.reshape(-1)
        cot = g.reshape((flat.shape[0],) + g.shape[idx.dim():])
        return sum_rows(flat, cot, ctx.rows), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an index tensor ``idx``: through
    :class:`GatherRows` where ``table`` requires grad and grad is
    enabled."""
    if table.requires_grad and torch.is_grad_enabled():
        return GatherRows.apply(table, idx)
    return table[idx]
