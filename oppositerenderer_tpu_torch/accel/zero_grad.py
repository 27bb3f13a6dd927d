"""The kernels' gradient contract: a zero gradient for every input.

The JAX package wraps each of its kernels in a ``custom_vjp`` whose
backward returns zeros (``accel/bvh.py:1113,1135``,
``pallas_bvh.py:227-236``, ``pallas_gather.py:251``, ``pallas_vm.py:199``).
:func:`zero_gradient` gives a kernel wrapper the same contract through one
``torch.autograd.Function``: the wrapper runs with autograd off on
detached inputs (a kernel reads raw pointers; the plain version on the
CPU would otherwise record the terms the kernel drops), its float outputs
join the graph with a zero backward, and its integer and boolean outputs
are marked non-differentiable. So a gradient does not depend on whether
the kernel or its plain version ran.
"""
from __future__ import annotations

import functools

import torch


class _ZeroGradient(torch.autograd.Function):

    @staticmethod
    def forward(ctx, fn, kwargs, *args):
        ctx.inputs = [(a.shape, a.dtype, a.device)
                      if isinstance(a, torch.Tensor) else None
                      for a in args]
        out = fn(*(a.detach() if isinstance(a, torch.Tensor) else a
                   for a in args), **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *grads):
        zeros = tuple(
            torch.zeros(like[0], dtype=like[1], device=like[2])
            if need else None
            for need, like in zip(ctx.needs_input_grad[2:], ctx.inputs))
        return (None, None) + zeros


def zero_gradient(fn):
    """``fn`` (tensor arguments and keyword options in, a tensor or a
    tuple of tensors out) under the zero-gradient contract."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return _ZeroGradient.apply(fn, kwargs, *args)
    return wrapper
