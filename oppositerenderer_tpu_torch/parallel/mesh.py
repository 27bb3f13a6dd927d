"""The collective layer of sharded rendering.

The counterpart of ``oppositerenderer_tpu/parallel/mesh.py`` and of the
``lax`` collectives that the JAX package calls inside ``shard_map``. A
:class:`Mesh` is one ``tile`` axis over the ranks of a
``torch.distributed`` process group: image bands, light subpaths and
photons shard along it, and each rank runs the same step on its own
shard (SPMD, as ``shard_map`` does), calling the mesh's collectives:

=====================  ==============================================
JAX                    :class:`Mesh`
=====================  ==============================================
``lax.psum``           :meth:`Mesh.psum` (``all_reduce`` SUM)
``lax.pmin``/``pmax``  :meth:`Mesh.pmin`/:meth:`Mesh.pmax`
``all_gather`` tiled   :meth:`Mesh.all_gather` (dim 0)
``all_to_all`` tiled   :meth:`Mesh.all_to_all` (``all_to_all_single``)
``psum_scatter``       :meth:`Mesh.psum_scatter` (dim 0)
``axis_index``         :attr:`Mesh.rank`
=====================  ==============================================

The collectives that carry values a gradient flows through (photon
powers, splats, the light-vertex store, gather sums) are differentiable,
each with the transposed collective as its backward: ``all_reduce`` and
``all_to_all_single`` through ``torch.distributed.nn.functional``, the
tiled gather and scatter through the two Functions below, which use
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` in both
directions (``torch.distributed.nn.functional``'s list forms pick their
backward by backend, and without NCCL take a list ``all_to_all``).

Transport: NCCL takes device tensors; gloo is a host transport, so a
gloo mesh copies each operand to the host and the result back to the
operand's device, explicitly and in one place (:meth:`Mesh._send`). A
one-rank mesh without a process group has identity collectives: it is
JAX's ``make_mesh(1)``. The rank-less and NCCL meshes are
:attr:`Mesh.capturable`: a CUDA graph holds their collectives, forward
and backward, so the sharded step and gradient run as graphs there.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from ..devices import resolve_device

class _AllGather(torch.autograd.Function):
    """Tiled all-gather along dim 0; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group = group
        out = x.new_empty((size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        size = dist.get_world_size(ctx.group)
        out = grad.new_empty((grad.shape[0] // size,) + grad.shape[1:])
        dist.reduce_scatter_tensor(out, grad.contiguous(), group=ctx.group)
        return out, None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over ranks, then each rank keeps its block of dim 0; the
    backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        out = x.new_empty((x.shape[0] // size,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty((ctx.size * grad.shape[0],) + grad.shape[1:])
        dist.all_gather_into_tensor(out, grad.contiguous(), group=ctx.group)
        return out, None, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One ``tile`` axis over ``size`` ranks; this process is ``rank``.
    ``group`` is None (and ``backend`` None) for the one-rank mesh, whose
    collectives are identities. ``device`` is where this rank renders."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: the
        rank-less mesh's are identities, and NCCL runs a CUDA rank's on
        the device, on the capturing stream (the communicator must exist
        before the capture: an eager call first creates it). gloo copies
        every operand to the host (:meth:`_send`), which a capture
        refuses."""
        return self.group is None or (self.backend == "nccl"
                                      and self.device.type == "cuda")

    def band(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of dim 0 (``x.shape[0] / size``
        rows)."""
        n = x.shape[0] // self.size
        return x[self.rank * n:(self.rank + 1) * n]

    # --- transport ----------------------------------------------------
    def _send(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the transport's device: the host for gloo, this
        rank's device otherwise."""
        if self.backend == "gloo":
            return x.cpu()
        return x.to(self.device)

    def _collective(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn`` on ``x`` moved to the transport, the result moved back
        to ``x``'s device; bool travels as uint8."""
        is_bool = x.dtype == torch.bool
        y = fn(self._send(x.to(torch.uint8) if is_bool else x))
        y = y.to(x.device)
        return y.to(torch.bool) if is_bool else y

    # --- collectives --------------------------------------------------
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (differentiable)."""
        if self.group is None:
            return x
        return self._collective(lambda y: dist_fn.all_reduce(
            y, op=dist.ReduceOp.SUM, group=self.group), x)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x

        def fn(y):
            y = y.detach().clone()
            dist.all_reduce(y, op=op, group=self.group)
            return y
        return self._collective(fn, x)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over ranks (no gradient)."""
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over ranks (no gradient)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order
        (JAX's tiled ``all_gather``; differentiable)."""
        if self.group is None:
            return x
        return self._collective(
            lambda y: _AllGather.apply(y, self.group, self.size), x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block d of dim 0 goes to rank d; the result holds, in rank
        order, the block each rank sent here (JAX's tiled ``all_to_all``
        with split and concat axis 0; differentiable)."""
        if self.group is None:
            return x

        def fn(y):
            y = y.contiguous()
            return dist_fn.all_to_all_single(torch.empty_like(y), y,
                                             group=self.group)
        return self._collective(fn, x)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``, of which this rank keeps its block
        of dim 0 (JAX's tiled ``psum_scatter``; differentiable)."""
        if self.group is None:
            return x
        return self._collective(
            lambda y: _ReduceScatter.apply(y, self.group, self.size), x)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (no gradient)."""
        if self.group is None:
            return x
        src = (0 if self.group is dist.group.WORLD
               else dist.get_global_rank(self.group, 0))

        def fn(y):
            y = y.detach().clone()
            dist.broadcast(y, src, group=self.group)
            return y
        return self._collective(fn, x)


def check_nccl_cards(world: int, backend: str) -> None:
    """Raise ``RuntimeError`` when ``world`` NCCL ranks would have to share
    a card: NCCL cannot put two ranks of one group on one device, and
    fails inside the collective (or hangs) when asked to. Gloo ranks may
    share a card (each copies through the host, :meth:`Mesh._send`)."""
    if backend != "nccl" or world <= 1:
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world > cards:
        raise RuntimeError(
            f"{world} NCCL ranks need a CUDA card each and this machine has "
            f"{cards}: NCCL cannot put two ranks on one card; pass "
            "--backend gloo (backend=\"gloo\") to let the ranks share "
            "cuda:0")


def make_mesh(n_devices: int | None = None, group=None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over ``group`` (the default process group when one is
    initialised), with this rank rendering on ``device`` (None: the CUDA
    card). Without a process group only a one-rank mesh exists, and so
    does ``n_devices=1`` in any group: each rank its own mesh.

    Raises ``ValueError`` when more ranks are asked for than the group
    has (silently taking fewer would make every sharded check a one-rank
    pass), or fewer but more than one: create that group with
    ``torch.distributed.new_group`` and pass it; ``RuntimeError`` for an
    NCCL group with more ranks than the machine has cards
    (:func:`check_nccl_cards`)."""
    device = resolve_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    size = 1 if group is None else dist.get_world_size(group)
    if n_devices is not None and n_devices > size:
        raise ValueError(
            f"requested {n_devices} ranks but the process group has "
            f"{size}: start that many processes "
            "(parallel.distributed.init_distributed)")
    if group is None or n_devices == 1:
        return Mesh(None, 0, 1, device, None)
    if n_devices is not None and n_devices < size:
        raise ValueError(
            f"requested {n_devices} of the group's {size} ranks: pass a "
            "group of that size (torch.distributed.new_group)")
    backend = str(dist.get_backend(group))
    if backend != "gloo" and device.type != "cuda":
        raise ValueError(f"the {backend} backend moves CUDA tensors; this "
                         f"rank renders on {device}")
    check_nccl_cards(size, backend)
    return Mesh(group, dist.get_rank(group), size, device, backend)
