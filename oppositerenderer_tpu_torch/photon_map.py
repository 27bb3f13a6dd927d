"""Photon maps: the sorted uniform grid and its fixed-budget gather, the
stochastic hash and the CPU kd-tree.

The counterpart of ``oppositerenderer_tpu/photon_map.py``
(the reference's ``renderer/OptixRenderer_SpatialHash.cu:209-283`` build
and ``ppm/IndirectRadianceEstimation.cu:69-237`` gather):

* build: masked AABB -> cell ids -> a STABLE sort by cell id (JAX's
  ``lax.sort`` is stable, so the port's grid is bit-identical to JAX's
  for the same photons) -> ``searchsorted`` offsets;
* gather: per query, the (y,z) rows of the cell box, each one contiguous
  x-interval of the sorted arrays, flattened into a fixed budget of
  entries with unbiased stride subsampling when the box is over budget.

The budgeted gather is PPM's path when the image does not split into
16x16 blocks; otherwise ``accel/gather_kernels.gather_photons_tiled``
runs. PPM's two other photon maps (``PhotonMapStructure``) follow: the
stochastic hash (one survivor per slot, scaled by the slot's count) and
the CPU kd-tree (built on the host by ``native/kdtree_builder.cpp``, on
the card in stream order between two copies, and range-queried on the
device with a fixed stack).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses

import torch

from .core.math import Tensor, dot
from .native import KD_NULL

BIG = 1e30


@dataclasses.dataclass
class PhotonBatch:
    """SoA photons (ppm/Photon.h:9-34). Fixed capacity, masked validity."""

    position: Tensor   # [P,3]
    power: Tensor      # [P,3]
    direction: Tensor  # [P,3] incident ray direction at deposit
    valid: Tensor      # [P] bool


@dataclasses.dataclass
class PhotonGrid:
    """Sorted uniform grid over a PhotonBatch (invalid photons last)."""

    position: Tensor   # [P,3]
    power: Tensor      # [P,3]
    direction: Tensor  # [P,3]
    offsets: Tensor    # [R^3+1] int32 prefix offsets into the sorted arrays
    origin: Tensor     # [3] grid world origin
    cell_size: Tensor  # [] scalar
    resolution: int
    n_valid: Tensor    # [] int32
    # [P,12] the photons as 48-byte records for B3's kernel
    # (pack_photon_records); not a field of the JAX package's
    packed: Tensor


PHOTON_RECORD = 12   # floats per packed photon record


def pack_photon_records(position: Tensor, direction: Tensor, power: Tensor,
                        x_cell: Tensor) -> Tensor:
    """[P, PHOTON_RECORD] float32: per photon (position, x), (direction,
    0), (power, 0), with x its grid cell's x index (exact in float32):
    three 16-byte groups, the layout in which B3's kernel stages a slot
    with one 16-byte copy per group. (Assigned column by column: on the
    card, torch.cat of such narrow columns is slower.)"""
    p = torch.empty((position.shape[0], PHOTON_RECORD), dtype=torch.float32,
                    device=position.device)
    p[:, 0:3] = position
    p[:, 3] = x_cell
    p[:, 4:7] = direction
    p[:, 8:11] = power
    p[:, 7] = 0.0
    p[:, 11] = 0.0
    return p


def cell_coords(p: Tensor, origin: Tensor, cell_size: Tensor,
                resolution: int) -> Tensor:
    """Integer cell coords [...,3] (int32), clipped to the grid."""
    c = torch.floor((p - origin) / cell_size).to(torch.int32)
    return torch.clamp(c, 0, resolution - 1)


def cell_index_1d(c: Tensor, resolution: int) -> Tensor:
    """x-major linearization (x runs fastest), matching the reference's
    x-contiguous interval scan."""
    return (c[..., 0] + c[..., 1] * resolution
            + c[..., 2] * resolution * resolution)


def min_cell_size_for_window(radius: Tensor, max_cells_per_axis: int
                             ) -> Tensor:
    """Smallest cell size for which a [p-r, p+r] box spans at most
    ``max_cells_per_axis`` cells per axis (floor(2r/cs)+2 in the worst
    alignment), so the gather's fixed cell window covers the whole sphere."""
    return (2.0 * radius / (max_cells_per_axis - 1)) * (1.0 + 1e-5)


def masked_bounds(photons: PhotonBatch) -> tuple[Tensor, Tensor, Tensor]:
    """(min [3], max [3], any valid) over the valid photons."""
    p = photons.position
    v = photons.valid[:, None]
    return (torch.amin(torch.where(v, p, BIG), dim=0),
            torch.amax(torch.where(v, p, -BIG), dim=0),
            torch.any(photons.valid))


def geometry_from_bounds(pmin: Tensor, pmax: Tensor, any_valid: Tensor,
                         resolution: int,
                         min_cell_size: Tensor | None = None
                         ) -> tuple[Tensor, Tensor]:
    """(origin, cell_size) of the uniform grid over the bounds [pmin,
    pmax] (the unit box when nothing is valid), with an optional
    cell-size floor."""
    pmin = torch.where(any_valid, pmin, 0.0)
    pmax = torch.where(any_valid, pmax, 1.0)
    extent = torch.clamp_min(pmax - pmin, 1e-6)
    cell_size = torch.amax(extent) / resolution
    if min_cell_size is not None:
        cell_size = torch.maximum(cell_size, torch.as_tensor(
            min_cell_size, dtype=cell_size.dtype, device=cell_size.device))
    return pmin, cell_size


def photon_grid_geometry(photons: PhotonBatch, resolution: int,
                         min_cell_size: Tensor | None = None
                         ) -> tuple[Tensor, Tensor]:
    """(origin, cell_size) of the uniform grid over the photons' masked
    AABB, with an optional cell-size floor."""
    return geometry_from_bounds(*masked_bounds(photons), resolution,
                                min_cell_size)


def build_photon_grid(photons: PhotonBatch, resolution: int,
                      min_cell_size: Tensor | None = None,
                      origin: Tensor | None = None,
                      cell_size: Tensor | None = None) -> PhotonGrid:
    """createUniformGridPhotonMap (OptixRenderer_SpatialHash.cu:209-283).

    ``min_cell_size`` floors the cell size: pass
    :func:`min_cell_size_for_window` of the gather radius so the gather's
    fixed cell window is exact. ``origin``/``cell_size`` pin the geometry
    instead: the sharded exchange (``parallel/exchange.py``) computes them
    from the global photon AABB, so that every rank's partial grid shares
    one coordinate system. The sort's permutation moves the photons
    once, as packed records; the grid's position, power and direction are
    views of their columns.
    """
    if origin is None or cell_size is None:
        origin, cell_size = photon_grid_geometry(photons, resolution,
                                                 min_cell_size)
    p = photons.position
    n_cells = resolution ** 3
    cells = cell_index_1d(cell_coords(p, origin, cell_size, resolution),
                          resolution)
    cells = torch.where(photons.valid, cells, n_cells)  # sentinel: last
    # stable, as jax.lax.sort: equal cells keep the deposit order
    cells_sorted, order = torch.sort(cells, stable=True)
    offsets = torch.searchsorted(
        cells_sorted, torch.arange(n_cells + 1, dtype=cells_sorted.dtype,
                                   device=p.device))
    packed = pack_photon_records(p, photons.direction, photons.power,
                                 cells % resolution)[order]
    return PhotonGrid(
        position=packed[:, 0:3], power=packed[:, 8:11],
        direction=packed[:, 4:7],
        offsets=offsets.to(torch.int32), origin=origin, cell_size=cell_size,
        resolution=resolution,
        n_valid=torch.sum(photons.valid).to(torch.int32), packed=packed)


# Jensen gaussian filter constants (IndirectRadianceEstimation.cu:60-67),
# shared with the tile gather (accel/gather_kernels.py, csrc/gather.cu).
# GAUSS_EXP_NEG_BETA is the reference's rounded exp(-beta): kept as is.
GAUSS_ALPHA = 1.818
GAUSS_BETA = 1.953
GAUSS_EXP_NEG_BETA = 0.141847


def gaussian_kernel_weight(distance2: Tensor, radius2: Tensor) -> Tensor:
    """Jensen gaussian filter (IndirectRadianceEstimation.cu:60-67)."""
    return GAUSS_ALPHA * (
        1.0 - (1.0 - torch.exp(-GAUSS_BETA * distance2 / (2.0 * radius2)))
        / (1.0 - GAUSS_EXP_NEG_BETA))


def ceil_div(a: Tensor, b: int) -> Tensor:
    """Integer ceil(a / b), as JAX's ``-(-a // b)``."""
    return -torch.div(-a, b, rounding_mode="floor")


def gather_cell_indices(offsets: Tensor, origin: Tensor, cell_size: Tensor,
                        resolution: int, position: Tensor, radius, *,
                        max_cells_per_axis: int = 4, budget_total: int = 256,
                        u_stride: Tensor | None = None):
    """Row indices of the (strided) grid entries inside the [p-r, p+r] box
    of each query (IndirectRadianceEstimation.cu:85-128): each (y,z) row's
    x-range is one contiguous interval; the intervals are flattened into
    one fixed budget with unbiased stride subsampling when a box holds
    more than ``budget_total`` entries.

    Returns (gidx [N,B] int32, gok [N,B] bool, stride [N] int32,
    total [N] int32).
    """
    res = resolution
    dev = position.device
    r = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                           device=dev), position.shape[:-1])
    npos = position - origin
    inv_cs = 1.0 / cell_size
    lo = torch.clamp(torch.floor((npos - r[..., None]) * inv_cs), 0,
                     res - 1).to(torch.int32)
    hi = torch.clamp(torch.floor((npos + r[..., None]) * inv_cs), 0,
                     res - 1).to(torch.int32)
    offs = offsets.long()

    # phase 1: per-lane (start, len) interval per (y,z) row of the box
    starts, lens = [], []
    for dz in range(max_cells_per_axis):
        z = lo[..., 2] + dz
        z_ok = z <= hi[..., 2]
        for dy in range(max_cells_per_axis):
            y = lo[..., 1] + dy
            ok = z_ok & (y <= hi[..., 1])
            cfrom = lo[..., 0] + y * res + z * res * res
            cto = hi[..., 0] + y * res + z * res * res
            start = offs[torch.where(ok, cfrom, 0).long()]
            end = offs[torch.where(ok, cto, 0).long() + 1]
            starts.append(torch.where(ok, start, 0))
            lens.append(torch.where(ok, end - start, 0))
    starts = torch.stack(starts, dim=-1).to(torch.int32)     # [N, R]
    lens = torch.stack(lens, dim=-1).to(torch.int32)         # [N, R]
    prefix = torch.cumsum(lens, dim=-1, dtype=torch.int32) - lens
    total = prefix[..., -1] + lens[..., -1]                  # [N]

    # stride subsampling of over-budget boxes
    stride = torch.clamp_min(ceil_div(total, budget_total), 1)
    if u_stride is None:
        offset = torch.zeros_like(stride)
    else:
        offset = torch.minimum((u_stride * stride).to(stride.dtype),
                               stride - 1)

    # phase 2: flatten the (strided) intervals into one index block
    ks = torch.arange(budget_total, dtype=torch.int32, device=dev)
    fk = offset[..., None] + ks * stride[..., None]          # [N, B]
    shape_k = position.shape[:-1] + (budget_total,)
    gidx = torch.zeros(shape_k, dtype=torch.int32, device=dev)
    gok = torch.zeros(shape_k, dtype=torch.bool, device=dev)
    for rn in range(starts.shape[-1]):
        off = fk - prefix[..., rn:rn + 1]
        sel = (off >= 0) & (off < lens[..., rn:rn + 1])
        gidx = torch.where(sel, starts[..., rn:rn + 1] + off, gidx)
        gok = gok | sel
    return gidx, gok, stride, total


def gather_photons(grid: PhotonGrid, position: Tensor, normal: Tensor,
                   radius, *, max_cells_per_axis: int = 4,
                   budget_total: int = 256, check_normal: bool = True,
                   u_stride: Tensor | None = None):
    """Kernel-weighted photon power within ``radius`` of each query [N,3]:
    the budgeted gather of :func:`gather_cell_indices`, each entry tested
    for distance and (optionally) normal opposition and weighted by the
    Jensen gaussian; an over-budget box's sum is scaled by its stride.

    Returns (power [N,3], stats dict of per-query int32 counts).
    """
    dev = position.device
    r = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                           device=dev), position.shape[:-1])
    radius2 = r * r
    gidx, gok, stride, total = gather_cell_indices(
        grid.offsets, grid.origin, grid.cell_size, grid.resolution,
        position, radius, max_cells_per_axis=max_cells_per_axis,
        budget_total=budget_total, u_stride=u_stride)
    gi = gidx.long()
    ppos = grid.position[gi]          # [N,B,3]
    ppow = grid.power[gi]
    pdir = grid.direction[gi]
    diff = position[..., None, :] - ppos
    d2 = dot(diff, diff)
    ok_p = gok & (d2 <= radius2[..., None])
    if check_normal:
        ok_p = ok_p & (dot(-pdir, normal[..., None, :]) >= 0.0)
    w = gaussian_kernel_weight(d2, radius2[..., None])
    accum = torch.sum(torch.where(ok_p[..., None], ppow * w[..., None], 0.0),
                      dim=-2)
    accum = accum * stride[..., None].to(torch.float32)   # reweight
    visited = torch.sum(gok, dim=-1, dtype=torch.int32)
    stats = dict(photons_visited=visited,
                 photon_subsampled=torch.clamp_min(total - visited, 0))
    return accum, stats


# ---------------------------------------------------------------------------
# stochastic hash (O(1) memory per cell)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StochasticHashMap:
    """Fixed-size hash: one surviving photon per slot and the count of
    photons hashed there (store_photon.h:17-24; the count scales the
    survivor's power). The cell size is the gather radius, so the 3^3
    neighbourhood covers the gather sphere."""

    position: Tensor   # [H,3]
    power: Tensor      # [H,3]
    direction: Tensor  # [H,3]
    count: Tensor      # [H] int32 photons hashed to the slot
    origin: Tensor     # [3]
    cell_size: Tensor  # []


HASH_PRIMES = (73856093, 19349663, 83492791)


def _hash_cell(c: Tensor, n_slots: int) -> Tensor:
    """Integer cell [..., 3] (int32) -> slot, by large-prime mixing. The
    JAX package multiplies in int32 and wraps; the low bits of the int64
    products are the same, and the mask keeps only low bits."""
    c = c.long()
    h = ((c[..., 0] * HASH_PRIMES[0]) ^ (c[..., 1] * HASH_PRIMES[1])
         ^ (c[..., 2] * HASH_PRIMES[2]))
    return (h & (n_slots - 1)).to(torch.int32)


def build_stochastic_hash(photons: PhotonBatch, cell_size: Tensor,
                          table_size_log2: int, key) -> StochasticHashMap:
    """initializeStochasticHashPhotonMap
    (OptixRenderer_SpatialHash.cu:286-334). Each slot keeps one photon: in
    the reference the last writer of a race, here (as in the JAX package)
    the last one in the order of a random priority per photon drawn from
    ``key`` (``jax.random.uniform``, over every row). A stable sort
    orders equal priorities by row, and the winner of each slot is the
    valid photon of highest rank in that order, found by a max-reduction,
    so the table is the JAX package's bit for bit on every device. Every
    row enters the count and the reduction at its own slot, an invalid
    one with a count of 0 and a rank of -1, so both have fixed sizes (no
    compaction, no host read: the build can be captured in a CUDA graph);
    the JAX package sends invalid rows to one extra slot, whose atomics
    would all collide on the card."""
    from .core.rng import uniform
    p = photons.position
    v = photons.valid
    dev = p.device
    pmin = torch.amin(torch.where(v[:, None], p, BIG), dim=0)
    pmin = torch.where(torch.any(v), pmin, 0.0)
    n_slots = 1 << table_size_log2
    c = torch.floor((p - pmin) / cell_size).to(torch.int32)
    slot = _hash_cell(c, n_slots).long()

    prio = uniform(key, (p.shape[0],), dev)
    order = torch.sort(prio, stable=True).indices
    v_r = v[order]                       # validity in rank order
    slot_r = slot[order]
    count = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    count.index_add_(0, slot_r, v_r.to(torch.int32))
    rank = torch.where(v_r, torch.arange(p.shape[0], device=dev), -1)
    best = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, slot_r, rank, reduce="amax")
    has = (best >= 0)[:, None]
    src = order[best.clamp_min(0)]

    def table(a):
        return torch.where(has, a[src], 0.0)

    return StochasticHashMap(
        position=table(p), power=table(photons.power),
        direction=table(photons.direction), count=count,
        origin=pmin, cell_size=torch.as_tensor(cell_size, device=dev))


def gather_stochastic_hash(h: StochasticHashMap, position: Tensor,
                           normal: Tensor, radius):
    """3^3 neighbourhood scan, each survivor's weight times its slot's
    count (IndirectRadianceEstimation.cu:131-166). Returns (power [N,3],
    an empty stats dict)."""
    n_slots = h.count.shape[0]
    dev = position.device
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    radius2 = torch.broadcast_to(r * r, position.shape[:-1])
    base = torch.floor((position - h.origin) / h.cell_size).to(torch.int32)
    accum = torch.zeros(position.shape[:-1] + (3,), dtype=torch.float32,
                        device=dev)
    # the 27 cell offsets (dx, dy, dz), dz slowest, made on the device
    step = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    oz, oy, ox = torch.meshgrid(step, step, step, indexing="ij")
    offsets = torch.stack([ox, oy, oz], dim=-1).reshape(27, 3)
    for off in offsets:
        slot = _hash_cell(base + off, n_slots).long()
        diff = position - h.position[slot]
        d2 = dot(diff, diff)
        cnt = h.count[slot]
        ok = ((cnt > 0) & (d2 <= radius2)
              & (dot(-h.direction[slot], normal) >= 0.0))
        w = gaussian_kernel_weight(d2, radius2)
        contrib = h.power[slot] * (w * cnt)[..., None]
        accum = accum + torch.where(ok[..., None], contrib, 0.0)
    return accum, {}


# ---------------------------------------------------------------------------
# CPU kd-tree (reference OptixRenderer_CPUKdTree.cpp:27-129)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhotonKdTree:
    """Left-balanced kd-tree photon map (children of slot i at 2i+1/2i+2).

    The analog of the reference's ACCELERATION_STRUCTURE_KD_TREE_CPU
    (config.h:18-21): the tree is median-built on the host
    (``native/kdtree_builder.cpp``), as the reference builds it on the
    CPU, and range-queried on the device with a fixed stack. The sorted
    uniform grid stays the production structure. On the card the host
    build runs in stream order between two copies (:class:`KdHostStage`)
    and a capture holds all ``max_visits`` steps of the gather, without
    its live-lane checks (:func:`gather_kdtree`), so a kd-tree iteration
    is captured in a CUDA graph as the grid's is (``renderer.py``), where
    the JAX package jits its host callback and its ``while_loop``.
    """

    position: Tensor   # [m,3] the photon at each slot (zeros on null slots)
    power: Tensor      # [m,3]
    direction: Tensor  # [m,3]
    axis: Tensor       # [m] int32: 0/1/2 split axis, 3 leaf, 4 null
    n_valid: Tensor    # [] int32


def _kd_capacity(n_rows: int) -> int:
    m = 1
    while m < n_rows:
        m = 2 * m + 1
    return m


class KdHostStage:
    """The kd-tree build of one photon row count on one card: the JAX
    package's host callback (``_kdtree_callback``, a ``jax.pure_callback``
    in its jitted step) in stream order. :meth:`enqueue` puts on the
    current stream the copy of the photons' positions and valid flags into
    pinned buffers, ``kd_build_host`` as a host function, and the copy of
    the slots' photon rows and axis flags into device buffers
    (``csrc/kd_stage.cu``); a CUDA graph captures the four as two memcpy
    nodes, a host node and two memcpy nodes.

    The buffers are allocated here, which a capture does not allow, so a
    stage is made by the eager first run of a body and reused by its
    capture (:func:`kd_host_stage`); a replay reads their raw addresses,
    so whatever holds the graph holds the stage."""

    def __init__(self, device: torch.device, rows: int):
        from .native import KdStageFields, kd_build_host_fn
        self.device = torch.device(device)
        self.rows = rows
        self.m = _kd_capacity(rows)
        self._host_fn = kd_build_host_fn()

        def pinned(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=True)

        self.host_position = pinned((rows, 3), torch.float32)
        self.host_valid = pinned((rows,), torch.bool)
        self.host_perm = pinned((self.m,), torch.int32)
        self.host_axis = pinned((self.m,), torch.int32)
        self.perm = torch.empty((self.m,), dtype=torch.int32,
                                device=self.device)
        self.axis = torch.empty_like(self.perm)
        self.fields = KdStageFields(
            pos=self.host_position.data_ptr(),
            valid=self.host_valid.data_ptr(),
            perm=self.host_perm.data_ptr(), axis=self.host_axis.data_ptr(),
            rows=rows, m=self.m)

    def enqueue(self, position: Tensor, valid: Tensor
                ) -> tuple[Tensor, Tensor]:
        """Enqueue the build of the tree over ``position`` [rows, 3] float32
        and ``valid`` [rows] bool (on the stage's card) on the current
        stream. Returns the device buffers (perm, axis) [m] int32 that it
        fills, which the next build overwrites."""
        from .accel.cuda_build import launch_on
        if (position.shape != (self.rows, 3)
                or position.dtype != torch.float32
                or valid.shape != (self.rows,) or valid.dtype != torch.bool
                or position.device != self.device
                or valid.device != self.device):
            raise ValueError(
                f"the kd-tree stage of {self.rows} rows on {self.device} "
                f"takes float32 [{self.rows}, 3] positions and bool "
                f"[{self.rows}] flags there, not {position.dtype} "
                f"{tuple(position.shape)} and {valid.dtype} "
                f"{tuple(valid.shape)}")
        launch_on(self.device, "kd_stage_enqueue", position.contiguous(),
                  valid.contiguous(), self.host_position, self.host_valid,
                  self.host_perm, self.host_axis, self.perm, self.axis,
                  self.rows, self.m, self._host_fn,
                  ctypes.addressof(self.fields))
        return self.perm, self.axis

    @property
    def build_seconds(self) -> float:
        """The host build's wall time in the last build that ran (its own
        clock; read after a synchronize)."""
        return self.fields.seconds


def _in_capture(device: torch.device) -> bool:
    """Whether work for ``device`` is being captured in a CUDA graph."""
    return (device.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


# the owner of the stages that builds make: None outside kd_stages(owner)
_KD_STAGES: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "kd_stages", default=None)
# the stages of builds outside any owner (the eager route), kept for the
# process: a stream may still be using one when its build returns
_SHARED_KD_STAGES: dict = {}


@contextlib.contextmanager
def kd_stages(owner: dict):
    """Inside the block kd-tree builds on the card take their stages from
    ``owner`` ((device, rows) -> :class:`KdHostStage`), making them there
    when missing: ``renderer.CapturedStep`` holds the stages its graph
    replays this way, and drops them when it drops the graph."""
    token = _KD_STAGES.set(owner)
    try:
        yield owner
    finally:
        _KD_STAGES.reset(token)


def kd_host_stage(device: torch.device, rows: int) -> KdHostStage:
    """The stage of ``rows`` photon rows on ``device``: the current owner's
    (:func:`kd_stages`) or, outside one, the process's. Raises inside a
    CUDA graph capture when it does not exist yet: a body's eager first
    run makes it."""
    owner = _KD_STAGES.get()
    owner = _SHARED_KD_STAGES if owner is None else owner
    key = (torch.device(device), rows)
    stage = owner.get(key)
    if stage is None:
        if _in_capture(key[0]):
            raise RuntimeError(
                "a kd-tree build is being captured before its host stage "
                "exists: run the body once eagerly first")
        stage = owner[key] = KdHostStage(*key)
    return stage


def _host_build(position: Tensor, valid: Tensor) -> tuple[Tensor, Tensor]:
    """(perm, axis) [m] int32 of the JAX package's ``_kdtree_callback`` by
    the native builder called directly on host copies (the CPU route)."""
    import numpy as np

    from .native import build_photon_kdtree_native
    m = _kd_capacity(position.shape[0])
    sel = np.nonzero(valid.cpu().numpy())[0]
    perm = np.full((m,), -1, np.int32)
    axis = np.full((m,), KD_NULL, np.int32)
    if sel.size:
        perm_c, axis_c = build_photon_kdtree_native(
            position.cpu().numpy()[sel])
        # compacted rows back to the batch's rows
        perm[:perm_c.shape[0]] = np.where(
            perm_c >= 0, sel[np.clip(perm_c, 0, None)], -1)
        axis[:axis_c.shape[0]] = axis_c
    return (torch.as_tensor(perm, device=position.device),
            torch.as_tensor(axis, device=position.device))


def build_photon_kdtree(photons: PhotonBatch) -> PhotonKdTree:
    """createPhotonKdTreeOnCPU (OptixRenderer_CPUKdTree.cpp:89-129): the
    native builder orders the valid rows on the host, and the tree's slots
    gather their photons on the device. The capacity follows from all
    rows, valid or not, as in the JAX package. On the card the build is
    enqueued in stream order (:class:`KdHostStage`), eager or captured,
    with no host read; on the CPU the builder is called directly."""
    p = photons.position.detach()
    if p.device.type == "cuda":
        perm_t, axis_t = kd_host_stage(p.device, p.shape[0]).enqueue(
            p, photons.valid)
    else:
        perm_t, axis_t = _host_build(p, photons.valid)
    safe = torch.clamp(perm_t, 0, p.shape[0] - 1).long()
    null = (perm_t < 0)[:, None]

    def slots(a):
        return torch.where(null, 0.0, a[safe])

    return PhotonKdTree(
        position=slots(photons.position), power=slots(photons.power),
        direction=slots(photons.direction),
        axis=torch.where(null[:, 0], KD_NULL, axis_t).to(torch.int32),
        n_valid=torch.sum(photons.valid).to(torch.int32))


# the eager kd gather asks the host whether any lane is live every this many
# steps (one host read a check)
KD_STEPS_PER_CHECK = 16


def gather_kdtree(tree: PhotonKdTree, position: Tensor, normal: Tensor,
                  radius, *, max_visits: int = 512,
                  check_normal: bool = True):
    """Range query over the kd-tree (IndirectRadianceEstimation.cu:168-210's
    stack traversal over all query lanes at once, with a fixed [N, S]
    stack): each step pops one slot per lane, adds its photon if it is
    within the radius, and pushes the far child (when the splitting plane
    is within the radius), then the near one.

    At most ``max_visits`` steps run (the reference's traversal is
    unbounded; lanes with work left are counted in ``kd_overrun``). The
    JAX package's ``while_loop`` asks before every step whether any lane
    is live; a step changes nothing once none is (it adds 0.0 and pushes
    nothing), so the answer only saves work. Eagerly the loop reads it on
    the host every ``KD_STEPS_PER_CHECK`` steps and ends at the first
    check with no live lane; inside a CUDA graph capture, which cannot
    read it, all ``max_visits`` steps are captured (PyTorch 2.11 gives
    Python no conditional graph node), and the result is the eager
    loop's bit for bit. The loop state (stack, stack pointers, sums,
    visits) is allocated before the first step and updated in place.

    Returns (power [N,3], stats with photons_visited [N] and kd_overrun).
    """
    m = tree.axis.shape[0]
    depth = max(1, m.bit_length())
    stack_size = depth + 2
    n = position.shape[0]
    dev = position.device
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    radius2 = torch.broadcast_to(r * r, (n,))
    lanes = torch.arange(n, device=dev)

    stack = torch.zeros((n, stack_size), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)  # root pushed
    accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    visited = torch.zeros((n,), dtype=torch.int32, device=dev)

    def push(child, when):
        at = torch.clamp_max(sp, stack_size - 1)[:, None]
        keep = stack.gather(1, at)
        stack.scatter_(1, at, torch.where(when[:, None], child[:, None],
                                          keep))
        sp.add_(when.long())

    def step():
        active = sp > 0
        slot = stack[lanes, torch.clamp_min(sp - 1, 0)]
        sp.sub_(active.long())

        ax = tree.axis[slot]
        ppos = tree.position[slot]
        ok = active & (ax != KD_NULL)

        diff = position - ppos
        d2 = dot(diff, diff)
        in_r = ok & (d2 <= radius2)
        if check_normal:
            in_r = in_r & (dot(-tree.direction[slot], normal) >= 0.0)
        w = gaussian_kernel_weight(d2, radius2)
        accum.add_(torch.where(in_r[:, None], tree.power[slot] * w[:, None],
                               0.0))
        visited.add_(ok.to(torch.int32))

        is_internal = ok & (ax < 3)
        axc = torch.clamp(ax, 0, 2).long()
        delta = position[lanes, axc] - ppos[lanes, axc]
        left = delta < 0.0
        near = torch.where(left, 2 * slot + 1, 2 * slot + 2)
        far = torch.where(left, 2 * slot + 2, 2 * slot + 1)
        push(far, is_internal & (delta * delta <= radius2) & (far < m))
        push(near, is_internal & (near < m))

    capturing = _in_capture(dev)
    for done in range(max_visits):
        if (not capturing and done % KD_STEPS_PER_CHECK == 0
                and not bool(torch.any(sp > 0))):
            break
        step()
    stats = dict(photons_visited=visited,
                 kd_overrun=torch.sum(sp > 0, dtype=torch.int32))
    return accum, stats
