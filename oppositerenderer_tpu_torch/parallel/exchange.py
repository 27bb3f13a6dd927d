"""Photon exchange by grid-cell owner, and the gather over the partial maps.

The counterpart of ``oppositerenderer_tpu/parallel/exchange.py``. Each
rank traces its share of the photons; instead of replicating the whole map
on every rank (``PhotonExchange.ALL_GATHER``), the photons travel to the
rank that owns their grid row:

1. the global photon AABB (one ``pmin`` of [min, -max, -any valid]) gives
   every rank one grid geometry;
2. a photon's owner is a hash of its (y, z) row (:func:`row_owner`): the
   gathers scan each x-contiguous run of cells as one interval, so a whole
   row lives on one rank;
3. :func:`bucket_photons_by_owner` (local, no collective) sorts the
   photons by owner into fixed-capacity slabs ``[D, cap, 9]``, JAX's
   capacity ``max(8, ceil(P cf / D))`` rounded up to 8; a group over
   capacity is systematically subsampled at a random phase ``u`` and its
   power reweighted by count / cap, so the exchanged map keeps its energy
   in expectation at any skew (variance, not bias);
4. one ``all_to_all`` delivers slab d to rank d, which sorts only its
   owned photons into a partial :class:`PhotonGrid` with the pinned
   geometry.

:func:`sharded_gather` then all-gathers the queries (the whole image, in
raster order: bands are contiguous), gathers each rank's partial sums (the
tile gather, kernel B3 on CUDA tensors, or the budgeted gather) and
returns each rank its own band of the sum with one ``psum_scatter``:
kernel-weighted power adds over the disjoint row partition.
"""
from __future__ import annotations

import torch

from ..accel.gather_kernels import (ROWS, TILE, gather_photons_tiled,
                                    tile_block_order_on)
from ..core.rng import _lowbias32
from ..photon_map import (PhotonBatch, PhotonGrid, build_photon_grid,
                          cell_coords, cell_index_1d, gather_photons,
                          geometry_from_bounds, masked_bounds)
from .mesh import Mesh

PHOTON_COLUMNS = 9   # position, power, direction


def row_owner(cells: torch.Tensor, resolution: int,
              n_devices: int) -> torch.Tensor:
    """Owner rank (int64) of each linear cell id: constant along x, so
    each x-contiguous interval of a gather lives on one rank."""
    row = (cells.to(torch.int64) // resolution)    # y + z * R
    return _lowbias32(row) % n_devices


def slab_capacity(p_local: int, n_devices: int,
                  capacity_factor: float) -> int:
    """Rows per destination slab: the fair share times the safety factor,
    at least 8 and a multiple of 8 (JAX's rule)."""
    cap = int(-(-p_local * capacity_factor // n_devices))
    return max(8, (cap + 7) // 8 * 8)


def global_grid_geometry(photons: PhotonBatch, resolution: int, mesh: Mesh,
                         min_cell_size: torch.Tensor | None = None):
    """(origin, cell_size) of the grid over every rank's valid photons:
    this rank's masked AABB reduced over ranks by one ``pmin`` of [min,
    -max, -any valid], with the cell-size floor."""
    lo, hi, any_valid = masked_bounds(photons)
    red = mesh.pmin(torch.cat([lo, -hi, -any_valid.to(lo.dtype)[None]]))
    return geometry_from_bounds(red[0:3], -red[3:6], red[6] < 0.0,
                                resolution, min_cell_size)


def bucket_photons_by_owner(photons: PhotonBatch, origin: torch.Tensor,
                            cell_size: torch.Tensor, resolution: int,
                            n_devices: int, capacity_factor: float,
                            subsample_u):
    """This rank's photons sorted by owner into destination slabs (the
    local half of JAX's ``exchange_photons_by_cell``, no collective).

    Returns (slab [D, cap, 9] float32: position, power, direction;
    slab_valid [D, cap] bool; overflow: the photons beyond their slab's
    capacity, int64 0-d). ``subsample_u`` in [0, 1) is the systematic
    subsample's phase, required: a fixed phase biases an overflowed
    group."""
    if subsample_u is None:
        raise TypeError(
            "subsample_u is required: pass u ~ Uniform[0,1) per iteration "
            "(e.g. core.rng.uniform(key, (), device)); the systematic "
            "subsample is unbiased only with a random phase")
    dev = photons.position.device
    p_local = photons.position.shape[0]
    cells = cell_index_1d(
        cell_coords(photons.position.detach(), origin, cell_size,
                    resolution), resolution)
    owner = row_owner(cells, resolution, n_devices)
    owner = torch.where(photons.valid, owner, n_devices)  # invalid last
    # stable, as jax.lax.sort: a slab keeps the deposit order
    owner_s, order = torch.sort(owner, stable=True)
    cols = torch.cat([photons.position, photons.power,
                      photons.direction], dim=1)[order]    # [P, 9]
    cap = slab_capacity(p_local, n_devices, capacity_factor)

    d = torch.arange(n_devices + 1, dtype=owner_s.dtype, device=dev)
    bounds = torch.searchsorted(owner_s, d)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    ks = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    # count / cap as XLA computes a division by a constant: times the
    # float32 reciprocal (cap set by a fill: no host-to-device copy)
    share = counts.to(torch.float32) * (
        torch.ones((), device=dev)
        / torch.full((), float(cap), dtype=torch.float32, device=dev))
    # over-capacity groups: stride count / cap at phase u; the others
    # pick the identity (floor(k + u) = k for u < 1)
    stride = torch.clamp_min(share, 1.0)
    u = torch.clamp(torch.as_tensor(subsample_u, dtype=torch.float32,
                                    device=dev), 0.0, 0.999)
    pick = torch.floor((ks.to(torch.float32) + u) * stride[:, None]
                       ).to(torch.int64)
    pick = torch.minimum(pick, torch.clamp_min(counts[:, None] - 1, 0))
    src = torch.clamp_max(starts[:, None] + pick, p_local - 1).reshape(-1)
    slab = cols[src].reshape(n_devices, cap, PHOTON_COLUMNS)
    # inverse inclusion probability on the power columns
    w = torch.where(counts > cap, share, 1.0)
    slab = torch.cat([slab[:, :, 0:3], slab[:, :, 3:6] * w[:, None, None],
                      slab[:, :, 6:9]], dim=2)
    overflow = torch.sum(torch.clamp_min(counts - cap, 0))
    return slab, ks < counts[:, None], overflow


def exchange_photons_by_cell(photons: PhotonBatch, resolution: int,
                             mesh: Mesh, min_cell_size=None,
                             capacity_factor: float = 2.0,
                             subsample_u=None):
    """Send this rank's photons to their cell owners and build the partial
    grid of the rows this rank owns (every rank calls it).

    Returns (grid, stats): the grid holds only the owned photons, in the
    global geometry; ``stats["photon_exchange_overflow"]`` counts, over
    all ranks, the photons that overflowed a slab (and were subsampled)."""
    origin, cell_size = global_grid_geometry(photons, resolution, mesh,
                                             min_cell_size)
    slab, slab_valid, overflow = bucket_photons_by_owner(
        photons, origin, cell_size, resolution, mesh.size, capacity_factor,
        subsample_u)
    # ONE all_to_all: slab d to rank d, validity as a tenth column
    packed = torch.cat([slab, slab_valid[..., None].to(slab.dtype)], dim=2)
    recv = mesh.all_to_all(packed.reshape(-1, PHOTON_COLUMNS + 1))
    owned = PhotonBatch(position=recv[:, 0:3], power=recv[:, 3:6],
                        direction=recv[:, 6:9], valid=recv[:, 9] > 0.5)
    grid = build_photon_grid(owned, resolution, origin=origin,
                             cell_size=cell_size)
    return grid, {"photon_exchange_overflow": mesh.psum(overflow)}


def sharded_gather(grid: PhotonGrid, q_position: torch.Tensor,
                   q_normal: torch.Tensor, radius, mesh: Mesh, *,
                   budget_total: int, u_stride: torch.Tensor | None = None,
                   check_normal: bool = True, max_cells_per_axis: int = 4,
                   tiled_wh: tuple[int, int] | None = None,
                   q_valid: torch.Tensor | None = None):
    """Gather against a cell-partitioned photon map: all-gather this
    rank's queries, gather the partial sums of every query against this
    rank's grid, and keep this rank's band of their sum over ranks.

    ``tiled_wh=(W, H)``: the tile gather (``gather_photons_tiled``: B3 on
    CUDA tensors, its plain version on the CPU) over the whole image's
    queries in 16x16 block order, ``u_rows`` from the all-gathered
    ``u_stride`` (global lane ids: the unsharded gather's uniforms).
    Otherwise the budgeted ``gather_photons`` with ``budget_total``
    entries a query. Returns (this rank's summed power [n_local, 3], the
    per-query stats of every query against this rank's grid)."""
    q_pos = mesh.all_gather(q_position)
    q_nrm = mesh.all_gather(q_normal)
    u = None if u_stride is None else mesh.all_gather(u_stride)
    if tiled_wh is not None:
        W, H = tiled_wh
        n = W * H
        perm, inv = tile_block_order_on(W, H, q_pos.device)
        valid = None if q_valid is None else mesh.all_gather(q_valid)[perm]
        acc_b, stats = gather_photons_tiled(
            grid, q_pos[perm], q_nrm[perm], radius,
            u_rows=u.reshape(n // TILE, TILE)[:, :ROWS + 2], valid=valid,
            check_normal=check_normal)
        partial = acc_b[inv]
        stats = {k: v[inv] for k, v in stats.items()}
    else:
        partial, stats = gather_photons(
            grid, q_pos, q_nrm, radius,
            max_cells_per_axis=max_cells_per_axis,
            budget_total=budget_total, check_normal=check_normal,
            u_stride=u)
    return mesh.psum_scatter(partial), stats
