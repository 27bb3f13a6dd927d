"""Tile-shared photon gather: the counterpart of
``oppositerenderer_tpu/accel/pallas_gather.py``.

Queries come in tiles of ``TILE`` = 256 consecutive entries, each a 16x16
pixel block (:func:`tile_block_order`). Per tile, :func:`_tile_tables`
(plain torch) takes the union of the queries' cell boxes, enumerates up
to 8x8 of its (y,z) grid rows (stride-sampled beyond 8 per axis) and cuts
each row, one contiguous interval of the cell-sorted photon arrays, to one
random block of ``CHUNK`` photons; every slot carries the inverse of its
inclusion probability as a weight, so the estimate stays unbiased.

``gather_photons_tiled`` then sums, for every query, the Jensen-weighted
power of the photons of its tile's slots: the hand-written kernel of
``csrc/gather.cu`` for CUDA tensors (built and loaded by ``cuda_build``),
``gather_photons_tiled_plain`` for CPU tensors. The wrapper counts its
kernel launches in a ``launches`` attribute. The kernel reads the grid's
photons as 48-byte records (``PhotonGrid.packed``, written by the grid's
own sort), culls each slot's window by its (y,z) grid row
(``_tile_tables``' ``rows``) against each query's cells, and splits a
tile's slots over ``SLOT_GROUPS`` CTAs whose partial sums a second kernel
adds in group order; the plain version sums every staged pair at once.
The TPU kernel's Mosaic layout workarounds (the transposed ``[16, P_pad]``
photon packing with its 128-aligned window, the static unroll) are not
ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..photon_map import (GAUSS_ALPHA, GAUSS_BETA, GAUSS_EXP_NEG_BETA,
                          PHOTON_RECORD, PhotonGrid, ceil_div)
from .cuda_build import launch

TILE = 256          # queries per tile
BLOCK = 16          # square image block edge (BLOCK^2 == TILE)
ROWS_Y = 8          # (y,z) row slot grid per tile
ROWS_Z = 8
ROWS = ROWS_Y * ROWS_Z
CHUNK = 256         # photons per row slot
# the kernels' cull box radius r (1 + 2^-10): rounding never drops a cell
BOX_SLACK = 1.0 + 2.0 ** -10
# CTAs per tile in B3's kernel, each with ROWS // SLOT_GROUPS slots: a
# tile's queries can sit in dense cells, and one CTA would walk all of its
# slots alone (1 to 32 timed on the card: PERF.md)
SLOT_GROUPS = 8

# [tiles, TILE, ROWS * CHUNK] elements the plain version materialises at once
PLAIN_ELEMENT_BUDGET = 1 << 23


def tile_block_order(width: int, height: int) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """(perm, inv_perm) int32 [H*W] mapping raster order to 16x16 image
    blocks: a block is a compact surface patch, the coherence the tile
    gather feeds on, where 256 consecutive raster pixels span half a row."""
    if width % BLOCK or height % BLOCK:
        raise ValueError(f"{width}x{height} does not split into "
                         f"{BLOCK}x{BLOCK} blocks")
    idx = np.arange(height * width, dtype=np.int32).reshape(height, width)
    perm = (idx.reshape(height // BLOCK, BLOCK, width // BLOCK, BLOCK)
            .transpose(0, 2, 1, 3).reshape(-1))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def _tile_tables(grid: PhotonGrid, position: torch.Tensor, radius,
                 u_row: torch.Tensor, valid: torch.Tensor | None = None):
    """Per-tile slot tables (pallas_gather.py:107-177).

    ``u_row`` [n_tiles, ROWS + 2] uniforms drive the subsampling (the y/z
    stride offsets, then one chunk pick per slot). ``valid`` masks queries
    out of the tile's box union; an all-invalid tile gets empty slots.

    Returns (starts, lens) int32 and weights f32, each [n_tiles, ROWS],
    per tile the photons visited and the photons in the (weighted) box
    union, int32 [n_tiles], and each slot's (y,z) grid row as the index of
    its x = 0 cell, y * res + z * res^2, int32 [n_tiles, ROWS] (0 for an
    empty slot): the B3 and B4 kernels cull a slot's window by it.
    """
    res = grid.resolution
    n = position.shape[0]
    n_tiles = n // TILE
    dev = position.device
    r = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                           device=dev), (n,))
    npos = position - grid.origin
    inv = 1.0 / grid.cell_size
    lo = torch.clamp(torch.floor((npos - r[:, None]) * inv), 0,
                     res - 1).to(torch.int32)
    hi = torch.clamp(torch.floor((npos + r[:, None]) * inv), 0,
                     res - 1).to(torch.int32)
    if valid is not None:
        lo = torch.where(valid[:, None], lo, res)   # min ignores invalid
        hi = torch.where(valid[:, None], hi, -1)    # max ignores invalid
    lo_t = torch.amin(lo.reshape(n_tiles, TILE, 3), dim=1)    # [Tt,3]
    hi_t = torch.amax(hi.reshape(n_tiles, TILE, 3), dim=1)

    def axis_rows(axis, slots, u):
        span = hi_t[:, axis] - lo_t[:, axis] + 1
        stride = torch.clamp_min(ceil_div(span, slots), 1)
        off = torch.minimum((u * stride.to(torch.float32)).to(torch.int32),
                            stride - 1)
        ks = torch.arange(slots, dtype=torch.int32, device=dev)
        vals = (lo_t[:, axis, None] + off[:, None]
                + ks[None, :] * stride[:, None])            # [Tt, slots]
        return vals, vals <= hi_t[:, axis, None], stride

    ys, ok_y, stride_y = axis_rows(1, ROWS_Y, u_row[:, 0])
    zs, ok_z, stride_z = axis_rows(2, ROWS_Z, u_row[:, 1])
    y = torch.repeat_interleave(ys, ROWS_Z, dim=1)           # [Tt, ROWS]
    oky = torch.repeat_interleave(ok_y, ROWS_Z, dim=1)
    z = zs.repeat(1, ROWS_Y)
    okz = ok_z.repeat(1, ROWS_Y)
    ok = oky & okz
    w_row = (stride_y * stride_z).to(torch.float32)[:, None]  # [Tt,1]

    offsets = grid.offsets.long()
    row = y * res + z * res * res
    cfrom = lo_t[:, 0, None] + row
    cto = hi_t[:, 0, None] + row
    start = offsets[torch.where(ok, cfrom, 0).long()].to(torch.int32)
    end = offsets[torch.where(ok, cto, 0).long() + 1].to(torch.int32)
    ln = torch.where(ok, end - start, 0)                     # [Tt, ROWS]

    # rows longer than CHUNK: one random CHUNK-block, weight = #blocks
    n_blocks = torch.clamp_min(ceil_div(ln, CHUNK), 1)
    u_blk = u_row[:, 2:2 + ROWS]
    blk = torch.minimum((u_blk * n_blocks.to(torch.float32)).to(torch.int32),
                        n_blocks - 1)
    start_s = start + blk * CHUNK
    ln_s = torch.clamp(ln - blk * CHUNK, 0, CHUNK)
    weight = torch.where(ok, w_row * n_blocks.to(torch.float32), 0.0)
    visited = torch.sum(ln_s, dim=1, dtype=torch.int32)
    total = torch.sum(torch.where(ok, ln, 0) * w_row.to(torch.int32), dim=1,
                      dtype=torch.int32)
    return start_s, ln_s, weight, visited, total, torch.where(ok, row, 0)


def gather_photons_tiled_plain(starts, lens, weights, rows, r2, qpos,
                               qnormal, grid, check_normal: bool = True):
    """Plain PyTorch version of the kernel's contract. For each tile, the
    windows ``[start, start + len)`` of its ROWS slots over the photons of
    ``grid`` against its TILE queries: d^2 summed per axis (never as q^2 +
    p^2 - 2 q.p, which cancels catastrophically at scene scale,
    pallas_gather.py:37-44), the pair kept if d^2 <= r2 and, with
    ``check_normal``, n.dir <= 0, weighted by the Jensen gaussian times the
    slot weight; returns sum w * power [N, 3]. The slots' grid ``rows``
    only let the kernel cull pairs that fail ``d2 <= r2``: this version
    tests every staged pair. Tiles go in chunks that bound the [tiles,
    TILE, ROWS * CHUNK] intermediates."""
    n_tiles = starts.shape[0]
    dev = qpos.device
    ppos, ppow, pdir = grid.position, grid.power, grid.direction
    out = torch.zeros((n_tiles * TILE, 3), dtype=torch.float32, device=dev)
    if ppos.shape[0] == 0:
        return out
    ct = max(1, PLAIN_ELEMENT_BUDGET // (TILE * ROWS * CHUNK))
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=dev)
    denom = 1.0 - GAUSS_EXP_NEG_BETA
    j = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    for t0 in range(0, n_tiles, ct):
        t1 = min(n_tiles, t0 + ct)
        m = j < lens[t0:t1, :, None]                         # [c, ROWS, C]
        idx = torch.where(m, starts[t0:t1, :, None] + j, 0).long()
        idx = idx.reshape(t1 - t0, 1, ROWS * CHUNK)
        m = m.reshape(t1 - t0, 1, ROWS * CHUNK)
        p = ppos[idx]                                        # [c, 1, K, 3]
        q = qpos[t0 * TILE:t1 * TILE].reshape(t1 - t0, TILE, 1, 3)
        dx = q[..., 0] - p[..., 0]                           # [c, TILE, K]
        dy = q[..., 1] - p[..., 1]
        dz = q[..., 2] - p[..., 2]
        d2 = dx * dx + dy * dy + dz * dz
        ok = m & (d2 <= r2)
        if check_normal:
            pd = pdir[idx]
            qn = qnormal[t0 * TILE:t1 * TILE].reshape(t1 - t0, TILE, 1, 3)
            ndp = (qn[..., 0] * pd[..., 0] + qn[..., 1] * pd[..., 1]
                   + qn[..., 2] * pd[..., 2])
            ok = ok & (ndp <= 0.0)
        expf = torch.exp(-GAUSS_BETA * d2 / (2.0 * r2))
        w = GAUSS_ALPHA * (1.0 - (1.0 - expf) / denom)
        w_s = torch.repeat_interleave(weights[t0:t1], CHUNK, dim=1)
        contrib = torch.where(ok, w, 0.0) * w_s[:, None, :]
        out[t0 * TILE:t1 * TILE] = torch.bmm(
            contrib, ppow[idx[:, 0]]).reshape(-1, 3)
    return out


def culled_windows_plain(grid: PhotonGrid, qpos, r2, starts, lens, rows):
    """The part of each slot's window that B3's kernel walks for each
    query, in the kernel's arithmetic: the photons of the query's own x
    cells in the slot's (y,z) row (the cells of its box on the radius
    sqrt(r2) * BOX_SLACK), none if its box misses the row. Returns (k0,
    k1) int64 [n_tiles, TILE, ROWS], grid row indices with k0 <= k1. Every
    pair of the window left out fails d2 <= r2."""
    res = grid.resolution
    n_tiles = starts.shape[0]
    rc = torch.sqrt(torch.as_tensor(r2, dtype=torch.float32)) * BOX_SLACK
    inv = 1.0 / grid.cell_size
    p = (qpos - grid.origin).reshape(n_tiles, TILE, 1, 3)
    lo = torch.clamp(torch.floor((p - rc) * inv), 0, res - 1).long()
    hi = torch.clamp(torch.floor((p + rc) * inv), 0, res - 1).long()
    row = rows.long()[:, None, :]                      # [tiles, 1, ROWS]
    y, z = (row // res) % res, row // (res * res)
    st = starts.long()[:, None, :]
    en = st + lens.long()[:, None, :]
    in_row = ((lo[..., 1] <= y) & (y <= hi[..., 1]) & (lo[..., 2] <= z)
              & (z <= hi[..., 2]) & (en > st))
    offsets = grid.offsets.long()
    a = torch.maximum(st, offsets[row + lo[..., 0]])
    b = torch.minimum(en, offsets[row + hi[..., 0] + 1])
    k0 = torch.where(in_row, a, st)
    return k0, torch.where(in_row & (a < b), b, k0)


def _check_gather(starts, lens, weights, rows, r2, qpos, qnormal, grid):
    n_tiles, n = starts.shape[0], qpos.shape[0]
    packed = getattr(grid, "packed", None)
    if packed is None:
        raise ValueError("the grid has no packed photon records")
    for name, a, shape, dtype in (
            ("starts", starts, (n_tiles, ROWS), torch.int32),
            ("lens", lens, (n_tiles, ROWS), torch.int32),
            ("weights", weights, (n_tiles, ROWS), torch.float32),
            ("rows", rows, (n_tiles, ROWS), torch.int32),
            ("r2", r2, (), torch.float32),
            ("qpos", qpos, (n_tiles * TILE, 3), torch.float32),
            ("qnormal", qnormal, (n, 3), torch.float32),
            ("packed", packed, (grid.position.shape[0], PHOTON_RECORD),
             torch.float32),
            ("offsets", grid.offsets, (grid.resolution ** 3 + 1,),
             torch.int32),
            ("origin", grid.origin, (3,), torch.float32),
            ("cell_size", grid.cell_size, (), torch.float32)):
        if a.device != qpos.device:
            raise ValueError(f"{name} is on {a.device}, qpos on "
                             f"{qpos.device}")
        if a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")


def gather_photons_tiled_kernel(starts, lens, weights, rows, r2, qpos,
                                qnormal, grid, check_normal: bool = True):
    """The kernel on CUDA tensors, with the plain version's contract."""
    _check_gather(starts, lens, weights, rows, r2, qpos, qnormal, grid)
    out = torch.empty_like(qpos)
    if starts.shape[0] == 0:
        return out
    part = torch.empty((SLOT_GROUPS,) + tuple(out.shape),
                       dtype=torch.float32, device=qpos.device)
    with torch.cuda.device(qpos.device):
        launch("gather_photons_tiled", *(a.data_ptr() for a in (
                   starts, lens, weights, rows, r2, qpos, qnormal,
                   grid.packed, grid.offsets, grid.origin, grid.cell_size)),
               grid.resolution, starts.shape[0], SLOT_GROUPS,
               int(bool(check_normal)), part.data_ptr(), out.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    gather_photons_tiled.launches += 1
    return out


def gather_photons_tiled(grid: PhotonGrid, position: torch.Tensor,
                         normal: torch.Tensor, radius, *,
                         u_rows: torch.Tensor, check_normal: bool = True,
                         valid: torch.Tensor | None = None):
    """Tile-shared photon gather (pallas_gather.py:275-344).
    ``position``/``normal`` are [N,3], N a multiple of TILE, in tile order
    (:func:`tile_block_order`); ``u_rows`` is [N // TILE, ROWS + 2]
    uniforms. Returns (accum_power [N,3], stats): the estimator and stats
    of ``photon_map.gather_photons``, with per-query stats being the
    owning tile's counts. The kernel for CUDA tensors, the plain version
    for CPU tensors."""
    n = position.shape[0]
    if n % TILE:
        raise ValueError(f"{n} queries are not a multiple of {TILE}")
    starts, lens, weights, visited, total, rows = _tile_tables(
        grid, position, radius, u_rows, valid=valid)
    r = torch.as_tensor(radius, dtype=torch.float32, device=position.device)
    args = (starts, lens, weights, rows, torch.square(r), position, normal,
            grid, check_normal)
    if position.device.type == "cpu":
        accum = gather_photons_tiled_plain(*args)
    else:
        accum = gather_photons_tiled_kernel(*args)
    stats = dict(
        photons_visited=torch.repeat_interleave(visited, TILE),
        photon_subsampled=torch.repeat_interleave(
            torch.clamp_min(total - visited, 0), TILE))
    return accum, stats


gather_photons_tiled.launches = 0
