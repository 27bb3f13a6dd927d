"""Tile-shared vertex merge: the counterpart of
``oppositerenderer_tpu/accel/pallas_vm.py`` (kernel B4).

One vertex-merging round of VCM gathers, for every camera vertex of a
bounce, the light vertices within the merge radius, weighted by the
Jensen kernel, the camera BSDF at the light vertex's incoming direction
and the recursive MIS weight (SmallVCM ``VertexCM::RangeQuery::Process``;
the budgeted reference is ``integrators/vcm._merge_vertices``). Camera
vertices past the first bounce are not image-coherent, so
:func:`merge_vertices_tiled` sorts them by grid cell first (stably, with
inactive ones last, as JAX's ``lax.sort``), tiles them by ``TILE`` and
takes B3's slot tables (``gather_kernels._tile_tables``) over the vertex
grid. Per query, :func:`_query_table` packs what the pair math needs into
one row of 32 floats. The RGB factors separate as
``f = kd/pi * s_lambert + rho_phong * s_phong``, so the pair loop keeps two
sums against the vertex throughputs and the colours apply per query
afterwards.

The pair loop is the hand-written kernel of ``csrc/vm.cu`` for CUDA
tensors and :func:`merge_vertices_tiled_plain` for CPU tensors; the
wrapper counts its kernel launches in ``merge_vertices_tiled.launches``.
The kernel reads the grid's vertices as 64-byte records
(:func:`pack_vertex_records`, built once per grid into
``VertexGrid.packed``) and culls each slot's window by its (y,z) grid row
(``_tile_tables``' ``rows``) against each query's cells; the plain
version sums every staged pair. The two sums and the colours applied to
them have a zero gradient on both devices (``zero_grad``), the JAX tile
kernel's ``custom_vjp``; the camera throughput and the normalisation
outside keep theirs. The TPU kernel's Mosaic workarounds (the
transposed ``[16, M_pad]`` vertex packing, the 128-aligned DMA window,
the static slot unroll) are not ported.
"""
from __future__ import annotations

import torch

from ..core.math import INV_PI, Tensor, dot, local_reflect
from ..photon_map import (GAUSS_ALPHA, GAUSS_BETA, GAUSS_EXP_NEG_BETA,
                          cell_coords, cell_index_1d)
from . import cuda_build
from .zero_grad import zero_gradient
from .gather_kernels import (CHUNK, PLAIN_ELEMENT_BUDGET, ROWS, TILE,
                             _tile_tables)

EPS_COSINE = 1e-6   # bsdf/bsdf.py EPS_COSINE (reference config.h:42)
EPS_PHONG = 1e-3    # bsdf/bsdf.py EPS_PHONG (reference BxDF.h:265)
QCOLS = 32          # query table columns
VERTEX_FIELDS = ("position", "wo", "throughput", "dVCM", "dVM", "cont",
                 "depth")
RECORD = 16         # floats per packed vertex record
# CTAs per tile in B4's kernel, each with ROWS // SLOT_GROUPS slots: a
# tile's queries can sit in dense cells, and one CTA would walk all of its
# slots alone
SLOT_GROUPS = 4


def pack_vertex_records(position: Tensor, wo: Tensor, throughput: Tensor,
                        dVCM: Tensor, dVM: Tensor, cont: Tensor,
                        depth: Tensor, cell: Tensor, resolution: int
                        ) -> Tensor:
    """[M, RECORD] float32: per vertex of a cell-sorted grid, ``cell`` its
    grid cell (res^3 past the last), (position, dVCM), (wo, dVM),
    (throughput, cont), (depth, x, 0, 0) with x the cell's x index (exact
    in float32): four 16-byte groups, the layout in which B4's kernel
    stages a slot with one 16-byte copy per group. (Assigned column by
    column: on the card, torch.cat of such narrow columns is slower.)"""
    p = torch.empty((position.shape[0], RECORD), dtype=torch.float32,
                    device=position.device)
    p[:, 0:3] = position
    p[:, 3] = dVCM
    p[:, 4:7] = wo
    p[:, 7] = dVM
    p[:, 8:11] = throughput
    p[:, 11] = cont
    p[:, 12] = depth
    p[:, 13] = cell % resolution
    p[:, 14:] = 0.0
    return p


def _query_table(cam_bsdf, cam_pos: Tensor, a_cam: Tensor, b_cam: Tensor,
                 ok_q: Tensor) -> Tensor:
    """[N, 32] per-query precomputes (pallas_vm.py:152-196).

    cols 0:3 position; 9:12 shading normal; 12:15 the geometric normal
    times sign(ng . world_fix), so the same-side test is one dot; 15:18 the
    Phong mirror direction in world space; 18 the Lambert reverse-pdf term
    fix_z/pi; 19/20 the same-side pick weights of the Lambert and Phong
    components; 21 the Phong exponent; 22 a_cam = cam_dVCM * mis_vc_w;
    23 b_cam = cam_dVM * cam_cont; 24 the query-valid flag. cols 3:9 and
    25:32 are zero.
    """
    n = cam_pos.shape[0]
    frame = cam_bsdf.frame
    fix = cam_bsdf.local_dir_fix
    fix_z = fix[..., 2]
    wfix = cam_bsdf.world_dir_fix()
    sgn = torch.where(dot(cam_bsdf.ng, wfix) >= 0.0, 1.0, -1.0)
    refl_w = frame.to_world(local_reflect(fix))

    pick = cam_bsdf.pick_probs()          # [N,4]
    # same-side components: Lambert, Phong, specular reflection
    sum_same = pick[:, 0] + pick[:, 1] + pick[:, 2]
    any_same = sum_same > 0.0
    safe = torch.where(any_same, sum_same, 1.0)
    w_l = torch.where(any_same, pick[:, 0] / safe, 0.0)
    w_p = torch.where(any_same, pick[:, 1] / safe, 0.0)
    ok = ok_q & any_same & (fix_z >= EPS_COSINE)

    q = torch.zeros((n, QCOLS), dtype=torch.float32, device=cam_pos.device)
    q[:, 0:3] = cam_pos
    q[:, 9:12] = frame.n
    q[:, 12:15] = cam_bsdf.ng * sgn[:, None]
    q[:, 15:18] = refl_w
    q[:, 18] = torch.clamp_min(fix_z, 0.0) * INV_PI
    q[:, 19] = w_l
    q[:, 20] = w_p
    q[:, 21] = cam_bsdf.phong_exp
    q[:, 22] = a_cam
    q[:, 23] = b_cam
    q[:, 24] = ok.to(torch.float32)
    return q


def merge_vertices_tiled_plain(starts, lens, weights, rows, scal, qtab,
                               vgrid):
    """Plain PyTorch version of the kernel's contract (``csrc/vm.cu``).
    For each tile, the windows ``[start, start + len)`` of its ROWS slots
    over the vertices of ``vgrid`` against its TILE query rows of
    ``qtab``; ``scal`` is (r2, mis_vc_w, depth1, max_path_length). The
    slots' grid ``rows`` only let the kernel cull pairs that fail
    ``d2 <= r2``: this version tests every staged pair. The pair math
    follows the Pallas body (pallas_vm.py:106-146) operation by operation.
    Returns the two sums (out1, out2), each [N, 3]. Tiles go in chunks that
    bound the [tiles, TILE, ROWS * CHUNK] intermediates; a chunk's windows
    are cut to its longest slot."""
    n_tiles = starts.shape[0]
    dev = qtab.device
    vpos, vwo, vthr, vdvcm, vdvm, vcont, vdepth = (
        getattr(vgrid, f) for f in VERTEX_FIELDS)
    out1 = torch.zeros((n_tiles * TILE, 3), dtype=torch.float32, device=dev)
    out2 = torch.zeros_like(out1)
    if vpos.shape[0] == 0:
        return out1, out2
    ct = max(1, PLAIN_ELEMENT_BUDGET // (TILE * ROWS * CHUNK))
    r2, mis_vc_w, depth1, max_len = scal[0], scal[1], scal[2], scal[3]
    denom = 1.0 - GAUSS_EXP_NEG_BETA
    for t0 in range(0, n_tiles, ct):
        t1 = min(n_tiles, t0 + ct)
        c = t1 - t0
        width = max(1, int(lens[t0:t1].max()))
        j = torch.arange(width, dtype=torch.int32, device=dev)
        cnt = j < lens[t0:t1, :, None]                       # [c, ROWS, w]
        idx = torch.where(cnt, starts[t0:t1, :, None] + j, 0).long()
        idx = idx.reshape(c, 1, ROWS * width)
        cnt = cnt.reshape(c, 1, ROWS * width)
        q = qtab[t0 * TILE:t1 * TILE].reshape(c, TILE, 1, QCOLS)
        p = vpos[idx]                                        # [c, 1, K, 3]
        wo = vwo[idx]

        dx = q[..., 0] - p[..., 0]                           # [c, TILE, K]
        dy = q[..., 1] - p[..., 1]
        dz = q[..., 2] - p[..., 2]
        d2 = dx * dx + dy * dy + dz * dz
        kw = GAUSS_ALPHA * (1.0 - (1.0 - torch.exp(
            -GAUSS_BETA * d2 / (2.0 * r2))) / denom)

        def qdot(c0):
            return (q[..., c0] * wo[..., 0] + q[..., c0 + 1] * wo[..., 1]
                    + q[..., c0 + 2] * wo[..., 2])

        lgz = qdot(9)                                        # n . wo
        same = qdot(12) > 0.0
        gen_ok = lgz >= EPS_COSINE
        dot_r = qdot(15)
        ph_ok = dot_r > EPS_PHONG
        e = q[..., 21]
        powe = torch.exp(e * torch.log(torch.clamp_min(dot_r, EPS_PHONG)))
        d_l = torch.clamp_min(lgz, 0.0) * INV_PI
        pdf_p = torch.where(ph_ok, (e + 1.0) * (0.5 * INV_PI) * powe, 0.0)
        dpdf = (q[..., 19] * d_l + q[..., 20] * pdf_p) * vcont[idx]
        rpdf = q[..., 19] * q[..., 18] + q[..., 20] * pdf_p
        w_light = vdvcm[idx] * mis_vc_w + vdvm[idx] * dpdf
        w_cam = q[..., 22] + q[..., 23] * rpdf
        misw = 1.0 / (w_light + 1.0 + w_cam)

        ok = (cnt & (d2 <= r2) & same & gen_ok
              & (vdepth[idx] + depth1 <= max_len) & (q[..., 24] > 0.5))
        w_s = torch.repeat_interleave(weights[t0:t1], width, dim=1)
        base = torch.where(ok, misw * kw, 0.0) * w_s[:, None, :]
        s2 = torch.where(ph_ok, base * powe, 0.0)
        thr = vthr[idx[:, 0]]                                # [c, K, 3]
        out1[t0 * TILE:t1 * TILE] = torch.bmm(base, thr).reshape(-1, 3)
        out2[t0 * TILE:t1 * TILE] = torch.bmm(s2, thr).reshape(-1, 3)
    return out1, out2


def _check_merge(starts, lens, weights, rows, scal, qtab, vgrid):
    n_tiles, m = starts.shape[0], vgrid.packed.shape[0]
    shapes = [("starts", starts, (n_tiles, ROWS), torch.int32),
              ("lens", lens, (n_tiles, ROWS), torch.int32),
              ("weights", weights, (n_tiles, ROWS), torch.float32),
              ("rows", rows, (n_tiles, ROWS), torch.int32),
              ("scal", scal, (4,), torch.float32),
              ("qtab", qtab, (n_tiles * TILE, QCOLS), torch.float32),
              ("packed", vgrid.packed, (m, RECORD), torch.float32),
              ("offsets", vgrid.offsets, (vgrid.resolution ** 3 + 1,),
               torch.int32),
              ("origin", vgrid.origin, (3,), torch.float32),
              ("cell_size", vgrid.cell_size, (), torch.float32)]
    for name, a, shape, dtype in shapes:
        if a.device != qtab.device:
            raise ValueError(f"{name} is on {a.device}, qtab on "
                             f"{qtab.device}")
        if a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vgrid.packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")


def merge_vertices_tiled_kernel(starts, lens, weights, rows, scal, qtab,
                                vgrid):
    """The kernel on CUDA tensors, with the plain version's contract."""
    _check_merge(starts, lens, weights, rows, scal, qtab, vgrid)
    out1 = torch.empty((qtab.shape[0], 3), dtype=torch.float32,
                       device=qtab.device)
    out2 = torch.empty_like(out1)
    if starts.shape[0] == 0:
        return out1, out2
    part = torch.empty((2, SLOT_GROUPS) + tuple(out1.shape),
                       dtype=torch.float32, device=qtab.device)
    cuda_build.launch_on(
        qtab.device, "merge_vertices_tiled", starts, lens, weights, rows,
        scal, qtab, vgrid.packed, vgrid.offsets, vgrid.origin,
        vgrid.cell_size, vgrid.resolution, starts.shape[0], SLOT_GROUPS,
        part, out1, out2)
    merge_vertices_tiled.launches += 1
    return out1, out2


def _merge_queries(vgrid, cfg, cam_bsdf, cam_pos, cam_dVCM, cam_dVM, active,
                   mis_vc_w):
    """Each camera vertex's grid cell (inactive ones past the last cell),
    query table row and colours kd/pi and rho_phong, in lane order."""
    res = vgrid.resolution
    # inactive lanes may carry non-finite positions: masked before the
    # float -> int cast, whose result for NaN differs between libraries
    pos_c = torch.where(active[:, None], cam_pos, vgrid.origin)
    cells = cell_index_1d(cell_coords(pos_c, vgrid.origin, vgrid.cell_size,
                                      res), res)
    cells = torch.where(active, cells, res ** 3)   # inactive sort last
    cam_cont = cam_bsdf.continuation_prob()
    if cfg.vcm_force_continuation_prob is not None:
        cam_cont = torch.full_like(cam_cont, cfg.vcm_force_continuation_prob)
    qtab = _query_table(cam_bsdf, cam_pos, cam_dVCM * mis_vc_w,
                        cam_dVM * cam_cont, active)
    kd_pi = cam_bsdf.kd * INV_PI
    rho = cam_bsdf.ks * ((cam_bsdf.phong_exp + 2.0) * (0.5 * INV_PI))[:, None]
    return cells, qtab, kd_pi, rho


def _sorted_tables(vgrid, cfg, cells, qtab, kd_pi, rho, radius_sq, mis_vc_w,
                   u_rows, depth1):
    """The queries sorted by cell (stably, as JAX's ``lax.sort``) and the
    slot tables of their tiles: (order, (starts, lens, weights, rows, scal,
    qtab, vgrid), kd_pi, rho), the last three in cell order."""
    dev = qtab.device
    radius_sq = torch.as_tensor(radius_sq, dtype=torch.float32, device=dev)
    _, order = torch.sort(cells, stable=True)
    qtab = qtab[order]
    starts, lens, weights, _, _, rows = _tile_tables(
        vgrid, qtab[:, 0:3], torch.sqrt(radius_sq), u_rows,
        valid=qtab[:, 24] > 0.5)
    # the integers by fills: no host-to-device copy in a captured step
    scal = torch.stack([
        radius_sq.reshape(()),
        torch.as_tensor(mis_vc_w, dtype=torch.float32,
                        device=dev).reshape(()),
        torch.full((), float(depth1), dtype=torch.float32, device=dev),
        torch.full((), float(cfg.vcm_max_path_length), dtype=torch.float32,
                   device=dev)])
    return (order, (starts, lens, weights, rows, scal, qtab, vgrid),
            kd_pi[order], rho[order])


def merge_tables(vgrid, cfg, cam_bsdf, cam_pos, cam_dVCM, cam_dVM, active,
                 radius_sq, mis_vc_w, u_rows, depth1):
    """Everything the pair loop takes, for one merge round
    (pallas_vm.py:274-312): the cell order of the queries, the slot tables,
    the slots' grid rows, the scalars, the cell-sorted query table, the
    grid, and the per-query colours kd/pi and rho_phong. Returns (order,
    (starts, lens, weights, rows, scal, qtab, vgrid), kd_pi, rho)."""
    return _sorted_tables(vgrid, cfg, *_merge_queries(
        vgrid, cfg, cam_bsdf, cam_pos, cam_dVCM, cam_dVM, active, mis_vc_w),
        radius_sq, mis_vc_w, u_rows, depth1)


@zero_gradient
def _merged(kd_pi, rho, *args):
    """kd/pi out1 + rho out2: the pair loop's two sums by the kernel for
    CUDA tensors, by the plain version for CPU tensors."""
    if kd_pi.device.type == "cpu":
        out1, out2 = merge_vertices_tiled_plain(*args)
    else:
        out1, out2 = merge_vertices_tiled_kernel(*args)
    return kd_pi * out1 + rho * out2


def merge_vertices_tiled(vgrid, cfg, cam_bsdf, cam_pos, cam_thr, cam_dVCM,
                         cam_dVM, active, radius_sq, mis_vc_w,
                         n_light_paths, u_rows, depth1, mesh=None) -> Tensor:
    """Tile-shared merge round (pallas_vm.py:260-321) -> contribution
    [N,3], already times cam_thr: the tile path of
    ``integrators/vcm._merge_vertices``. N is a multiple of TILE;
    ``u_rows`` is [N // TILE, ROWS + 2] uniforms, drawn per raster lane and
    applied to the cell-sorted tiles, as in JAX. The kernel for CUDA
    tensors, the plain version for CPU tensors; the merged sums have a
    zero gradient on both.

    With a process-group ``mesh`` (``parallel.mesh.Mesh``; N is then this
    rank's band of camera vertices) the tiles are the whole image's: the
    ranks all-gather their queries, sort them all by cell, each merges
    its share of the tiles, and one ``psum_scatter`` returns each rank its
    band, so that every vertex meets the tile and uniforms it meets
    unsharded."""
    n = cam_pos.shape[0]
    if n % TILE:
        raise ValueError(f"{n} queries are not a multiple of {TILE}")
    queries = _merge_queries(vgrid, cfg, cam_bsdf, cam_pos, cam_dVCM,
                             cam_dVM, active, mis_vc_w) + (u_rows,)
    sharded = mesh is not None and mesh.group is not None
    if sharded:
        # the sums have a zero gradient: the queries travel detached
        queries = tuple(mesh.all_gather(a.detach()) for a in queries)
    cells, qtab, kd_pi, rho, u_rows = queries
    order, args, kd_pi, rho = _sorted_tables(
        vgrid, cfg, cells, qtab, kd_pi, rho, radius_sq, mis_vc_w, u_rows,
        depth1)
    if sharded:
        starts, lens, weights, rows, scal, qtab, g = args
        t = starts.shape[0] // mesh.size
        ts = slice(mesh.rank * t, (mesh.rank + 1) * t)
        qs = slice(mesh.rank * t * TILE, (mesh.rank + 1) * t * TILE)
        acc_s = _merged(kd_pi[qs], rho[qs], starts[ts], lens[ts],
                        weights[ts], rows[ts], scal, qtab[qs], g)
        acc = torch.zeros((qtab.shape[0], 3), dtype=acc_s.dtype,
                          device=acc_s.device)
        acc[order[qs]] = acc_s.detach()
        acc = mesh.psum_scatter(acc)
    else:
        acc_s = _merged(kd_pi, rho, *args)
        acc = torch.empty_like(acc_s)
        acc[order] = acc_s
    radius_sq = args[4][0]
    norm = 1.0 / (torch.pi * radius_sq * n_light_paths)
    return cam_thr * acc * norm


merge_vertices_tiled.launches = 0
