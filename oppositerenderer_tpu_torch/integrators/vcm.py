"""VCM bidirectional path tracing: vertex connection and vertex merging.

The counterpart of ``oppositerenderer_tpu/integrators/vcm.py``: the
recursive MIS quantities dVCM/dVC/dVM of the "Implementing VCM" tech
report as the reference codes them (``renderer/vcm/mis.h``: init :35-105,
on hit :109-123, on scatter :133-186), the reference's techniques in
``renderer/vcm/vcm.h`` (t=1 camera splats :65-161, s=0 emitter hits
:493-522, s=1 next-event estimation :406-488, vertex connection :315-400)
with the balance heuristic and the host-side factors of
``OptixRenderer.cpp:675-696`` (etaVCM, misVc/VmWeightFactor), and the JAX
package's vertex merging (:class:`VertexGrid`, :func:`_merge_vertices`),
which goes beyond the reference.

Every random decision draws the JAX package's per-lane streams in the same
order, so the two packages trace the same paths for the same seed. Light
vertices live in a dense ``[n_paths, max_len - 1]`` store with validity
masks; a bounce writes each storable vertex with one indexed assignment at
its path's next free slot (JAX writes with one-hot masks, a TPU
workaround). The merge takes the tile-shared merge
(``accel/vm_kernels.merge_vertices_tiled``, kernel B4 on CUDA, its plain
version on the CPU) whenever the camera vertices split into tiles of 256,
on every device, and the budgeted merge otherwise: the image does not
depend on the device. A camera bounce traces the shadow rays of its s=1
sample and of all its vertex connections in one batch, one any-hit
launch where the JAX package traces each technique's rays alone; the
contributions are added in the JAX package's order. The coherent
first-bounce peel (a BVH routing choice of the TPU) is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.gather_kernels import ROWS, TILE
from ..accel.intersect import intersect, occluded
from ..accel.vm_kernels import merge_vertices_tiled, pack_vertex_records
from ..bsdf import BSDF
from ..camera import Camera
from ..config import RenderConfig
from ..core.math import Frame, Tensor, dot, length, max3
from ..core.profiling import pass_scope
from ..core.rng import Key, LaneSampler, fold_in_range, iteration_key
from ..core.sampling import cos_hemisphere_pdf_w, pdf_w_to_a
from ..lights import light_emit, light_illuminate
from ..photon_map import (PhotonBatch, cell_coords, cell_index_1d,
                          gather_cell_indices, gaussian_kernel_weight,
                          min_cell_size_for_window, photon_grid_geometry)
from ..scene.types import Scene
from .common import bsdf_at_hit, device_scalar, pixel_coords, scene_epsilon

PASS_VCM_LIGHT = 4
PASS_VCM_CAMERA = 5
BIG = 1e30
EPS_COSINE = 1e-6


@dataclasses.dataclass
class LightVertexStore:
    """Dense light-subpath vertices [n_paths, max_verts]."""

    position: Tensor     # [P,V,3]
    throughput: Tensor   # [P,V,3]
    dVCM: Tensor         # [P,V]
    dVC: Tensor          # [P,V]
    dVM: Tensor          # [P,V]
    mat: Tensor          # [P,V] int32
    ns: Tensor           # [P,V,3]
    ng: Tensor           # [P,V,3]
    wo: Tensor           # [P,V,3] direction back along the incoming ray
    valid: Tensor        # [P,V] bool
    depth: Tensor        # [P,V] int32: light path length at the vertex

    def map(self, fn) -> "LightVertexStore":
        """The store with ``fn`` applied to every field."""
        return LightVertexStore(**{f.name: fn(getattr(self, f.name))
                                   for f in dataclasses.fields(self)})


def _map_bsdf(b: BSDF, fn) -> BSDF:
    """The BSDF with ``fn`` applied to every per-lane tensor."""
    fields = {f.name: fn(getattr(b, f.name)) for f in dataclasses.fields(b)
              if f.name != "frame"}
    return BSDF(frame=Frame(u=fn(b.frame.u), v=fn(b.frame.v),
                            n=fn(b.frame.n)), **fields)


def _cont_prob(bsdf: BSDF, cfg: RenderConfig) -> Tensor:
    """RR continuation probability as the MIS weights use it: what
    sampleScattering uses, including the testing override."""
    if cfg.vcm_force_continuation_prob is not None:
        return torch.full_like(bsdf.ior, cfg.vcm_force_continuation_prob)
    return bsdf.continuation_prob()


def _rebuild_bsdf(scene: Scene, mat: Tensor, ns: Tensor, ng: Tensor,
                  wo: Tensor) -> BSDF:
    """A light vertex's BSDF from its material id and frame (the reference
    embeds a VcmBSDF blob in the vertex, LightVertex.h:14-30)."""
    kd, ks, expn, kr, kt, ior, diel = scene.materials.bsdf_coefficients(
        mat.long())
    return BSDF.make(ns, ng, wo, kd, ks, expn, kr, kt, ior, diel)


# ---------------------------------------------------------------------------
# light pass
# ---------------------------------------------------------------------------

def trace_light_pass(scene: Scene, camera: Camera, cfg: RenderConfig,
                     key: Key, eps: Tensor, mis_vc_w: Tensor,
                     mis_vm_w: Tensor, lane_ids: Tensor,
                     n_light_paths_global: int):
    """Light subpaths: store their vertices and splat t=1 connections.

    ``lane_ids`` are GLOBAL path indices; ``n_light_paths_global`` is the
    total over all shards (the t=1 MIS weight and splat normalisation).
    Returns (LightVertexStore, splat image [H,W,3], stats).
    """
    W, H = cfg.width, cfg.height
    n_paths = lane_ids.shape[0]
    dev = lane_ids.device
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    n_lights = scene.lights.n_lights
    center, radius = scene.bounding_sphere
    max_verts = cfg.vcm_max_path_length - 1

    # initLightPayload (VCMLightPass.cu:117-163)
    li = torch.clamp_max((s.next1() * n_lights).to(torch.int64),
                         n_lights - 1)
    rows = scene.lights.row(li)
    light_pick_pdf = 1.0 / n_lights
    radiance, o, d, emission_pdf_w, direct_pdf_w, cos_at_light = light_emit(
        rows, s.next2(), s.next2(), center, radius,
        eps_cosine=cfg.eps_cosine)
    emission_pdf_w = (emission_pdf_w * light_pick_pdf).detach()
    direct_pdf_w = (direct_pdf_w * light_pick_pdf).detach()
    throughput = radiance / torch.clamp_min(emission_pdf_w, 1e-30)[:, None]

    # initLightMisTerms (mis.h:35-80)
    dVCM = direct_pdf_w / torch.clamp_min(emission_pdf_w, 1e-30)
    used_cos = torch.where(rows.is_finite, cos_at_light, 1.0)
    dVC = torch.where(rows.is_delta, 0.0,
                      used_cos / torch.clamp_min(emission_pdf_w, 1e-30))
    dVM = dVC * mis_vc_w

    alive = torch.ones((n_paths,), dtype=torch.bool, device=dev)
    splat = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    # flat [P*V + 1] buffers: lanes with nothing to store write the spare
    # last row, so one indexed assignment per field needs no compaction
    n_rows = n_paths * max_verts

    def buf(*shape, dtype=torch.float32):
        return torch.zeros((n_rows + 1,) + shape, dtype=dtype, device=dev)

    bufs = dict(position=buf(3), throughput=buf(3), dVCM=buf(), dVC=buf(),
                dVM=buf(), mat=buf(dtype=torch.int32), ns=buf(3), ng=buf(3),
                wo=buf(3), valid=buf(dtype=torch.bool),
                depth=buf(dtype=torch.int32))
    n_stored = torch.zeros((n_paths,), dtype=torch.int32, device=dev)
    lane_row = torch.arange(n_paths, device=dev) * max_verts
    tmin = torch.full((n_paths,), 1.0, device=dev) * eps

    depth_keys = fold_in_range(key, 3001, cfg.vcm_max_path_length - 1)
    for depth1 in range(1, cfg.vcm_max_path_length):   # depth after ++
        skey = LaneSampler(depth_keys[depth1 - 1], lane_ids,
                           cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, tmin, torch.where(alive, BIG, 0.0))
        bsdf, is_emitter, _ = bsdf_at_hit(scene, hit, d)
        # emitters absorb (DiffuseEmitter.cu:76-79)
        live = alive & hit.hit & ~is_emitter

        n_eff = bsdf.frame.n  # flipped for glass hit from inside
        cos_in = dot(n_eff, -d)
        live = live & (cos_in >= EPS_COSINE)  # vcm.h:245-250

        # updateMisTermsOnHit (mis.h:109-123)
        dVCM = torch.where(live, dVCM * torch.square(hit.t) / cos_in, dVCM)
        dVC = torch.where(live, dVC / cos_in, dVC)
        dVM = torch.where(live, dVM / cos_in, dVM)

        storeable = live & ~bsdf.is_specular()

        # store the vertex (vcm.h:256-291) in its path's next free slot
        row = torch.where(storeable, lane_row + n_stored, n_rows)
        for name, val in (("position", hit.position),
                          ("throughput", throughput), ("dVCM", dVCM),
                          ("dVC", dVC), ("dVM", dVM), ("mat", hit.mat),
                          ("ns", n_eff), ("ng", bsdf.ng), ("wo", -d)):
            bufs[name][row] = val
        bufs["valid"].index_fill_(0, row, True)
        bufs["depth"].index_fill_(0, row, depth1)
        n_stored = n_stored + storeable.to(torch.int32)

        # t=1: connect to the camera (vcm.h:65-161)
        if cfg.vcm_connect_camera_t1:
            splat = splat + _connect_camera_t1(
                scene, camera, cfg, bsdf, hit.position, throughput, dVCM,
                dVC, storeable, n_light_paths_global, mis_vm_w, eps)

        # terminate if too long (vcm.h:303-307), else scatter
        can_continue = live & (cfg.vcm_max_path_length >= depth1 + 2)
        o, d, throughput, dVCM, dVC, dVM, alive = _sample_scattering(
            skey, bsdf, hit.position, throughput, dVCM, dVC, dVM,
            can_continue, mis_vc_w, mis_vm_w, adjoint=True,
            force_cont_prob=cfg.vcm_force_continuation_prob)

    store = LightVertexStore(**{
        k: v[:n_rows].reshape((n_paths, max_verts) + v.shape[1:])
        for k, v in bufs.items()})
    stats = dict(light_vertices_stored=torch.sum(n_stored),
                 avg_light_path_verts=torch.mean(n_stored.to(torch.float32)))
    return store, splat.reshape(H, W, 3), stats


def _connect_camera_t1(scene, camera, cfg, bsdf, hitpoint, throughput,
                       dVCM, dVC, active, n_light_paths, mis_vm_w, eps):
    """connectCameraT1 (vcm.h:65-161) -> splat buffer [H*W,3]."""
    W, H = cfg.width, cfg.height
    to_cam = camera.eye - hitpoint
    dist = length(to_cam)
    dir_to_cam = to_cam / torch.clamp_min(dist, 1e-20)[:, None]

    px, py, inside, _ = camera.world_to_raster(hitpoint, W, H)

    f, cos_to_cam, _, rev_pdf = bsdf.f(dir_to_cam)
    rev_pdf = rev_pdf * _cont_prob(bsdf, cfg)

    camera_pdf_w, cos_at_cam = camera.pdf_quantities(-dir_to_cam, W, H)
    ok_cam = cos_at_cam > 1e-6
    camera_pdf_a = torch.where(
        ok_cam, camera_pdf_w * torch.abs(cos_to_cam)
        / torch.clamp_min(torch.square(dist), 1e-20), 0.0).detach()

    w_light = torch.clamp_min((camera_pdf_a / n_light_paths) * (
        mis_vm_w + dVCM + dVC * rev_pdf), 0.0)
    mis_weight = (1.0 / (w_light + 1.0)).detach()

    contrib = (mis_weight[:, None] * throughput * f
               * (camera_pdf_a / n_light_paths)[:, None])

    ok = active & inside & (max3(f) > 0.0) & ok_cam
    # not-ok lanes trace an empty interval
    occ = occluded(scene, hitpoint, dir_to_cam,
                   torch.full_like(dist, 1.0) * eps,
                   torch.where(ok, torch.maximum(dist - 2 * eps, eps), 0.0))
    ok = ok & ~occ
    contrib = torch.where(ok[:, None], contrib, 0.0)
    # the pixel of a lane outside the frustum is masked before its float ->
    # int cast is used
    pix = (torch.clamp(torch.where(ok, py, 0.0).to(torch.int64), 0, H - 1)
           * W + torch.clamp(torch.where(ok, px, 0.0).to(torch.int64), 0,
                             W - 1))
    return torch.zeros((H * W, 3), dtype=torch.float32,
                       device=hitpoint.device).index_add_(0, pix, contrib)


def _sample_scattering(skey: LaneSampler, bsdf: BSDF, hitpoint, throughput,
                       dVCM, dVC, dVM, can_continue, mis_vc_w, mis_vm_w,
                       adjoint: bool, force_cont_prob: float | None = None):
    """sampleScattering (vcm.h:166-204) and updateMisTermsOnScatter
    (mis.h:133-186), with masks. Draws RR, then the BSDF sample."""
    if force_cont_prob is not None:
        cont_prob = torch.full_like(bsdf.ior, force_cont_prob)
    else:
        cont_prob = bsdf.continuation_prob()
    rr = skey.next1() < cont_prob
    live = can_continue & rr

    res = bsdf.sample(skey.next3(), adjoint=adjoint)
    live = live & res.valid & (res.pdf_w > 0.0)

    # reverse pdf: the direct one for specular, else evaluated (vcm.h:184)
    _, _, _, rev = bsdf.f(res.world_dir)
    rev_pdf = torch.where(res.is_specular, res.pdf_w, rev)
    dir_pdf = res.pdf_w * cont_prob
    rev_pdf = rev_pdf * cont_prob

    cos_out = res.cos_theta
    safe_dir = torch.clamp_min(dir_pdf, 1e-30)
    new_dVC_spec = dVC * cos_out
    new_dVM_spec = dVM * cos_out
    new_dVC_ns = (cos_out / safe_dir) * (dVC * rev_pdf + dVCM + mis_vm_w)
    new_dVM_ns = (cos_out / safe_dir) * (dVM * rev_pdf + dVCM * mis_vc_w
                                         + 1.0)
    new_dVCM_ns = 1.0 / safe_dir

    sp = res.is_specular
    dVC_n = torch.where(live, torch.where(sp, new_dVC_spec, new_dVC_ns), dVC)
    dVM_n = torch.where(live, torch.where(sp, new_dVM_spec, new_dVM_ns), dVM)
    dVCM_n = torch.where(live, torch.where(sp, 0.0, new_dVCM_ns), dVCM)

    w = res.f * (cos_out / torch.clamp_min(dir_pdf, 1e-30))[:, None]
    thr = torch.where(live[:, None], throughput * w, throughput)
    return hitpoint, res.world_dir, thr, dVCM_n, dVC_n, dVM_n, live


# ---------------------------------------------------------------------------
# vertex merging: the reference scaffolds it (the mis_vm terms, the
# vmNormalization constant of OptixRenderer.cpp:300-301) but disables it;
# here, as in the JAX package, per the tech report and SmallVCM's merge on
# the sorted uniform grid of the photon map
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VertexGrid:
    """Sorted uniform grid over the flattened light-vertex store."""

    position: Tensor    # [M,3]
    wo: Tensor          # [M,3] direction back along the vertex's ray
    throughput: Tensor  # [M,3]
    dVCM: Tensor        # [M]
    dVM: Tensor         # [M]
    cont: Tensor        # [M] RR continuation prob of the vertex's BSDF
    depth: Tensor       # [M] light path length at the vertex (float32)
    offsets: Tensor     # [R^3+1] int32
    origin: Tensor      # [3]
    cell_size: Tensor   # []
    resolution: int
    # [M,16] the vertices as 64-byte records for B4's kernel
    # (vm_kernels.pack_vertex_records); not a field of the JAX package's
    packed: Tensor


def build_vertex_grid(scene: Scene, cfg: RenderConfig,
                      store: LightVertexStore, radius: Tensor) -> VertexGrid:
    """Flatten the store and sort it by grid cell, stably as JAX's
    ``lax.sort``, so the grid is bit-identical to the JAX package's
    (the photon grid's build, OptixRenderer_SpatialHash.cu:209-283)."""
    flat = store.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    res = cfg.photon_grid_resolution
    origin, cell_size = photon_grid_geometry(
        PhotonBatch(position=flat.position, power=flat.throughput,
                    direction=flat.wo, valid=flat.valid), res,
        min_cell_size=min_cell_size_for_window(radius, 4))

    # each vertex's reverse continuation prob (SmallVCM scales the camera ->
    # light reverse pdf of the merge MIS weight by it), computed once here
    cont = _cont_prob(_rebuild_bsdf(scene, flat.mat, flat.ns, flat.ng,
                                    flat.wo), cfg)

    n_cells = res ** 3
    cells = cell_index_1d(cell_coords(flat.position, origin, cell_size,
                                      res), res)
    cells = torch.where(flat.valid, cells, n_cells)
    cells_sorted, order = torch.sort(cells, stable=True)
    offsets = torch.searchsorted(
        cells_sorted, torch.arange(n_cells + 1, dtype=cells_sorted.dtype,
                                   device=cells.device))
    fields = dict(
        position=flat.position[order], wo=flat.wo[order],
        throughput=flat.throughput[order], dVCM=flat.dVCM[order],
        dVM=flat.dVM[order], cont=cont[order],
        depth=flat.depth.to(torch.float32)[order])
    offsets = offsets.to(torch.int32)
    return VertexGrid(**fields, offsets=offsets, origin=origin,
                      cell_size=cell_size, resolution=res,
                      packed=pack_vertex_records(**fields, cell=cells_sorted,
                                                 resolution=res))


def _merge_vertices(scene: Scene, cfg: RenderConfig, cam_bsdf: BSDF,
                    cam_pos, cam_thr, cam_dVCM, cam_dVM, active,
                    vgrid: VertexGrid, radius_sq, mis_vc_w, n_light_paths,
                    u_stride, depth1, mesh=None):
    """One camera bounce's merge against the light-vertex grid -> the
    contribution [n,3], already times cam_thr.

    MIS weights as SmallVCM's VertexCM::RangeQuery::Process:
      wLight  = lv.dVCM * misVcWeightFactor + lv.dVM * Mis(cameraDirPdfW)
      wCamera = cam.dVCM * misVcWeightFactor + cam.dVM * Mis(cameraRevPdfW)
    with the direct pdf scaled by the light vertex's continuation prob and
    the reverse pdf by the camera BSDF's. Kernel: the Jensen gaussian of
    the photon gather, normalised by 1/(pi r^2 nLightPaths) like the
    reference's vmNormalization.

    n a multiple of TILE takes the tile merge (kernel B4 on CUDA, its plain
    version on the CPU; ``u_stride`` of the first ROWS + 2 lanes of each
    raster tile drives its subsampling); otherwise the budgeted gather of
    ``cfg.vcm_vm_budget`` entries per query, subsampled by ``u_stride``.
    """
    n = cam_pos.shape[0]
    if n % TILE == 0:
        u_rows = u_stride.reshape(n // TILE, TILE)[:, :ROWS + 2]
        return merge_vertices_tiled(
            vgrid, cfg, cam_bsdf, cam_pos, cam_thr, cam_dVCM, cam_dVM,
            active, radius_sq, mis_vc_w, n_light_paths, u_rows, depth1,
            mesh=mesh)

    radius_sq = device_scalar(radius_sq, cam_pos.device)
    # inactive lanes may carry non-finite positions: masked before the
    # grid's float -> int casts
    pos_q = torch.where(active[:, None], cam_pos, vgrid.origin)
    gidx, gok, stride, _ = gather_cell_indices(
        vgrid.offsets, vgrid.origin, vgrid.cell_size, vgrid.resolution,
        pos_q, torch.sqrt(radius_sq), max_cells_per_axis=4,
        budget_total=cfg.vcm_vm_budget, u_stride=u_stride)
    gi = gidx.long()
    ppos = vgrid.position[gi]          # [N,B,3]
    pwo = vgrid.wo[gi]
    pthr = vgrid.throughput[gi]

    diff = cam_pos[:, None, :] - ppos
    d2 = dot(diff, diff)
    ok = (gok & (d2 <= radius_sq) & active[:, None]
          & (vgrid.depth[gi] + depth1 <= cfg.vcm_max_path_length))

    # the camera BSDF at each light vertex's incoming direction
    f, _, dpdf, rpdf = _map_bsdf(cam_bsdf, lambda a: a[:, None]).f(pwo)
    dpdf = dpdf * vgrid.cont[gi]
    rpdf = rpdf * _cont_prob(cam_bsdf, cfg)[:, None]

    w_light = vgrid.dVCM[gi] * mis_vc_w + vgrid.dVM[gi] * dpdf
    w_camera = (cam_dVCM * mis_vc_w)[:, None] + cam_dVM[:, None] * rpdf
    mis_weight = (1.0 / (w_light + 1.0 + w_camera)).detach()

    kw = gaussian_kernel_weight(d2, radius_sq)
    acc = torch.sum(torch.where(ok[..., None],
                                f * pthr * (mis_weight * kw)[..., None],
                                0.0), dim=-2)
    acc = acc * stride[:, None].to(torch.float32)   # subsample reweight
    norm = 1.0 / (torch.pi * radius_sq * n_light_paths)
    return cam_thr * acc * norm


# ---------------------------------------------------------------------------
# camera pass
# ---------------------------------------------------------------------------

def trace_camera_pass(scene: Scene, camera: Camera, cfg: RenderConfig,
                      key: Key, eps: Tensor, mis_vc_w: Tensor,
                      mis_vm_w: Tensor, store: LightVertexStore,
                      n_light_paths: int, px: Tensor, py: Tensor,
                      lane_ids: Tensor, pair: Tensor,
                      vgrid: VertexGrid | None = None,
                      radius_sq: Tensor | None = None,
                      mesh=None) -> Tensor:
    """Camera subpaths with every technique -> radiance [n,3].

    ``pair`` indexes rows of ``store`` (1:1 pairing, vcm.h:603-607);
    ``n_light_paths`` is the global count. ``vgrid``/``radius_sq`` enable
    the merge rounds and are required when ``cfg.vcm_use_vm``. A sharded
    step passes its ``mesh``: the tile merge then tiles the whole image's
    camera vertices (``accel/vm_kernels.merge_vertices_tiled``)."""
    if cfg.vcm_use_vm and vgrid is None:
        raise ValueError("cfg.vcm_use_vm requires a VertexGrid "
                         "(build_vertex_grid) and radius_sq")
    W, H = cfg.width, cfg.height
    n = px.shape[0]
    dev = px.device
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    n_lights = scene.lights.n_lights
    center, sradius = scene.bounding_sphere
    light_pick_prob = 1.0 / n_lights

    o, d = camera.generate_rays(px, py, s.next2(), W, H, dof_u=s.next2())
    camera_pdf_w, _ = camera.pdf_quantities(d, W, H)

    uniform = cfg.vcm_uniform_vertex_sampling
    if uniform:
        # VCM_UNIFORM_VERTEX_SAMPLING: valid vertices first (a stable sort
        # replaces the reference's atomically appended LVC, vcm.h:281), so
        # a uniform draw over [0, n_valid) picks any stored vertex with
        # equal probability (vcm.h:583-601); each of the n_conn draws is
        # scaled by invPick = n_valid / (n_conn * n_light_paths), the JAX
        # package's derivation (the reference's branch is unfinished)
        flat = store.map(lambda a: a.reshape((-1,) + a.shape[2:]))
        compact = torch.argsort((~flat.valid).to(torch.uint8), stable=True)
        n_valid = torch.sum(flat.valid).to(torch.int32)
        n_conn = max(1, cfg.vcm_uniform_connections)
        inv_pick = (torch.clamp_min(n_valid.to(torch.float32), 1.0)
                    / (n_conn * n_light_paths))
    elif cfg.vcm_connect_vertices:
        # the paired light subpath is fixed for the whole camera path:
        # gather its rows, and rebuild their BSDFs, once
        store_p = store.map(lambda a: a[pair])
        lv_bsdf_p = _rebuild_bsdf(scene, store_p.mat, store_p.ns,
                                  store_p.ng, store_p.wo)
        lv_cont_p = _cont_prob(lv_bsdf_p, cfg)

    # initCameraMisTerms (mis.h:84-105)
    dVCM = (n_light_paths / camera_pdf_w).detach()
    dVC = torch.zeros((n,), dtype=torch.float32, device=dev)
    dVM = torch.zeros((n,), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    tmin = torch.full((n,), 1.0, device=dev) * eps

    depth_keys = fold_in_range(key, 4001, cfg.vcm_max_path_length)
    for depth1 in range(1, cfg.vcm_max_path_length + 1):
        skey = LaneSampler(depth_keys[depth1 - 1], lane_ids,
                           cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, tmin, torch.where(alive, BIG, 0.0))
        live = alive & hit.hit

        bsdf, is_emitter, _ = bsdf_at_hit(scene, hit, d)
        cos_in = dot(bsdf.frame.n, -d)

        # updateMisTermsOnHit (mis.h:109-123), before any technique runs
        upd = live & (cos_in >= EPS_COSINE)
        dVCM = torch.where(upd, dVCM * torch.square(hit.t) / cos_in, dVCM)
        dVC = torch.where(upd, dVC / cos_in, dVC)
        dVM = torch.where(upd, dVM / cos_in, dVM)

        # s=0: emitter hit (DiffuseEmitter.cu:95-119, vcm.h:493-522)
        em = live & is_emitter
        if cfg.vcm_connect_light_s0:
            mat = hit.mat.long()
            lemit = scene.materials.emission[mat]
            front = dot(hit.ns, -d) > 0.0
            mrow = scene.materials.light_index[mat]
            inv_area = scene.lights.inverse_area[
                torch.clamp_min(mrow, 0).long()]
            direct_pdf_a = inv_area * light_pick_prob
            emission_pdf_w = (cos_hemisphere_pdf_w(hit.ng, -d) * inv_area
                              * light_pick_prob)
            w_camera = torch.clamp_min(direct_pdf_a * dVCM
                                       + emission_pdf_w * dVC, 0.0)
            mis_weight = (torch.ones_like(w_camera) if depth1 == 1
                          else (1.0 / (1.0 + w_camera)).detach())
            contrib = throughput * lemit * mis_weight[:, None]
            color = color + torch.where((em & front)[:, None], contrib, 0.0)

        live2 = live & ~em & (cos_in >= EPS_COSINE)
        connectable = live2 & ~bsdf.is_specular()

        # the shadow rays of this bounce's techniques, (direction, tmax,
        # contribution, ok) each, traced in one batch below
        shadow = []

        # s=1: next-event estimation with full MIS (vcm.h:406-488)
        if cfg.vcm_connect_light_s1:
            li = torch.clamp_max((skey.next1() * n_lights).to(torch.int64),
                                 n_lights - 1)
            rows = scene.lights.row(li)
            radiance, dir_l, ldist, direct_pdf_w, emission_pdf_w, \
                cos_at_light = light_illuminate(
                    rows, skey.next2(), hit.position, center, sradius,
                    eps_cosine=cfg.eps_cosine)
            f, cos_to_light, bsdf_dir_pdf, bsdf_rev_pdf = bsdf.f(dir_l)
            cont = _cont_prob(bsdf, cfg)
            bsdf_dir_pdf = torch.where(rows.is_delta, 0.0,
                                       bsdf_dir_pdf * cont)
            bsdf_rev_pdf = bsdf_rev_pdf * cont
            w_light = torch.clamp_min(bsdf_dir_pdf / torch.clamp_min(
                light_pick_prob * direct_pdf_w, 1e-30), 0.0)
            w_camera = torch.clamp_min(
                emission_pdf_w * torch.clamp_min(cos_to_light, 0.0)
                / torch.clamp_min(direct_pdf_w * cos_at_light, 1e-30)
                * (mis_vm_w + dVCM + dVC * bsdf_rev_pdf), 0.0)
            mis_weight = (1.0 / (w_light + 1.0 + w_camera)).detach()
            geom_factor = (torch.clamp_min(cos_to_light, 0.0)
                           / torch.clamp_min(light_pick_prob * direct_pdf_w,
                                             1e-30)).detach()
            contrib = (mis_weight * geom_factor)[:, None] \
                * radiance * f * throughput
            ok = connectable & (max3(radiance) > 0.0) & (max3(f) > 0.0)
            shadow.append((dir_l, torch.where(
                ok, torch.maximum(ldist - 2 * eps, eps), 0.0), contrib, ok))

        # vertex connections (vcm.h:315-400, loop :603-616)
        if cfg.vcm_connect_vertices:
            cam_cont = _cont_prob(bsdf, cfg)
            if uniform:
                # n_conn uniformly picked vertices of the whole store
                for _ in range(n_conn):
                    u = skey.next1()
                    vi = torch.minimum(
                        (u * n_valid.to(torch.float32)).to(torch.int32),
                        torch.clamp_min(n_valid - 1, 0))
                    lv = flat.map(lambda a: a[compact[vi.long()]])
                    lv_bsdf = _rebuild_bsdf(scene, lv.mat, lv.ns, lv.ng,
                                            lv.wo)
                    shadow.append(_connect_vertices(
                        bsdf, cam_cont, hit.position, throughput,
                        dVCM, dVC, lv_bsdf, _cont_prob(lv_bsdf, cfg),
                        lv.position, lv.throughput, lv.dVCM, lv.dVC,
                        connectable & lv.valid & (n_valid > 0), mis_vm_w,
                        eps, inv_vert_pick_pdf=inv_pick))
            else:
                for v in range(store_p.valid.shape[1]):
                    shadow.append(_connect_vertices(
                        bsdf, cam_cont, hit.position, throughput,
                        dVCM, dVC, _map_bsdf(lv_bsdf_p, lambda a: a[:, v]),
                        lv_cont_p[:, v], store_p.position[:, v],
                        store_p.throughput[:, v], store_p.dVCM[:, v],
                        store_p.dVC[:, v], connectable & store_p.valid[:, v],
                        mis_vm_w, eps))
        if shadow:
            color = _add_unoccluded(scene, color, hit.position, tmin, shadow)

        # vertex merging (tech report sec. 5; SmallVCM merge)
        if cfg.vcm_use_vm:
            u_merge = skey.next1()
            with pass_scope("vcm_merge") as out:
                color = color + out(_merge_vertices(
                    scene, cfg, bsdf, hit.position, throughput, dVCM, dVM,
                    connectable, vgrid, radius_sq, mis_vc_w, n_light_paths,
                    u_merge, depth1, mesh=mesh))

        # terminate if the path is too long, else scatter
        can_continue = live2 & (depth1 < cfg.vcm_max_path_length)
        o, d, throughput, dVCM, dVC, dVM, alive = _sample_scattering(
            skey, bsdf, hit.position, throughput, dVCM, dVC, dVM,
            can_continue, mis_vc_w, mis_vm_w, adjoint=False,
            force_cont_prob=cfg.vcm_force_continuation_prob)
    return color


def _connect_vertices(cam_bsdf, cam_cont, cam_hit, cam_thr, cam_dVCM,
                      cam_dVC, lv_bsdf, lv_cont, lv_pos, lv_thr, lv_dVCM,
                      lv_dVC, active, mis_vm_w, eps, inv_vert_pick_pdf=1.0):
    """connectVertices (vcm.h:315-400) up to its shadow ray: (direction,
    tmax, contribution, ok), for :func:`_add_unoccluded`. ``cam_cont``/
    ``lv_cont`` are the two BSDFs' continuation probs (:func:`_cont_prob`),
    which the caller computes once per bounce or store.
    ``inv_vert_pick_pdf`` is 1 for 1:1 pairing and 1/vertexPickPdf under
    uniform vertex sampling (vcm.h:367-371: it scales the contribution and
    the mis_vm_w terms)."""
    direction = lv_pos - cam_hit
    dist2 = dot(direction, direction)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
    direction = direction / dist[:, None]

    cam_f, cam_cos, cam_dir_pdf, cam_rev_pdf = cam_bsdf.f(direction)
    cam_dir_pdf = cam_dir_pdf * cam_cont
    cam_rev_pdf = cam_rev_pdf * cam_cont

    lv_f, lv_cos, lv_dir_pdf, lv_rev_pdf = lv_bsdf.f(-direction)
    lv_dir_pdf = lv_dir_pdf * lv_cont
    lv_rev_pdf = lv_rev_pdf * lv_cont

    geometry = (lv_cos * cam_cos / torch.clamp_min(dist2, 1e-30)).detach()

    cam_dir_pdf_a = pdf_w_to_a(cam_dir_pdf, dist, lv_cos)
    lv_dir_pdf_a = pdf_w_to_a(lv_dir_pdf, dist, cam_cos)

    w_light = torch.clamp_min(cam_dir_pdf_a * (
        mis_vm_w * inv_vert_pick_pdf + lv_dVCM + lv_dVC * lv_rev_pdf), 0.0)
    w_camera = torch.clamp_min(lv_dir_pdf_a * (
        mis_vm_w * inv_vert_pick_pdf + cam_dVCM + cam_dVC * cam_rev_pdf),
        0.0)
    mis_weight = (1.0 / (w_light + 1.0 + w_camera)).detach()

    contrib = (geometry * mis_weight * inv_vert_pick_pdf)[:, None] \
        * cam_f * lv_f * cam_thr * lv_thr

    ok = (active & (geometry > 0.0) & (max3(cam_f) > 0.0)
          & (max3(lv_f) > 0.0))
    # not-ok lanes trace an empty interval
    return (direction, torch.where(ok, torch.maximum(dist - 2 * eps, eps),
                                   0.0), contrib, ok)


def _add_unoccluded(scene, color, origin, tmin, terms):
    """``color`` plus each term's contribution where its shadow ray is not
    occluded. ``terms`` are (direction, tmax, contribution, ok), their rays
    all from ``origin`` at ``tmin``; every ray is traced in one batch of
    ``len(terms)`` x N lanes (one any-hit launch a camera bounce, where a
    call per technique made 1 + L - 1 of them), and the contributions are
    added in the terms' order, the order of the per-technique sums."""
    n = origin.shape[0]
    occ = occluded(scene, origin.repeat(len(terms), 1),
                   torch.cat([t[0] for t in terms]),
                   tmin.repeat(len(terms)),
                   torch.cat([t[1] for t in terms])).reshape(len(terms), n)
    for blocked, (_, _, contrib, ok) in zip(occ, terms):
        color = color + torch.where((ok & ~blocked)[:, None], contrib, 0.0)
    return color


# ---------------------------------------------------------------------------
# full iteration
# ---------------------------------------------------------------------------

def mis_factors(cfg: RenderConfig, radius_sq: Tensor):
    """Host-side MIS factors (OptixRenderer.cpp:675-696), float32: etaVCM =
    (nVM / nVC) pi r^2 with nVM = n_light_paths and nVC = 1 under 1:1
    pairing, n_light_paths under uniform vertex sampling (:679). Returns
    (mis_vm_w, mis_vc_w), each 0 where its technique is off."""
    n_light_paths = cfg.width * cfg.height
    n_vc = n_light_paths if cfg.vcm_uniform_vertex_sampling else 1
    eta_vcm = (float(n_light_paths) / n_vc) * torch.pi * radius_sq
    zero = torch.zeros_like(eta_vcm)
    return (eta_vcm if cfg.vcm_use_vm else zero,
            1.0 / eta_vcm if cfg.vcm_use_vc else zero)


def render_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                     iteration, base_key: Key, radius_sq
                     ) -> tuple[Tensor, dict]:
    """One VCM iteration at the squared merge radius ``radius_sq``:
    radiance [H, W, 3] and the stats (light vertices stored, average light
    path vertices). ``iteration`` is an int or a 0-d int64 tensor,
    ``base_key`` a host or a device key, ``radius_sq`` a number or a 0-d
    tensor: the tensor forms draw the same numbers and read nothing from
    the host."""
    dev = scene.device
    eps = scene_epsilon(scene)
    n_light_paths = cfg.width * cfg.height   # light launch = image size
    radius_sq = device_scalar(radius_sq, dev)
    mis_vm_w, mis_vc_w = mis_factors(cfg, radius_sq)

    lkey = iteration_key(base_key, iteration, PASS_VCM_LIGHT)
    ckey = iteration_key(base_key, iteration, PASS_VCM_CAMERA)

    n = cfg.width * cfg.height
    path_lanes = torch.arange(n_light_paths, dtype=torch.int64, device=dev)
    with pass_scope("vcm_light_pass") as out:
        store, splat, lstats = out(trace_light_pass(
            scene, camera, cfg, lkey, eps, mis_vc_w, mis_vm_w, path_lanes,
            n_light_paths))
    vgrid = None
    if cfg.vcm_use_vm:
        with pass_scope("vcm_vertex_grid") as out:
            vgrid = out(build_vertex_grid(scene, cfg, store,
                                          torch.sqrt(radius_sq)))
    px, py = pixel_coords(cfg.width, cfg.height, dev)
    pixel_lanes = torch.arange(n, dtype=torch.int64, device=dev)
    pair = pixel_lanes % n_light_paths
    with pass_scope("vcm_camera_pass") as out:
        color = out(trace_camera_pass(
            scene, camera, cfg, ckey, eps, mis_vc_w, mis_vm_w, store,
            n_light_paths, px, py, pixel_lanes, pair, vgrid=vgrid,
            radius_sq=radius_sq))
    return color.reshape(cfg.height, cfg.width, 3) + splat, lstats
