"""Progressive photon mapping (wavefront).

The counterpart of ``oppositerenderer_tpu/integrators/ppm.py``; the pass
schedule per iteration follows OptixRenderer::renderNextIteration for PPM
(``renderer/OptixRenderer.cpp:569-672``):

1. eye pass: radiance rays walk specular chains and store the first
   non-specular hit of each pixel (``ppm/RayGeneratorPPM.cu``);
2. photon pass: ``cfg.photons_per_iteration`` photons, each depositing at
   most ``cfg.max_photon_deposits_per_emitted`` times at non-specular hits
   from depth 1, Russian roulette from depth 3 (``ppm/PhotonGenerator.cu``,
   ``material/Diffuse.cu:92-131``);
3. photon map build, by ``cfg.photon_map_structure``: the sorted uniform
   grid (``photon_map.build_photon_grid``), the stochastic hash or the
   CPU kd-tree;
4. indirect estimate (``ppm/IndirectRadianceEstimation.cu``): on the grid
   the tile gather (``accel/gather_kernels``, kernel B3 on CUDA) when the
   image splits into 16x16 blocks, the budgeted
   ``photon_map.gather_photons`` otherwise; the hash's 3^3 scan or the
   kd-tree's range query (plain torch: no TPU kernel computes them);
5. direct estimate: shadow samples at the hitpoints; emitter, specular and
   miss pixels pass their stored radiance through
   (``ppm/DirectRadianceEstimation.cu``);
6. in a participating medium, the in-scattered radiance: one point of
   the eye walk's in-medium segments per pixel gathers the volumetric
   photons (``integrators/media.py``).

The JAX package picks its gather by backend; the port takes the tile
gather on every device, so the image does not depend on the device: a
CUDA tensor runs the kernel, a CPU tensor its plain version. Every random
decision draws the JAX package's per-lane streams. The deliberate fixes of
the JAX package against the reference (cosine emission from area lights,
the gather's BRDF kd/pi, no emitter display clamp unless
``reference_faithful``) are kept.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.gather_kernels import (ROWS, TILE, gather_photons_tiled,
                                    tile_block_order_on)
from ..accel.intersect import intersect
from ..bsdf import BSDF
from ..camera import Camera
from ..config import PhotonMapStructure, RenderConfig
from ..core.math import Tensor, dot, luminance
from ..core.profiling import pass_scope
from ..core.rng import Key, LaneSampler, fold_in, fold_in_range, \
    iteration_key
from ..core.sampling import (sample_cone, sample_disc, sample_unit_sphere,
                             sample_unit_hemisphere_cos)
from ..lights import AREA, SPOT
from ..photon_map import (PhotonBatch, PhotonGrid, build_photon_grid,
                          build_photon_kdtree, build_stochastic_hash,
                          gather_kdtree, gather_photons,
                          gather_stochastic_hash, min_cell_size_for_window)
from ..scene.types import Medium, Scene
from .common import (bsdf_at_hit, device_scalar, nee_direct, pixel_coords,
                     scene_epsilon)
from .media import (sample_scatter_distance, segment_overlap, transmittance,
                    volumetric_radiance_estimate)

PASS_PPM_EYE = 1
PASS_PPM_PHOTON = 2
PASS_PPM_ESTIMATE = 3
BIG = 1e30


@dataclasses.dataclass
class HitpointBuffer:
    """Per-pixel first-non-specular-hit record (renderer/Hitpoint.h:9-18,
    plus what rebuilds the BSDF for the estimates).

    The ``vol_*`` fields (zeros without a medium) hold one in-scatter
    sample: a segment of the whole eye walk, picked by a weighted
    reservoir (the reference gathers on every in-medium segment,
    ParticipatingMedium.cu:66-201; one reweighted sample keeps one
    volumetric gather per pixel and stays unbiased)."""

    position: Tensor        # [N,3]
    wo: Tensor              # [N,3] direction back toward the previous vertex
    attenuation: Tensor     # [N,3] specular-chain throughput
    radiance: Tensor        # [N,3] emitter radiance picked up on the walk
    mat: Tensor             # [N] int32 material id at the stored hit
    kd: Tensor              # [N,3] diffuse reflectance
    ns: Tensor              # [N,3] shading normal
    ng: Tensor              # [N,3] geometric normal
    found: Tensor           # [N] bool: stored a non-specular hit
    hit_emitter: Tensor     # [N] bool
    specular_chain: Tensor  # [N] bool: passed >= 1 specular vertex
    vol_point: Tensor       # [N,3] sampled in-medium point
    vol_t: Tensor           # [N] distance into the medium at the sample
    vol_len: Tensor         # [N] in-medium overlap length of the segment
    vol_atten: Tensor       # [N,3] path attenuation up to the segment start
    vol_w: Tensor           # [N] reservoir weight of the selected segment
    vol_wsum: Tensor        # [N] total reservoir weight over the walk


def _norm(a: Tensor) -> Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm computes it."""
    return torch.sqrt(dot(a, a))


# ---------------------------------------------------------------------------
# 1. eye pass
# ---------------------------------------------------------------------------

def trace_eye_pass(scene: Scene, camera: Camera, cfg: RenderConfig,
                   key: Key, eps: Tensor, px: Tensor, py: Tensor,
                   lane_ids: Tensor) -> HitpointBuffer:
    """Walk each pixel's specular chain to its first non-specular hit
    (RayGeneratorPPM.cu; Diffuse.cu:71-88, Mirror.cu:52-64,
    Glass.cu:90-140), for at most ``cfg.max_radiance_trace_depth``
    segments. In a medium, every segment outside a dielectric is
    attenuated by its transmittance and offered to the in-scatter
    reservoir; that draws two uniforms a step before the BSDF's, as the
    JAX package does, and none without a medium."""
    n = px.shape[0]
    dev = px.device
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    o, d = camera.generate_rays(px, py, s.next2(), cfg.width, cfg.height,
                                dof_u=s.next2())

    def zeros3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def zeros1():
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def no():
        return torch.zeros((n,), dtype=torch.bool, device=dev)

    hp = HitpointBuffer(
        position=zeros3(), wo=zeros3(),
        attenuation=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=zeros3(),
        mat=torch.zeros((n,), dtype=torch.int32, device=dev), kd=zeros3(),
        ns=zeros3(), ng=zeros3(), found=no(), hit_emitter=no(),
        specular_chain=no(), vol_point=zeros3(), vol_t=zeros1(),
        vol_len=zeros1(), vol_atten=zeros3(), vol_w=zeros1(),
        vol_wsum=zeros1())
    walking = torch.ones((n,), dtype=torch.bool, device=dev)
    tmin = torch.full((n,), 1.0, device=dev) * eps
    medium = scene.medium
    # a dielectric's interior skips the medium: the bit flips on every
    # refraction (a side change against the geometric normal), the form
    # of the reference's *_IN_PARTICIPATING_MEDIUM ray types
    # (RayType.h:16-22, Glass.cu:146-160); only a medium reads it
    inside = no()

    depth_keys = fold_in_range(key, 1000, cfg.max_radiance_trace_depth)
    for depth in range(cfg.max_radiance_trace_depth):
        skey = LaneSampler(depth_keys[depth], lane_ids,
                           cheap=cfg.use_cheap_random)
        # dead lanes trace an EMPTY interval (tmax 0 < tmin)
        hit = intersect(scene, o, d, tmin, torch.where(walking, BIG, 0.0))
        live = walking & hit.hit
        bsdf, is_emitter, emitter_rad = bsdf_at_hit(scene, hit, d)
        is_spec = bsdf.is_specular() & ~is_emitter

        if medium is not None:
            # transmittance over the segment's in-medium part
            # (ParticipatingMedium.cu:66-93); the reservoir weighs a
            # segment by its in-medium length times the luminance of the
            # attenuation before it and takes it with probability
            # w / wsum, so render_iteration reweights by wsum / w
            t_seg = torch.where(hit.hit, hit.t, 0.0)
            t_enter, overlap = segment_overlap(medium, o, d, t_seg)
            in_medium = walking & ~inside
            overlap = torch.where(in_medium, overlap, 0.0)
            tr = transmittance(medium, overlap)
            atten_before = hp.attenuation
            hp.attenuation = torch.where(walking[:, None],
                                         hp.attenuation * tr[:, None],
                                         hp.attenuation)
            w_seg = overlap * torch.clamp_min(luminance(atten_before), 0.0)
            wsum_new = hp.vol_wsum + w_seg
            take = in_medium & (w_seg > 0.0) & (
                skey.next1() * wsum_new < w_seg)
            t_v = skey.next1() * overlap
            sel_v = take[:, None]
            hp.vol_point = torch.where(sel_v, o + (t_enter + t_v)[:, None] * d,
                                       hp.vol_point)
            hp.vol_t = torch.where(take, t_v, hp.vol_t)
            hp.vol_len = torch.where(take, overlap, hp.vol_len)
            hp.vol_atten = torch.where(sel_v, atten_before, hp.vol_atten)
            hp.vol_w = torch.where(take, w_seg, hp.vol_w)
            hp.vol_wsum = wsum_new

        # emitter: pick up radiance, stop (DiffuseEmitter.cu:40-52)
        em = live & is_emitter
        hp.radiance = hp.radiance + torch.where(
            em[:, None], hp.attenuation * emitter_rad, 0.0)
        hp.hit_emitter = hp.hit_emitter | em

        # non-specular: store the hitpoint, stop (Diffuse.cu:71-88)
        store = live & ~is_emitter & ~is_spec
        sel = store[:, None]
        hp.position = torch.where(sel, hit.position, hp.position)
        hp.wo = torch.where(sel, -d, hp.wo)
        hp.mat = torch.where(store, hit.mat, hp.mat)
        hp.kd = torch.where(sel, bsdf.kd, hp.kd)
        hp.ns = torch.where(sel, bsdf.frame.n, hp.ns)
        hp.ng = torch.where(sel, bsdf.ng, hp.ng)
        hp.found = hp.found | store

        # specular: continue the walk (Mirror.cu:52-64, Glass.cu:90-140)
        cont = live & is_spec
        res = bsdf.sample(skey.next3())
        w = res.f * (res.cos_theta
                     / torch.clamp_min(res.pdf_w, 1e-20))[:, None]
        hp.attenuation = torch.where((cont & res.valid)[:, None],
                                     hp.attenuation * w, hp.attenuation)
        hp.specular_chain = hp.specular_chain | cont
        if medium is not None:
            inside = inside ^ (cont & res.valid & (
                dot(bsdf.ng, res.world_dir) * dot(bsdf.ng, -d) < 0.0))
        o = torch.where(cont[:, None], hit.position, o)
        d = torch.where(cont[:, None], res.world_dir, d)
        walking = cont & res.valid
    return hp


# ---------------------------------------------------------------------------
# 2. photon pass
# ---------------------------------------------------------------------------

def emit_photons(scene: Scene, s: LaneSampler
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """PhotonGenerator.cu:41-129: (origin, direction, power [N,3]).

    Area lights: a uniform point, a cosine-distributed direction. Point
    lights: the whole sphere, or, more than 1.5 bounding radii from the
    scene, a disc toward the scene's bounding sphere with the solid-angle
    power factor (PhotonGenerator.cu:53-71). Spot lights: the cone."""
    n_lights = scene.lights.n_lights
    center, radius = scene.bounding_sphere
    li = torch.clamp_max((s.next1() * n_lights).to(torch.int64),
                         n_lights - 1)
    lt = scene.lights.row(li)
    power = lt.power * n_lights  # light-pick pdf compensation

    u_pos = s.next2()
    u_dir = s.next2()

    pos_area = lt.position + u_pos[:, 0:1] * lt.v1 + u_pos[:, 1:2] * lt.v2
    dir_area, _, _ = sample_unit_hemisphere_cos(lt.normal, u_dir,
                                                bias_small_cosine=True)

    to_light = lt.position - center
    dist_l = _norm(to_light)
    to_light_n = to_light / torch.clamp_min(dist_l, 1e-20)[:, None]
    well_outside = dist_l > 1.5 * radius
    disc_pt = sample_disc(u_pos, torch.broadcast_to(center, to_light.shape),
                          torch.broadcast_to(radius, dist_l.shape),
                          -to_light_n)
    dir_disc = disc_pt - lt.position
    dir_disc = dir_disc / torch.clamp_min(_norm(dir_disc), 1e-20)[:, None]
    solid_factor = (1.0 - dist_l * torch.rsqrt(radius * radius
                                               + dist_l * dist_l)) / 2.0
    dir_sphere, _ = sample_unit_sphere(u_dir)
    dir_point = torch.where(well_outside[:, None], dir_disc, dir_sphere)
    factor_point = torch.where(well_outside, solid_factor, 1.0)

    dir_spot, _ = sample_cone(u_dir, lt.angle, lt.normal)

    is_area = lt.kind == AREA
    is_spot = lt.kind == SPOT
    origin = torch.where(is_area[:, None], pos_area, lt.position)
    direction = torch.where(is_area[:, None], dir_area,
                            torch.where(is_spot[:, None], dir_spot,
                                        dir_point))
    power = power * torch.where(is_area | is_spot, 1.0,
                                factor_point)[:, None]
    return origin, direction, power


def _photon_batch(rows: dict) -> PhotonBatch:
    return PhotonBatch(position=torch.cat(rows["pos"]),
                       power=torch.cat(rows["pow"]),
                       direction=torch.cat(rows["dir"]),
                       valid=torch.cat(rows["valid"]))


def trace_photon_pass(scene: Scene, cfg: RenderConfig, key: Key,
                      eps: Tensor, lane_ids: Tensor
                      ) -> tuple[PhotonBatch, PhotonBatch | None, dict]:
    """Trace ``lane_ids.shape[0]`` photon paths (``lane_ids`` are global
    photon indices): (surface photons, volumetric photons or None without
    a medium, stats). Deposit rows come out depth-major, row
    ``depth * n + lane``, as the JAX package's stacked per-bounce scan
    outputs: that order goes into the grid's stable sort. Capacity is
    ``n * max_photon_trace_depth`` rows; the per-path deposit budgets
    (config.h:23-27; ``cfg.media_max_deposits_per_photon`` in the medium)
    mask the rest.

    In a medium, a photon outside a dielectric samples a free-flight
    distance; if it falls before the surface, the photon scatters there
    (ParticipatingMedium.cu:110-201): it deposits a volumetric photon with
    its power before the albedo, takes the albedo and an isotropic new
    direction, and skips the surface. That draws one uniform before the
    BSDF's and two after them a step, as the JAX package does, and none
    without a medium."""
    n = lane_ids.shape[0]
    dev = lane_ids.device
    max_dep = cfg.max_photon_deposits_per_emitted
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    o, d, power = emit_photons(scene, s)

    stored = torch.zeros((n,), dtype=torch.int32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    path_len = torch.zeros((n,), dtype=torch.int32, device=dev)
    tmin = torch.full((n,), 1.0, device=dev) * eps
    rows = {"pos": [], "pow": [], "dir": [], "valid": []}
    medium = scene.medium
    if medium is not None:
        vmax = cfg.media_max_deposits_per_photon
        vol_stored = torch.zeros((n,), dtype=torch.int32, device=dev)
        vol_rows = {"pos": [], "pow": [], "dir": [], "valid": []}
        albedo = medium.sigma_s / torch.clamp_min(medium.sigma_t, 1e-12)
        # the dielectric-interior bit (trace_eye_pass)
        inside = torch.zeros((n,), dtype=torch.bool, device=dev)

    depth_keys = fold_in_range(key, 2000, cfg.max_photon_trace_depth)
    for depth in range(cfg.max_photon_trace_depth):
        skey = LaneSampler(depth_keys[depth], lane_ids,
                           cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, tmin, torch.where(alive, BIG, 0.0))
        bsdf, is_emitter, _ = bsdf_at_hit(scene, hit, d)
        live = alive & hit.hit & ~is_emitter  # emitters absorb
        is_spec = bsdf.is_specular()

        if medium is not None:
            t_enter, overlap = segment_overlap(
                medium, o, d, torch.where(hit.hit, hit.t, BIG))
            delta, _ = sample_scatter_distance(medium, skey.next1())
            scatter = alive & ~inside & (delta < overlap)
            sp = o + (t_enter + delta)[:, None] * d
            vdep = scatter & (vol_stored < vmax)
            for k, v in (("pos", sp), ("pow", power), ("dir", d),
                         ("valid", vdep)):
                vol_rows[k].append(v)
            vol_stored = vol_stored + vdep.to(torch.int32)
            power = torch.where(scatter[:, None], power * albedo, power)
            new_dir, _ = sample_unit_sphere(skey.next2())
            live = live & ~scatter   # scattered lanes skip the surface

        # deposit at non-specular hits from depth 1 (Diffuse.cu:98-103)
        deposit = live & ~is_spec & (depth >= 1) & (stored < max_dep)
        for k, v in (("pos", hit.position), ("pow", power), ("dir", d),
                     ("valid", deposit)):
            rows[k].append(v)
        stored = stored + deposit.to(torch.int32)

        # full-capacity paths stop (Diffuse.cu:124-127)
        live = live & (stored < max_dep)

        # bounce: adjoint BSDF sample; for diffuse this is power *= Kd
        res = bsdf.sample(skey.next3(), adjoint=True)
        w = res.f * (res.cos_theta
                     / torch.clamp_min(res.pdf_w, 1e-20))[:, None]
        power = torch.where((live & res.valid)[:, None], power * w, power)
        live = live & res.valid

        # Russian roulette from depth 3 (Diffuse.cu:107-117)
        if depth >= cfg.photon_rr_start_depth:
            p_cont = bsdf.continuation_prob()
        else:
            p_cont = torch.ones((n,), dtype=torch.float32, device=dev)
        survive = skey.next1() < p_cont
        power = torch.where(
            (live & survive)[:, None],
            power / torch.clamp_min(p_cont, 1e-20)[:, None], power)
        live = live & survive

        if medium is not None:
            inside = inside ^ (live & (dot(bsdf.ng, res.world_dir)
                                       * dot(bsdf.ng, -d) < 0.0))
        o = torch.where(live[:, None], hit.position, o)
        d = torch.where(live[:, None], res.world_dir, d)
        alive = live
        if medium is not None:
            o = torch.where(scatter[:, None], sp, o)
            d = torch.where(scatter[:, None], new_dir, d)
            alive = live | scatter
        path_len = path_len + alive.to(torch.int32)

    stats = dict(photons_stored=torch.sum(stored),
                 avg_photon_path_length=torch.mean(
                     path_len.to(torch.float32)))
    vol_photons = None
    if medium is not None:
        vol_photons = _photon_batch(vol_rows)
        stats["volumetric_photons_stored"] = torch.sum(vol_stored)
    return _photon_batch(rows), vol_photons, stats


# ---------------------------------------------------------------------------
# full iteration
# ---------------------------------------------------------------------------

def _volumetric(medium: Medium, cfg: RenderConfig, hp: HitpointBuffer,
                vol_photons: PhotonBatch, radius: Tensor, est_key: Key,
                pixel_lanes: Tensor) -> Tensor:
    """The in-scattered radiance [N,3] at each pixel's reservoir-picked
    eye segment. The volume density needs a wider support: the budgeted
    gather at 3r without the normal test, on every device, as in the JAX
    package (no tile kernel computes it)."""
    vol_radius = radius * 3.0
    vgrid = build_photon_grid(
        vol_photons, cfg.photon_grid_resolution,
        min_cell_size=min_cell_size_for_window(vol_radius, 4))
    s_vg = LaneSampler(fold_in(est_key, 56), pixel_lanes,
                       cheap=cfg.use_cheap_random)
    vpow, _ = gather_photons(vgrid, hp.vol_point, hp.ns, vol_radius,
                             max_cells_per_axis=4,
                             budget_total=cfg.gather_photon_budget,
                             check_normal=False, u_stride=s_vg.next1())
    return volumetric_estimate(medium, cfg, hp, vpow, radius)


def volumetric_estimate(medium: Medium, cfg: RenderConfig,
                        hp: HitpointBuffer, vpow: Tensor,
                        radius: Tensor) -> Tensor:
    """The in-scattered radiance [N,3] from the volume gather's power
    ``vpow`` (at 3 ``radius``), reweighted by the inverse probability of
    the reservoir's pick."""
    sel_ok = hp.vol_w > 0.0
    inv_pick = torch.where(
        sel_ok, hp.vol_wsum / torch.clamp_min(hp.vol_w, 1e-30), 0.0)
    volumetric = volumetric_radiance_estimate(
        medium, vpow, radius * 3.0, hp.vol_len, hp.vol_t,
        cfg.photons_per_iteration, weight=hp.vol_atten * inv_pick[:, None])
    return torch.where(sel_ok[:, None], volumetric, 0.0)


def grid_gather(cfg: RenderConfig, hp: HitpointBuffer, photons: PhotonBatch,
                radius: Tensor, est_key: Key, pixel_lanes: Tensor):
    """The sorted grid's build and its gather (:func:`gather_on_grid`).
    Returns (power [N,3], per-query stats)."""
    with pass_scope("ppm_grid_build") as out:
        grid = out(build_photon_grid(
            photons, cfg.photon_grid_resolution,
            min_cell_size=min_cell_size_for_window(radius, 4)))
    return gather_on_grid(cfg, hp, grid, radius, est_key, pixel_lanes)


def gather_on_grid(cfg: RenderConfig, hp: HitpointBuffer, grid: PhotonGrid,
                   radius: Tensor, est_key: Key, pixel_lanes: Tensor):
    """The gather on a built grid: the tile gather when the image splits
    into 16x16 blocks (``hp`` then holds the whole image's hitpoints), the
    budgeted gather otherwise. Reads ``hp.position``, ``ns`` and
    ``found``. Returns (power [N,3], per-query stats)."""
    W, H = cfg.width, cfg.height
    n = W * H
    dev = radius.device
    s_gather = LaneSampler(fold_in(est_key, 55), pixel_lanes,
                           cheap=cfg.use_cheap_random)
    with pass_scope("ppm_indirect_gather") as out:
        if W % 16 == 0 and H % 16 == 0:
            perm, inv = tile_block_order_on(W, H, dev)
            u_rows = s_gather.next1().reshape(n // TILE, TILE)[:, :ROWS + 2]
            acc_b, stats = gather_photons_tiled(
                grid, hp.position[perm], hp.ns[perm], radius,
                u_rows=u_rows, valid=hp.found[perm])
            return out((acc_b[inv], stats))
        return out(gather_photons(
            grid, hp.position, hp.ns, radius, max_cells_per_axis=4,
            budget_total=cfg.gather_photon_budget,
            u_stride=s_gather.next1()))


def render_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                     iteration, base_key: Key, radius_sq
                     ) -> tuple[Tensor, dict]:
    """One PPM iteration at the squared gather radius ``radius_sq``:
    radiance [H, W, 3] and the stats dict (photons stored, average photon
    path length, the surface gather's counts: photons visited and
    subsampled on the grid, photons visited and lanes cut short
    (``kd_overrun``) on the kd-tree, none on the hash; in a medium the
    volumetric photons stored). ``iteration`` is an int or a 0-d int64
    tensor, ``base_key`` a host or a device key, ``radius_sq`` a number or
    a 0-d tensor: the tensor forms draw the same numbers and read nothing
    from the host, but for the kd-tree's eager gather, whose live-lane
    checks its captured form leaves out (``photon_map.gather_kdtree``)."""
    W, H = cfg.width, cfg.height
    n = W * H
    dev = scene.device
    eps = scene_epsilon(scene)
    radius_sq = device_scalar(radius_sq, dev)
    radius = torch.sqrt(radius_sq)

    eye_key = iteration_key(base_key, iteration, PASS_PPM_EYE)
    photon_key = iteration_key(base_key, iteration, PASS_PPM_PHOTON)
    est_key = iteration_key(base_key, iteration, PASS_PPM_ESTIMATE)

    px, py = pixel_coords(W, H, dev)
    pixel_lanes = torch.arange(n, dtype=torch.int64, device=dev)
    with pass_scope("ppm_eye_pass") as out:
        hp = out(trace_eye_pass(scene, camera, cfg, eye_key, eps, px, py,
                                pixel_lanes))

    photon_lanes = torch.arange(cfg.photons_per_iteration,
                                dtype=torch.int64, device=dev)
    with pass_scope("ppm_photon_pass") as out:
        photons, vol_photons, photon_stats = out(trace_photon_pass(
            scene, cfg, photon_key, eps, photon_lanes))

    structure = cfg.photon_map_structure
    if structure == PhotonMapStructure.SORTED_UNIFORM_GRID:
        accum_power, gather_stats = grid_gather(cfg, hp, photons, radius,
                                                est_key, pixel_lanes)
    elif structure == PhotonMapStructure.KD_TREE_CPU:
        with pass_scope("ppm_kdtree_build") as out:
            tree = out(build_photon_kdtree(photons))
        with pass_scope("ppm_indirect_gather") as out:
            accum_power, gather_stats = out(gather_kdtree(
                tree, hp.position, hp.ns, radius))
    else:
        with pass_scope("ppm_hash_build") as out:
            table = out(build_stochastic_hash(
                photons, radius, cfg.stochastic_hash_size_log2,
                fold_in(photon_key, 77)))
        with pass_scope("ppm_indirect_gather") as out:
            accum_power, gather_stats = out(gather_stochastic_hash(
                table, hp.position, hp.ns, radius))

    radiance = shade(scene, cfg, hp, accum_power, radius_sq, est_key,
                     pixel_lanes, eps)
    if scene.medium is not None:
        with pass_scope("ppm_volume_gather") as out:
            radiance = radiance + out(_volumetric(
                scene.medium, cfg, hp, vol_photons, radius, est_key,
                pixel_lanes))
    radiance = radiance.reshape(H, W, 3)
    stats = dict(**photon_stats,
                 **{k: torch.sum(v) for k, v in gather_stats.items()})
    return radiance, stats


def shade(scene: Scene, cfg: RenderConfig, hp: HitpointBuffer,
          accum_power: Tensor, radius_sq: Tensor, est_key: Key,
          pixel_lanes: Tensor, eps: Tensor) -> Tensor:
    """A pixel's radiance [N,3] without the medium: the indirect estimate
    from the gathered photon power, the direct estimate at the hitpoint,
    and the emitter, specular and miss pixels' stored radiance."""
    brdf = hp.kd / torch.pi  # the reference uses kd (module docstring)
    indirect = (accum_power * brdf * hp.attenuation
                / (torch.pi * radius_sq * cfg.photons_per_iteration))
    indirect = torch.where(hp.found[:, None], indirect, 0.0)

    # direct estimate at the hitpoints (DirectRadianceEstimation.cu:29-77)
    _, ks_l, exp_l, kr_l, kt_l, ior_l, diel_l = \
        scene.materials.bsdf_coefficients(hp.mat.long())
    hp_bsdf = BSDF.make(hp.ns, hp.ng, hp.wo, hp.kd, ks_l, exp_l, kr_l,
                        kt_l, ior_l, diel_l)
    s_est = LaneSampler(est_key, pixel_lanes, cheap=cfg.use_cheap_random)
    with pass_scope("ppm_direct_estimation") as out:
        direct = out(nee_direct(scene, hp_bsdf, hp.position, hp.found, s_est,
                                cfg.ppm_direct_shadow_samples, eps,
                                reference_faithful=cfg.reference_faithful))
    direct = torch.where(hp.found[:, None], hp.attenuation * direct, 0.0)
    # emitter/specular/miss pixels pass their stored radiance through; the
    # reference clamps it to <= 1 (DirectRadianceEstimation.cu:38), only
    # in reference_faithful mode here
    passthrough = (torch.clamp_max(hp.radiance, 1.0)
                   if cfg.reference_faithful else hp.radiance)
    return direct + indirect + passthrough
