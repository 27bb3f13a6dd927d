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
3. grid build: the sorted uniform grid (``photon_map.build_photon_grid``);
4. indirect estimate: the tile gather (``accel/gather_kernels``, kernel B3
   on CUDA) when the image splits into 16x16 blocks, the budgeted
   ``photon_map.gather_photons`` otherwise
   (``ppm/IndirectRadianceEstimation.cu``);
5. direct estimate: shadow samples at the hitpoints; emitter, specular and
   miss pixels pass their stored radiance through
   (``ppm/DirectRadianceEstimation.cu``).

The JAX package picks its gather by backend; the port takes the tile
gather on every device, so the image does not depend on the device: a
CUDA tensor runs the kernel, a CPU tensor its plain version. Every random
decision draws the JAX package's per-lane streams. The deliberate fixes of
the JAX package against the reference (cosine emission from area lights,
the gather's BRDF kd/pi, no emitter display clamp unless
``reference_faithful``) are kept. Participating media, the stochastic hash
and the CPU kd-tree arrive with later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.gather_kernels import (ROWS, TILE, gather_photons_tiled,
                                    tile_block_order)
from ..accel.intersect import intersect
from ..bsdf import BSDF
from ..camera import Camera
from ..config import PhotonMapStructure, RenderConfig
from ..core.math import Tensor, dot
from ..core.rng import Key, LaneSampler, fold_in, iteration_key
from ..core.sampling import (sample_cone, sample_disc, sample_unit_sphere,
                             sample_unit_hemisphere_cos)
from ..lights import AREA, SPOT
from ..photon_map import (PhotonBatch, build_photon_grid, gather_photons,
                          min_cell_size_for_window)
from ..scene.types import Scene
from .common import bsdf_at_hit, nee_direct, pixel_coords, scene_epsilon

PASS_PPM_EYE = 1
PASS_PPM_PHOTON = 2
PASS_PPM_ESTIMATE = 3
BIG = 1e30


@dataclasses.dataclass
class HitpointBuffer:
    """Per-pixel first-non-specular-hit record (renderer/Hitpoint.h:9-18,
    plus what rebuilds the BSDF for the estimates). The JAX record's
    in-medium sample fields belong to the media slice."""

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


def _require_surface_only(scene: Scene) -> None:
    if scene.medium is not None:
        raise NotImplementedError(
            "PPM in participating media arrives with the media slice of "
            "the port")


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
    segments."""
    _require_surface_only(scene)
    n = px.shape[0]
    dev = px.device
    s = LaneSampler(key, lane_ids, cheap=cfg.use_cheap_random)
    o, d = camera.generate_rays(px, py, s.next2(), cfg.width, cfg.height,
                                dof_u=s.next2())

    def zeros3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def no():
        return torch.zeros((n,), dtype=torch.bool, device=dev)

    hp = HitpointBuffer(
        position=zeros3(), wo=zeros3(),
        attenuation=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=zeros3(),
        mat=torch.zeros((n,), dtype=torch.int32, device=dev), kd=zeros3(),
        ns=zeros3(), ng=zeros3(), found=no(), hit_emitter=no(),
        specular_chain=no())
    walking = torch.ones((n,), dtype=torch.bool, device=dev)
    tmin = torch.full((n,), 1.0, device=dev) * eps

    for depth in range(cfg.max_radiance_trace_depth):
        skey = LaneSampler(fold_in(key, 1000 + depth), lane_ids,
                           cheap=cfg.use_cheap_random)
        # dead lanes trace an EMPTY interval (tmax 0 < tmin)
        hit = intersect(scene, o, d, tmin, torch.where(walking, BIG, 0.0))
        live = walking & hit.hit
        bsdf, is_emitter, emitter_rad = bsdf_at_hit(scene, hit, d)
        is_spec = bsdf.is_specular() & ~is_emitter

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


def trace_photon_pass(scene: Scene, cfg: RenderConfig, key: Key,
                      eps: Tensor, lane_ids: Tensor
                      ) -> tuple[PhotonBatch, dict]:
    """Trace ``lane_ids.shape[0]`` photon paths (``lane_ids`` are global
    photon indices). Deposit rows come out depth-major, row
    ``depth * n + lane``, as the JAX package's stacked per-bounce scan
    outputs: that order goes into the grid's stable sort. Capacity is
    ``n * max_photon_trace_depth`` rows; the per-path deposit budget
    (config.h:23-27) masks the rest."""
    _require_surface_only(scene)
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

    for depth in range(cfg.max_photon_trace_depth):
        skey = LaneSampler(fold_in(key, 2000 + depth), lane_ids,
                           cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d, tmin, torch.where(alive, BIG, 0.0))
        bsdf, is_emitter, _ = bsdf_at_hit(scene, hit, d)
        live = alive & hit.hit & ~is_emitter  # emitters absorb
        is_spec = bsdf.is_specular()

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

        o = torch.where(live[:, None], hit.position, o)
        d = torch.where(live[:, None], res.world_dir, d)
        alive = live
        path_len = path_len + alive.to(torch.int32)

    photons = PhotonBatch(position=torch.cat(rows["pos"]),
                          power=torch.cat(rows["pow"]),
                          direction=torch.cat(rows["dir"]),
                          valid=torch.cat(rows["valid"]))
    stats = dict(photons_stored=torch.sum(stored),
                 avg_photon_path_length=torch.mean(
                     path_len.to(torch.float32)))
    return photons, stats


# ---------------------------------------------------------------------------
# full iteration
# ---------------------------------------------------------------------------

def render_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                     iteration: int, base_key: Key, radius_sq
                     ) -> tuple[Tensor, dict]:
    """One PPM iteration at the squared gather radius ``radius_sq``:
    radiance [H, W, 3] and the stats dict (photons stored, average photon
    path length, photons visited and subsampled by the gather)."""
    if cfg.photon_map_structure != PhotonMapStructure.SORTED_UNIFORM_GRID:
        raise NotImplementedError(
            f"{cfg.photon_map_structure.name}: the port's PPM builds the "
            "sorted uniform grid; the stochastic hash and the CPU kd-tree "
            "arrive with a later slice")
    W, H = cfg.width, cfg.height
    n = W * H
    dev = scene.device
    eps = scene_epsilon(scene)
    radius_sq = torch.as_tensor(radius_sq, dtype=torch.float32, device=dev)
    radius = torch.sqrt(radius_sq)

    eye_key = iteration_key(base_key, iteration, PASS_PPM_EYE)
    photon_key = iteration_key(base_key, iteration, PASS_PPM_PHOTON)
    est_key = iteration_key(base_key, iteration, PASS_PPM_ESTIMATE)

    px, py = pixel_coords(W, H, dev)
    pixel_lanes = torch.arange(n, dtype=torch.int64, device=dev)
    with torch.profiler.record_function("ppm_eye_pass"):
        hp = trace_eye_pass(scene, camera, cfg, eye_key, eps, px, py,
                            pixel_lanes)

    photon_lanes = torch.arange(cfg.photons_per_iteration,
                                dtype=torch.int64, device=dev)
    with torch.profiler.record_function("ppm_photon_pass"):
        photons, photon_stats = trace_photon_pass(scene, cfg, photon_key,
                                                  eps, photon_lanes)

    with torch.profiler.record_function("ppm_grid_build"):
        grid = build_photon_grid(
            photons, cfg.photon_grid_resolution,
            min_cell_size=min_cell_size_for_window(radius, 4))
    s_gather = LaneSampler(fold_in(est_key, 55), pixel_lanes,
                           cheap=cfg.use_cheap_random)
    with torch.profiler.record_function("ppm_indirect_gather"):
        if W % 16 == 0 and H % 16 == 0:
            perm, inv = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                         for a in tile_block_order(W, H))
            u_rows = s_gather.next1().reshape(n // TILE, TILE)[:, :ROWS + 2]
            acc_b, gather_stats = gather_photons_tiled(
                grid, hp.position[perm], hp.ns[perm], radius,
                u_rows=u_rows, valid=hp.found[perm])
            accum_power = acc_b[inv]
        else:
            accum_power, gather_stats = gather_photons(
                grid, hp.position, hp.ns, radius, max_cells_per_axis=4,
                budget_total=cfg.gather_photon_budget,
                u_stride=s_gather.next1())

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
    with torch.profiler.record_function("ppm_direct_estimation"):
        direct = nee_direct(scene, hp_bsdf, hp.position, hp.found, s_est,
                            cfg.ppm_direct_shadow_samples, eps,
                            reference_faithful=cfg.reference_faithful)
    direct = torch.where(hp.found[:, None], hp.attenuation * direct, 0.0)
    # emitter/specular/miss pixels pass their stored radiance through; the
    # reference clamps it to <= 1 (DirectRadianceEstimation.cu:38), only
    # in reference_faithful mode here
    passthrough = (torch.clamp_max(hp.radiance, 1.0)
                   if cfg.reference_faithful else hp.radiance)

    radiance = (direct + indirect + passthrough).reshape(H, W, 3)
    stats = dict(**photon_stats,
                 **{k: torch.sum(v) for k, v in gather_stats.items()})
    return radiance, stats
