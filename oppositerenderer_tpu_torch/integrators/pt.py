"""Unidirectional path tracer (wavefront).

The counterpart of ``oppositerenderer_tpu/integrators/pt.py``; the
estimator follows the reference PT kernel (``pt/RayGeneratorPT.cu:46-134``):
a jittered camera ray per pixel (+ DoF), a bounded bounce loop with NEE
shadow samples, emitters counted only on primary hits or through
specular chains, and Russian roulette from ``path_rr_start_depth`` with
continuation probability = max component of the throughput. The bounce
loop is a Python loop over the full wavefront; every random decision
draws the JAX package's per-lane counter-based streams, so the two
packages trace the same paths for the same seed.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..accel.intersect import intersect
from ..camera import Camera
from ..config import RenderConfig
from ..core.math import Tensor, max3
from ..core.profiling import pass_scope
from ..core.rng import Key, LaneSampler, fold_in_range, iteration_key, \
    lane_key_words
from ..scene.types import Scene
from .common import bsdf_at_hit, nee_direct, pixel_coords, scene_epsilon

PASS_PT = 0
BIG = 1e30


def render_lanes(scene: Scene, camera: Camera, cfg: RenderConfig,
                 iteration: int | Tensor | Sequence[int], base_key: Key,
                 px: Tensor, py: Tensor, lane_ids: Tensor) -> Tensor:
    """PT radiance [n, 3] for arbitrary pixel lanes (the tile-shardable
    unit). ``lane_ids`` are GLOBAL lane indices, which select the RNG
    streams.

    ``iteration`` is one iteration number (an int, or a 0-d int64 tensor
    with which, or with a device ``base_key``, every key is derived on
    the device: the same streams, no host read), or G numbers: then the
    lanes are G equal stacked groups and group g draws the streams of
    ``iteration[g]``, bit-identical to rendering the groups separately.
    """
    n = px.shape[0]
    device = px.device
    eps = scene_epsilon(scene)
    its = (list(iteration) if isinstance(iteration, (list, tuple))
           else [iteration])
    if n % len(its):
        raise ValueError(f"{n} lanes do not split into {len(its)} groups")
    keys = [iteration_key(base_key, it, PASS_PT) for it in its]
    # per group, the key of each bounce
    depth_keys = [fold_in_range(k, 1, cfg.pt_max_segments) for k in keys]

    def words(ks: list[Key]):
        return ks[0] if len(ks) == 1 else lane_key_words(
            ks, n // len(ks), device)

    def sampler(ks: list[Key]) -> LaneSampler:
        return LaneSampler(words(ks), lane_ids, cheap=cfg.use_cheap_random)

    s = sampler(keys)
    o, d = camera.generate_rays(px, py, s.next2(), cfg.width, cfg.height,
                                dof_u=s.next2())

    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    active = torch.ones((n,), dtype=torch.bool, device=device)
    count_emitter = torch.ones((n,), dtype=torch.bool, device=device)
    tmin = torch.full((n,), 1.0, device=device) * eps

    for depth in range(cfg.pt_max_segments):
        skey = sampler([dk[depth] for dk in depth_keys])
        # dead lanes trace an EMPTY interval (tmax 0 < tmin)
        hit = intersect(scene, o, d, tmin, torch.where(active, BIG, 0.0))
        active = active & hit.hit

        bsdf, is_emitter, emitter_rad = bsdf_at_hit(scene, hit, d)

        # --- emitter hit: count if primary/specular chain, then stop ------
        count = active & is_emitter & count_emitter
        radiance = radiance + torch.where(count[:, None],
                                          throughput * emitter_rad, 0.0)
        active = active & ~is_emitter

        # --- NEE: shadow samples to uniformly picked lights ---------------
        if cfg.pt_direct_light_sampling and cfg.pt_shadow_samples > 0:
            direct = nee_direct(scene, bsdf, hit.position, active, skey,
                                cfg.pt_shadow_samples, eps,
                                reference_faithful=cfg.reference_faithful)
            radiance = radiance + throughput * direct

        # --- sample the continuation direction ----------------------------
        res = bsdf.sample(skey.next3())
        weight = res.f * (res.cos_theta
                          / torch.clamp_min(res.pdf_w, 1e-20))[:, None]
        throughput = throughput * torch.where(res.valid[:, None], weight, 0.0)
        active = active & res.valid

        # --- Russian roulette (RayGeneratorPT.cu:108-117) ------------------
        if depth >= cfg.path_rr_start_depth:
            p_cont = torch.clamp(max3(throughput), 0.0, 1.0).detach()
        else:
            p_cont = torch.ones((n,), dtype=torch.float32, device=device)
        survive = skey.next1() < p_cont
        throughput = throughput / torch.clamp_min(p_cont, 1e-20)[:, None]
        active = active & survive

        o, d, count_emitter = hit.position, res.world_dir, res.is_specular
    return radiance


def render_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                     iteration, base_key: Key) -> Tensor:
    """One full-frame PT iteration -> radiance [H, W, 3]. ``iteration`` is
    an int or a 0-d int64 tensor, ``base_key`` a host or a device key."""
    W, H = cfg.width, cfg.height
    device = scene.device
    px, py = pixel_coords(W, H, device)
    lane_ids = torch.arange(W * H, dtype=torch.int64, device=device)
    with pass_scope("pt_raytrace_pass") as out:
        radiance = out(render_lanes(scene, camera, cfg, iteration, base_key,
                                    px, py, lane_ids))
    return radiance.reshape(H, W, 3)
