"""Debug observability: per-pixel path traces, non-finite checks, photon
path-length histograms.

The counterpart of ``oppositerenderer_tpu/debug.py``, the reference's
debug machinery:

* :func:`trace_debug_pixel`: the ``OPTIX_PRINTF[I/ID]`` per-debug-pixel
  tracing (``helpers/helpers.h:27-110``): replay the PT walk of one pixel
  with the random stream it gets inside the full render, and return each
  bounce's state (position, material, throughput, pdf, NEE contribution)
  as host values.
* :func:`check_iteration`: one render iteration with every pass's outputs
  checked for NaN and infinity at its ``pass_scope`` boundary (the JAX
  package runs ``checkify``'s NaN checks, which torch has no counterpart
  of; the reference's closest analog is the per-entry-point OptiX
  exception program, OptixRenderer.cpp:156-181).
* :func:`photon_depth_histogram`: the photon path-length histogram of
  ``OptixRenderer::debugOutputPhotonTracing`` (OptixRenderer.cpp:872-953).
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.intersect import intersect
from .camera import Camera
from .config import RenderConfig, RenderMethod
from .core.profiling import nonfinite_check
from .core.rng import LaneSampler, fold_in, iteration_key, make_root_key
from .integrators.common import bsdf_at_hit, nee_direct, scene_epsilon
from .scene.types import Scene


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def trace_debug_pixel(scene: Scene, camera: Camera, cfg: RenderConfig,
                      x: int, y: int, iteration: int = 0, seed_key=None):
    """Replay the PT path of pixel (x, y) and return a list of per-bounce
    dicts. The lane id and the passes' keys are ``integrators.pt``'s, so
    the recorded path is the one the full render computes."""
    from .integrators.pt import BIG, PASS_PT

    if seed_key is None:
        seed_key = make_root_key(0)
    dev = scene.device
    key = iteration_key(seed_key, iteration, PASS_PT)
    lane = torch.tensor([y * cfg.width + x], dtype=torch.int64, device=dev)
    px = torch.tensor([x], dtype=torch.int64, device=dev)
    py = torch.tensor([y], dtype=torch.int64, device=dev)
    eps = scene_epsilon(scene)

    s = LaneSampler(key, lane, cheap=cfg.use_cheap_random)
    o, d = camera.generate_rays(px, py, s.next2(), cfg.width, cfg.height,
                                dof_u=s.next2())
    throughput = torch.ones((1, 3), dtype=torch.float32, device=dev)
    records = []
    for depth in range(cfg.pt_max_segments):
        skey = LaneSampler(fold_in(key, depth + 1), lane,
                           cheap=cfg.use_cheap_random)
        hit = intersect(scene, o, d,
                        torch.full((1,), 1.0, device=dev) * eps,
                        torch.full((1,), BIG, device=dev))
        bsdf, is_emitter, emitter_rad = bsdf_at_hit(scene, hit, d)
        rec = dict(depth=depth,
                   origin=_host(o[0]), direction=_host(d[0]),
                   hit=bool(hit.hit[0]), t=float(hit.t[0]),
                   position=_host(hit.position[0]),
                   material=int(hit.mat[0]),
                   normal=_host(hit.ns[0]),
                   is_emitter=bool(is_emitter[0]),
                   emitter_radiance=_host(emitter_rad[0]),
                   throughput=_host(throughput[0]),
                   is_specular=bool(bsdf.is_specular()[0]))
        if not rec["hit"] or rec["is_emitter"]:
            records.append(rec)
            break
        if cfg.pt_direct_light_sampling and cfg.pt_shadow_samples > 0:
            direct = nee_direct(scene, bsdf, hit.position, hit.hit, skey,
                                cfg.pt_shadow_samples, eps,
                                reference_faithful=cfg.reference_faithful)
            rec["nee_direct"] = _host((throughput * direct)[0])
        res = bsdf.sample(skey.next3())
        rec["sampled_dir"] = _host(res.world_dir[0])
        rec["sample_pdf_w"] = float(res.pdf_w[0])
        rec["sample_valid"] = bool(res.valid[0])
        records.append(rec)
        if not rec["sample_valid"]:
            break
        w = res.f * (res.cos_theta
                     / torch.clamp_min(res.pdf_w, 1e-20))[:, None]
        throughput = throughput * w
        o, d = hit.position, res.world_dir
    return records


def check_iteration(scene: Scene, camera: Camera, cfg: RenderConfig,
                    iteration: int = 0, seed: int = 0,
                    radius_sq: float = 0.002):
    """Run one render iteration with every pass's outputs checked for NaN
    and infinity at its ``pass_scope`` boundary. Returns (None, or a
    message naming the first pass whose outputs held a non-finite value,
    and the radiance [H, W, 3] as the integrator returned it). A debugging
    tool: each check waits for the device."""
    from .integrators import ppm, pt, vcm

    key = make_root_key(seed)
    method = cfg.render_method
    with nonfinite_check() as check:
        if method == RenderMethod.PATH_TRACING:
            radiance = pt.render_iteration(scene, camera, cfg, iteration,
                                           key)
        elif method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
            radiance = ppm.render_iteration(scene, camera, cfg, iteration,
                                            key, radius_sq)[0]
        else:
            radiance = vcm.render_iteration(scene, camera, cfg, iteration,
                                            key, radius_sq)[0]
    return check.message, radiance


def photon_depth_histogram(scene: Scene, cfg: RenderConfig, seed: int = 0,
                           iteration: int = 0):
    """Photon path-length histogram (debugOutputPhotonTracing,
    OptixRenderer.cpp:872-953): counts of photon paths by number of stored
    deposits, plus totals."""
    from .integrators import ppm

    n = cfg.photons_per_iteration
    photon_key = iteration_key(make_root_key(seed), iteration,
                               ppm.PASS_PPM_PHOTON)
    lanes = torch.arange(n, dtype=torch.int64, device=scene.device)
    photons, _vol, stats = ppm.trace_photon_pass(
        scene, cfg, photon_key, scene_epsilon(scene), lanes)
    # the photon pass stacks deposits depth-major (flat index = depth * n
    # + lane), so a path's count sums over the leading depth axis
    per_path = photons.valid.reshape(-1, n).sum(dim=0)
    cap = cfg.max_photon_deposits_per_emitted
    hist = torch.bincount(torch.clamp(per_path, 0, cap), minlength=cap + 1)
    return dict(deposits_histogram=_host(hist.to(torch.int32)),
                photons_stored=int(stats["photons_stored"]),
                avg_photon_path_length=float(
                    stats["avg_photon_path_length"]))
