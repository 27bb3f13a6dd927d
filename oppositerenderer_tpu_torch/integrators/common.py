"""Shared wavefront machinery of the integrators.

The counterpart of ``oppositerenderer_tpu/integrators/common.py``: every
lane builds the same dense composite BSDF from the material table, with
the glass inside-hit normal flip and IOR swap of Glass.cu:261-264 applied
per lane.
"""
from __future__ import annotations

import torch

from ..accel.intersect import Hit, occluded
from ..bsdf import BSDF
from ..core.math import Tensor, dot, max3
from ..lights import light_contribution
from ..scene.types import EMITTER, GLASS, Scene


def scene_epsilon(scene: Scene) -> Tensor:
    """Self-intersection offset scaled to the scene (the reference's fixed
    1e-4 suits the 2.5-unit box but is marginal at Cornell's 556 units).
    A 0-d tensor on the scene's device."""
    e = scene.aabb_max - scene.aabb_min
    diag = torch.sqrt(torch.sum(e * e))
    return torch.clamp_min(2e-5 * diag, 1e-4)


def bsdf_at_hit(scene: Scene, hit: Hit, incoming_dir: Tensor
                ) -> tuple[BSDF, Tensor, Tensor]:
    """Build the per-lane BSDF at hit points.

    ``incoming_dir`` is the ray direction (pointing AT the surface).
    Returns (bsdf, is_emitter, emitter_radiance) where emitter_radiance is
    Lemit on front-face emitter hits, else 0 (DiffuseEmitter.cu:40-52).
    """
    if scene.has_textures:
        raise NotImplementedError(
            "textured materials arrive with the texture slice of the port")
    m = scene.materials.row(hit.mat.long())
    kind = m.kind
    kd, ks, exponent, kr, kt, ior, kr_diel = m.coefficients()

    # glass hit from inside: flip normals, swap the IOR pair
    from_outside = dot(hit.ng, incoming_dir) < 0.0
    flip = ((kind == GLASS) & ~from_outside)[..., None]
    ns = torch.where(flip, -hit.ns, hit.ns)
    ng = torch.where(flip, -hit.ng, hit.ng)
    ior_eff = torch.where(flip[..., 0], 1.0 / ior, ior)

    bsdf = BSDF.make(ns, ng, -incoming_dir, kd, ks, exponent, kr, kt,
                     ior_eff, kr_diel)

    is_emitter = kind == EMITTER
    front = dot(hit.ns, -incoming_dir) > 0.0
    emitter_radiance = torch.where((is_emitter & front)[..., None],
                                   m.emission, 0.0)
    return bsdf, is_emitter, emitter_radiance


def pixel_coords(width: int, height: int, device: torch.device | str
                 ) -> tuple[Tensor, Tensor]:
    """Flattened pixel index grids [H*W] (lane = y * W + x)."""
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def nee_direct(scene: Scene, bsdf: BSDF, position: Tensor, active: Tensor,
               sampler, n_samples: int, eps: Tensor,
               reference_faithful: bool = False) -> Tensor:
    """Next-event estimation at surface points: ``n_samples`` shadow rays to
    uniformly picked lights, averaged (pt/RayGeneratorPT.cu:88-100), with
    the BSDF f applied instead of raw albedo unless ``reference_faithful``.

    Returns the direct radiance [N,3] (throughput NOT applied).
    """
    n = position.shape[0]
    device = position.device
    n_lights = scene.lights.n_lights
    nee_ok = active & ~bsdf.is_specular()
    direct = torch.zeros((n, 3), dtype=torch.float32, device=device)
    if n_samples <= 0:
        return direct
    for _ in range(n_samples):
        li = torch.clamp_max((sampler.next1() * n_lights).to(torch.int64),
                             n_lights - 1)
        contrib, point_on_light, dist = light_contribution(
            scene.lights.row(li), position, bsdf.frame.n, sampler.next2())
        dir_l = (point_on_light - position) \
            / torch.clamp_min(dist, 1e-20)[:, None]
        f, _, _, _ = bsdf.f(dir_l)
        if reference_faithful:
            f = f * torch.pi
        worth = nee_ok & (max3(contrib) > 0.0) & (max3(f) > 0.0)
        # lanes not worth a shadow ray trace an empty interval
        occ = occluded(scene, position, dir_l,
                       torch.full((n,), 1.0, device=device) * eps,
                       torch.where(worth,
                                   torch.maximum(dist - 2 * eps, eps), 0.0))
        vis = worth & ~occ
        direct = direct + torch.where(vis[:, None], f * contrib * n_lights,
                                      0.0)
    return direct / n_samples
