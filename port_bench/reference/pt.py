"""The plain reference's path tracer, written from the estimator the
configuration states, with none of the program's code or streams.

A jittered pinhole ray a pixel; at most ``segments`` bounces; emission
counted where the camera ray itself hits an emitter's front; at each
diffuse vertex one next-event sample of the area light, weighted by the
path's throughput; the next direction cosine-distributed (a throughput
factor of kd); Russian roulette from depth ``rr_start`` with the
throughput's largest component as the continuation probability. Its
expectation is the image the program's PT converges to. Differentiable
in the scene's kd and emission: sampling decisions take no gradient.
"""
from __future__ import annotations

import torch

from .scene import EPS_COSINE, Scene, camera_rays, cosine_direction, \
    direct, intersect


def radiance(s: Scene, px, py, width: int, height: int, gen,
             segments: int, rr_start: int, shadow_samples: int = 1):
    """Radiance [N, 3] of one path for each pixel (px, py)."""
    n = px.shape[0]
    dev = px.device
    o, d = camera_rays(s, px, py,
                       torch.rand((n, 2), generator=gen, device=dev),
                       width, height)
    thr = torch.ones((n, 3), device=dev)
    out = torch.zeros((n, 3), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    for depth in range(segments):
        t, idx, hit = intersect(s, o, d, s.eps, torch.where(
            active, torch.full_like(thr[:, 0], float("inf")),
            torch.zeros_like(thr[:, 0])))
        active = active & hit
        t = torch.where(hit, t, torch.zeros_like(t))
        pos = o + t[:, None] * d
        normal = s.normal[idx]
        mat = s.material[idx]
        is_em = s.emitter[mat]
        wo = -d
        if depth == 0:
            front = (normal * wo).sum(1) > 0
            out = out + torch.where((active & is_em & front)[:, None],
                                    thr * s.emission[mat],
                                    torch.zeros_like(out))
        active = active & ~is_em
        kd = s.kd[mat]
        if shadow_samples:
            out = out + thr * direct(s, pos, normal, wo, kd, active, gen,
                                     shadow_samples)
        u = torch.rand((n, 2), generator=gen, device=dev)
        new_d = cosine_direction(normal, u)
        valid = (((normal * wo).sum(1) >= EPS_COSINE)
                 & ((normal * new_d).sum(1) >= EPS_COSINE))
        thr = torch.where(valid[:, None], thr * kd, torch.zeros_like(thr))
        active = active & valid
        if depth >= rr_start:
            p = torch.clamp(thr.detach().amax(1), 0.0, 1.0)
            survive = torch.rand((n,), generator=gen, device=dev) < p
            thr = thr / torch.clamp_min(p, 1e-20)[:, None]
            active = active & survive
        o, d = pos, new_d
    return out


def iteration_tiles(s: Scene, fields: dict, check: dict, iteration: int,
                    gen):
    """One iteration's value for each tile of ``check["tile"]`` pixels
    square (row-major from the image's bottom row): the mean over
    ``check["queries"]`` pixels drawn uniformly in it of a pixel's
    radiance summed over its channels [T]; and no ray counts."""
    W, H, tile = fields["width"], fields["height"], check["tile"]
    tx, ty = W // tile, H // tile
    q = check["queries"]
    dev = s.device
    T = tx * ty
    cols = torch.arange(T, device=dev) % tx
    rows = torch.arange(T, device=dev) // tx
    px = (cols[:, None] * tile + torch.randint(
        tile, (T, q), generator=gen, device=dev)).reshape(-1)
    py = (rows[:, None] * tile + torch.randint(
        tile, (T, q), generator=gen, device=dev)).reshape(-1)
    with torch.no_grad():
        rad = radiance(s, px, py, W, H, gen, segments(fields),
                       fields["path_rr_start_depth"],
                       fields["pt_shadow_samples"])
    return rad.sum(1).reshape(T, q).mean(1), None


def segments(fields: dict) -> int:
    """The bounces a path may make: with next-event estimation the
    configuration's ``pt_max_segments_nee``."""
    if fields["pt_direct_light_sampling"]:
        return fields["pt_max_segments_nee"]
    raise ValueError("the reference traces PT with next-event estimation "
                     "only")


def loss_and_grad(s: Scene, fields: dict, wrt: list, values: list, gen,
                  rows: tuple | None = None):
    """The mean radiance of one path a pixel over the whole image (or
    over its ``rows`` = (first, stop) only) and its gradient with respect
    to ``values``, one tensor for each (field, material) of ``wrt``:
    ("kd", m) is material m's kd, ("emission_scale", _) scales every
    emission."""
    W, H = fields["width"], fields["height"]
    dev = s.device
    leaves = [v.detach().clone().to(dev).requires_grad_(True)
              for v in values]
    kd_index = kd = scale = None
    for (field, m), leaf in zip(wrt, leaves):
        if field == "kd":
            kd_index, kd = m, leaf
        elif field == "emission_scale":
            scale = leaf
        else:
            raise ValueError(f"the reference differentiates no {field}")
    scene = s.with_values(kd_index, kd, scale)
    y0, y1 = rows if rows else (0, H)
    py, px = torch.meshgrid(torch.arange(y0, y1, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    rad = radiance(scene, px.reshape(-1), py.reshape(-1), W, H, gen,
                   segments(fields), fields["path_rr_start_depth"],
                   fields["pt_shadow_samples"])
    loss = rad.mean()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.detach() for g in grads]
