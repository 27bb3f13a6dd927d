"""The plain reference's progressive photon mapping, written from the
estimator the configuration states, with none of the program's code or
streams.

A pixel's value in an iteration at squared radius r^2: where the camera
ray hits an emitter's front, its radiance; where it hits a diffuse
surface, the mean of ``direct_samples`` next-event samples of the area
light plus the photon density estimate, kd / pi times the sum over the
iteration's photons within r whose direction faces the surface of the
Jensen cone weight times their power, over pi r^2 and the photons
emitted. Photons leave uniform points of the area light in
cosine-distributed directions, each carrying the light's power; at
each diffuse hit after the first they are stored, at most
``max_deposits`` times, then scattered cosine-distributed (power times
kd), with Russian roulette from depth ``rr_start`` at kd's largest
component; emitters absorb them. The radius follows the progressive
schedule r_{i+1}^2 = r_i^2 (i + alpha) / (i + 1) from the scene's own
initial radius.

The gather is brute force over the photons in each tile's box: every
photon within r of a query lies in the box of the tile's queries grown
by r, and every such pair is tested.
"""
from __future__ import annotations

import math

import torch

from .scene import EPS_COSINE, Scene, camera_rays, cosine_direction, \
    direct, intersect

GAUSS_ALPHA = 1.818
GAUSS_BETA = 1.953
PAIR_CHUNK = 1 << 22


def initial_radius(s: Scene, fields: dict) -> float:
    """1% of the padded scene box's diagonal, at least the upstream
    project's area heuristic: the radius a configuration derives from
    its scene, the only one the reference knows."""
    if not fields["ppm_default_radius_from_scene"]:
        raise ValueError("the reference derives the radius from the scene")
    cube = s.volume ** (1.0 / 3.0)
    return max(0.01 * s.diag, 6.0 * cube * cube * 3.94e-6)


def radius_sq(r0: float, alpha: float, iteration: int) -> float:
    r2 = r0 * r0
    for i in range(iteration):
        r2 *= (i + alpha) / (i + 1.0)
    return r2


def photons(s: Scene, n: int, gen, depth: int, max_deposits: int,
            rr_start: int):
    """(positions, incoming directions, powers) of the stored photons of
    ``n`` emitted, and the photons alive as each depth's rays are
    traced."""
    dev = s.device
    u = torch.rand((n, 4), generator=gen, device=dev)
    o = (s.light_anchor + u[:, :1] * s.light_u + u[:, 1:2] * s.light_v)
    d = cosine_direction(s.light_normal.expand(n, 3), u[:, 2:])
    power = s.light_power.expand(n, 3).clone()
    stored = torch.zeros((n,), dtype=torch.int32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    keep, alive_at = [], []
    for k in range(depth):
        alive_at.append(int(alive.sum()))
        t, idx, hit = intersect(s, o, d, s.eps, torch.where(
            alive, torch.full_like(power[:, 0], math.inf),
            torch.zeros_like(power[:, 0])))
        mat = s.material[idx]
        live = alive & hit & ~s.emitter[mat]
        pos = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
        dep = live & (k >= 1) & (stored < max_deposits)
        keep.append((pos[dep], d[dep], power[dep]))
        stored = stored + dep.to(torch.int32)
        live = live & (stored < max_deposits)
        normal = s.normal[idx]
        kd = s.kd[mat]
        new_d = cosine_direction(normal, torch.rand((n, 2), generator=gen,
                                                    device=dev))
        valid = (((normal * -d).sum(1) >= EPS_COSINE)
                 & ((normal * new_d).sum(1) >= EPS_COSINE))
        live = live & valid
        power = torch.where(live[:, None], power * kd, power)
        if k >= rr_start:
            p = torch.clamp_max(kd.amax(1), 1.0)
            survive = torch.rand((n,), generator=gen, device=dev) < p
            live = live & survive
            power = torch.where(live[:, None],
                                power / torch.clamp_min(p, 1e-20)[:, None],
                                power)
        o = torch.where(live[:, None], pos, o)
        d = torch.where(live[:, None], new_d, d)
        alive = live
    return (torch.cat([x[0] for x in keep]), torch.cat([x[1] for x in keep]),
            torch.cat([x[2] for x in keep]), alive_at)


def gather(qpos, qnormal, qvalid, ppos, pdir, ppow, r2: float):
    """Per query [T, Q] the Jensen-weighted power [T, Q, 3] of the
    photons within sqrt(r2) whose direction faces the query's normal, by
    brute force over the photons in each tile's grown box."""
    T, Q, _ = qpos.shape
    dev = qpos.device
    acc = torch.zeros((T, Q, 3), device=dev)
    if ppos.shape[0] == 0:
        return acc
    r = math.sqrt(r2)
    big = torch.full_like(qpos, math.inf)
    lo = torch.where(qvalid[..., None], qpos, big).amin(1) - r       # [T, 3]
    hi = torch.where(qvalid[..., None], qpos, -big).amax(1) + r
    inside = ((ppos[None] >= lo[:, None]) & (ppos[None] <= hi[:, None])
              ).all(-1)                                              # [T, P]
    ti, pj = inside.nonzero(as_tuple=True)
    denom = 1.0 - math.exp(-GAUSS_BETA)
    step = max(1, PAIR_CHUNK // Q)
    for a in range(0, ti.shape[0], step):
        t_, p_ = ti[a:a + step], pj[a:a + step]
        diff = qpos[t_] - ppos[p_][:, None]          # [c, Q, 3]
        d2 = (diff * diff).sum(-1)
        faces = (qnormal[t_] * pdir[p_][:, None]).sum(-1) <= 0.0
        ok = (d2 <= r2) & faces & qvalid[t_]
        w = GAUSS_ALPHA * (1.0 - (1.0 - torch.exp(-GAUSS_BETA * d2
                                                  / (2.0 * r2))) / denom)
        w = torch.where(ok, w, torch.zeros_like(w))
        acc.index_add_(0, t_, w[..., None] * ppow[p_][:, None])
    return acc


def tile_values(s: Scene, fields: dict, tile: int, queries: int,
                n_photons: int, r2: float, gen):
    """One iteration at squared radius ``r2``: for each tile of ``tile``
    pixels square (row-major from the image's bottom row), the mean over
    ``queries`` pixels drawn uniformly in it of a pixel's value summed
    over its channels [T]; and the photons alive at each depth, per
    photon emitted."""
    W, H = fields["width"], fields["height"]
    tx, ty = W // tile, H // tile
    dev = s.device
    T = tx * ty
    cols = torch.arange(T, device=dev) % tx
    rows = torch.arange(T, device=dev) // tx
    px = (cols[:, None] * tile + torch.randint(
        tile, (T, queries), generator=gen, device=dev)).reshape(-1)
    py = (rows[:, None] * tile + torch.randint(
        tile, (T, queries), generator=gen, device=dev)).reshape(-1)
    n = px.shape[0]
    o, d = camera_rays(s, px, py, torch.rand((n, 2), generator=gen,
                                             device=dev), W, H)
    t, idx, hit = intersect(s, o, d, s.eps, math.inf)
    pos = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
    normal = s.normal[idx]
    mat = s.material[idx]
    is_em = s.emitter[mat]
    front = (normal * -d).sum(1) > 0
    value = torch.where((hit & is_em & front)[:, None], s.emission[mat],
                        torch.zeros_like(pos))
    found = hit & ~is_em
    kd = s.kd[mat]
    value = value + direct(s, pos, normal, -d, kd, found, gen,
                           fields["ppm_direct_shadow_samples"])
    ppos, pdir, ppow, alive_at = photons(
        s, n_photons, gen, fields["max_photon_trace_depth"],
        fields["max_photon_deposits_per_emitted"],
        fields["photon_rr_start_depth"])
    power = gather(pos.reshape(T, queries, 3), normal.reshape(T, queries, 3),
                   found.reshape(T, queries), ppos, pdir, ppow,
                   r2).reshape(n, 3)
    indirect = power * kd / math.pi / (math.pi * r2 * n_photons)
    value = value + torch.where(found[:, None], indirect,
                                torch.zeros_like(indirect))
    per_photon = [a / n_photons for a in alive_at]
    return value.sum(1).reshape(T, queries).mean(1), per_photon


def iteration_tiles(s: Scene, fields: dict, check: dict, iteration: int,
                    gen):
    """One iteration's tile values at the radius of ``iteration``
    (:func:`tile_values`) and the rays each of the program's closest-hit
    calls has alive, expected from this iteration's photons: the eye
    pass's ``max_radiance_trace_depth`` calls over every pixel, of which
    only the first has rays (no specular surface continues a walk here),
    and the photon pass's over ``photons_per_iteration`` photons."""
    r0 = initial_radius(s, fields)
    r2 = radius_sq(r0, fields["ppm_alpha"], iteration)
    with torch.no_grad():
        tiles, per_photon = tile_values(s, fields, check["tile"],
                                        check["queries"], check["photons"],
                                        r2, gen)
    n_px = fields["width"] * fields["height"]
    eye = [n_px] + [0] * (fields["max_radiance_trace_depth"] - 1)
    n_ph = fields["photons_per_iteration"]
    calls = ([{"lanes": n_px, "live": x} for x in eye]
             + [{"lanes": n_ph, "live": f * n_ph} for f in per_photon])
    return tiles, calls
