"""The plain reference's scene: parallelograms read from
``reference/scenes/<name>.json``, intersected by brute force.

Every ray is tested against every parallelogram: the plane's distance,
then the hit's two coordinates along the edges, each in [0, 1]. Only
diffuse and emitting materials are known here; a scene that uses another
kind is refused. With ``low_precision`` every intersection call rounds
its rays' origins and directions to bfloat16 first: the control, the
precision below the float32 the configurations state.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import torch

SCENES = Path(__file__).resolve().parent / "scenes"
EPS_COSINE = 1e-6


@dataclasses.dataclass
class Scene:
    anchor: torch.Tensor      # [M, 3]
    normal: torch.Tensor      # [M, 3] unit, along edge1 x edge2
    to_u: torch.Tensor        # [M, 3]: u = (p - anchor) . to_u
    to_v: torch.Tensor        # [M, 3]
    material: torch.Tensor    # [M] index into kd / emission
    kd: torch.Tensor          # [K, 3]
    emission: torch.Tensor    # [K, 3] radiance of emitting materials
    emitter: torch.Tensor     # [K] bool
    light_anchor: torch.Tensor
    light_u: torch.Tensor
    light_v: torch.Tensor
    light_normal: torch.Tensor
    light_area: float
    light_power: torch.Tensor   # [3]
    light_radiance: torch.Tensor  # [3]
    eye: torch.Tensor
    look: torch.Tensor        # eye to the image plane's centre
    cam_u: torch.Tensor       # half the image plane's width, along x
    cam_v: torch.Tensor       # half its height, along y
    eps: float                # ray offset, from the scene's size
    diag: float
    volume: float
    n_triangles: int
    low_precision: bool = False

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    def with_values(self, kd_index: int | None = None, kd=None,
                    emission_scale=None) -> "Scene":
        """The scene with one material's kd and the emission scaled (the
        light's power and every emitter's radiance), either possibly a
        tensor that requires grad."""
        out = dataclasses.replace(self)
        if kd is not None:
            rows = [self.kd[i] for i in range(self.kd.shape[0])]
            rows[kd_index] = kd.reshape(3)
            out.kd = torch.stack(rows)
        if emission_scale is not None:
            s = emission_scale.reshape(())
            out.emission = self.emission * s
            out.light_power = self.light_power * s
            out.light_radiance = self.light_radiance * s
        return out


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot(a, b):
    return sum(x * y for x, y in zip(a, b))


def _unit(a):
    n = math.sqrt(_dot(a, a))
    return [x / n for x in a]


def load(name: str, device, low_precision: bool = False) -> Scene:
    data = json.loads((SCENES / f"{name}.json").read_text())
    mats = data["materials"]
    n_mat = 1 + max(m["index"] for m in mats.values())
    kd = [[0.0] * 3 for _ in range(n_mat)]
    emission = [[0.0] * 3 for _ in range(n_mat)]
    emitter = [False] * n_mat
    light = data["area_light"]
    quads = {q[0]: q for q in data["parallelograms"]}
    _, l_anchor, l_u, l_v, l_mat = quads[light["parallelogram"]]
    l_cross = _cross(l_u, l_v)
    l_area = math.sqrt(_dot(l_cross, l_cross))
    radiance = [p / (l_area * math.pi) for p in light["power"]]
    for m in mats.values():
        if m["kind"] == "diffuse":
            kd[m["index"]] = list(m["kd"])
        elif m["kind"] == "emitter":
            emitter[m["index"]] = True
            emission[m["index"]] = radiance
        else:
            raise ValueError(f"the reference knows no {m['kind']} material")
    anchor, normal, to_u, to_v, mat = [], [], [], [], []
    lo, hi = [math.inf] * 3, [-math.inf] * 3
    for _, a, e1, e2, m in data["parallelograms"]:
        n = _unit(_cross(e1, e2))
        c1, c2 = _cross(e2, n), _cross(n, e1)
        anchor.append(a)
        normal.append(n)
        to_u.append([x / _dot(e1, c1) for x in c1])
        to_v.append([x / _dot(e2, c2) for x in c2])
        mat.append(mats[m]["index"])
        for corner in (a, [p + q for p, q in zip(a, e1)],
                       [p + q for p, q in zip(a, e2)],
                       [p + q + r for p, q, r in zip(a, e1, e2)]):
            lo = [min(x, y) for x, y in zip(lo, corner)]
            hi = [max(x, y) for x, y in zip(hi, corner)]
    pad = data.get("aabb_padding", 0.0)
    ext = [h - l + 2 * pad for h, l in zip(hi, lo)]
    diag = math.sqrt(_dot(ext, ext))
    cam = data["camera"]
    look = [b - a for a, b in zip(cam["eye"], cam["lookat"])]
    up = _unit(cam["up"])
    cu = _unit(_cross(look, up))
    cv = _unit(_cross(cu, look))
    dist = math.sqrt(_dot(look, look))
    ulen = dist * math.tan(math.radians(cam["hfov"] * 0.5))
    vlen = dist * math.tan(math.radians(cam["vfov"] * 0.5))

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=device)

    return Scene(
        anchor=t(anchor), normal=t(normal), to_u=t(to_u), to_v=t(to_v),
        material=t(mat, torch.int64), kd=t(kd), emission=t(emission),
        emitter=t(emitter, torch.bool), light_anchor=t(l_anchor),
        light_u=t(l_u), light_v=t(l_v), light_normal=t(_unit(l_cross)),
        light_area=l_area, light_power=t(light["power"]),
        light_radiance=t(radiance), eye=t(cam["eye"]), look=t(look),
        cam_u=t([x * ulen for x in cu]), cam_v=t([x * vlen for x in cv]),
        eps=max(2e-5 * diag, 1e-4), diag=diag,
        volume=ext[0] * ext[1] * ext[2],
        n_triangles=2 * len(data["parallelograms"]),
        low_precision=low_precision)


def camera_rays(s: Scene, px, py, jitter, width: int, height: int):
    """Pinhole rays through pixel (px, py) at ``jitter`` in [0, 1)^2; row
    0 is the image's bottom."""
    dx = (px.to(torch.float32) + jitter[:, 0]) / width * 2.0 - 1.0
    dy = (py.to(torch.float32) + jitter[:, 1]) / height * 2.0 - 1.0
    d = dx[:, None] * s.cam_u + dy[:, None] * s.cam_v + s.look
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return s.eye.expand_as(d), d


def _rounded(s: Scene, o, d):
    if not s.low_precision:
        return o, d
    return (o.to(torch.bfloat16).to(torch.float32),
            d.to(torch.bfloat16).to(torch.float32))


def intersect(s: Scene, o, d, tmin: float, tmax):
    """Closest hit of each ray in (tmin, tmax): (t, parallelogram index,
    hit). ``tmax`` is a number or a tensor [N]."""
    o, d = _rounded(s, o.detach(), d.detach())
    denom = d @ s.normal.T                                    # [N, M]
    num = (s.anchor * s.normal).sum(1) - o @ s.normal.T
    t = num / torch.where(denom == 0, torch.ones_like(denom), denom)
    p_u = (o @ s.to_u.T) - (s.anchor * s.to_u).sum(1)
    p_v = (o @ s.to_v.T) - (s.anchor * s.to_v).sum(1)
    u = p_u + t * (d @ s.to_u.T)
    v = p_v + t * (d @ s.to_v.T)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=o.device)
    ok = ((denom != 0) & (t > tmin) & (t < tmax.reshape(-1, 1))
          & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1))
    t = torch.where(ok, t, torch.full_like(t, math.inf))
    best, idx = torch.min(t, dim=1)
    return best, idx, torch.isfinite(best)


def occluded(s: Scene, o, d, tmin: float, tmax):
    _, _, hit = intersect(s, o, d, tmin, tmax)
    return hit


def onb(n):
    """Two unit tangents of each unit normal."""
    a = torch.where((n[:, 0].abs() > 0.9)[:, None],
                    torch.tensor([0.0, 1.0, 0.0], device=n.device),
                    torch.tensor([1.0, 0.0, 0.0], device=n.device))
    t = torch.linalg.cross(n, a)
    t = t / torch.linalg.vector_norm(t, dim=1, keepdim=True)
    return t, torch.linalg.cross(n, t)


def cosine_direction(n, u):
    """Cosine-distributed directions about the unit normals ``n``."""
    t, b = onb(n)
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    z = torch.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0))
    return ((r * torch.cos(phi))[:, None] * t
            + (r * torch.sin(phi))[:, None] * b + z[:, None] * n)


def direct(s: Scene, pos, normal, wo, kd, active, gen, samples: int):
    """Next-event estimate at diffuse points [N, 3]: the mean of
    ``samples`` shadow rays to uniform points of the area light,
    Le cos cos' A / d^2 times kd / pi where both directions lie above
    the surface and nothing is in between."""
    n = pos.shape[0]
    out = torch.zeros((n, 3), device=pos.device)
    wo_up = (wo * normal).sum(1) >= EPS_COSINE
    for _ in range(samples):
        u = torch.rand((n, 2), generator=gen, device=pos.device)
        y = s.light_anchor + u[:, :1] * s.light_u + u[:, 1:] * s.light_v
        to = y - pos
        dist = torch.linalg.vector_norm(to, dim=1)
        w = to / dist[:, None]
        cos_s = (normal * w).sum(1)
        cos_l = -(w * s.light_normal).sum(1)
        worth = active & wo_up & (cos_s >= EPS_COSINE) & (cos_l > 0)
        occ = occluded(s, pos, w, s.eps, torch.where(
            worth, torch.clamp_min(dist - 2 * s.eps, s.eps),
            torch.zeros_like(dist)))
        g = (torch.clamp_min(cos_s, 0) * torch.clamp_min(cos_l, 0)
             * s.light_area / dist ** 2)
        lit = (worth & ~occ)[:, None]
        out = out + torch.where(lit, s.light_radiance * kd / math.pi
                                * g[:, None], torch.zeros_like(out))
    return out / samples
