"""Light table and next-event light sampling.

The counterpart of ``oppositerenderer_tpu/lights.py``: the reference's
``renderer/Light.{h,cpp}`` tagged union as a structure of arrays, and
``getLightContribution`` (``renderer/helpers/light.h:29-89``). Light
construction is host-side numpy, identical to the JAX package, so both
packages build the same tables. ``light_emit`` and ``light_illuminate``
arrive with the PPM and VCM slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.math import INV_PI, PI, Tensor, dot, length

AREA, POINT, SPOT = 0, 1, 2

LIGHT_FIELDS = ("kind", "power", "position", "v1", "v2", "normal",
                "inverse_area", "emission", "angle", "is_delta", "is_finite")


@dataclasses.dataclass
class LightTable:
    """All scene lights, SoA. [L] rows."""

    kind: Tensor          # [L] int32: AREA/POINT/SPOT
    power: Tensor         # [L,3] total emitted power (flux)
    position: Tensor      # [L,3] anchor (area) / position (point, spot)
    v1: Tensor            # [L,3] area edge 1
    v2: Tensor            # [L,3] area edge 2
    normal: Tensor        # [L,3] area normal / spot direction
    inverse_area: Tensor  # [L]
    emission: Tensor      # [L,3] Lemit (area) / intensity (point, spot)
    angle: Tensor         # [L] spot cone half-angle (radians)
    is_delta: Tensor      # [L] bool
    is_finite: Tensor     # [L] bool

    @property
    def n_lights(self) -> int:
        return self.kind.shape[0]

    def row(self, idx: Tensor) -> "LightTable":
        """Per-lane light rows."""
        return LightTable(**{f: getattr(self, f)[idx] for f in LIGHT_FIELDS})


def make_area_light(power, anchor, v1, v2) -> dict:
    """Light::Light(power, position, v1, v2) — Light.cpp:14-29."""
    power = np.asarray(power, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    c = np.cross(v1, v2)
    area = np.float32(np.linalg.norm(c))
    return dict(kind=AREA, power=power,
                position=np.asarray(anchor, np.float32), v1=v1, v2=v2,
                normal=(c / max(area, np.float32(1e-20))).astype(np.float32),
                inverse_area=np.float32(1.0 / area),
                emission=(power / (area * PI)).astype(np.float32),
                angle=0.0, is_delta=False, is_finite=True)


def make_point_light(power, position) -> dict:
    """Light::Light(power, position) — Light.cpp:31-40."""
    power = np.asarray(power, np.float32)
    z = np.zeros(3, np.float32)
    return dict(kind=POINT, power=power,
                position=np.asarray(position, np.float32),
                v1=z, v2=z, normal=z, inverse_area=0.0,
                emission=(power * (0.25 * INV_PI)).astype(np.float32),
                angle=0.0, is_delta=True, is_finite=True)


def make_spot_light(power, position, direction, angle_deg) -> dict:
    """Light::Light(power, position, direction, angle) — Light.cpp:42-51,
    with the PBRT p.614 intensity 1/(2pi(1-cos theta)) (the reference's
    degree conversion is a bug)."""
    power = np.asarray(power, np.float32)
    angle = np.float32(np.deg2rad(angle_deg))
    solid = np.float32(2.0 * PI * (1.0 - np.cos(angle)))
    d = np.asarray(direction, np.float32)
    z = np.zeros(3, np.float32)
    return dict(kind=SPOT, power=power,
                position=np.asarray(position, np.float32),
                v1=z, v2=z,
                normal=(d / max(np.linalg.norm(d), 1e-20)).astype(np.float32),
                inverse_area=0.0,
                emission=(power / solid).astype(np.float32), angle=angle,
                is_delta=True, is_finite=True)


def build_light_table(light_dicts: list[dict],
                      device: torch.device | str = "cpu") -> LightTable:
    fields = {}
    for name in LIGHT_FIELDS:
        vals = np.stack([np.asarray(d[name]) for d in light_dicts]).astype(
            np.int32 if name == "kind"
            else np.bool_ if name.startswith("is_") else np.float32)
        fields[name] = torch.as_tensor(vals, device=device)
    return LightTable(**fields)


def light_contribution(lt: LightTable, rec_position: Tensor,
                       rec_normal: Tensor, u2: Tensor):
    """PT next-event estimation toward one light per lane
    (getLightContribution, light.h:29-89), *excluding* visibility.

    ``lt`` holds per-lane rows. Returns ``(contrib, point_on_light, dist)``
    where ``contrib`` is the pre-BRDF factor: Le * cos_surf * cos_light *
    A / d^2 (area), intensity * cos_surf / d^2 (point/spot).
    """
    is_area = lt.kind == AREA
    is_spot = lt.kind == SPOT
    point_on_light = torch.where(
        is_area[..., None],
        lt.position + u2[..., 0:1] * lt.v1 + u2[..., 1:2] * lt.v2,
        lt.position)
    towards = point_on_light - rec_position
    dist = length(towards)
    towards = towards / torch.clamp_min(dist, 1e-20)[..., None]
    cos_surf = torch.clamp_min(dot(rec_normal, towards), 0.0)
    cos_light = torch.clamp_min(dot(-towards, lt.normal), 0.0)
    in_cone = dot(-towards, lt.normal) >= torch.cos(lt.angle)
    geo = torch.where(is_area, cos_light / lt.inverse_area,
                      torch.where(is_spot, in_cone.to(torch.float32), 1.0))
    contrib = lt.emission * (cos_surf * geo / torch.square(
        torch.clamp_min(dist, 1e-20)))[..., None]
    return contrib, point_on_light, dist
