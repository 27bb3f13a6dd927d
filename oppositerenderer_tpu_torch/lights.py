"""Light table and next-event light sampling.

The counterpart of ``oppositerenderer_tpu/lights.py``: the reference's
``renderer/Light.{h,cpp}`` tagged union as a structure of arrays, and
``getLightContribution`` (``renderer/helpers/light.h:29-89``), and VCM's
``lightEmit`` (:92-145) and ``lightIlluminate`` (:147-216). Light
construction is host-side numpy, identical to the JAX package, so both
packages build the same tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.math import INV_PI, PI, Tensor, dot, length
from .core.sampling import (cone_pdf_w, sample_cone, sample_unit_sphere,
                            sample_unit_hemisphere_cos)

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


def _point_cone(lt: LightTable, scene_center: Tensor, scene_radius: Tensor):
    """A point light outside the scene's bounding sphere emits into the
    cone toward it: (outside, cone half-angle via arcsin, unit axis)."""
    to_center = scene_center - lt.position
    dist_c = length(to_center)
    axis = to_center / torch.clamp_min(dist_c, 1e-20)[..., None]
    outside = scene_radius < dist_c
    theta = torch.arcsin(torch.clamp(
        scene_radius / torch.clamp_min(dist_c, 1e-20), 0.0, 1.0))
    return outside, theta, axis


def light_emit(lt: LightTable, u2_dir: Tensor, u2_pos: Tensor,
               scene_center: Tensor, scene_radius: Tensor,
               eps_cosine: float = 1e-6):
    """Sample an emission point and direction (lightEmit, light.h:92-145).

    Returns ``(radiance, position, direction, emission_pdf_w, direct_pdf_a,
    cos_theta_light)``. ``emission_pdf_w`` is the product of the position
    pdf (area) and the solid-angle direction pdf; an area light's radiance
    is Lemit * cos_theta, with the cosine biased away from 0 like the
    reference's.
    """
    is_area = lt.kind == AREA
    is_spot = lt.kind == SPOT

    pos_area = (lt.position + u2_pos[..., 0:1] * lt.v1
                + u2_pos[..., 1:2] * lt.v2)
    dir_area, pdf_area, cos_area = sample_unit_hemisphere_cos(
        lt.normal, u2_dir, bias_small_cosine=True, eps_cosine=eps_cosine)
    emission_pdf_area = pdf_area * lt.inverse_area
    rad_area = lt.emission * cos_area[..., None]

    outside, theta, axis = _point_cone(lt, scene_center, scene_radius)
    dir_cone, pdf_cone = sample_cone(u2_dir, theta, axis)
    dir_sph, pdf_sph = sample_unit_sphere(u2_dir)
    dir_point = torch.where(outside[..., None], dir_cone, dir_sph)
    pdf_point = torch.where(outside, pdf_cone, pdf_sph)

    dir_spot, pdf_spot = sample_cone(u2_dir, lt.angle, lt.normal)

    direction = torch.where(is_area[..., None], dir_area,
                            torch.where(is_spot[..., None], dir_spot,
                                        dir_point))
    emission_pdf = torch.where(is_area, emission_pdf_area,
                               torch.where(is_spot, pdf_spot, pdf_point))
    position = torch.where(is_area[..., None], pos_area,
                           torch.broadcast_to(lt.position, pos_area.shape))
    direct_pdf_a = torch.where(is_area, lt.inverse_area, 1.0)
    cos_theta = torch.where(is_area, cos_area, 1.0)
    radiance = torch.where(is_area[..., None], rad_area, lt.emission)
    return radiance, position, direction, emission_pdf, direct_pdf_a, \
        cos_theta


def light_illuminate(lt: LightTable, u2: Tensor, receive_position: Tensor,
                     scene_center: Tensor, scene_radius: Tensor,
                     eps_cosine: float = 1e-6):
    """Sample a point for VCM's next-event estimation with its pdfs
    (lightIlluminate, light.h:147-216).

    Returns ``(radiance, dir_to_light, dist, direct_pdf_w, emission_pdf_w,
    cos_theta_light)``. A delta light's ``direct_pdf_w`` is d^2, the
    reference's convention: the 1/d^2 conversion is folded in, so that
    radiance / direct_pdf_w is the contribution for both kinds.
    """
    is_area = lt.kind == AREA
    is_spot = lt.kind == SPOT

    point = torch.where(
        is_area[..., None],
        lt.position + u2[..., 0:1] * lt.v1 + u2[..., 1:2] * lt.v2,
        lt.position)
    to_light = point - receive_position
    dist = length(to_light)
    dir_to_light = to_light / torch.clamp_min(dist, 1e-20)[..., None]
    d2 = torch.square(dist)

    cos_light = dot(lt.normal, -dir_to_light)
    ok_area = cos_light >= eps_cosine
    direct_pdf_area = lt.inverse_area * d2 / torch.clamp_min(cos_light,
                                                             1e-20)
    emission_pdf_area = (lt.inverse_area * torch.clamp_min(cos_light, 0.0)
                         * INV_PI)

    outside, theta, _ = _point_cone(lt, scene_center, scene_radius)
    emission_pdf_point = torch.where(outside, cone_pdf_w(theta),
                                     0.25 * INV_PI)
    emission_pdf_spot = cone_pdf_w(lt.angle)
    in_cone = dot(-dir_to_light, lt.normal) >= torch.cos(lt.angle)

    radiance = torch.where(
        is_area[..., None],
        torch.where(ok_area[..., None], lt.emission, 0.0),
        torch.where(is_spot[..., None],
                    torch.where(in_cone[..., None], lt.emission, 0.0),
                    lt.emission))
    direct_pdf_w = torch.where(is_area, direct_pdf_area, d2)
    emission_pdf_w = torch.where(
        is_area, emission_pdf_area,
        torch.where(is_spot, emission_pdf_spot, emission_pdf_point))
    cos_theta = torch.where(is_area, cos_light, 1.0)
    return (radiance, dir_to_light, dist, direct_pdf_w, emission_pdf_w,
            cos_theta)
