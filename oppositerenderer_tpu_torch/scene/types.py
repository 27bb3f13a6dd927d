"""Scene data model: SoA geometry, material table, scene record.

The counterpart of ``oppositerenderer_tpu/scene/types.py``. A scene is a
handful of dense tensors: triangles (parallelograms become two
triangles), analytic spheres, a material parameter table indexed per
primitive, the light table, the texture atlases and, above
``accel.bvh.BVH_AUTO_THRESHOLD`` triangles, the BVH, and optionally a
homogeneous participating medium over a box.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from ..core.math import Tensor, length
from ..core.rows import take_rows
from ..lights import LightTable

# material kinds (reference material/ host classes)
DIFFUSE, GLOSSY, MIRROR, GLASS, EMITTER, TEXTURED = 0, 1, 2, 3, 4, 5

MATERIAL_FIELDS = ("kind", "kd", "ks", "exponent", "kr", "kt", "ior",
                   "emission", "light_index", "texture_id", "normal_map_id")


@dataclasses.dataclass
class MaterialTable:
    """One row per material. Parameters follow the reference host classes:
    Diffuse(Kd), Glossy(Kd, Ks, exp), Mirror(Kr), Glass(ior, Kr, Kt),
    DiffuseEmitter(power->Lemit, Kd), Texture(Kd map)."""

    kind: Tensor          # [M] int32
    kd: Tensor            # [M,3]
    ks: Tensor            # [M,3]
    exponent: Tensor      # [M]
    kr: Tensor            # [M,3]
    kt: Tensor            # [M,3]
    ior: Tensor           # [M]
    emission: Tensor      # [M,3] Lemit (emitters only)
    light_index: Tensor   # [M] int32 row into LightTable, -1 if not emitter
    texture_id: Tensor    # [M] int32, -1 = no texture
    normal_map_id: Tensor  # [M] int32, -1 = none

    def row(self, idx: Tensor) -> "MaterialTable":
        """Per-lane material rows (``core.rows.take_rows``)."""
        return MaterialTable(**{f: take_rows(getattr(self, f), idx)
                                for f in MATERIAL_FIELDS})

    def bsdf_coefficients(self, idx: Tensor):
        """BSDF component coefficients for per-lane material ids ``idx``:
        ``row(idx).coefficients()``."""
        return self.row(idx).coefficients()

    def coefficients(self):
        """BSDF component coefficients of (per-lane) rows — each material's
        VcmBSDF construction (Diffuse.cu:174-242, Glossy.cu:188-230,
        Mirror.cu:134-177, Glass.cu:258-356).

        Returns ``(kd, ks, exponent, kr, kt, ior, kr_is_dielectric)``.
        """
        m = self
        k = m.kind[..., None]
        is_glass = m.kind == GLASS
        kd = torch.where((k == DIFFUSE) | (k == GLOSSY) | (k == EMITTER)
                         | (k == TEXTURED), m.kd, 0.0)
        ks = torch.where(k == GLOSSY, m.ks, 0.0)
        kr = torch.where(k == MIRROR, m.kr,
                         torch.where(is_glass[..., None], m.kr, 0.0))
        kt = torch.where(is_glass[..., None], m.kt, 0.0)
        return kd, ks, m.exponent, kr, kt, m.ior, is_glass


@dataclasses.dataclass
class Geometry:
    """Triangle soup + analytic spheres (SoA).

    Triangles store the Moller-Trumbore terms (v0, edges) plus per-vertex
    shading normals and uvs; the geometric normal is normalize(e1 x e2).
    Spheres are the reference's analytic sphere (sphere.cu:32-66).
    """

    tri_v0: Tensor         # [T,3]
    tri_e1: Tensor         # [T,3] v1-v0
    tri_e2: Tensor         # [T,3] v2-v0
    tri_n0: Tensor         # [T,3] shading normals at vertices
    tri_n1: Tensor         # [T,3]
    tri_n2: Tensor         # [T,3]
    tri_uv0: Tensor        # [T,2]
    tri_uv1: Tensor        # [T,2]
    tri_uv2: Tensor        # [T,2]
    tri_tangent: Tensor    # [T,3] per-face tangent (normal mapping)
    tri_bitangent: Tensor  # [T,3]
    tri_mat: Tensor        # [T] int32
    sph_center: Tensor     # [S,3]
    sph_radius: Tensor     # [S]
    sph_mat: Tensor        # [S] int32

    @property
    def n_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]


@dataclasses.dataclass
class Medium:
    """Homogeneous participating medium over an AABB (the reference's
    ParticipatingMedium material on an AAB instance covering the scene,
    material/ParticipatingMedium.{h,cu}; flag-gated default-off)."""

    sigma_s: Tensor   # [] scattering coefficient
    sigma_a: Tensor   # [] absorption coefficient
    aabb_min: Tensor  # [3]
    aabb_max: Tensor  # [3]

    @property
    def sigma_t(self) -> Tensor:
        return self.sigma_s + self.sigma_a


@dataclasses.dataclass
class Scene:
    geometry: Geometry
    materials: MaterialTable
    lights: LightTable
    aabb_min: Tensor  # [3]
    aabb_max: Tensor  # [3]
    textures: Tensor | None = None     # [n_tex, R, R, 3] diffuse atlas
    normal_maps: Tensor | None = None  # [n_nm, R, R, 3] normal-map atlas
    bvh: object = None                 # accel.bvh.Bvh (big scenes)
    medium: Medium | None = None       # PPM renders it; PT, VCM do not
    name: str = "scene"
    # the dense route's triangle tables (accel.intersect.dense_tables), set
    # per instance at first use; not a field, so dataclasses.replace does
    # not carry it to a scene with other geometry
    dense_cache: ClassVar[tuple | None] = None

    @property
    def device(self) -> torch.device:
        return self.geometry.tri_v0.device

    @property
    def has_textures(self) -> bool:
        return self.textures is not None and self.textures.shape[0] > 0

    @property
    def bounding_sphere(self) -> tuple[Tensor, Tensor]:
        """(center, radius) of the scene AABB's bounding sphere (the
        distant point light's disc mode of ``ppm.emit_photons``)."""
        c = 0.5 * (self.aabb_min + self.aabb_max)
        return c, length(self.aabb_max - c)

    def initial_ppm_radius_estimate(self) -> float:
        """IScene::getSceneInitialPPMRadiusEstimate (IScene.cpp:23-31):
        r = 6 * cbrt(volume)^2 * 3.94e-6."""
        extent = (self.aabb_max - self.aabb_min).cpu().numpy()
        volume = float(np.prod(extent))
        cube = volume ** (1.0 / 3.0)
        return 6.0 * cube * cube * 3.94e-6
