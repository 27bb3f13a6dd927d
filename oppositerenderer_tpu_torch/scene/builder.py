"""Host-side scene construction (numpy), producing the Scene record.

The counterpart of ``oppositerenderer_tpu/scene/builder.py``: geometry
accumulates in Python lists (one triangle at a time) and vectorised
blocks (``add_mesh``, ``add_triangle_soup``), and is flattened to dense
arrays once, then moved to the requested device with the texture
atlases and the optional participating medium.
"""
from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve_device
from ..lights import build_light_table
from .texture import build_atlas, compute_triangle_tangents
from .types import (DIFFUSE, EMITTER, GLASS, GLOSSY, MATERIAL_FIELDS, MIRROR,
                    TEXTURED, Geometry, MaterialTable, Medium, Scene)


class SceneBuilder:
    def __init__(self, name: str = "scene"):
        self.name = name
        self._materials: list[dict] = []
        self._tris: list[tuple] = []     # (v0,v1,v2,n0,n1,n2,uv0,uv1,uv2,mat)
        self._bulk: list[dict] = []      # vectorised mesh blocks (add_mesh)
        self._spheres: list[tuple] = []  # (center, radius, mat)
        self._lights: list[dict] = []
        self._textures: list = []        # images of the diffuse atlas
        self._normal_maps: list = []
        self._medium: tuple | None = None   # (sigma_s, sigma_a, min, max)
        self._aabb_min = np.full(3, np.inf, np.float32)
        self._aabb_max = np.full(3, -np.inf, np.float32)

    # ------------------------------------------------------------ materials
    def _add_material(self, **kw) -> int:
        row = dict(kind=DIFFUSE, kd=(0, 0, 0), ks=(0, 0, 0), exponent=0.0,
                   kr=(0, 0, 0), kt=(0, 0, 0), ior=1.0, emission=(0, 0, 0),
                   light_index=-1, texture_id=-1, normal_map_id=-1)
        row.update(kw)
        self._materials.append(row)
        return len(self._materials) - 1

    def add_diffuse(self, kd) -> int:
        """material/Diffuse.h."""
        return self._add_material(kind=DIFFUSE, kd=kd)

    def add_glossy(self, kd, ks, exponent: float) -> int:
        """material/Glossy.h (Kd + Phong lobe)."""
        return self._add_material(kind=GLOSSY, kd=kd, ks=ks,
                                  exponent=exponent)

    def add_mirror(self, kr) -> int:
        """material/Mirror.h."""
        return self._add_material(kind=MIRROR, kr=kr)

    def add_glass(self, ior: float, kr=(1, 1, 1), kt=(1, 1, 1)) -> int:
        """material/Glass.h."""
        return self._add_material(kind=GLASS, ior=ior, kr=kr, kt=kt)

    def add_emitter(self, power, kd=(1, 1, 1), *, light: dict) -> int:
        """material/DiffuseEmitter.h: Lemit = power * inverseArea / pi, tied
        to an area light entry."""
        light_idx = len(self._lights)
        self._lights.append(light)
        c = np.cross(np.asarray(light["v1"], np.float32),
                     np.asarray(light["v2"], np.float32))
        inverse_area = 1.0 / np.linalg.norm(c)
        lemit = np.asarray(power, np.float32) * inverse_area / np.pi
        return self._add_material(kind=EMITTER, kd=kd, emission=tuple(lemit),
                                  light_index=light_idx)

    def add_texture_image(self, image) -> int:
        """Register a diffuse texture image (np [H,W,3] in [0,1])."""
        self._textures.append(image)
        return len(self._textures) - 1

    def add_normal_map_image(self, image) -> int:
        self._normal_maps.append(image)
        return len(self._normal_maps) - 1

    def add_textured(self, kd, texture_id: int,
                     normal_map_id: int = -1) -> int:
        """material/Texture.h (kd scales the texture lookup)."""
        return self._add_material(kind=TEXTURED, kd=kd,
                                  texture_id=texture_id,
                                  normal_map_id=normal_map_id)

    def add_light(self, light: dict) -> int:
        """Standalone (non-emitter-geometry) light, e.g. point/spot."""
        self._lights.append(light)
        return len(self._lights) - 1

    # ------------------------------------------------------------- geometry
    def _grow_aabb(self, pts: np.ndarray):
        self._aabb_min = np.minimum(self._aabb_min, pts.min(axis=0))
        self._aabb_max = np.maximum(self._aabb_max, pts.max(axis=0))

    def add_triangle(self, v0, v1, v2, material: int, n0=None, n1=None,
                     n2=None, uv0=(0, 0), uv1=(0, 0), uv2=(0, 0)):
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        ng = np.cross(v1 - v0, v2 - v0)
        nrm = ng / max(np.linalg.norm(ng), 1e-20)
        n0 = nrm if n0 is None else np.asarray(n0, np.float32)
        n1 = nrm if n1 is None else np.asarray(n1, np.float32)
        n2 = nrm if n2 is None else np.asarray(n2, np.float32)
        self._tris.append((v0, v1, v2, n0, n1, n2,
                           np.asarray(uv0, np.float32),
                           np.asarray(uv1, np.float32),
                           np.asarray(uv2, np.float32), material))
        self._grow_aabb(np.stack([v0, v1, v2]))

    def add_parallelogram(self, anchor, offset1, offset2, material: int):
        """Two triangles, split as the reference's parallelogram footprint
        (Cornell.cpp:33-66). UVs span the unit square."""
        a = np.asarray(anchor, np.float32)
        o1 = np.asarray(offset1, np.float32)
        o2 = np.asarray(offset2, np.float32)
        self.add_triangle(a, a + o1, a + o1 + o2, material,
                          uv0=(0, 0), uv1=(1, 0), uv2=(1, 1))
        self.add_triangle(a, a + o1 + o2, a + o2, material,
                          uv0=(0, 0), uv1=(1, 1), uv2=(0, 1))

    def add_mesh(self, vertices, faces, material: int, normals=None,
                 uvs=None):
        """Indexed triangle mesh (Scene.cpp:361-430 analog), vectorised for
        meshes of hundreds of thousands of faces."""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        if faces.size == 0:
            return
        v0 = vertices[faces[:, 0]]
        v1 = vertices[faces[:, 1]]
        v2 = vertices[faces[:, 2]]
        if normals is not None:
            normals = np.asarray(normals, np.float32)
            n0, n1, n2 = (normals[faces[:, i]] for i in range(3))
        else:
            ng = np.cross(v1 - v0, v2 - v0)
            ng = ng / np.maximum(np.linalg.norm(ng, axis=1, keepdims=True),
                                 1e-20)
            n0 = n1 = n2 = ng
        if uvs is not None:
            uvs = np.asarray(uvs, np.float32)
            uv0, uv1, uv2 = (uvs[faces[:, i]] for i in range(3))
        else:
            uv0 = uv1 = uv2 = np.zeros((faces.shape[0], 2), np.float32)
        mat = np.full((faces.shape[0],), material, np.int32)
        self._bulk.append(dict(v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
                               uv0=uv0, uv1=uv1, uv2=uv2, mat=mat))
        self._grow_aabb(vertices[np.unique(faces)])

    def add_triangle_soup(self, tris, material, normals=None, uvs=None):
        """Bulk triangle soup [T,3,3] (+ per-vertex normals [T,3,3], uvs
        [T,3,2], per-triangle or scalar material), with no per-face Python
        loop."""
        tris = np.asarray(tris, np.float32)
        if tris.size == 0:
            return
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        if normals is None:
            ng = np.cross(v1 - v0, v2 - v0)
            ng /= np.maximum(np.linalg.norm(ng, axis=1, keepdims=True),
                             1e-20)
            n0 = n1 = n2 = ng
        else:
            normals = np.asarray(normals, np.float32)
            n0, n1, n2 = normals[:, 0], normals[:, 1], normals[:, 2]
        if uvs is None:
            uv0 = uv1 = uv2 = np.zeros((tris.shape[0], 2), np.float32)
        else:
            uvs = np.asarray(uvs, np.float32)
            uv0, uv1, uv2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        mat = np.broadcast_to(np.asarray(material, np.int32),
                              (tris.shape[0],)).copy()
        self._bulk.append(dict(v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
                               uv0=uv0, uv1=uv1, uv2=uv2, mat=mat))
        self._grow_aabb(tris.reshape(-1, 3))

    @property
    def n_triangles(self) -> int:
        return (len(self._tris)
                + sum(b["mat"].shape[0] for b in self._bulk))

    def set_medium(self, sigma_s: float, sigma_a: float, aabb_min=None,
                   aabb_max=None):
        """Attach a homogeneous participating medium (the scene's box by
        default, like the reference's AABInstance in Cornell.cpp:175-179)."""
        self._medium = (float(sigma_s), float(sigma_a), aabb_min, aabb_max)

    def add_sphere(self, center, radius: float, material: int):
        c = np.asarray(center, np.float32)
        self._spheres.append((c, float(radius), material))
        self._grow_aabb(np.stack([c - radius, c + radius]))

    # ---------------------------------------------------------------- build
    def build(self, aabb_padding: float = 0.0,
              device: torch.device | str | None = None) -> Scene:
        """The Scene record on ``device`` (None: the CUDA card)."""
        device = resolve_device(device)
        if not self._tris and not self._bulk and not self._spheres:
            raise ValueError("empty scene")
        if not self._lights:
            raise ValueError("scene has no lights")

        def col(idx, width):
            if self._tris:
                return np.stack([t[idx] for t in self._tris])
            return np.zeros((0, width), np.float32)

        names = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
        cols = {nm: np.concatenate(
            [col(i, 2 if nm.startswith("uv") else 3)]
            + [b[nm] for b in self._bulk], axis=0)
            for i, nm in enumerate(names)}
        mats = np.concatenate(
            [np.asarray([t[9] for t in self._tris], np.int32).reshape(-1)]
            + [b["mat"] for b in self._bulk])
        v0, v1, v2 = cols["v0"], cols["v1"], cols["v2"]
        tangent, bitangent = compute_triangle_tangents(
            v0, v1, v2, cols["uv0"], cols["uv1"], cols["uv2"])

        def t(a, dtype=np.float32):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        geom = Geometry(
            tri_v0=t(v0), tri_e1=t(v1 - v0), tri_e2=t(v2 - v0),
            tri_n0=t(cols["n0"]), tri_n1=t(cols["n1"]), tri_n2=t(cols["n2"]),
            tri_uv0=t(cols["uv0"]), tri_uv1=t(cols["uv1"]),
            tri_uv2=t(cols["uv2"]),
            tri_tangent=t(tangent), tri_bitangent=t(bitangent),
            tri_mat=t(mats, np.int32),
            sph_center=t(np.stack([s[0] for s in self._spheres])
                         if self._spheres else np.zeros((0, 3))),
            sph_radius=t([s[1] for s in self._spheres]),
            sph_mat=t([s[2] for s in self._spheres], np.int32),
        )
        int_fields = ("kind", "light_index", "texture_id", "normal_map_id")
        mt = MaterialTable(**{
            f: t([m[f] for m in self._materials],
                 np.int32 if f in int_fields else np.float32)
            for f in MATERIAL_FIELDS})
        medium = None
        if self._medium is not None:
            ss, sa, mmin, mmax = self._medium
            medium = Medium(
                sigma_s=t(ss), sigma_a=t(sa),
                aabb_min=t(self._aabb_min if mmin is None else mmin),
                aabb_max=t(self._aabb_max if mmax is None else mmax))
        return Scene(geometry=geom, materials=mt, medium=medium,
                     lights=build_light_table(self._lights, device),
                     aabb_min=t(self._aabb_min - aabb_padding),
                     aabb_max=t(self._aabb_max + aabb_padding),
                     textures=build_atlas(self._textures, device=device),
                     normal_maps=build_atlas(self._normal_maps,
                                             device=device),
                     name=self.name)
