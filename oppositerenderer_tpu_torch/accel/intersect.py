"""Ray-scene intersection.

The counterpart of ``oppositerenderer_tpu/accel/intersect.py``. Scenes
with a BVH (above ``accel.bvh.BVH_AUTO_THRESHOLD`` triangles) walk it with
``bvh_kernels.traverse``/``traverse_any`` (kernel B5); the others test
every ray against every triangle with ``intersect_kernels.closest_hit_tris``
/ ``occluded_tris`` (kernels B1/B2, on the tables of :func:`dense_tables`;
the plain version's Moller-Trumbore takes the place of the JAX package's
``_tri_hits``). Each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors. Analytic spheres are tested in torch either way, and the
winner's attributes are interpolated in torch. One kernel launch takes
all rays of a call; ``chunk_size`` bounds the dense plain version's
[chunk, T] intermediates only. The JAX package's ``coherent`` flag routed
primary rays to its TPU packet kernel; on the GPU one traversal kernel
serves every ray population, so there is no such route.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.math import Tensor, cross, dot, normalize
from ..scene.types import EMITTER, Scene
from .bvh_kernels import traverse, traverse_any
from .intersect_kernels import (BIG, closest_hit_tris, occluded_tris,
                                tri9_from_geometry, triangle_records)


@dataclasses.dataclass
class Hit:
    """Closest-hit record (the reference's attribute/PRD fields, SoA)."""

    t: Tensor         # [N] hit distance (BIG on miss)
    prim: Tensor      # [N] int32 primitive id (tris then spheres), -1 on miss
    hit: Tensor       # [N] bool
    position: Tensor  # [N,3]
    ng: Tensor        # [N,3] geometric normal (as authored, not flipped)
    ns: Tensor        # [N,3] interpolated shading normal
    uv: Tensor        # [N,2] texture coords
    mat: Tensor       # [N] int32 material id (0 on miss; gate on .hit)


def _sphere_hits(o, d, center, radius, tmin, tmax):
    """Analytic sphere (sphere.cu:32-66): nearest root in range. [N,S]."""
    oc = o[:, None, :] - center[None, :, :]
    b = dot(d[:, None, :], oc)
    c = dot(oc, oc) - torch.square(radius)[None, :]
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    in0 = (t0 > tmin[:, None]) & (t0 < tmax[:, None])
    in1 = (t1 > tmin[:, None]) & (t1 < tmax[:, None])
    t = torch.where(in0, t0, t1)
    valid = (disc > 0.0) & (in0 | in1)
    return t, valid


def _finalize_hit(scene: Scene, o, d, tmin, tmax, t_best_tri, best_tri,
                  bu, bv) -> Hit:
    """Merge the best triangle hit with the analytic spheres and
    interpolate attributes."""
    g = scene.geometry
    T = g.n_triangles
    n = o.shape[0]

    if g.n_spheres > 0:
        t_sph, ok_sph = _sphere_hits(o, d, g.sph_center, g.sph_radius,
                                     tmin, tmax)
        t_sph = torch.where(ok_sph, t_sph, BIG)
        t_best_sph, best_sph = torch.min(t_sph, dim=1)
    else:
        best_sph = torch.zeros_like(best_tri)
        t_best_sph = torch.full_like(t_best_tri, BIG)

    use_sph = t_best_sph < t_best_tri
    t_hit = torch.minimum(t_best_tri, t_best_sph)
    hit = t_hit < BIG
    prim = torch.where(use_sph, T + best_sph, best_tri)
    prim = torch.where(hit, prim, -1).to(torch.int32)
    # missed lanes keep a sane position (o + d): ~1e30 positions would leak
    # inf/NaN into masked downstream math
    position = o + torch.where(hit, t_hit, 1.0)[:, None] * d

    # triangle attributes (barycentric interpolation, TriangleMesh.cu:60-116)
    w0 = 1.0 - bu - bv
    ns_tri = normalize(w0[:, None] * g.tri_n0[best_tri]
                       + bu[:, None] * g.tri_n1[best_tri]
                       + bv[:, None] * g.tri_n2[best_tri])
    ng_tri = normalize(cross(g.tri_e1[best_tri], g.tri_e2[best_tri]))
    mat_tri = g.tri_mat[best_tri]
    # uv interpolation serves textures only
    if scene.has_textures:
        uv_tri = (w0[:, None] * g.tri_uv0[best_tri]
                  + bu[:, None] * g.tri_uv1[best_tri]
                  + bv[:, None] * g.tri_uv2[best_tri])
    else:
        uv_tri = torch.zeros((n, 2), dtype=torch.float32, device=o.device)

    if g.n_spheres > 0:
        n_sph = normalize(position - g.sph_center[best_sph])
        use = use_sph[:, None]
        ns = torch.where(use, n_sph, ns_tri)
        ng = torch.where(use, n_sph, ng_tri)
        mat = torch.where(use_sph, g.sph_mat[best_sph], mat_tri)
        uv = torch.where(use, 0.0, uv_tri)
    else:
        ns, ng, mat, uv = ns_tri, ng_tri, mat_tri, uv_tri

    return Hit(t=torch.where(hit, t_hit, BIG), prim=prim, hit=hit,
               position=position, ng=ng, ns=ns, uv=uv,
               mat=torch.where(hit, mat, 0).to(torch.int32))


def occluder_mask(scene: Scene, prim_mat: Tensor) -> Tensor:
    """Everything but emitters occludes (gatherAnyHitOnNonEmitter /
    DiffuseEmitter.cu:63-68)."""
    return scene.materials.kind[prim_mat.long()] != EMITTER


def dense_tables(scene: Scene) -> tuple[Tensor, Tensor]:
    """The dense route's triangle record tables (``triangle_records``):
    B1's [T, 12], every triangle, and B2's [T_occ, 12], the triangles that
    are no emitter. Built once per scene, and again only if its geometry
    or materials object is replaced."""
    g, m = scene.geometry, scene.materials
    cache = scene.dense_cache
    if cache is None or cache[0] is not g or cache[1] is not m:
        tri9 = tri9_from_geometry(g)
        cache = (g, m, triangle_records(tri9),
                 triangle_records(tri9, occluder_mask(scene, g.tri_mat)))
        scene.dense_cache = cache
    return cache[2], cache[3]


def intersect(scene: Scene, o: Tensor, d: Tensor, tmin: Tensor,
              tmax: Tensor, chunk_size: int | None = None) -> Hit:
    """Closest hit for rays [N,3] against the whole scene: through its BVH
    when it has one, else by brute force."""
    g = scene.geometry
    if scene.bvh is not None:
        t, idx, bu, bv, found = traverse(
            scene.bvh, o.contiguous(), d.contiguous(), tmin.contiguous(),
            tmax.contiguous())
        best_tri = torch.clamp(idx, 0, max(g.n_triangles - 1, 0)).long()
        t_best_tri = torch.where(found, t, BIG)
        return _finalize_hit(scene, o, d, tmin, tmax, t_best_tri, best_tri,
                             bu, bv)
    t, idx, bu, bv = closest_hit_tris(
        o.contiguous(), d.contiguous(), tmin.contiguous(),
        tmax.contiguous(), dense_tables(scene)[0], chunk_size)
    best_tri = torch.clamp(idx, 0, max(g.n_triangles - 1, 0)).long()
    t_best_tri = torch.where(idx >= 0, t, BIG)
    return _finalize_hit(scene, o, d, tmin, tmax, t_best_tri, best_tri,
                         bu, bv)


def occluded(scene: Scene, o: Tensor, d: Tensor, tmin: Tensor,
             tmax: Tensor, chunk_size: int | None = None) -> Tensor:
    """Shadow-ray test [N] -> bool. Emitter surfaces never occlude (in a
    BVH their flags are baked into the leaf rows)."""
    g = scene.geometry
    if scene.bvh is not None:
        occ = traverse_any(scene.bvh, o.contiguous(), d.contiguous(),
                           tmin.contiguous(), tmax.contiguous())
    else:
        occ = occluded_tris(o.contiguous(), d.contiguous(),
                            tmin.contiguous(), tmax.contiguous(),
                            dense_tables(scene)[1], chunk_size)
    if g.n_spheres > 0:
        _, ok_sph = _sphere_hits(o, d, g.sph_center, g.sph_radius,
                                 tmin, tmax)
        occ = occ | torch.any(ok_sph & occluder_mask(scene, g.sph_mat)[None],
                              dim=1)
    return occ
