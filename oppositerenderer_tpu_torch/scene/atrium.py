"""Atrium: procedural Sponza-class stress scene.

The counterpart of ``oppositerenderer_tpu/scene/atrium.py``, with the same
numpy geometry, textures and lights: a two-story colonnaded courtyard hall
with arches, banners, balustrades and vases, ~253k triangles at
detail=1.0 (counts grow O(detail^2)). It stands in for the reference's
external Sponza download (README.md:15). Procedural checker and brick
textures with a brick normal map cover the TEXTURED material path, the
columns are GLOSSY, the decor spheres MIRROR and GLASS, and the sun is a
distant POINT light plus an AREA sky strip at the opening. Above
``BVH_AUTO_THRESHOLD`` triangles the scene carries a BVH.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import BVH_AUTO_THRESHOLD, build_scene_bvh
from ..camera import Camera
from ..devices import resolve_device
from ..lights import make_area_light, make_point_light
from .builder import SceneBuilder
from .types import Scene

# hall dimensions (meters-ish)
HALL_L = 36.0   # x
HALL_W = 16.0   # z
HALL_H = 12.0   # y
STORY_H = 5.0


# --------------------------------------------------------------------------
# mesh primitives (vectorized)
# --------------------------------------------------------------------------

def _grid(nx: int, nz: int):
    """Unit-square grid vertices [n,2] + faces [m,3]."""
    xs = np.linspace(0.0, 1.0, nx + 1, dtype=np.float32)
    zs = np.linspace(0.0, 1.0, nz + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    uv = np.stack([gx.ravel(), gz.ravel()], axis=1)
    i = np.arange(nx + 1, dtype=np.int64)
    j = np.arange(nz + 1, dtype=np.int64)
    vid = (i[:, None] * (nz + 1) + j[None, :])
    q00 = vid[:-1, :-1].ravel()
    q10 = vid[1:, :-1].ravel()
    q01 = vid[:-1, 1:].ravel()
    q11 = vid[1:, 1:].ravel()
    faces = np.concatenate([np.stack([q00, q10, q11], 1),
                            np.stack([q00, q11, q01], 1)])
    return uv, faces


def _plane(builder, mat, anchor, e1, e2, nx, nz, uv_scale=(1.0, 1.0),
           displace=None):
    """Subdivided parallelogram; optional height displacement along the
    plane normal (displace(u, v) -> h)."""
    uv, faces = _grid(nx, nz)
    anchor = np.asarray(anchor, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    verts = anchor + uv[:, :1] * e1 + uv[:, 1:] * e2
    if displace is not None:
        n = np.cross(e1, e2)
        n = n / max(np.linalg.norm(n), 1e-20)
        verts = verts + displace(uv[:, 0], uv[:, 1])[:, None] * n
    builder.add_mesh(verts, faces, mat,
                     uvs=uv * np.asarray(uv_scale, np.float32))


def _lathe(builder, mat, center, profile_r, profile_y, segments: int,
           uv_v=None):
    """Surface of revolution: profile (r_i, y_i) swept around +y at
    ``center``. Smooth normals from the profile slope."""
    center = np.asarray(center, np.float32)
    r = np.asarray(profile_r, np.float32)
    y = np.asarray(profile_y, np.float32)
    k = r.shape[0]
    ang = np.linspace(0.0, 2.0 * np.pi, segments + 1, dtype=np.float32)
    ca, sa = np.cos(ang), np.sin(ang)
    # vertices [k, segments+1, 3]
    vx = r[:, None] * ca[None, :]
    vz = r[:, None] * sa[None, :]
    vy = np.broadcast_to(y[:, None], vx.shape)
    verts = np.stack([vx, vy, vz], axis=-1).reshape(-1, 3) + center
    # profile slope -> normals
    dr = np.gradient(r)
    dy = np.gradient(y)
    ln = np.maximum(np.hypot(dy, dr), 1e-9)
    nr, ny = dy / ln, -dr / ln
    nx = nr[:, None] * ca[None, :]
    nz = nr[:, None] * sa[None, :]
    nyv = np.broadcast_to(ny[:, None], nx.shape)
    normals = np.stack([nx, nyv, nz], axis=-1).reshape(-1, 3)
    s1 = segments + 1
    i = np.arange(k - 1, dtype=np.int64)
    j = np.arange(segments, dtype=np.int64)
    v00 = (i[:, None] * s1 + j[None, :]).ravel()
    v01 = v00 + 1
    v10 = v00 + s1
    v11 = v10 + 1
    faces = np.concatenate([np.stack([v00, v10, v11], 1),
                            np.stack([v00, v11, v01], 1)])
    uu = np.broadcast_to(ang[None, :] / (2 * np.pi), vx.shape).reshape(-1)
    vv = np.broadcast_to(
        (y[:, None] - y.min()) / max(y.max() - y.min(), 1e-9),
        vx.shape).reshape(-1)
    builder.add_mesh(verts, faces, mat, normals=normals,
                     uvs=np.stack([uu, vv], 1))


def _arch(builder, mat, p0, p1, height, width, segments: int, rings: int):
    """Half-torus arch between two column tops."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    mid = 0.5 * (p0 + p1)
    axis = p1 - p0
    span = np.linalg.norm(axis)
    axis = axis / max(span, 1e-9)
    up = np.asarray([0, 1, 0], np.float32)
    out = np.cross(axis, up)
    t = np.linspace(0.0, np.pi, segments + 1, dtype=np.float32)
    ring_c = (mid - axis * (span / 2) * np.cos(t)[:, None]
              + up * height * np.sin(t)[:, None])
    phi = np.linspace(0.0, 2 * np.pi, rings + 1, dtype=np.float32)
    # tube frame: axis x up rotated along the arc
    tang = (axis * (span / 2) * np.sin(t)[:, None]
            + up * height * np.cos(t)[:, None])
    tang = tang / np.maximum(np.linalg.norm(tang, axis=1, keepdims=True),
                             1e-9)
    nrm1 = np.cross(tang, out)
    verts = (ring_c[:, None, :]
             + (np.cos(phi)[None, :, None] * out[None, None, :]
                + np.sin(phi)[None, :, None] * nrm1[:, None, :])
             * (width / 2))
    k, s1 = segments + 1, rings + 1
    normals = verts - ring_c[:, None, :]
    normals = normals / np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    i = np.arange(segments, dtype=np.int64)
    j = np.arange(rings, dtype=np.int64)
    v00 = (i[:, None] * s1 + j[None, :]).ravel()
    v01 = v00 + 1
    v10 = v00 + s1
    v11 = v10 + 1
    faces = np.concatenate([np.stack([v00, v10, v11], 1),
                            np.stack([v00, v11, v01], 1)])
    builder.add_mesh(verts.reshape(-1, 3), faces, mat,
                     normals=normals.reshape(-1, 3))


# --------------------------------------------------------------------------
# procedural textures
# --------------------------------------------------------------------------

def _checker_texture(res=256, c0=(0.85, 0.82, 0.75), c1=(0.45, 0.42, 0.4),
                     tiles=8):
    ij = np.indices((res, res)) * tiles // res
    mask = ((ij[0] + ij[1]) % 2).astype(np.float32)[..., None]
    return (np.asarray(c0, np.float32) * (1 - mask)
            + np.asarray(c1, np.float32) * mask)


def _brick_texture(res=256, tiles=6):
    y, x = np.indices((res, res)).astype(np.float32) / res * tiles
    row = np.floor(y)
    x = x + 0.5 * (row % 2)
    fy, fx = y - np.floor(y), x - np.floor(x)
    mortar = ((fy < 0.08) | (fx < 0.06)).astype(np.float32)
    rng = np.random.default_rng(7)
    shade = rng.uniform(0.75, 1.0, (int(tiles) + 1, int(tiles * 2) + 2))
    bx = np.floor(x).astype(int) % shade.shape[1]
    by = np.floor(y).astype(int) % shade.shape[0]
    base = np.asarray([0.62, 0.34, 0.27], np.float32) * \
        shade[by, bx][..., None]
    grey = np.asarray([0.7, 0.7, 0.68], np.float32)
    rgb = base * (1 - mortar[..., None]) + grey * mortar[..., None]
    # tangent-space normal map from the mortar height field
    h = 1.0 - mortar
    gx = np.roll(h, -1, 1) - h
    gy = np.roll(h, -1, 0) - h
    n = np.stack([-gx * 2.0, -gy * 2.0, np.ones_like(h)], axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return rgb.astype(np.float32), (0.5 * (n + 1.0)).astype(np.float32)


# --------------------------------------------------------------------------
# the scene
# --------------------------------------------------------------------------

def make_atrium(detail: float = 1.0,
                device: torch.device | str | None = None
                ) -> tuple[Scene, Camera]:
    """Sponza-class two-story atrium. ~260k tris at detail=1.0."""
    device = resolve_device(device)
    b = SceneBuilder("Atrium")
    # internal scale calibrated so detail=1.0 lands at ~260k triangles
    # (Crytek Sponza class); counts grow O(detail^2)
    d = max(0.1, float(detail)) * 1.9

    floor_tex = b.add_texture_image(_checker_texture())
    brick_rgb, brick_nm = _brick_texture()
    brick_tex = b.add_texture_image(brick_rgb)
    brick_n = b.add_normal_map_image(brick_nm)

    m_floor = b.add_textured((1, 1, 1), floor_tex)
    m_wall = b.add_textured((1, 1, 1), brick_tex, normal_map_id=brick_n)
    m_column = b.add_glossy((0.55, 0.52, 0.46), (0.35, 0.35, 0.35), 40.0)
    m_trim = b.add_diffuse((0.58, 0.55, 0.5))
    m_banner = [b.add_diffuse(c) for c in
                ((0.55, 0.12, 0.12), (0.12, 0.3, 0.55), (0.5, 0.42, 0.1))]
    m_mirror = b.add_mirror((0.9, 0.9, 0.9))
    m_glass = b.add_glass(1.5)

    gr = max(8, int(48 * d))

    def rocky(amplitude):
        rng = np.random.default_rng(3)
        def f(u, v):
            h = np.zeros_like(u)
            for k in range(1, 4):
                ph = rng.uniform(0, 2 * np.pi, 2)
                h += (np.sin(2 * np.pi * k * u * 1.7 + ph[0])
                      * np.cos(2 * np.pi * k * v * 1.3 + ph[1])) / k
            return (amplitude * h).astype(np.float32)
        return f

    # floor / walls / ceiling ring (the courtyard is open above the middle)
    _plane(b, m_floor, (0, 0, 0), (HALL_L, 0, 0), (0, 0, HALL_W),
           gr, gr // 2, uv_scale=(12, 6))
    _plane(b, m_wall, (0, 0, 0), (0, 0, HALL_W), (0, HALL_H, 0),
           gr // 2, gr // 2, uv_scale=(4, 3))                      # x=0
    _plane(b, m_wall, (HALL_L, 0, HALL_W), (0, 0, -HALL_W),
           (0, HALL_H, 0), gr // 2, gr // 2, uv_scale=(4, 3))      # x=L
    _plane(b, m_wall, (HALL_L, 0, 0), (-HALL_L, 0, 0), (0, HALL_H, 0),
           gr, gr // 2, uv_scale=(9, 3))                           # z=0
    _plane(b, m_wall, (0, 0, HALL_W), (HALL_L, 0, 0), (0, HALL_H, 0),
           gr, gr // 2, uv_scale=(9, 3))                           # z=W
    # ceiling ring (opening in the middle third)
    ring = HALL_W / 4
    _plane(b, m_wall, (0, HALL_H, 0), (HALL_L, 0, 0), (0, 0, ring),
           gr, gr // 8, uv_scale=(9, 1))
    _plane(b, m_wall, (0, HALL_H, HALL_W), (HALL_L, 0, 0), (0, 0, -ring),
           gr, gr // 8, uv_scale=(9, 1))

    # colonnades: two stories, two rows
    n_cols = max(4, int(10 * d))
    seg = max(8, int(22 * d))
    xs = np.linspace(4.0, HALL_L - 4.0, n_cols)
    col_profile_y = np.asarray([0.0, 0.25, 0.3, STORY_H - 0.5,
                                STORY_H - 0.2, STORY_H], np.float32)
    col_profile_r = np.asarray([0.55, 0.5, 0.34, 0.34, 0.52, 0.56],
                               np.float32)
    for story in range(2):
        y0 = story * STORY_H
        for z in (ring, HALL_W - ring):
            for x in xs:
                _lathe(b, m_column, (x, y0, z),
                       col_profile_r, col_profile_y + 0.0, seg)
            # arches between neighbours
            for i in range(n_cols - 1):
                _arch(b, m_trim, (xs[i], y0 + STORY_H - 0.3, z),
                      (xs[i + 1], y0 + STORY_H - 0.3, z),
                      0.9, 0.5, max(6, int(14 * d)), max(4, int(8 * d)))
        # gallery slab between the rows at the story top
        _plane(b, m_floor, (2.0, y0 + STORY_H, 0), (HALL_L - 4.0, 0, 0),
               (0, 0, ring), gr, gr // 8, uv_scale=(10, 1))
        _plane(b, m_floor, (2.0, y0 + STORY_H, HALL_W),
               (HALL_L - 4.0, 0, 0), (0, 0, -ring), gr, gr // 8,
               uv_scale=(10, 1))

    # balustrade posts on the first-story galleries
    n_posts = max(10, int(40 * d))
    post_r = np.asarray([0.09, 0.13, 0.05, 0.12, 0.08], np.float32)
    post_y = np.asarray([0.0, 0.22, 0.5, 0.78, 1.0], np.float32)
    for x in np.linspace(3.0, HALL_L - 3.0, n_posts):
        for z in (ring + 0.2, HALL_W - ring - 0.2):
            _lathe(b, m_trim, (x, STORY_H, z), post_r, post_y,
                   max(6, int(10 * d)))

    # hanging banners (displaced cloth)
    n_ban = max(3, int(9 * d))
    for i, x in enumerate(np.linspace(6.0, HALL_L - 6.0, n_ban)):
        for z, sgn in ((ring + 0.05, 1.0), (HALL_W - ring - 0.05, -1.0)):
            _plane(b, m_banner[i % 3], (x - 1.0, STORY_H + 3.8, z),
                   (2.0, 0, 0), (0, -3.0, sgn * 0.4),
                   max(6, int(16 * d)), max(8, int(24 * d)),
                   displace=rocky(0.08))

    # vases on the gallery + decor spheres on the floor
    vase_r = np.asarray([0.02, 0.28, 0.34, 0.18, 0.1, 0.16], np.float32)
    vase_y = np.asarray([0.0, 0.12, 0.5, 0.78, 0.9, 1.05], np.float32)
    for x in np.linspace(5.0, HALL_L - 5.0, max(4, int(12 * d))):
        _lathe(b, m_trim, (x, STORY_H + 0.02, ring + 0.6),
               vase_r, vase_y, max(8, int(16 * d)))
    b.add_sphere((HALL_L * 0.35, 1.0, HALL_W / 2), 1.0, m_mirror)
    b.add_sphere((HALL_L * 0.55, 0.8, HALL_W / 2 + 1.8), 0.8, m_glass)

    # lights: sun (distant point through the opening) + sky strip emitter
    b.add_light(make_point_light(
        power=(6.0e5, 5.6e5, 5.0e5),
        position=(HALL_L * 0.5 + 14.0, 60.0, HALL_W * 0.5 - 10.0)))
    sky = make_area_light(power=(15000.0, 16800.0, 19200.0),
                          anchor=(2.0, HALL_H - 0.02, ring),
                          v1=(HALL_L - 4.0, 0, 0),
                          v2=(0, 0, HALL_W - 2 * ring))
    m_sky = b.add_emitter((15000.0, 16800.0, 19200.0), light=sky)
    b.add_parallelogram((2.0, HALL_H - 0.02, ring), (HALL_L - 4.0, 0, 0),
                        (0, 0, HALL_W - 2 * ring), m_sky)

    scene = b.build(aabb_padding=0.5, device=device)
    if scene.geometry.n_triangles > BVH_AUTO_THRESHOLD:
        scene, bvh = build_scene_bvh(scene)
        scene = dataclasses.replace(scene, bvh=bvh)

    camera = Camera.make(eye=(2.5, 2.2, HALL_W * 0.5 - 2.2),
                         lookat=(HALL_L * 0.7, 3.5, HALL_W * 0.5 + 1.0),
                         up=(0, 1, 0), hfov=62.0, vfov=62.0, device=device)
    return scene, camera
