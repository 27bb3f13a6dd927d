"""Conference: procedural Conference-Room-class benchmark scene.

The counterpart of ``oppositerenderer_tpu/scene/conference.py``, with the
same numpy geometry: an enclosed meeting room (a long rounded-edge table,
rows of slatted chairs with turned legs, wall panelling, a window band and
ceiling light panels) standing in for the reference's external Greg Ward
conference room (README.md:15). Interior light transport dominated by
indirect bounces. ~185k triangles at detail=1.0 (counts grow
O(detail^2)). Materials: DIFFUSE walls, a TEXTURED carpet, a GLOSSY table
top, a MIRROR whiteboard and a GLASS pitcher, with AREA ceiling panels and
an AREA window band. Above ``BVH_AUTO_THRESHOLD`` triangles the scene
carries a BVH.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import BVH_AUTO_THRESHOLD, build_scene_bvh
from ..camera import Camera
from ..lights import make_area_light
from .builder import SceneBuilder
from .types import Scene
from .atrium import _checker_texture, _grid, _lathe, _plane

ROOM_L = 12.0   # x
ROOM_W = 8.0    # z
ROOM_H = 3.2    # y


def _box(b, mat, center, size, n=1):
    """Axis-aligned box out of subdivided planes (outward normals)."""
    cx, cy, cz = center
    sx, sy, sz = size
    x0, x1 = cx - sx / 2, cx + sx / 2
    y0, y1 = cy - sy / 2, cy + sy / 2
    z0, z1 = cz - sz / 2, cz + sz / 2
    _plane(b, mat, (x0, y1, z0), (sx, 0, 0), (0, 0, sz), n, n)  # top
    _plane(b, mat, (x0, y0, z1), (sx, 0, 0), (0, 0, -sz), n, n)  # bottom
    _plane(b, mat, (x0, y0, z0), (0, sy, 0), (sx, 0, 0), n, n)
    _plane(b, mat, (x0, y0, z1), (sx, 0, 0), (0, sy, 0), n, n)
    _plane(b, mat, (x1, y0, z1), (0, 0, -sz), (0, sy, 0), n, n)
    _plane(b, mat, (x0, y0, z0), (0, 0, sz), (0, sy, 0), n, n)


def _chair(b, mats, cx, cz, facing, d):
    """Slatted chair: 4 turned legs, seat, slatted back."""
    wood, seat_m = mats
    s = 0.5          # seat size
    h = 0.45         # seat height
    ca, sa = float(np.cos(facing)), float(np.sin(facing))

    def rot(px, pz):
        return (cx + ca * px - sa * pz, cz + sa * px + ca * pz)

    seg = max(8, int(18 * d))
    # densify the leg profile (turned-wood look): 12 interpolated rings
    base_r = np.array([0.03, 0.022, 0.03, 0.02], np.float32)
    base_y = np.array([0.0, 0.15, 0.3, h], np.float32)
    prof_y = np.linspace(0.0, h, 12).astype(np.float32)
    prof_r = (np.interp(prof_y, base_y, base_r)
              * (1.0 + 0.12 * np.sin(prof_y * 40.0))).astype(np.float32)
    for px, pz in ((-s / 2, -s / 2), (s / 2, -s / 2),
                   (-s / 2, s / 2), (s / 2, s / 2)):
        x, z = rot(px * 0.9, pz * 0.9)
        _lathe(b, wood, (x, 0.0, z), prof_r, prof_y, seg)
    # seat: thin box
    x, z = rot(0.0, 0.0)
    n = max(2, int(6 * d))
    _box(b, seat_m, (x, h + 0.02, z), (s, 0.04, s), n)
    # back: 5 vertical slats + top rail, on the -px side, rotated
    n_sl = 7
    for i in range(n_sl):
        px = -s / 2 + 0.04
        pz = -s / 2 + (i + 0.5) * s / n_sl
        x, z = rot(px, pz)
        _box(b, wood, (x, h + 0.3, z), (0.02, 0.5, 0.05),
             max(1, int(3 * d)))
    x, z = rot(-s / 2 + 0.04, 0.0)
    _box(b, wood, (x, h + 0.58, z), (0.03, 0.06, s), n)


def make_conference(detail: float = 1.0,
                    device: torch.device | str = "cpu"
                    ) -> tuple[Scene, Camera]:
    d = max(0.05, float(detail))
    b = SceneBuilder(f"Conference:{detail:g}")

    # materials
    wall = b.add_diffuse((0.72, 0.7, 0.64))
    ceil_m = b.add_diffuse((0.85, 0.85, 0.85))
    carpet_tex = b.add_texture_image(
        _checker_texture(res=128, c0=(0.28, 0.3, 0.38),
                         c1=(0.22, 0.24, 0.3)))
    carpet = b.add_textured((0.9, 0.9, 0.9), carpet_tex)
    wood = b.add_diffuse((0.42, 0.27, 0.14))
    seat_m = b.add_diffuse((0.5, 0.12, 0.1))
    table_top = b.add_glossy((0.3, 0.2, 0.1), (0.5, 0.5, 0.5), 80.0)
    trim = b.add_diffuse((0.55, 0.52, 0.46))
    board = b.add_mirror((0.85, 0.88, 0.9))
    glass = b.add_glass(1.5)

    n_wall = max(2, int(40 * d))
    # room shell (inward normals)
    _plane(b, carpet, (0, 0, 0) if False else (-ROOM_L / 2, 0, -ROOM_W / 2),
           (0, 0, ROOM_W), (ROOM_L, 0, 0), n_wall, n_wall)
    _plane(b, ceil_m, (-ROOM_L / 2, ROOM_H, -ROOM_W / 2),
           (ROOM_L, 0, 0), (0, 0, ROOM_W), n_wall, n_wall)
    _plane(b, wall, (-ROOM_L / 2, 0, -ROOM_W / 2),
           (ROOM_L, 0, 0), (0, ROOM_H, 0), n_wall, n_wall // 2)
    _plane(b, wall, (ROOM_L / 2, 0, ROOM_W / 2),
           (-ROOM_L, 0, 0), (0, ROOM_H, 0), n_wall, n_wall // 2)
    _plane(b, wall, (ROOM_L / 2, 0, -ROOM_W / 2),
           (0, 0, ROOM_W), (0, ROOM_H, 0), n_wall // 2, n_wall // 2)
    _plane(b, wall, (-ROOM_L / 2, 0, ROOM_W / 2),
           (0, 0, -ROOM_W), (0, ROOM_H, 0), n_wall // 2, n_wall // 2)

    # wall panelling strips (adds triangle volume + occlusion detail)
    n_panel = max(4, int(18 * d))
    for i in range(n_panel):
        x = -ROOM_L / 2 + (i + 0.5) * ROOM_L / n_panel
        _box(b, trim, (x, 1.0, -ROOM_W / 2 + 0.03), (0.5, 2.0, 0.05),
             max(1, int(8 * d)))
        _box(b, trim, (x, 1.0, ROOM_W / 2 - 0.03), (0.5, 2.0, 0.05),
             max(1, int(8 * d)))

    # conference table: rounded-end top (lathe caps + box middle) + legs
    tl, tw, th = 5.0, 1.8, 0.74
    n_t = max(2, int(24 * d))
    _box(b, table_top, (0, th, 0), (tl - tw, 0.06, tw), n_t)
    seg_t = max(8, int(56 * d))
    cap_r = np.array([tw / 2, tw / 2, 0.0], np.float32)
    cap_y = np.array([0.0, 0.055, 0.06], np.float32)
    _lathe(b, table_top, ((tl - tw) / 2, th - 0.03, 0), cap_r, cap_y,
           seg_t)
    _lathe(b, table_top, (-(tl - tw) / 2, th - 0.03, 0), cap_r, cap_y,
           seg_t)
    leg_r = np.array([0.12, 0.08, 0.1, 0.06], np.float32)
    leg_y = np.array([0.0, 0.2, 0.5, th - 0.06], np.float32)
    for lx in (-tl / 3, 0.0, tl / 3):
        _lathe(b, wood, (lx, 0.0, 0.0), leg_r, leg_y,
               max(8, int(40 * d)))

    # chairs around the table + audience rows
    n_side = max(3, int(5 * d) + 2)
    for i in range(n_side):
        x = -tl / 2 + 0.7 + i * (tl - 1.4) / max(1, n_side - 1)
        _chair(b, (wood, seat_m), x, tw / 2 + 0.45, np.pi / 2, d)
        _chair(b, (wood, seat_m), x, -tw / 2 - 0.45, -np.pi / 2, d)
    _chair(b, (wood, seat_m), tl / 2 + 0.5, 0.0, np.pi, d)
    _chair(b, (wood, seat_m), -tl / 2 - 0.5, 0.0, 0.0, d)
    rows = max(1, int(3 * d))
    for r in range(rows):
        for i in range(max(4, int(9 * d))):
            x = -ROOM_L / 2 + 1.0 + i * 1.1
            _chair(b, (wood, seat_m), x, ROOM_W / 2 - 0.9 - 0.8 * r,
                   np.pi / 2, d)

    # whiteboard (mirror) on the end wall + glass pitcher on the table
    _plane(b, board, (ROOM_L / 2 - 0.02, 1.0, -1.2),
           (0, 0, 2.4), (0, 1.2, 0), 2, 2)
    b.add_sphere((0.4, th + 0.2, 0.2), 0.14, glass)

    # lights: two ceiling panels + window band on one long wall
    panels = []
    for px in (-ROOM_L / 5, ROOM_L / 5):
        anchor = (px - 0.8, ROOM_H - 0.02, -0.6)
        v1, v2 = (1.6, 0.0, 0.0), (0.0, 0.0, 1.2)
        power = (420.0, 410.0, 380.0)
        light = make_area_light(power, anchor, v1, v2)
        em = b.add_emitter(power, light=light)
        b.add_parallelogram(anchor, v1, v2, em)
        panels.append(em)
    w_anchor = (-ROOM_L / 2 + 1.5, 1.1, -ROOM_W / 2 + 0.01)
    w_v1, w_v2 = (4.0, 0.0, 0.0), (0.0, 1.4, 0.0)
    w_power = (1150.0, 1200.0, 1350.0)
    wl = make_area_light(w_power, w_anchor, w_v1, w_v2)
    em_w = b.add_emitter(w_power, light=wl)
    b.add_parallelogram(w_anchor, w_v1, w_v2, em_w)

    scene = b.build(aabb_padding=0.05, device=device)
    if scene.geometry.n_triangles > BVH_AUTO_THRESHOLD:
        scene, bvh = build_scene_bvh(scene)
        scene = dataclasses.replace(scene, bvh=bvh)
    camera = Camera.make(eye=(-4.6, 1.7, 2.9), lookat=(1.2, 0.8, -0.6),
                         hfov=65.0, vfov=50.0, device=device)
    return scene, camera
