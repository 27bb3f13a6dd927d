"""Procedural Cornell scenes + factory.

The counterpart of ``oppositerenderer_tpu/scene/cornell.py``: geometry,
colours, light powers and cameras of the reference's ``scene/Cornell.cpp``
and ``scene/CornellSmall.cpp``, and the name->scene mapping of
``Gui/scene/SceneFactory.cpp:24-80`` for the eight Cornell scenes and the
procedural BVH scenes.
"""
from __future__ import annotations

import enum

import torch

from ..camera import Camera
from ..devices import resolve_device
from ..lights import make_area_light, make_point_light
from .builder import SceneBuilder
from .types import Scene


class CornellSmallConfig(enum.IntFlag):
    """CornellSmall::Config (CornellSmall.h:24-41)."""

    SMALLVCM_COLORS = 1 << 0
    LIGHT_AREA = 1 << 1
    LIGHT_AREA_UPWARDS = 1 << 2
    LIGHT_POINT = 1 << 3
    LIGHT_POINT_STRONG = 1 << 4
    LIGHT_POINT_DISTANT = 1 << 5
    BACKWALL_BLUE = 1 << 6
    FLOOR_MIRROR = 1 << 7
    FLOOR_GLOSSY = 1 << 8
    BLOCKS = 1 << 9
    LARGE_MIRROR_SPHERE = 1 << 10
    LARGE_GLASS_SPHERE = 1 << 11
    SMALL_MIRROR_SPHERE = 1 << 12
    SMALL_GLASS_SPHERE = 1 << 13
    DEFAULT = LIGHT_AREA | BLOCKS


def make_cornell(device: torch.device | str | None = None
                 ) -> tuple[Scene, Camera]:
    """Classic Cornell box (Cornell.cpp:20-31, 69-196; camera :203-211)."""
    device = resolve_device(device)
    b = SceneBuilder("Cornell")
    white = b.add_diffuse((0.8, 0.8, 0.8))
    green = b.add_diffuse((0.05, 0.8, 0.05))
    red = b.add_diffuse((1.0, 0.05, 0.05))

    b.add_parallelogram((0, 0, 0), (0, 0, 559.2), (556, 0, 0), white)  # floor
    b.add_parallelogram((0, 548.80, 0), (556, 0, 0), (0, 0, 559.2), white)
    b.add_parallelogram((0, 0, 559.2), (0, 548.8, 0), (556, 0, 0), white)
    b.add_parallelogram((0, 0, 0), (0, 548.8, 0), (0, 0, 559.2), green)
    b.add_parallelogram((556, 0, 0), (0, 0, 559.2), (0, 548.8, 0), red)

    anchor, v1, v2 = (343.0, 548.7999, 227.0), (0, 0, 105.0), (-130.0, 0, 0)
    power = (0.5e6, 0.4e6, 0.2e6)
    em = b.add_emitter(power, kd=(1, 1, 1),
                       light=make_area_light(power, anchor, v1, v2))
    b.add_parallelogram(anchor, v1, v2, em)

    scene = b.build(aabb_padding=5.0, device=device)
    camera = Camera.make(eye=(278, 273, -850), lookat=(278, 273, 0),
                         up=(0, 1, 0), hfov=35.0, vfov=35.0, device=device)
    return scene, camera


def make_cornell_small(config: CornellSmallConfig = CornellSmallConfig.DEFAULT,
                       device: torch.device | str | None = None
                       ) -> tuple[Scene, Camera]:
    """SmallVCM-style box (CornellSmall.cpp:25-330; camera :333-341)."""
    device = resolve_device(device)
    C = CornellSmallConfig
    b = SceneBuilder("CornellSmall")

    if config & C.SMALLVCM_COLORS:
        white = b.add_diffuse((0.803922, 0.803922, 0.803922))
        green = b.add_diffuse((0.156863, 0.803922, 0.172549))
        red = b.add_diffuse((0.803922, 0.152941, 0.152941))
    else:
        white = b.add_diffuse((0.8, 0.8, 0.8))
        green = b.add_diffuse((0.05, 0.8, 0.05))
        red = b.add_diffuse((1.0, 0.05, 0.05))
    blue = b.add_diffuse((0.156863, 0.172549, 0.803922))
    mirror = b.add_mirror((1.0, 1.0, 1.0))
    glossy_white = b.add_glossy((0.1, 0.1, 0.1), (0.7, 0.7, 0.7), 90.0)
    glass = b.add_glass(1.6, kr=(1, 1, 1), kt=(1, 1, 1))

    mat_floor = white
    if config & C.FLOOR_MIRROR:
        mat_floor = mirror
    elif config & C.FLOOR_GLOSSY:
        mat_floor = glossy_white
    mat_back = blue if config & C.BACKWALL_BLUE else white
    # SmallVCM colours swap the wall colours (CornellSmall.cpp:166-173)
    mat_right = red if config & C.SMALLVCM_COLORS else green
    mat_left = green if config & C.SMALLVCM_COLORS else red

    b.add_parallelogram((0, 0, 0), (0, 0, 2.5), (2.5, 0, 0), mat_floor)
    if not (config & C.LIGHT_POINT_DISTANT):   # distant light: open ceiling
        b.add_parallelogram((0, 2.5, 0), (2.5, 0, 0), (0, 0, 2.5), white)
    b.add_parallelogram((0, 0, 2.5), (0, 2.5, 0), (2.5, 0, 0), mat_back)
    b.add_parallelogram((0, 0, 0), (0, 2.5, 0), (0, 0, 2.5), mat_right)
    b.add_parallelogram((2.5, 0, 0), (0, 0, 2.5), (0, 2.5, 0), mat_left)

    if config & C.BLOCKS:
        s = 1.0 / 220.0
        blocks = [
            ((130, 165, 65), (-48, 0, 160), (160, 0, 49)),
            ((290, 0, 114), (0, 165, 0), (-50, 0, 158)),
            ((130, 0, 65), (0, 165, 0), (160, 0, 49)),
            ((82, 0, 225), (0, 165, 0), (48, 0, -160)),
            ((240, 0, 272), (0, 165, 0), (-158, 0, -47)),
            ((423, 340, 247), (-158, 0, 49), (49, 0, 159)),
            ((423, 0, 247), (0, 340, 0), (49, 0, 159)),
            ((472, 0, 406), (0, 340, 0), (-158, 0, 50)),
            ((314, 0, 456), (0, 340, 0), (-49, 0, -160)),
            ((265, 0, 296), (0, 340.1, 0), (158, 0, -49)),
        ]
        for a, o1, o2 in blocks:
            b.add_parallelogram(tuple(x * s for x in a),
                                tuple(x * s for x in o1),
                                tuple(x * s for x in o2), white)

    if config & (C.LIGHT_AREA | C.LIGHT_AREA_UPWARDS):
        anchor = [1.0, 2.499, 1.0]
        v1, v2 = [0.5, 0.0, 0.0], [0.0, 0.0, 0.5]
        if config & C.LIGHT_AREA_UPWARDS:
            v1, v2 = v2, v1
            anchor[1] -= 0.1
        power = (19.661107023935260172519494336416,) * 3
        em = b.add_emitter(power, kd=(1, 1, 1),
                           light=make_area_light(power, anchor, v1, v2))
        b.add_parallelogram(anchor, v1, v2, em)
    elif config & (C.LIGHT_POINT | C.LIGHT_POINT_STRONG
                   | C.LIGHT_POINT_DISTANT):
        anchor = [1.25, 2.25, 1.25]
        power = 30.0
        if config & C.LIGHT_POINT_STRONG:
            power = 70.0
        if config & C.LIGHT_POINT_DISTANT:
            power = 200.0
            anchor[1] += 5.0
        b.add_light(make_point_light((power,) * 3, anchor))

    if config & (C.LARGE_MIRROR_SPHERE | C.LARGE_GLASS_SPHERE):
        mat = glass if config & C.LARGE_GLASS_SPHERE else mirror
        b.add_sphere((1.25, 0.8, 1.25), 0.8, mat)
    if config & C.SMALL_GLASS_SPHERE:
        b.add_sphere((1.25 - 0.535714269, 0.5, 1.25), 0.5, glass)
    if config & C.SMALL_MIRROR_SPHERE:
        b.add_sphere((1.25 + 0.535714269, 0.5, 1.25), 0.5, mirror)

    scene = b.build(aabb_padding=0.1, device=device)
    camera = Camera.make(eye=(1.25, 1.25, -2.85), lookat=(1.25, 1.25, 0),
                         up=(0, 1, 0), hfov=45.0, vfov=45.0, device=device)
    return scene, camera


_C = CornellSmallConfig
CORNELL_SMALL_VARIANTS = {
    "CornellSmall": _C.DEFAULT,
    "CornellSmallNoBlocks": _C.LIGHT_AREA,
    "CornellSmallLargeSphere": (_C.SMALLVCM_COLORS | _C.BACKWALL_BLUE
                                | _C.FLOOR_GLOSSY | _C.LARGE_MIRROR_SPHERE
                                | _C.LIGHT_AREA),
    "CornellSmallSmallSpheres": (_C.SMALLVCM_COLORS | _C.BACKWALL_BLUE
                                 | _C.FLOOR_GLOSSY | _C.LIGHT_POINT_STRONG
                                 | _C.SMALL_GLASS_SPHERE
                                 | _C.SMALL_MIRROR_SPHERE),
    "CornellSmallLightUpwards": (_C.SMALLVCM_COLORS | _C.BACKWALL_BLUE
                                 | _C.LIGHT_AREA_UPWARDS),
    "CornellSmallPointDistant": (_C.SMALLVCM_COLORS | _C.BACKWALL_BLUE
                                 | _C.LIGHT_POINT_DISTANT
                                 | _C.SMALL_GLASS_SPHERE
                                 | _C.SMALL_MIRROR_SPHERE),
    "CornellSmallPointTest": (_C.SMALLVCM_COLORS | _C.BACKWALL_BLUE
                              | _C.SMALL_GLASS_SPHERE | _C.FLOOR_GLOSSY
                              | _C.LIGHT_POINT_STRONG),
}

# the Cornell scenes of SceneFactory.cpp:24-80
SCENE_NAMES = ("Cornell",) + tuple(CORNELL_SMALL_VARIANTS)


def get_scene_by_name(name: str,
                      device: torch.device | str | None = None
                      ) -> tuple[Scene, Camera]:
    """SceneFactory::getSceneByName (Gui/scene/SceneFactory.cpp:24-80): the
    eight Cornell scenes and the procedural BVH scenes "Atrium" and
    "Conference" ("Atrium:<detail>", "Conference:<detail>" scale their
    triangle counts); any other name is a scene file (.dae/.obj) for
    :func:`~oppositerenderer_tpu_torch.scene.collada.load_scene_file`.
    ``device`` None is the CUDA card
    (:func:`~oppositerenderer_tpu_torch.devices.resolve_device`)."""
    device = resolve_device(device)
    if name == "Cornell":
        return make_cornell(device)
    if name in CORNELL_SMALL_VARIANTS:
        return make_cornell_small(CORNELL_SMALL_VARIANTS[name], device)
    base, _, detail = name.partition(":")
    if base == "Atrium":
        from .atrium import make_atrium
        return make_atrium(float(detail or 1.0), device)
    if base == "Conference":
        from .conference import make_conference
        return make_conference(float(detail or 1.0), device)
    from .collada import load_scene_file
    return load_scene_file(name, device)
