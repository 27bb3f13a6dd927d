from .builder import SceneBuilder
from .cornell import (SCENE_NAMES, CornellSmallConfig, get_scene_by_name,
                      make_cornell, make_cornell_small)
from .types import (DIFFUSE, EMITTER, GLASS, GLOSSY, MIRROR, TEXTURED,
                    Geometry, MaterialTable, Scene)

__all__ = [
    "Scene", "Geometry", "MaterialTable", "SceneBuilder",
    "make_cornell", "make_cornell_small", "get_scene_by_name",
    "CornellSmallConfig", "SCENE_NAMES",
    "DIFFUSE", "GLOSSY", "MIRROR", "GLASS", "EMITTER", "TEXTURED",
]
