from .builder import SceneBuilder
from .collada import (LAST_LOAD_PHASES, default_camera_for,
                      generate_smooth_normals, load_collada, load_obj,
                      load_scene_file)
from .collada_export import export_collada
from .cornell import (SCENE_NAMES, CornellSmallConfig, get_scene_by_name,
                      make_cornell, make_cornell_small)
from .types import (DIFFUSE, EMITTER, GLASS, GLOSSY, MIRROR, TEXTURED,
                    Geometry, MaterialTable, Medium, Scene)

__all__ = [
    "Scene", "Geometry", "MaterialTable", "Medium", "SceneBuilder",
    "make_cornell", "make_cornell_small", "get_scene_by_name",
    "CornellSmallConfig", "SCENE_NAMES",
    "load_scene_file", "load_collada", "load_obj", "default_camera_for",
    "generate_smooth_normals", "export_collada", "LAST_LOAD_PHASES",
    "DIFFUSE", "GLOSSY", "MIRROR", "GLASS", "EMITTER", "TEXTURED",
]
