"""PyTorch/CUDA port of ``oppositerenderer_tpu``.

The same renderer for an NVIDIA Hopper GPU: plain array code is PyTorch,
and each Pallas TPU kernel of the JAX package becomes a kernel written by
hand in CUDA C++ (``csrc/``), with a plain PyTorch version beside it that
runs for CPU tensors. The package mirrors the JAX package's module paths.
It covers path tracing and progressive photon mapping with the dense
intersector on the Cornell scenes; ``ROADMAP.md`` lists what follows.
"""
from .camera import Camera
from .config import Intersector, RenderConfig, RenderMethod
from .film import Film, save_png, save_tga
from .renderer import Renderer
from .scene import get_scene_by_name

__all__ = [
    "Camera", "Film", "Intersector", "RenderConfig", "RenderMethod",
    "Renderer", "get_scene_by_name", "save_png", "save_tga",
]
