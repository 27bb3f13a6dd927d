"""PyTorch/CUDA port of ``oppositerenderer_tpu``.

The same renderer for an NVIDIA Hopper GPU: plain array code is PyTorch,
and each Pallas TPU kernel of the JAX package becomes a kernel written by
hand in CUDA C++ (``csrc/``), with a plain PyTorch version beside it that
runs for CPU tensors. The package mirrors the JAX package's module paths.
It covers path tracing, progressive photon mapping (also in a
participating medium; on the sorted grid, the stochastic hash or the
host-built kd-tree) and VCM with vertex merging, on the Cornell scenes
(dense intersector), the BVH scenes and Collada/OBJ files, gradients
with respect to material and emission parameters (``diff``), and their
distribution over ``torch.distributed`` (``parallel``: tile-sharded
steps, iteration-sharded processes). The tools are ported too: profiling
(``core.profiling``), the device table (``devices``), ``debug``, the
interactive camera and the live viewer (``viewer``, the CLI's
``--serve``), and the packet node-step microbenchmark
(``scripts.packet_kernel_exp``).
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
