"""Distribution: tile-sharded render steps over a ``torch.distributed``
process group (``mesh``, ``exchange``, ``render``) and iteration-sharded
multi-process rendering (``distributed``); ``worker`` is the rank entry
point. The counterpart of ``oppositerenderer_tpu/parallel/``."""
from .mesh import Mesh, make_mesh
from .render import (gather_image, make_sharded_render_fn,
                     make_sharded_render_raw)

__all__ = ["make_mesh", "Mesh", "make_sharded_render_fn",
           "make_sharded_render_raw", "gather_image"]
