"""Scene, BVH, camera, key, photon and light-vertex records from the JAX
package's leaves.

The JAX package's records are trees of arrays. Handed over as numpy
arrays, with the port's field names (a nested mapping, e.g. from
``dataclasses.fields`` of each JAX record), they become the port's
records on a given device, so both packages render the same scene. This
module reads numpy only: it never imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .accel.bvh import Bvh
from .camera import Camera
from .core.rng import Key
from .integrators.vcm import LightVertexStore, VertexGrid
from .lights import LIGHT_FIELDS, LightTable
from .photon_map import PhotonBatch, PhotonGrid
from .scene.types import MATERIAL_FIELDS, Geometry, MaterialTable, Scene

GEOMETRY_FIELDS = tuple(Geometry.__dataclass_fields__)
CAMERA_FIELDS = ("eye", "lookdir", "up", "camera_u", "camera_v", "aperture")
PHOTON_BATCH_FIELDS = tuple(PhotonBatch.__dataclass_fields__)
PHOTON_GRID_ARRAYS = ("position", "power", "direction", "offsets", "origin",
                      "cell_size", "n_valid")
LIGHT_VERTEX_FIELDS = tuple(LightVertexStore.__dataclass_fields__)
VERTEX_GRID_ARRAYS = tuple(f for f in VertexGrid.__dataclass_fields__
                           if f != "resolution")
BVH_NODES = ("nodes_min", "nodes_max", "nodes_a", "nodes_b")
BVH_STATICS = ("root_code", "arity", "leaf_size", "max_stack")


def _tensor(a, device) -> torch.Tensor:
    # np.array copies: the leaves may be read-only views of device arrays
    return torch.as_tensor(np.array(a), device=device)


def _tensors(leaves: Mapping, names, device) -> dict:
    return {n: _tensor(leaves[n], device) for n in names}


def scene_from_numpy(leaves: Mapping, device: torch.device | str = "cpu"
                     ) -> Scene:
    """``leaves`` maps ``geometry``/``materials``/``lights`` to mappings of
    their fields, plus ``aabb_min``, ``aabb_max`` and optionally ``name``,
    ``textures``, ``normal_maps`` (the atlases), ``bvh`` (a mapping for
    :func:`bvh_from_numpy`) and ``medium``. A scene with a medium belongs
    to the media slice and is refused."""
    if leaves.get("medium") is not None:
        raise NotImplementedError(
            "scenes with a medium arrive with the media slice of the port")
    atlases = {k: _tensor(leaves[k], device)
               for k in ("textures", "normal_maps")
               if leaves.get(k) is not None}
    bvh = leaves.get("bvh")
    return Scene(
        geometry=Geometry(**_tensors(leaves["geometry"], GEOMETRY_FIELDS,
                                     device)),
        materials=MaterialTable(**_tensors(leaves["materials"],
                                           MATERIAL_FIELDS, device)),
        lights=LightTable(**_tensors(leaves["lights"], LIGHT_FIELDS,
                                     device)),
        aabb_min=_tensor(leaves["aabb_min"], device),
        aabb_max=_tensor(leaves["aabb_max"], device),
        bvh=None if bvh is None else bvh_from_numpy(bvh, device),
        name=str(leaves.get("name", "scene")), **atlases)


def bvh_from_numpy(leaves: Mapping, device: torch.device | str = "cpu"
                   ) -> Bvh:
    """``leaves`` maps a JAX ``Bvh``'s binary node arrays, its ``rows``
    table and its ``root_code``/``arity``/``leaf_size``/``max_stack``; its
    int8 ``q_rows`` table serves the TPU only and is not read. The JAX
    package's ``max_stack`` (sized for its code stack) is at least the
    port's depth + 1, so its table traverses as it is. The binary node
    arrays stay on the host, the table goes to ``device``."""
    return Bvh(**_tensors(leaves, BVH_NODES, "cpu"),
               rows=_tensor(leaves["rows"], device),
               **{k: int(leaves[k]) for k in BVH_STATICS})


def camera_from_numpy(leaves: Mapping, device: torch.device | str = "cpu"
                      ) -> Camera:
    """``leaves`` maps the camera's array fields and ``hfov``/``vfov``."""
    return Camera(**_tensors(leaves, CAMERA_FIELDS, device),
                  hfov=float(leaves["hfov"]), vfov=float(leaves["vfov"]))


def key_from_numpy(words) -> Key:
    """A key from its ``uint32[2]`` words (``jax.random.key_data``)."""
    w = np.asarray(words, np.uint32).reshape(-1)
    if w.shape != (2,):
        raise ValueError(f"a key has two 32-bit words, got {w.shape[0]}")
    return int(w[0]), int(w[1])


def photon_batch_from_numpy(leaves: Mapping,
                            device: torch.device | str = "cpu"
                            ) -> PhotonBatch:
    """``leaves`` maps ``position``/``power``/``direction`` [P,3] and
    ``valid`` [P] (a JAX ``PhotonBatch``'s fields)."""
    return PhotonBatch(**_tensors(leaves, PHOTON_BATCH_FIELDS, device))


def photon_grid_from_numpy(leaves: Mapping,
                           device: torch.device | str = "cpu") -> PhotonGrid:
    """``leaves`` maps a JAX ``PhotonGrid``'s arrays and ``resolution``."""
    return PhotonGrid(**_tensors(leaves, PHOTON_GRID_ARRAYS, device),
                      resolution=int(leaves["resolution"]))


def light_vertex_store_from_numpy(leaves: Mapping,
                                  device: torch.device | str = "cpu"
                                  ) -> LightVertexStore:
    """``leaves`` maps a JAX ``LightVertexStore``'s fields ([P,V,...])."""
    return LightVertexStore(**_tensors(leaves, LIGHT_VERTEX_FIELDS, device))


def vertex_grid_from_numpy(leaves: Mapping,
                           device: torch.device | str = "cpu") -> VertexGrid:
    """``leaves`` maps a JAX ``VertexGrid``'s arrays and ``resolution``."""
    return VertexGrid(**_tensors(leaves, VERTEX_GRID_ARRAYS, device),
                      resolution=int(leaves["resolution"]))
