"""Scene, BVH, camera, key, photon, hitpoint and light-vertex records from
the JAX package's leaves.

The JAX package's records are trees of arrays. Handed over as numpy
arrays, with the port's field names (a nested mapping, e.g. from
``dataclasses.fields`` of each JAX record), they become the port's
records on a given device (None: the CUDA card, as everywhere in the
port), so both packages render the same scene. This module reads numpy
only: it never imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .accel.bvh import Bvh
from .accel.vm_kernels import VERTEX_FIELDS, pack_vertex_records
from .camera import Camera
from .core.rng import Key
from .devices import resolve_device
from .integrators.ppm import HitpointBuffer
from .integrators.vcm import LightVertexStore, VertexGrid
from .lights import LIGHT_FIELDS, LightTable
from .photon_map import PhotonBatch, PhotonGrid, pack_photon_records
from .scene.types import (MATERIAL_FIELDS, Geometry, MaterialTable, Medium,
                          Scene)

GEOMETRY_FIELDS = tuple(Geometry.__dataclass_fields__)
CAMERA_FIELDS = ("eye", "lookdir", "up", "camera_u", "camera_v", "aperture")
PHOTON_BATCH_FIELDS = tuple(PhotonBatch.__dataclass_fields__)
PHOTON_GRID_ARRAYS = ("position", "power", "direction", "offsets", "origin",
                      "cell_size", "n_valid")
LIGHT_VERTEX_FIELDS = tuple(LightVertexStore.__dataclass_fields__)
MEDIUM_FIELDS = tuple(Medium.__dataclass_fields__)
HITPOINT_FIELDS = tuple(HitpointBuffer.__dataclass_fields__)
VERTEX_GRID_ARRAYS = tuple(f for f in VertexGrid.__dataclass_fields__
                           if f not in ("resolution", "packed"))
BVH_NODES = ("nodes_min", "nodes_max", "nodes_a", "nodes_b")
BVH_STATICS = ("root_code", "arity", "leaf_size", "max_stack")


def _tensor(a, device) -> torch.Tensor:
    # np.array copies: the leaves may be read-only views of device arrays
    return torch.as_tensor(np.array(a), device=resolve_device(device))


def _tensors(leaves: Mapping, names, device) -> dict:
    return {n: _tensor(leaves[n], device) for n in names}


def scene_from_numpy(leaves: Mapping,
                     device: torch.device | str | None = None
                     ) -> Scene:
    """``leaves`` maps ``geometry``/``materials``/``lights`` to mappings of
    their fields, plus ``aabb_min``, ``aabb_max`` and optionally ``name``,
    ``textures``, ``normal_maps`` (the atlases), ``bvh`` (a mapping for
    :func:`bvh_from_numpy`) and ``medium`` (a mapping of ``sigma_s``,
    ``sigma_a``, ``aabb_min`` and ``aabb_max``)."""
    atlases = {k: _tensor(leaves[k], device)
               for k in ("textures", "normal_maps")
               if leaves.get(k) is not None}
    bvh = leaves.get("bvh")
    medium = leaves.get("medium")
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
        medium=(None if medium is None
                else Medium(**_tensors(medium, MEDIUM_FIELDS, device))),
        name=str(leaves.get("name", "scene")), **atlases)


def bvh_from_numpy(leaves: Mapping,
                   device: torch.device | str | None = None
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


def camera_from_numpy(leaves: Mapping,
                      device: torch.device | str | None = None
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
                            device: torch.device | str | None = None
                            ) -> PhotonBatch:
    """``leaves`` maps ``position``/``power``/``direction`` [P,3] and
    ``valid`` [P] (a JAX ``PhotonBatch``'s fields)."""
    return PhotonBatch(**_tensors(leaves, PHOTON_BATCH_FIELDS, device))


def _x_cells(offsets: torch.Tensor, n: int, res: int) -> torch.Tensor:
    """The x index of the grid cell of each of a sorted grid's ``n``
    entries (0 past the last cell), from its prefix ``offsets``."""
    cell = torch.searchsorted(offsets, torch.arange(
        n, dtype=offsets.dtype, device=offsets.device), right=True) - 1
    return cell % res


def photon_grid_from_numpy(leaves: Mapping,
                           device: torch.device | str | None = None
                           ) -> PhotonGrid:
    """``leaves`` maps a JAX ``PhotonGrid``'s arrays and ``resolution``;
    the port's packed photon records are built from them."""
    arrays = _tensors(leaves, PHOTON_GRID_ARRAYS, device)
    res = int(leaves["resolution"])
    x = _x_cells(arrays["offsets"], arrays["position"].shape[0], res)
    return PhotonGrid(**arrays, resolution=res, packed=pack_photon_records(
        arrays["position"], arrays["direction"], arrays["power"], x))


def hitpoint_from_numpy(leaves: Mapping,
                        device: torch.device | str | None = None
                        ) -> HitpointBuffer:
    """``leaves`` maps a JAX ``HitpointBuffer``'s fields (the eye pass's
    records, its ``vol_*`` in-medium sample included)."""
    return HitpointBuffer(**_tensors(leaves, HITPOINT_FIELDS, device))


def light_vertex_store_from_numpy(leaves: Mapping,
                                  device: torch.device | str | None = None
                                  ) -> LightVertexStore:
    """``leaves`` maps a JAX ``LightVertexStore``'s fields ([P,V,...])."""
    return LightVertexStore(**_tensors(leaves, LIGHT_VERTEX_FIELDS, device))


def vertex_grid_from_numpy(leaves: Mapping,
                           device: torch.device | str | None = None
                           ) -> VertexGrid:
    """``leaves`` maps a JAX ``VertexGrid``'s arrays and ``resolution``;
    the port's packed vertex records are built from them."""
    arrays = _tensors(leaves, VERTEX_GRID_ARRAYS, device)
    res = int(leaves["resolution"])
    return VertexGrid(**arrays, resolution=res, packed=pack_vertex_records(
        **{f: arrays[f] for f in VERTEX_FIELDS},
        cell=_x_cells(arrays["offsets"], arrays["position"].shape[0], res),
        resolution=res))
