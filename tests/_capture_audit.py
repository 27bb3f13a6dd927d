"""Shared by the ``test_torch_capture_{shard,grad}.py`` files: the capture
audit of the sharded step and gradient, and the CPU stand-in for a
graph's replays.

The audit and the fake-CUDA helpers are ``test_torch_capture_safe.py``'s
(the captured iteration's audit), imported from there. What is added:

* :class:`BackwardAudit`: the same refused operations, for a backward
  run on real CPU tensors. A CPU-only torch cannot run the autograd
  engine on fake CUDA tensors (the engine asks for a CUDA device guard
  and aborts the process), so the forward is audited on fake CUDA
  tensors and the backward on the CPU: autograd's backward formulas are
  the same operators on both devices, and the host-to-card copy rule has
  no meaning where every tensor is on the host.
* :class:`ReplayOnCpu`: ``capture.CapturedCall`` as a CPU test can run
  it: the first call runs the body and keeps its output as the static
  output, and each later "replay" runs the body again and writes the
  result into those same tensors, as a graph rewrites its outputs. With
  it and ``uses_graph`` forced true, the graph route's operand plumbing
  and copies run on the CPU.
"""
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from test_torch_capture_safe import (REFUSED, CaptureAudit,  # noqa: F401
                                     fake_cuda_indexing, fake_like,
                                     launches)

from oppositerenderer_tpu_torch.accel.intersect import dense_tables
from oppositerenderer_tpu_torch.capture import CapturedCall
from oppositerenderer_tpu_torch.config import (PhotonExchange, RenderConfig,
                                               RenderMethod)
from oppositerenderer_tpu_torch.parallel.mesh import Mesh
from oppositerenderer_tpu_torch.scene import get_scene_by_name
from oppositerenderer_tpu_torch.scene.types import Medium

SIZE = 32
PPM = RenderMethod.PROGRESSIVE_PHOTON_MAPPING
VCM = RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING


def ppm_cfg(**kw):
    return RenderConfig(width=SIZE, height=SIZE, render_method=PPM,
                        photons_per_iteration=1 << 12,
                        photon_grid_resolution=16, **kw)


# name -> (scene name, config, the kernels its step launches)
CASES = {
    "pt": ("CornellSmall", lambda: RenderConfig(width=SIZE, height=SIZE),
           ("closest_hit_tris", "occluded_tris")),
    "ppm_all_to_all": ("CornellSmall", ppm_cfg,
                       ("closest_hit_tris", "occluded_tris",
                        "gather_photons_tiled")),
    "ppm_all_gather": ("CornellSmall", lambda: ppm_cfg(
        photon_exchange=PhotonExchange.ALL_GATHER),
        ("closest_hit_tris", "occluded_tris", "gather_photons_tiled")),
    "ppm_medium": ("medium", ppm_cfg,
                   ("closest_hit_tris", "occluded_tris",
                    "gather_photons_tiled")),
    "vcm_vm": ("CornellSmall", lambda: RenderConfig(
        width=SIZE, height=SIZE, render_method=VCM, vcm_max_path_length=4,
        photon_grid_resolution=16, vcm_use_vm=True),
        ("closest_hit_tris", "occluded_tris", "merge_vertices_tiled")),
    "bvh_pt": ("Atrium:0.1", lambda: RenderConfig(width=SIZE, height=SIZE),
               ("bvh_closest", "bvh_any")),
}


def scene_of(name):
    """The case's scene and camera on the CPU (``medium``: CornellSmall
    in JAX's test medium)."""
    if name != "medium":
        return get_scene_by_name(name, "cpu")
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    return dataclasses.replace(scene, medium=Medium(
        sigma_s=torch.tensor(0.15), sigma_a=torch.tensor(0.02),
        aabb_min=torch.zeros(3), aabb_max=torch.full((3,), 2.5))), cam


def with_tables(name):
    """The case's scene and camera on the CPU and, on the dense route,
    its triangle tables, as the eager run builds them before a capture
    (made outside ``FakeTensorMode``)."""
    scene, cam = scene_of(name)
    return scene, cam, dense_tables(scene) if scene.bvh is None else None


def fake_cuda(scene, cam, tables):
    """:func:`with_tables`' scene and camera as empty fakes on a fake CUDA
    device, the tables in the scene's cache (inside ``FakeTensorMode``)."""
    scene, cam = fake_like(scene), fake_like(cam)
    if tables is not None:
        scene.dense_cache = (scene.geometry, scene.materials,
                             *map(fake_like, tables))
    return scene, cam


def cuda_mesh():
    """The rank-less one-rank mesh on the (fake) card."""
    return Mesh(None, 0, 1, torch.device("cuda"), None)


class BackwardAudit(TorchDispatchMode):
    """Fails on an operation of the refused list (``REFUSED``); records
    every operator it sees in ``seen``."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.seen.add(name)
        if any(name.startswith(r) for r in REFUSED):
            raise AssertionError(f"a captured backward calls {func}")
        return func(*args, **(kwargs or {}))


def _write(static, new) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(new)
    elif isinstance(static, dict):
        for k in static:
            _write(static[k], new[k])
    else:
        for s, n in zip(static, new):
            _write(s, n)


class ReplayOnCpu(CapturedCall):
    """``CapturedCall`` whose replays run the body on the CPU and write
    into the first run's output tensors."""

    def run(self):
        if self.out is None:
            self.out = self.body()
        else:
            _write(self.out, self.body())
            self.replays += 1
        return self.out
