"""The captured iteration holds nothing a CUDA graph refuses.

On the card a Renderer captures one iteration in a CUDA graph
(``renderer.CapturedStep``). A capture refuses a host read (``.item()``,
``bool(t)``), an operation whose output shape depends on the data
(``nonzero``, a boolean mask, ``unique``, ``bincount``) and a copy from
host memory to the card (``torch.tensor(...)`` or ``torch.as_tensor`` of
host data). This CPU test runs the captured body itself,
``CapturedStep._body``, under ``FakeTensorMode`` on a fake CUDA device:
the scene and the camera are empty fakes of their real shapes and dtypes,
the kernel launches (``cuda_build.launch_on``) are shape-only stand-ins,
and a dispatch mode fails on any operation of that list inside the step
(a host-to-card copy shows as ``lift_fresh`` or as a copy from a host
tensor). PT, PPM on the grid, the hash and in a medium, VCM+VM and PT
through a BVH run at 32^2; the kd-tree's iteration, whose host build is a
stand-in here, is audited in ``test_torch_kdtree_graph.py``.
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from oppositerenderer_tpu_torch.accel import cuda_build
from oppositerenderer_tpu_torch.accel.intersect import dense_tables
from oppositerenderer_tpu_torch.config import (PhotonMapStructure,
                                               RenderConfig, RenderMethod)
from oppositerenderer_tpu_torch.renderer import CapturedStep, Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name
from oppositerenderer_tpu_torch.scene.types import Medium

torch.set_num_threads(2)
# the wrappers' alignment checks read a fake's data pointer (0)
pytestmark = pytest.mark.filterwarnings(
    "ignore:Accessing the data pointer of FakeTensor")

SIZE = 32
REFUSED = ("_local_scalar_dense", "nonzero", "bincount", "unique",
           "masked_select", "lift_fresh")
PPM = RenderMethod.PROGRESSIVE_PHOTON_MAPPING


class CaptureAudit(TorchDispatchMode):
    """Fails on an operation a CUDA graph capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if any(name.startswith(r) for r in REFUSED):
            raise AssertionError(f"a captured step calls {func}")
        if name in ("_to_copy", "copy_", "_copy_from"):
            devs = {a.device.type for a in args
                    if isinstance(a, torch.Tensor)}
            if "cpu" in devs:
                raise AssertionError(f"a captured step copies host data "
                                     f"to the card ({func})")
        return func(*args, **(kwargs or {}))


aten = torch.ops.aten


def _basic_index(t, idx):
    """Apply the int, slice, None and Ellipsis parts of ``t[idx]`` as
    views; returns (view, [(dim, index tensor)]) for the tensor parts."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    n = sum(i is not None and i is not Ellipsis for i in idx)
    view, dim, adv = t, 0, []
    for i in idx:
        if i is Ellipsis:   # the dims no other part consumes
            dim += t.dim() - n
        elif i is None:
            view = aten.unsqueeze.default(view, dim)
            dim += 1
        elif isinstance(i, int):
            view = aten.select.int(view, dim, i)
        elif isinstance(i, slice):
            view = aten.slice.Tensor(view, dim, i.start, i.stop, i.step or 1)
            dim += 1
        else:
            i = i if isinstance(i, torch.Tensor) else torch.tensor(i)
            if i.dtype == torch.bool:
                raise AssertionError("a captured step indexes by a boolean "
                                     "mask (a data-dependent shape)")
            adv.append((dim, i))
            dim += 1
    return view, adv


def _indices(view, adv):
    out = [None] * (max(d for d, _ in adv) + 1)
    for d, i in adv:
        out[d] = i
    return out


def _fake_getitem(t, idx):
    view, adv = _basic_index(t, idx)
    return aten.index.Tensor(view, _indices(view, adv)) if adv else view


def _fake_setitem(t, idx, value):
    view, adv = _basic_index(t, idx)
    if not isinstance(value, torch.Tensor):
        value = aten.scalar_tensor.default(value, dtype=t.dtype,
                                           device=t.device)
    if adv:
        aten.index_put_.default(view, _indices(view, adv), value)
    else:
        aten.copy_.default(view, value)


@pytest.fixture(autouse=True)
def fake_cuda_indexing(monkeypatch):
    """A CPU-only torch has no CUDA device guard, which the hand-written
    Python bindings of indexing, index assignment, ``copy_`` and ``~``
    enter (the operators themselves run on fakes): on fake tensors they
    call the same aten operators directly, so the audit sees them."""
    monkeypatch.setattr(FakeTensor, "__getitem__", _fake_getitem,
                        raising=False)
    monkeypatch.setattr(FakeTensor, "__setitem__", _fake_setitem,
                        raising=False)
    monkeypatch.setattr(FakeTensor, "copy_",
                        lambda self, src, non_blocking=False:
                        aten.copy_.default(self, src), raising=False)
    monkeypatch.setattr(FakeTensor, "__invert__",
                        lambda self: aten.bitwise_not.default(self),
                        raising=False)


def fake_like(obj):
    """``obj`` with every tensor (in nested dataclasses) replaced by an
    empty fake CUDA tensor of its shape and dtype (inside the mode)."""
    if isinstance(obj, torch.Tensor):
        return torch.empty(obj.shape, dtype=obj.dtype, device="cuda")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: fake_like(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def medium_scene(name):
    scene, cam = get_scene_by_name(name, "cpu")
    return dataclasses.replace(scene, medium=Medium(
        sigma_s=torch.tensor(0.15), sigma_a=torch.tensor(0.02),
        aabb_min=torch.zeros(3), aabb_max=torch.full((3,), 2.5))), cam


def ppm_cfg(**kw):
    return RenderConfig(width=SIZE, height=SIZE, render_method=PPM,
                        photons_per_iteration=1 << 12,
                        photon_grid_resolution=16, **kw)


CASES = {
    "pt": ("CornellSmall", lambda: RenderConfig(width=SIZE, height=SIZE),
           ("closest_hit_tris", "occluded_tris")),
    "ppm_grid": ("CornellSmall", ppm_cfg,
                 ("closest_hit_tris", "occluded_tris",
                  "gather_photons_tiled")),
    "ppm_hash": ("CornellSmall", lambda: ppm_cfg(
        photon_map_structure=PhotonMapStructure.STOCHASTIC_HASH),
        ("closest_hit_tris", "occluded_tris")),
    "ppm_medium": ("medium", ppm_cfg,
                   ("closest_hit_tris", "occluded_tris",
                    "gather_photons_tiled")),
    "vcm_vm": ("CornellSmall", lambda: RenderConfig(
        width=SIZE, height=SIZE, vcm_max_path_length=4,
        photon_grid_resolution=16, vcm_use_vm=True,
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING),
        ("closest_hit_tris", "occluded_tris", "merge_vertices_tiled")),
    "bvh_pt": ("Atrium:0.1", lambda: RenderConfig(width=SIZE, height=SIZE),
               ("bvh_closest", "bvh_any")),
}


@pytest.fixture
def launches(monkeypatch):
    """Shape-only stand-ins for the kernel launches: the wrappers allocate
    their outputs; the stand-in records the entry point's name."""
    names = []
    monkeypatch.setattr(cuda_build, "launch_on",
                        lambda device, name, *args: names.append(name))
    return names


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_step_holds_no_refused_operation(case, launches):
    scene_name, make_cfg, kernels = CASES[case]
    scene, cam = (medium_scene("CornellSmall") if scene_name == "medium"
                  else get_scene_by_name(scene_name, "cpu"))
    cfg = make_cfg()
    tables = dense_tables(scene) if scene.bvh is None else None
    with FakeTensorMode():
        scene, cam = fake_like(scene), fake_like(cam)
        assert scene.device.type == "cuda"
        if tables is not None:
            # the dense route's triangle tables are built once per scene,
            # by the eager iteration before the capture
            scene.dense_cache = (scene.geometry, scene.materials,
                                 *map(fake_like, tables))
        r = Renderer(scene, cam, cfg, seed=3, ppm_initial_radius=0.05)
        assert r.uses_graph()
        step = CapturedStep(r._raw_step(), cam, r.ppm_initial_radius,
                            cfg.ppm_alpha, SIZE, SIZE, r.device)
        for closed_form in (False, True):
            step.prepare(cam, r.root_key, 5, 2,
                         None if closed_form else 0.0025)
            with CaptureAudit():
                rad, stats = step._body()
            assert rad.shape == (SIZE, SIZE, 3) and rad.device.type == "cuda"
            assert all(v.dim() == 0 for v in stats.values())
    assert set(launches) >= set(kernels), launches


def test_the_kd_tree_takes_the_graph_and_autograd_stays_eager():
    """Every photon map takes the graph on the card, the kd-tree too (its
    host build is a host node of the graph); a replay records no autograd
    tape, so a scene that requires grad takes the eager body under grad
    mode."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    with FakeTensorMode():
        scene, cam = fake_like(scene), fake_like(cam)
        for structure, graph in (
                (PhotonMapStructure.SORTED_UNIFORM_GRID, True),
                (PhotonMapStructure.STOCHASTIC_HASH, True),
                (PhotonMapStructure.KD_TREE_CPU, True)):
            r = Renderer(scene, cam, ppm_cfg(photon_map_structure=structure),
                         ppm_initial_radius=0.05)
            assert r.uses_graph() is graph, structure
        kd = scene.materials.kd.clone().requires_grad_(True)
        grad_scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, kd=kd))
        r = Renderer(grad_scene, cam, RenderConfig(width=SIZE, height=SIZE),
                     ppm_initial_radius=0.05)
        assert not r.uses_graph()
        with torch.no_grad():
            assert r.uses_graph()


def test_the_audit_refuses_a_host_read_and_a_host_copy():
    """The audit itself: each refused form raises inside the mode."""
    with FakeTensorMode():
        x = torch.empty(8, device="cuda")
        for bad in (lambda: bool((x > 0).any()),
                    lambda: x[x > 0],
                    lambda: torch.nonzero(x),
                    lambda: torch.as_tensor(0.5, device="cuda"),
                    lambda: torch.tensor([1, 2], device="cuda"),
                    lambda: torch.bincount(x.long())):
            with pytest.raises(Exception), CaptureAudit():
                bad()
        with CaptureAudit():   # fills and device arithmetic pass
            torch.full((), 0.5, device="cuda") + x.sum()
            torch.where(x > 0, x, 0.0)
