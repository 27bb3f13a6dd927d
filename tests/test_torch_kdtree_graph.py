"""The kd-tree photon map's compiled iteration, on the CPU.

On the card a kd-tree PPM iteration is one CUDA graph: the JAX package's
host callback (``_kdtree_callback``, a ``jax.pure_callback`` in its jitted
step) becomes ``native/kdtree_builder.cpp``'s ``kd_build_host``, a CUDA
host function between two copies (``photon_map.KdHostStage``), and JAX's
``lax.while_loop`` gather becomes ``max_visits`` captured steps. Here:

* ``kd_build_host``, called through ctypes (and through its address, as
  the card calls it) on numpy buffers, gives ``_kdtree_callback``'s
  permutation and axes bit for bit, and the port's CPU build's;
* the captured form of the gather, run on CPU tensors, equals the eager
  loop bit for bit and JAX's ``gather_kdtree`` at
  ``test_torch_photon_maps.py``'s bar;
* the captured body of a kd-tree iteration, under ``FakeTensorMode`` on a
  fake CUDA device with the stage's entry point a stand-in, holds no
  operation a capture refuses (``test_torch_capture_safe.py``'s audit);
* the captured step holds its stages, and releasing it, or dropping it,
  frees them.
"""
import ctypes
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from test_torch_capture_safe import (CaptureAudit,  # noqa: F401
                                     fake_cuda_indexing, fake_like,
                                     launches, ppm_cfg)
from test_torch_photon_maps import KD_ATOL, KD_RTOL, both, make_photons, \
    queries

from oppositerenderer_tpu import photon_map as jpm
from oppositerenderer_tpu_torch import native
from oppositerenderer_tpu_torch import photon_map as pm
from oppositerenderer_tpu_torch.accel.intersect import dense_tables
from oppositerenderer_tpu_torch.config import PhotonMapStructure
from oppositerenderer_tpu_torch.renderer import CapturedStep, Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings(
    "ignore:Accessing the data pointer of FakeTensor")

KD = PhotonMapStructure.KD_TREE_CPU
SIZE = 32


def stage_build(pos: np.ndarray, valid: np.ndarray, by_address: bool):
    """``kd_build_host`` on a stage of numpy buffers: (perm, axis, the
    stage's fields). ``by_address`` calls it through the address the card's
    stream is given (``native.kd_build_host_fn``)."""
    rows = pos.shape[0]
    m = pm._kd_capacity(rows)
    pos = np.ascontiguousarray(pos, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    perm = np.full(m, 7, np.int32)      # overwritten in every slot
    axis = np.full(m, 7, np.int32)
    fields = native.KdStageFields(
        pos=pos.ctypes.data, valid=valid.ctypes.data, perm=perm.ctypes.data,
        axis=axis.ctypes.data, rows=rows, m=m)
    if by_address:
        ctypes.CFUNCTYPE(None, ctypes.c_void_p)(native.kd_build_host_fn())(
            ctypes.addressof(fields))
    else:
        native.kdtree_lib().kd_build_host(ctypes.byref(fields))
    return perm, axis, fields


BUILD_CASES = {
    "clustered": dict(n=1500, frac_valid=0.8, cluster=True),
    "uniform": dict(n=1500, frac_valid=0.8),
    "all_valid": dict(n=1023, frac_valid=1.1),
    "none_valid": dict(n=300, frac_valid=0.0),
    "odd_rows": dict(n=2900, frac_valid=0.55, cluster=True),
}


@pytest.mark.parametrize("by_address", [False, True])
@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_kd_build_host_equals_the_jax_callback(case, by_address):
    """The host node's function gives JAX's ``_kdtree_callback`` bit for
    bit (the valid rows compacted in ascending order, as ``np.nonzero``
    does: the builder's ``nth_element`` is not stable), and the port's CPU
    build. No valid row: all-null slots, where the JAX callback raises
    (ROADMAP queue C, PR 9)."""
    assert native.kdtree_lib() is not None, "g++ could not build the kd-tree"
    leaves = make_photons(seed=5, **BUILD_CASES[case])
    pos, valid = leaves["position"], leaves["valid"]
    perm, axis, fields = stage_build(pos, valid, by_address)
    assert fields.n_valid == int(valid.sum())
    assert fields.seconds >= 0.0
    assert perm.shape[0] == pm._kd_capacity(pos.shape[0])
    cpu_perm, cpu_axis = pm._host_build(torch.as_tensor(pos),
                                        torch.as_tensor(valid))
    np.testing.assert_array_equal(perm, cpu_perm.numpy())
    np.testing.assert_array_equal(axis, cpu_axis.numpy())
    if not valid.any():
        assert (perm == -1).all() and (axis == native.KD_NULL).all()
        with pytest.raises(IndexError):
            jpm._kdtree_callback(pos, valid)
        return
    jperm, jaxis = jpm._kdtree_callback(pos, valid)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(axis, jaxis)
    assert sorted(perm[perm >= 0].tolist()) == np.nonzero(valid)[0].tolist()


@pytest.mark.parametrize("max_visits", [16, 37, 512, 4096])
@pytest.mark.parametrize("check_normal", [True, False])
def test_captured_gather_equals_the_eager_loop_and_jax(max_visits,
                                                       check_normal,
                                                       monkeypatch):
    """The gather's captured form (every one of ``max_visits`` steps, no
    host read), run on CPU tensors, equals the eager loop (host checks,
    an early end) bit for bit, and JAX's ``while_loop`` at
    ``test_torch_photon_maps.py``'s bar with equal visits and overruns.
    At 4096 every lane ends early, so the steps after the last live lane
    must change nothing."""
    leaves = make_photons(n=1200, frac_valid=0.85, cluster=True)
    jb, tb = both(leaves)
    jt, tt = jpm.build_photon_kdtree(jb), pm.build_photon_kdtree(tb)
    q, nrm = queries(n=128, seed=3, lo=0.2, hi=1.8, up=False)
    args = (tt, torch.as_tensor(q), torch.as_tensor(nrm), 0.3)
    kw = dict(max_visits=max_visits, check_normal=check_normal)
    eager, est = pm.gather_kdtree(*args, **kw)
    host_reads = []
    monkeypatch.setattr(pm, "_in_capture", lambda device: True)
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda t: host_reads.append(t) or True)
    got, gst = pm.gather_kdtree(*args, **kw)
    monkeypatch.undo()
    assert host_reads == []
    assert torch.equal(got, eager)
    assert torch.equal(gst["photons_visited"], est["photons_visited"])
    assert int(gst["kd_overrun"]) == int(est["kd_overrun"])
    want, wst = jpm.gather_kdtree(jt, jnp.asarray(q), jnp.asarray(nrm),
                                  jnp.float32(0.3), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KD_RTOL,
                               atol=KD_ATOL)
    np.testing.assert_array_equal(gst["photons_visited"].numpy(),
                                  np.asarray(wst["photons_visited"]))
    assert int(gst["kd_overrun"]) == int(wst["kd_overrun"])
    assert (int(gst["kd_overrun"]) > 0) == (max_visits <= 512)


class StageStandIn(pm.KdHostStage):
    """A stage without pinned memory or a library: the device buffers as
    empty tensors on the (fake) card; :meth:`enqueue` is the real one, so
    its checks run and the entry point is named to ``launch_on``."""

    def __init__(self, device, rows):
        self.device = torch.device(device)
        self.rows = rows
        self.m = pm._kd_capacity(rows)
        self._host_fn = 0
        self.perm = torch.empty((self.m,), dtype=torch.int32,
                                device=self.device)
        self.axis = torch.empty_like(self.perm)
        self.host_position = self.host_valid = None
        self.host_perm = self.host_axis = None
        self.fields = native.KdStageFields()


def test_captured_kd_iteration_holds_no_refused_operation(launches,
                                                          monkeypatch):
    """A kd-tree PPM iteration's captured body (``CapturedStep._body``)
    at 32^2 on a fake card: no host read, no data-dependent shape, no host
    copy; it enqueues the stage's build, launches B1 and B2, and its stage
    is the captured step's."""
    monkeypatch.setattr(pm, "KdHostStage", StageStandIn)
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = ppm_cfg(photon_map_structure=KD)
    tables = dense_tables(scene)
    rows = cfg.photons_per_iteration * cfg.max_photon_trace_depth
    with FakeTensorMode():
        scene, cam = fake_like(scene), fake_like(cam)
        scene.dense_cache = (scene.geometry, scene.materials,
                             *map(fake_like, tables))
        r = Renderer(scene, cam, cfg, seed=3, ppm_initial_radius=0.05)
        assert r.uses_graph()
        step = CapturedStep(r._raw_step(), cam, r.ppm_initial_radius,
                            cfg.ppm_alpha, SIZE, SIZE, r.device)
        # the stage as the eager first run makes it, outside the capture
        with pm.kd_stages(step.kd_stages):
            stage = pm.kd_host_stage(scene.device, rows)
        monkeypatch.setattr(pm, "_in_capture", lambda device: True)
        for closed_form in (False, True):
            step.prepare(cam, r.root_key, 5, 2,
                         None if closed_form else 0.0025)
            with CaptureAudit():
                rad, stats = step.body()
            assert rad.shape == (SIZE, SIZE, 3) and rad.device.type == "cuda"
            assert {"photons_visited", "kd_overrun"} <= stats.keys()
    assert list(step.kd_stages.values()) == [stage]
    assert launches.count("kd_stage_enqueue") == 2
    assert {"closest_hit_tris", "occluded_tris"} <= set(launches)
    assert "gather_photons_tiled" not in launches


def test_a_stage_is_never_made_inside_a_capture(monkeypatch):
    """A build captured before its body ran eagerly has no stage: it
    raises, since a capture may not allocate pinned memory."""
    monkeypatch.setattr(pm, "_in_capture", lambda device: True)
    with pm.kd_stages({}), pytest.raises(RuntimeError, match="eagerly"):
        pm.kd_host_stage(torch.device("cuda", 0), 100)


@pytest.mark.parametrize("release", [True, False])
def test_the_captured_step_holds_and_frees_its_stage(release, monkeypatch):
    """The stage a captured step's body made lives as long as the step: a
    replay reads its buffers. ``release()`` drops it, and so does the
    step's last reference (no reference cycle, with the collector off),
    and the process's own stages (builds outside any step) are apart."""
    monkeypatch.setattr(pm, "KdHostStage", StageStandIn)
    monkeypatch.setattr(pm, "_SHARED_KD_STAGES", {})
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = ppm_cfg(photon_map_structure=KD)
    r = Renderer(scene, cam, cfg, seed=3)
    dev = torch.device("cuda", 0)
    gc.collect()
    gc.disable()
    try:
        step = CapturedStep(r._raw_step(), cam, r.ppm_initial_radius,
                            cfg.ppm_alpha, SIZE, SIZE, r.device)
        with FakeTensorMode():   # the stand-in's buffers on a fake card
            with pm.kd_stages(step.kd_stages):
                stage = pm.kd_host_stage(dev, 100)
                assert pm.kd_host_stage(dev, 100) is stage
            shared = pm.kd_host_stage(dev, 100)
        assert shared is not stage and pm._SHARED_KD_STAGES == {
            (dev, 100): shared}
        refs = [weakref.ref(stage), weakref.ref(step)]
        del stage
        assert refs[0]() is not None
        if release:
            step.release()
            assert refs[0]() is None and step.kd_stages == {}
        del step
        assert [ref() for ref in refs] == [None, None]
    finally:
        gc.enable()
