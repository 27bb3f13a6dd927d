"""The sharded step as a CUDA graph
(``parallel.render.make_sharded_render_fn``).

JAX jits its sharded step, collectives included. On a CUDA scene over a
rank-less or NCCL mesh the port captures the step in one CUDA graph whose
operands (the iteration, the key's words, the radius) are device buffers;
gloo meshes and the CPU run it eagerly, by one predicate
(``parallel.render.uses_graph``). Here, on the CPU:

* the captured body, ``fn.captured.body``, under ``FakeTensorMode`` on a
  fake CUDA device over the rank-less mesh, holds no operation a capture
  refuses (``test_torch_capture_safe.py``'s audit): PT, PPM with each
  exchange and in a medium, VCM+VM, and PT through a BVH at 32^2, with
  int and with tensor operands;
* the step with device-tensor operands equals its int form bit for bit,
  band and stats, per method;
* the graph route itself, run on the CPU with a stand-in whose replays
  rewrite the first run's outputs (``_capture_audit.ReplayOnCpu``),
  equals the eager route call for call and returns tensors that the next
  call leaves alone.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _capture_audit import (CASES, SIZE, CaptureAudit, ReplayOnCpu,
                            cuda_mesh, fake_cuda, scene_of, with_tables)
# the fixtures: fake CUDA indexing (autouse) and the launch stand-ins
from _capture_audit import fake_cuda_indexing, launches  # noqa: F401
from oppositerenderer_tpu_torch.core.rng import device_key, make_root_key
from oppositerenderer_tpu_torch.parallel import make_mesh
from oppositerenderer_tpu_torch.parallel import render as sharded
from oppositerenderer_tpu_torch.parallel.render import (
    make_sharded_render_fn, make_sharded_render_raw)

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings(
    "ignore:Accessing the data pointer of FakeTensor")

SEED, IT, R2 = 3, 5, 0.0025


def device_operands(dev):
    return (torch.full((), IT, dtype=torch.int64, device=dev),
            device_key(make_root_key(SEED), dev),
            torch.full((), R2, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_sharded_step_holds_no_refused_operation(case, launches):
    scene_name, make_cfg, kernels = CASES[case]
    real = with_tables(scene_name)
    with FakeTensorMode():
        scene, cam = fake_cuda(*real)
        mesh = cuda_mesh()
        assert mesh.capturable and sharded.uses_graph(scene, mesh)
        fn = make_sharded_render_fn(scene, cam, make_cfg(), mesh)

        def audited():   # the operands are set outside, the body inside
            with CaptureAudit():
                return fn.captured.body()
        fn.captured.run = audited
        for args in ((IT, make_root_key(SEED), R2),
                     device_operands("cuda")):
            band, stats = fn(*args)
            assert band.shape == (SIZE, SIZE, 3)
            assert band.device.type == "cuda"
            assert all(v.dim() == 0 and v.device.type == "cuda"
                       for v in stats.values())
    assert set(launches) >= set(kernels), launches


def assert_equal(got, want):
    (band, stats), (wband, wstats) = got, want
    assert torch.equal(band.view(torch.int32), wband.view(torch.int32))
    assert set(stats) == set(wstats)
    for k, v in wstats.items():
        assert torch.equal(stats[k], v), k


@pytest.mark.parametrize("case", ["pt", "ppm_all_to_all", "ppm_all_gather",
                                  "vcm_vm"])
def test_tensor_operands_equal_the_int_form(case):
    scene_name, make_cfg, _ = CASES[case]
    scene, cam = scene_of(scene_name)
    raw = make_sharded_render_raw(scene, cam, make_cfg(), make_mesh(
        1, device="cpu"))
    assert_equal(raw(scene, *device_operands("cpu")),
                 raw(scene, IT, make_root_key(SEED), R2))


@pytest.mark.parametrize("case", ["pt", "ppm_all_to_all"])
def test_the_graph_route_replays_the_eager_step(case, monkeypatch):
    """Forced onto the graph route on the CPU: each call equals the eager
    route at its operands, and the first call's band is not rewritten by
    the second."""
    monkeypatch.setattr(sharded, "uses_graph", lambda scene, mesh: True)
    monkeypatch.setattr(sharded, "CapturedCall", ReplayOnCpu)
    scene_name, make_cfg, _ = CASES[case]
    scene, cam = scene_of(scene_name)
    fn = make_sharded_render_fn(scene, cam, make_cfg(),
                                make_mesh(1, device="cpu"))
    assert isinstance(fn.captured, ReplayOnCpu) and fn.eager is not fn
    first = fn(IT, make_root_key(SEED), R2)
    kept = first[0].clone()
    second = fn(*device_operands("cpu")[:2], R2 * 0.5)
    assert fn.captured.replays == 1
    assert torch.equal(first[0], kept)
    assert_equal(first, fn.eager(IT, make_root_key(SEED), R2))
    assert_equal(second, fn.eager(IT, make_root_key(SEED), R2 * 0.5))
    assert first[0] is not fn.captured.out[0]


def test_a_worker_counts_the_replays_of_a_captured_step(monkeypatch):
    """A ``render`` case on a capturable mesh warms up (the eager run and
    the capture), then replays: the worker adds the replays' launches to
    the wrappers' own count of the eager run."""
    from oppositerenderer_tpu_torch.parallel import worker

    class Counted(ReplayOnCpu):
        def run(self):
            self.capture_launches = {"closest_hit_tris": 5}
            return super().run()
    monkeypatch.setattr(sharded, "uses_graph", lambda scene, mesh: True)
    monkeypatch.setattr(sharded, "CapturedCall", Counted)
    case = dict(next(c for c in worker.sharding_cases(16)
                     if c["name"] == "pt"), reps=3)
    out = worker.run_cases([case], torch.device("cpu"),
                           make_mesh(1, device="cpu"))
    # on the CPU the wrappers count nothing: the 3 replays' 5 each
    assert int(out["pt.launches.closest_hit_tris"]) == 15
    assert int(out["pt.launches.occluded_tris"]) == 0
    assert out["pt.image"].shape == (16, 16, 3)


@pytest.mark.parametrize("graph_route", [True, False])
def test_captures_hold_no_reference_cycle(graph_route, monkeypatch):
    """The cycle collector may run inside a capture, and a graph it frees
    there is destroyed on a capturing stream, which invalidates the
    capture. So the captured iteration, the sharded step and the sharded
    gradient, and their captures, are freed by their last reference,
    never left to the collector."""
    import gc
    import weakref

    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.renderer import CapturedStep, Renderer
    monkeypatch.setattr(sharded, "uses_graph",
                        lambda scene, mesh: graph_route)
    scene, cam = scene_of("CornellSmall")
    cfg = CASES["pt"][1]()
    mesh = make_mesh(1, device="cpu")
    r = Renderer(scene, cam, cfg, seed=SEED)
    makers = [
        lambda: make_sharded_render_fn(scene, cam, cfg, mesh),
        lambda: diff.make_sharded_loss_and_grad(
            scene, cam, cfg, mesh, {("kd", 0): scene.materials.kd[0]})]
    if graph_route:
        makers.append(lambda: CapturedStep(
            r._raw_step(), cam, r.ppm_initial_radius, cfg.ppm_alpha, SIZE,
            SIZE, r.device))
    gc.collect()
    gc.disable()
    try:
        for make in makers:
            made = make()
            captured = getattr(made, "captured", made)
            assert (captured is not None) == graph_route
            refs = [weakref.ref(made)] + (
                [] if captured is None else [weakref.ref(captured)])
            del made, captured
            assert [ref() for ref in refs] == [None] * len(refs)
    finally:
        gc.enable()
