"""The port's spans (``core.profiling.span``) and the benchmark's readers
of them.

A span is a ``record_function`` range while a ``torch.profiler`` records
and nothing otherwise; ``pass_scope`` is a span with its outputs hook.
On the frame path a render is ``renderer.render`` holding
``renderer.operands``, ``capture.replay``, ``renderer.film`` and
``renderer.readback``; a replayed gradient step holds ``diff.operands``,
``capture.replay`` and ``diff.unpack``. The readers
``outside_graph_ms.iter`` and ``outside_graph_ms.grad``
(``port_bench/metrics/``) are held to a synthetic Chrome trace here. The
``cuda`` tests need a card; without one they skip. Run them on such a
machine with

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""
import json

import pytest
import torch

from oppositerenderer_tpu_torch.config import RenderConfig
from oppositerenderer_tpu_torch.core.profiling import (nonfinite_check,
                                                       pass_scope, span)
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name
from port_bench.harness import cells
from port_bench.harness.runner import Context
from port_bench.harness.trace import Trace, profiled

READERS = ("outside_graph_ms.iter", "outside_graph_ms.grad")


def chrome_events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def ranges(events, name) -> list:
    return [e for e in events if e.get("name") == name
            and e.get("cat") == "user_annotation"]


def holds(outer, inner) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_span_opens_no_range_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"range {name!r} opened with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    with span("renderer.render"):
        with span("capture.replay"):
            y = torch.ones(3) * 2.0
    assert torch.equal(y, torch.full((3,), 2.0))


def test_span_is_a_user_annotation_range_that_nests(tmp_path):
    with torch.profiler.profile() as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(4).add_(1.0)
    events = chrome_events(prof, tmp_path)
    (outer,), (inner,) = ranges(events, "outer"), ranges(events, "inner")
    assert holds(outer, inner) and inner["dur"] < outer["dur"]


def test_pass_scope_keeps_its_outputs_hook_and_nonfinite_report(tmp_path):
    x = torch.tensor([1.0, 2.0])
    with pass_scope("clean_pass") as out:
        assert out(x) is x
    bad = torch.tensor([1.0, float("nan"), float("inf")])
    with torch.profiler.profile() as prof:
        with nonfinite_check() as check:
            with pass_scope("first_pass") as out:
                out({"radiance": x})
            with pass_scope("bad_pass") as out:
                assert out({"radiance": bad})["radiance"] is bad
            with pass_scope("later_pass") as out:
                out(bad)
    assert check.message == ("pass bad_pass: 2 non-finite values of 3 in "
                             "its output out['radiance']")
    events = chrome_events(prof, tmp_path)
    for name in ("first_pass", "bad_pass", "later_pass"):
        assert len(ranges(events, name)) == 1


def test_a_cpu_render_holds_its_film_and_readback_spans(tmp_path):
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(width=64, height=64, iterations_per_dispatch=1)
    r = Renderer(scene, cam, cfg, seed=0)
    with torch.profiler.profile() as prof:
        r.render(2)                     # two chunks, one readback
    events = chrome_events(prof, tmp_path)
    (render,) = ranges(events, "renderer.render")
    films = ranges(events, "renderer.film")
    (readback,) = ranges(events, "renderer.readback")
    assert len(films) == 2
    assert all(holds(render, e) for e in films + [readback])
    assert films[-1]["ts"] < readback["ts"]
    # the CPU runs the eager body: no operands written, no graph replayed
    assert not ranges(events, "renderer.operands")
    assert not ranges(events, "capture.replay")


# ---------------------------------------------------------------------------
# the readers, on a synthetic trace: each step a port_bench.step range of
# 1000 us whose capture.replay range (from 100 us) holds a cudaGraphLaunch,
# whose correlation id two kernels carry, and a fill launched before it
# ---------------------------------------------------------------------------

def synthetic_step(t0, corr, launch_us, kernel_span, with_replay=True):
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": t0 + ts,
                "dur": dur, "pid": 1, "tid": 1, "args": args}
    k0, k1 = kernel_span
    events = [
        x("user_annotation", "port_bench.step", 0, 1000),
        x("cuda_runtime", "cudaMemsetAsync", 20, 10, correlation=corr + 1),
        x("gpu_memset", "Memset (Device)", 40, 5, correlation=corr + 1),
        x("cuda_runtime", "cudaGraphLaunch", 110, launch_us - 20,
          correlation=corr),
        x("kernel", "first_kernel", k0, 50, correlation=corr),
        x("kernel", "last_kernel", k1 - 40, 40, correlation=corr),
    ]
    if with_replay:
        events.append(x("user_annotation", "capture.replay", 100,
                        launch_us))
    for e in events:   # device operations run on the device's stream
        if e["cat"] in ("kernel", "gpu_memset"):
            e["pid"], e["tid"] = 0, 7
    return events


def three_steps(with_replay=(True, True, True)) -> list:
    """A first step that the profiler's start slows, and two after it:
    their graphs end 700 and 950 us into them."""
    return (synthetic_step(0, 10, 900, (900, 990), with_replay[0])
            + synthetic_step(5000, 20, 300, (400, 700), with_replay[1])
            + synthetic_step(9000, 30, 500, (350, 950), with_replay[2]))


def context(trace: Trace) -> Context:
    """What the runner hands a reader: the trace and its step ranges."""
    steps = [(e["ts"], e["ts"] + e["dur"])
             for e in trace.ranges("port_bench.step")]
    return Context(cell=None, spans={}, trace=trace, steps=steps,
                   eager=None, work=None)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_trace(name):
    # each step less its replay's start (100 us) to its graph's end
    want = ((1000 - (700 - 100)) + (1000 - (950 - 100))) / 2 / 1e3
    got = cells.reader(name)(context(Trace(three_steps())))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_leaves_out_the_first_traced_step(name):
    read = cells.reader(name)
    slow_first = read(context(Trace(three_steps())))
    events = three_steps()
    for e in events[:7]:    # the first step's graph now ends 600 us sooner
        if e["cat"] == "kernel":
            e["ts"] -= 600
    assert read(context(Trace(events))) == slow_first
    # a first step without the span is not read either
    assert read(context(Trace(three_steps((False, True, True))))) \
        == slow_first


@pytest.mark.parametrize("name", READERS)
def test_reader_needs_two_traced_steps(name):
    one = synthetic_step(0, 10, 300, (400, 700))
    assert cells.reader(name)(context(Trace(one))) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_replay_span_gives_none(name):
    read = cells.reader(name)
    assert read(context(Trace(three_steps((True, False, False))))) is None
    # one traced step without the span is enough
    assert read(context(Trace(three_steps((True, True, False))))) is None
    assert read(Context(cell=None, spans={}, trace=None, steps=[],
                        eager=None, work=None)) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_captured_pt_step_launches_its_kernels_under_the_replay(cuda):
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    r = Renderer(scene, cam, RenderConfig(width=64, height=64), seed=0)
    r.render(2)                 # the eager run, the capture, a replay
    counts = dict(r.captured_step.capture_launches)
    with profiled("cuda") as prof:
        for _ in range(3):
            with torch.profiler.record_function("port_bench.step"):
                r.render(1)
    trace = Trace.of(prof)
    renders = trace.ranges("renderer.render")
    assert len(renders) == 3
    for name in ("renderer.operands", "capture.replay", "renderer.film",
                 "renderer.readback"):
        spans = trace.ranges(name)
        assert len(spans) == 3, name
        assert all(holds(a, b) for a, b in zip(renders, spans)), name
    under = {id(e) for e in trace.launched_under(
        lambda n: n == "capture.replay")}
    names = {e["name"] for e in trace.device if id(e) in under}
    assert any("closest_hit_tris_kernel" in n for n in names), names
    for render in renders:
        step = trace.device_between(render["ts"],
                                    render["ts"] + render["dur"])
        mine = [e for e in step if id(e) in under]
        assert len(mine) >= 0.95 * len(step), (len(mine), len(step))
    assert r.captured_step.capture_launches == counts
    ctx = context(trace)
    outside = cells.reader("outside_graph_ms.iter")(ctx)
    assert outside is not None
    assert 0 <= outside <= min(b - a for a, b in ctx.steps[1:]) / 1e3


@pytest.mark.cuda
def test_a_span_inside_a_captured_body_leaves_its_replay_exact(cuda):
    from oppositerenderer_tpu_torch.capture import CapturedCall
    x = torch.linspace(-3.0, 3.0, 4099, device=cuda)

    def body():
        with span("inside_the_body"):
            y = torch.sin(x) * 3.0 + x.square()
        return torch.cumsum(y, 0)

    call = CapturedCall(body, cuda)
    eager = call.run().clone()          # eager, then captured
    assert call.graph is not None
    with profiled("cuda") as prof:
        replayed = call.run().clone()
        torch.cuda.synchronize(cuda)
    assert torch.equal(replayed, eager)
    assert torch.equal(call.run(), eager)
    trace = Trace.of(prof)
    assert trace.ranges("capture.replay")
    assert not trace.ranges("inside_the_body")
