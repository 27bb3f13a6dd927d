"""The ``cornell_small.vcm`` cell: the plain reference's VCM
(``port_bench/reference/vcm.py``), the cell's rehearsal on the CPU with
and without a fault in the program, the ``vcm_connect`` and
``vcm_splat`` spans of the port's VCM and their readers.

The reference weighs every strategy by the balance heuristic in Veach's
explicit form; it is held here to the plain reference's path tracer at a
path length where neither estimator's cap matters, and its weights to a
float64 product over every split. The ``cuda`` test needs a card; without
one it skips. Run it on such a machine with

    python -m pytest --noconftest -m cuda tests/test_torch_vcm_reference.py
"""
import ast
import json
import math
import time
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.integrators import vcm as port_vcm
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name
from port_bench.harness import cells, compare, runner
from port_bench.harness.runner import Context
from port_bench.harness.trace import Trace
from port_bench.reference import pt, scene, vcm

ROOT = Path(__file__).resolve().parents[1]
CELL = "cornell_small.vcm"
SPEC = json.loads((ROOT / f"port_bench/cells/{CELL}.json").read_text())
FIELDS = json.loads((ROOT / f"port_bench/configs/{SPEC['config']}.json")
                    .read_text())["render_config"]
LIMITS = SPEC["limits"]
SEED = 2 ** 31 + 4242       # above 32 signed bits, as a run's seed may be
VCM = RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
READERS = {"vcm_light_pass_ms": "vcm_light_pass",
           "vcm_connect_ms": "vcm_connect", "vcm_splat_ms": "vcm_splat"}


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def random_paths(n_edges: int, batch: int, gen):
    """Diffuse paths y_0 .. y_{n-1} inside CornellSmall's box as
    ``vcm.vertex_pdfs`` takes them ([batch, n + 1], the eye last): y_0 on
    the light, each normal turned toward both neighbours, continuation
    probabilities in [0.2, 1]."""
    s = scene.load("CornellSmall", "cpu")
    u = torch.rand((batch, 2), generator=gen)
    y0 = s.light_anchor + u[:, :1] * s.light_u + u[:, 1:] * s.light_v
    rest = 0.2 + 2.1 * torch.rand((batch, n_edges - 1, 3), generator=gen)
    pos = torch.cat([y0[:, None], rest, s.eye.expand(batch, 1, 3)], 1)
    prev = torch.cat([pos[:, :1], pos[:, :-2]], 1)
    toward = (torch.nn.functional.normalize(pos[:, 1:] - pos[:, :-1], dim=-1)
              + torch.nn.functional.normalize(prev - pos[:, :-1], dim=-1))
    normal = torch.nn.functional.normalize(toward, dim=-1)
    normal[:, 0] = s.light_normal
    normal = torch.cat([normal, normal[:, -1:]], 1)
    cont = 0.2 + 0.8 * torch.rand((batch, n_edges + 1), generator=gen)
    return s, pos, normal, cont, torch.full((batch,), n_edges)


def float64_split_pdfs(s, pos, normal, cont, n, n_light_paths):
    """n_s p_s of every split, as plain products in float64: Veach's
    formula written once more, apart from the module's log sums."""
    pf, pr = (x.double() for x in vcm.vertex_pdfs(s, pos, normal, cont, n,
                                                   32, 32))
    out = []
    for k in range(pf.shape[1] + 1):
        p = torch.ones(pf.shape[0], dtype=torch.float64)
        for i in range(pf.shape[1]):
            p = p * (pf[:, i] if i < k else pr[:, i])
        out.append(p * (n_light_paths if k == pf.shape[1] else 1))
    return torch.stack(out, 1)


@pytest.mark.parametrize("n_edges", [1, 2, 3, 7, 20])
def test_the_weights_of_every_split_sum_to_one(n_edges):
    gen = torch.Generator().manual_seed(n_edges)
    s, pos, normal, cont, n = random_paths(n_edges, 64, gen)
    splits = 1 if n_edges == 1 else n_edges + 1
    w = torch.stack([vcm.mis_weight(s, pos, normal, cont, n,
                                    torch.full_like(n, k), 32, 32, 1024)
                     for k in range(splits)], 1)
    assert torch.all(w >= 0)
    torch.testing.assert_close(w.sum(1), torch.ones(64), rtol=0,
                               atol=1e-5)
    p = float64_split_pdfs(s, pos, normal, cont, n, 1024)[:, :splits]
    torch.testing.assert_close(w.double(), p / p.sum(1, keepdim=True),
                               rtol=1e-4, atol=1e-6)


def test_a_padded_path_weighs_as_the_path_alone():
    """Paths of different lengths share a batch: past its eye a path's
    entries change no weight."""
    gen = torch.Generator().manual_seed(3)
    s, pos, normal, cont, n = random_paths(5, 16, gen)
    alone = [vcm.mis_weight(s, pos, normal, cont, n, torch.full_like(n, k),
                            32, 32, 1024) for k in range(6)]
    junk = torch.rand((16, 4, 3), generator=gen)
    padded = (torch.cat([pos, junk], 1), torch.cat([normal, junk], 1),
              torch.cat([cont, junk[..., 0]], 1))
    for k in range(6):
        torch.testing.assert_close(
            vcm.mis_weight(s, *padded, n, torch.full_like(n, k), 32, 32,
                           1024), alone[k], rtol=1e-5, atol=1e-7)


def test_uncapped_vcm_agrees_with_the_path_tracer():
    """At 40 bounces neither estimator's cap matters: both estimate the
    same image, CornellSmall at 16x16 with seeded random kd."""
    W = H = 16
    fields = dict(FIELDS, width=W, height=H, vcm_max_path_length=40,
                  pt_max_segments_nee=40)
    s = scene.load("CornellSmall", "cpu")
    g = torch.Generator().manual_seed(11)
    for m in range(3):      # the white, green and red diffuse materials
        s = s.with_values(m, 0.15 + 0.6 * torch.rand(3, generator=g))
    check = {"tile": 8, "queries": 256, "light_paths": 512}
    gen = torch.Generator().manual_seed(12)
    n = 40
    rows_vcm = torch.stack([vcm.iteration_tiles(s, fields, check, i, gen)[0]
                            for i in range(n)])
    rows_pt = torch.stack([pt.iteration_tiles(s, fields, check, i, gen)[0]
                           for i in range(n)])
    numbers = compare.tile_numbers(rows_vcm.mean(0), rows_vcm, rows_pt)
    ok, table = compare.judge(numbers, LIMITS)
    assert ok, table


def test_the_reference_refuses_what_it_does_not_estimate():
    s = scene.load("CornellSmall", "cpu")
    gen = torch.Generator().manual_seed(0)
    check = {"tile": 8, "queries": 4, "light_paths": 4}
    for key, value in (("vcm_use_vm", True),
                       ("vcm_uniform_vertex_sampling", True),
                       ("vcm_connect_camera_t1", False),
                       ("vcm_force_continuation_prob", 0.5)):
        fields = dict(FIELDS, width=16, height=16, **{key: value})
        with pytest.raises(ValueError, match=key):
            vcm.iteration_tiles(s, fields, check, 0, gen)


def test_the_reference_imports_only_torch_and_its_scene():
    tree = ast.parse((ROOT / "port_bench/reference/vcm.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert names <= {"__future__", "dataclasses", "math", "torch",
                     ".scene"}, names


# ---------------------------------------------------------------------------
# the cell, rehearsed on the CPU through the program's Renderer
# ---------------------------------------------------------------------------

def test_the_cell_runs_the_upstream_vcm_deployment():
    """The cell's configuration is a file of its own, with the estimator's
    upstream settings: VC on, VM off, path length 10, nothing cut, and the
    scene and resolution of the default deployment."""
    assert SPEC["config"] != "cornell_small"
    cfg = json.loads((ROOT / f"port_bench/configs/{SPEC['config']}.json")
                     .read_text())
    base = json.loads((ROOT / "port_bench/configs/cornell_small.json")
                      .read_text())
    assert cfg["source"] != base["source"] and cfg["reduced"] == []
    assert (cfg["scene"], cfg["width"], cfg["height"]) == (
        "CornellSmall", 512, 512)
    assert (FIELDS["vcm_use_vc"], FIELDS["vcm_use_vm"],
            FIELDS["vcm_max_path_length"]) == (True, False, 10)


def rehearse(seconds):
    return runner.run(CELL, SEED, seconds, False, time.perf_counter(),
                      device_name="cpu")


def test_the_rehearsal_is_correct():
    res = rehearse(10.0)
    assert res["correct"], res["check"]
    assert set(res["check"]) == set(LIMITS)
    assert res["attempted"] >= 4


def _no_splats(monkeypatch):
    real = port_vcm._connect_camera_t1
    monkeypatch.setattr(port_vcm, "_connect_camera_t1",
                        lambda *a, **k: torch.zeros_like(real(*a, **k)))


def _unit_connection_weight(monkeypatch):
    """Every vertex connection at MIS weight 1: the partial sums of the
    other strategies' pdfs (dVCM, dVC) read as zero there, and nowhere
    else."""
    real = port_vcm._connect_vertices

    def connect(cam_bsdf, cam_cont, cam_hit, cam_thr, cam_dVCM, cam_dVC,
                lv_bsdf, lv_cont, lv_pos, lv_thr, lv_dVCM, lv_dVC, *rest,
                **kw):
        zero = torch.zeros_like
        return real(cam_bsdf, cam_cont, cam_hit, cam_thr, zero(cam_dVCM),
                    zero(cam_dVC), lv_bsdf, lv_cont, lv_pos, lv_thr,
                    zero(lv_dVCM), zero(lv_dVC), *rest, **kw)
    monkeypatch.setattr(port_vcm, "_connect_vertices", connect)


@pytest.mark.parametrize("fault", [_no_splats, _unit_connection_weight],
                         ids=["no_splats", "unit_connection_weight"])
def test_the_rehearsal_fails_with_a_fault(monkeypatch, fault):
    fault(monkeypatch)
    res = rehearse(10.0)
    assert not res["correct"]
    over = [k for k, v in res["check"].items()
            if math.isfinite(v["value"]) and v["value"] > v["limit"]]
    assert over, res["check"]


# ---------------------------------------------------------------------------
# the spans and their readers
# ---------------------------------------------------------------------------

def vcm_renderer(size=16, device="cpu"):
    sc, cam = get_scene_by_name("CornellSmall", device)
    return Renderer(sc, cam, RenderConfig(width=size, height=size,
                                          render_method=VCM), seed=5)


class OpCount(TorchDispatchMode):
    """The operators dispatched, less the profiler's own."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != "profiler":
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_an_eager_vcm_body_records_its_connect_and_splat_ranges():
    L = FIELDS["vcm_max_path_length"]
    with OpCount() as quiet:
        vcm_renderer().compute_iteration(0)
    with torch.profiler.profile() as prof:
        with OpCount() as traced:
            vcm_renderer().compute_iteration(0)
    trace = Trace.of(prof)
    (light,) = trace.ranges("vcm_light_pass")
    (camera,) = trace.ranges("vcm_camera_pass")
    splats = trace.ranges("vcm_splat")
    connects = trace.ranges("vcm_connect")
    assert len(splats) == L - 1 and len(connects) == L

    def inside(outer, e):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])
    assert all(inside(light, e) for e in splats)
    assert all(inside(camera, e) for e in connects)
    # the ranges add no operation to the body
    assert traced.n == quiet.n > 0


def synthetic_eager_body() -> list:
    """An eager body's trace events: each range holds the launch of one
    kernel of 100 us times its index, and a nested range's launch counts
    once."""
    events, t, corr = [], 0.0, 0
    for i, name in enumerate(["vcm_light_pass", "vcm_splat", "vcm_connect",
                              "vcm_connect", "vcm_camera_pass"], start=1):
        corr += 1
        events += [
            {"ph": "X", "cat": "user_annotation", "name": name, "ts": t,
             "dur": 50, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t + 10, "dur": 5, "pid": 1, "tid": 1,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": t + 20,
             "dur": 100.0 * i, "pid": 0, "tid": 7,
             "args": {"correlation": corr}}]
        t += 1000
    # a splat range nested in the light pass's, around one more kernel
    events += [
        {"ph": "X", "cat": "user_annotation", "name": "vcm_light_pass",
         "ts": t, "dur": 80, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "vcm_splat",
         "ts": t + 5, "dur": 40, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": t + 10, "dur": 5, "pid": 1, "tid": 1,
         "args": {"correlation": 99}},
        {"ph": "X", "cat": "kernel", "name": "k6", "ts": t + 20,
         "dur": 600.0, "pid": 0, "tid": 7, "args": {"correlation": 99}}]
    return events


@pytest.mark.parametrize("name,want", [("vcm_light_pass_ms", 0.7),
                                       ("vcm_splat_ms", 0.8),
                                       ("vcm_connect_ms", 0.7)])
def test_reader_on_a_synthetic_eager_body(name, want):
    ctx = Context(cell=None, spans={}, trace=None, steps=[],
                  eager=Trace(synthetic_eager_body()), work=None)
    assert cells.reader(name)(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_range_or_an_eager_body_gives_none(name):
    events = [e for e in synthetic_eager_body()
              if e["name"] != READERS[name]]
    ctx = Context(cell=None, spans={}, trace=None, steps=[],
                  eager=Trace(events), work=None)
    assert cells.reader(name)(ctx) is None
    assert cells.reader(name)(Context(cell=None, spans={}, trace=None,
                                      steps=[], eager=None,
                                      work=None)) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_captured_vcm_replay_launches_what_it_did_without_spans(
        cuda, monkeypatch):
    from contextlib import nullcontext

    def replay_ops():
        r = vcm_renderer(64, cuda)
        r.render(2)                 # the eager run, the capture, a replay
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            r.render(1)
            torch.cuda.synchronize(cuda)
        ops = Trace.of(prof).launched_under(lambda n: n == "capture.replay")
        return len(ops), dict(r.captured_step.capture_launches)

    with_spans = replay_ops()
    monkeypatch.setattr(port_vcm, "span", lambda name: nullcontext())
    assert with_spans[0] > 0
    assert replay_ops() == with_spans
