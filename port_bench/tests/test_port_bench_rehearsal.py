"""Each cell rehearsed on the CPU at its configuration's rehearsal size,
the result line's form, the exits without a card, without the program
and with JAX loaded, and the check failing under each fault the cells
can have: a step that leaves its state unchanged, half of the batch left
out with the mean taken over the rest, an answer altered where it is
produced."""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from port_bench.harness import runner

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
RENDER_CELLS = [w["name"] for w in BENCH["workloads"]
                if w["traffic"] != "pt_grad"]
SEED = 2 ** 31 + 12345          # above 32 signed bits, as a run's seed may be
# PPM's iterations are slow on the CPU: its rehearsal window is longer
SECONDS = {"cornell_small.ppm": 8.0}
# At the rehearsal's 32x32 the program's tile gather subsamples whole
# 16x16 blocks with large weights, so a window's few PPM iterations
# spread too far for the card's limits: there the sound rehearsal's
# numbers are only read, and the faults checked against the limits.
SOUND_ON_THE_CPU = [c for c in CELLS if c != "cornell_small.ppm"]


def rehearse(cell, trace=False, seconds=None, seed=SEED):
    return runner.run(cell, seed, seconds or SECONDS.get(cell, 3.0), trace,
                      time.perf_counter(), device_name="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_well_formed(cell):
    res = rehearse(cell)
    assert all(math.isfinite(v["value"]) for v in res["check"].values())
    if cell in SOUND_ON_THE_CPU:
        assert res["correct"], res["check"]
        assert res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in BENCH["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "check"


def test_traced_rehearsal_reads_the_host_spans():
    res = rehearse("cornell_small.ppm", trace=True)
    assert all(math.isfinite(v["value"]) for v in res["check"].values())
    assert res["metrics"]["capture_s"]["value"] > 0
    # the CPU has no device trace: the device's readers find nothing
    assert "roofline.b1_closest" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_same_seed_draws_the_same_reference():
    from port_bench.harness import cells
    from port_bench.harness.window import check_of, render_fields
    from port_bench.loops import progressive
    cell = cells.resolve("cornell_small.pt", benchmark=BENCH)
    name, fields = render_fields(cell, True)
    check = check_of(cell, True)
    a, _ = progressive.reference_rows(cell, SEED, name, fields, check, 30,
                                      torch.device("cpu"))
    b, _ = progressive.reference_rows(cell, SEED, name, fields, check, 30,
                                      torch.device("cpu"))
    assert torch.equal(a, b)


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=600)


def test_without_a_card_it_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(["--workload", "cornell_small.ppm", "--seed", "1",
                "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_it_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "_build"))
    out = _run(["--workload", "cornell_small.ppm", "--seed", "1",
                "--seconds", "1", "--trace", "0", "--device", "cpu"],
               tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_jax_loaded_it_exits_without_a_result(tmp_path):
    # a module of the JAX package's top-level name, put on the path
    fake = tmp_path / "oppositerenderer_tpu"
    fake.mkdir()
    (fake / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text(
        "import oppositerenderer_tpu\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = _run(["--workload", "cornell_small.pt_grad", "--seed", "1",
                "--seconds", "0.3", "--trace", "0", "--device", "cpu"],
               ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "oppositerenderer_tpu" in out.stderr


# --- faults: the timed path broken underneath ------------------------------

def _unchanged_film(monkeypatch):
    from oppositerenderer_tpu_torch import film
    monkeypatch.setattr(film.Film, "add_iterations",
                        lambda self, rad, n: film.Film(self.accum.clone(),
                                                       self.iterations + n))


def _half_batch(monkeypatch):
    """Half of each iteration's lanes (the first half in lane order, the
    image's lower rows) left out, the rest doubled so the image keeps its
    mean."""
    from oppositerenderer_tpu_torch import renderer

    real = renderer.Renderer._raw_step

    def raw(self):
        step = real(self)

        def half(*a):
            rad, stats = step(*a)
            keep = torch.full_like(rad, 2.0)
            keep.view(-1, 3)[:keep.numel() // 6] = 0.0
            return rad * keep, stats
        return half
    monkeypatch.setattr(renderer.Renderer, "_raw_step", raw)


def _altered_answer(monkeypatch):
    """Each iteration's radiance doubled where the integrator produces
    it."""
    from oppositerenderer_tpu_torch import renderer

    real = renderer.Renderer._raw_step

    def raw(self):
        step = real(self)
        return lambda *a: (lambda r, s: (r * 2.0, s))(*step(*a))
    monkeypatch.setattr(renderer.Renderer, "_raw_step", raw)


@pytest.mark.parametrize("cell", RENDER_CELLS)
@pytest.mark.parametrize("fault", [_unchanged_film, _half_batch,
                                   _altered_answer])
def test_a_broken_render_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = rehearse(cell)
    assert not res["correct"], res["check"]


def _grad_fault(kind):
    def apply(monkeypatch):
        from oppositerenderer_tpu_torch import diff
        from oppositerenderer_tpu_torch.integrators import pt
        real = diff.make_sharded_loss_and_grad
        if kind == "half":
            # the first half of the lanes left out, the mean taken over
            # the rest
            lanes_real = pt.render_lanes

            def half(*a, **k):
                rad = lanes_real(*a, **k)
                keep = torch.full_like(rad, 2.0)
                keep[:rad.shape[0] // 2] = 0.0
                return rad * keep
            monkeypatch.setattr(pt, "render_lanes", half)
            return

        def make(*a, **k):
            fn = real(*a, **k)

            def broken(values=None, **kw):
                loss, grads = fn(values, **kw)
                if kind == "unchanged":
                    grads = {g: torch.zeros_like(v) for g, v in grads.items()}
                else:
                    loss = loss * 2.0
                    grads = {g: v * 2.0 for g, v in grads.items()}
                return loss, grads
            return broken
        monkeypatch.setattr(diff, "make_sharded_loss_and_grad", make)
    return apply


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_gradient_step_is_not_correct(kind, monkeypatch):
    _grad_fault(kind)(monkeypatch)
    res = rehearse("cornell_small.pt_grad")
    assert not res["correct"], res["check"]
