"""The port's measurement entry points against the JAX repo's own:
``bench_torch.py`` against ``bench.py`` (its ray accounting on every
case's configuration, the record's keys, the one JSON line, the table of
``--write-perf``, the load guard), the per-pass timer and the VCM-mode
timer against ``scripts/pass_timing.py`` and ``scripts/vcm_modes_bench.py``
(their names and the gathered-store formula), and the port's import
purity. Everything runs on the CPU, where the kernels' plain versions
run and no kernel launches.
"""
import ast
import contextlib
import functools
import io
import json
import re
import sys
from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU, set up by the conftest)
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import bench_torch  # noqa: E402
from oppositerenderer_tpu.config import RenderConfig as JConfig  # noqa: E402
from oppositerenderer_tpu_torch import config  # noqa: E402
from oppositerenderer_tpu_torch.config import RenderConfig  # noqa: E402
from oppositerenderer_tpu_torch.scripts import (pass_timing,  # noqa: E402
                                                vcm_modes_bench)

# bench.py's six cases (bench.py:230-255: scene, size, iterations and the
# extra fields at the defaults --size 512 --iters 20) and --quick's
# (128^2, 4 iterations, 1<<16 photons)
CASE_CONFIGS = {
    "pt": dict(width=512, height=512, iterations_per_dispatch=20),
    "ppm": dict(width=512, height=512, iterations_per_dispatch=5,
                photons_per_iteration=1 << 20),
    "vcm": dict(width=512, height=512, iterations_per_dispatch=5),
    "vcm_vm": dict(width=512, height=512, iterations_per_dispatch=2,
                   vcm_use_vm=True),
    "atrium_pt": dict(width=512, height=512, iterations_per_dispatch=5),
    "conference_pt": dict(width=1024, height=1024,
                          iterations_per_dispatch=2),
    "quick": dict(width=128, height=128, iterations_per_dispatch=4,
                  photons_per_iteration=1 << 16),
    "quick_ppm": dict(width=128, height=128, iterations_per_dispatch=2,
                      photons_per_iteration=1 << 16),
}
ACCOUNTING = ("pt_rays_per_iteration", "ppm_rays_per_iteration",
              "vcm_rays_per_iteration")
# the port's cases for the record's keys: (method, size, iterations, extra)
PORT_CASES = {
    "pt": ("pt", 32, 2, {}),
    "ppm": ("ppm", 32, 1, {"photons_per_iteration": 1 << 12}),
    "vcm": ("vcm", 16, 1, {}),
    "vcm_vm": ("vcm", 16, 1, {"vcm_use_vm": True}),
}
FORBIDDEN_ROOTS = {"jax", "jaxlib", "bench", "oppositerenderer_tpu"}


@pytest.mark.parametrize("case", sorted(CASE_CONFIGS))
def test_ray_accounting_equals_bench(case):
    kw = CASE_CONFIGS[case]
    want, got = JConfig(**kw), RenderConfig(**kw)
    for name in ACCOUNTING:
        assert getattr(bench_torch, name)(got) == \
            getattr(bench, name)(want), name


def test_chip_smoke_keeps_no_copy_of_the_accounting():
    """One ``card_line``, the port's ``devices.card_line``, which
    bench_torch imports, and one ray accounting, bench_torch's: neither
    chip_smoke.py (read, not imported) nor bench_torch.py defines another."""
    from oppositerenderer_tpu_torch import devices
    assert bench_torch.card_line is devices.card_line
    for path in ("chip_smoke.py", "bench_torch.py"):
        src = (REPO / path).read_text()
        assert not re.search(r"^def card_line\b", src, re.M), path
    src = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^def \w*rays_per_iteration", src, re.M)
    for name in ACCOUNTING:
        assert name in vars(bench_torch), name


@pytest.fixture(scope="module")
def jax_record():
    """JAX's bench.run_case for PT at 16^2, one iteration, one rep."""
    return bench.run_case("CornellSmall", "pt", 16, 1, reps=1)


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_run_case_record_has_the_jax_keys(case, jax_record):
    method, size, iters, extra = PORT_CASES[case]
    rec = bench_torch.run_case("CornellSmall", method, size, iters, extra,
                               reps=1, device="cpu")
    assert set(jax_record) <= set(rec)
    assert set(rec) - set(jax_record) == {"graph", "launches"}
    assert (rec["scene"], rec["method"], rec["resolution"],
            rec["iterations"], rec["reps"]) == (
        "CornellSmall", method, f"{size}x{size}", iters, 1)
    cfg = RenderConfig(width=size, height=size, **extra)
    rays = bench_torch.RAYS_PER_ITERATION[method](cfg)
    assert rec["rays_per_s"] == round(rays * iters / rec["seconds"]) > 0
    assert rec["ms_per_iteration"] == pytest.approx(
        rec["seconds"] / iters * 1e3)
    assert rec["spread"] == 0.0 and rec["compile_seconds"] > 0
    # the CPU runs the eager body and the plain versions: no graph, no
    # launch
    assert rec["graph"] is False
    assert set(rec["launches"].values()) == {0}


def _result_keys_of_bench_main() -> set:
    """The keys of the dict ``result`` that bench.py's main prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets]
                == ["result"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no result dict")


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """``bench_torch.py --quick --method pt --device cpu --write-perf``:
    (its stdout, its result, the table it wrote)."""
    table = tmp_path_factory.mktemp("bench") / "table.md"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = bench_torch.main(["--quick", "--method", "pt", "--device",
                                   "cpu", "--write-perf", str(table)])
    return out.getvalue(), result, table.read_text()


def test_cli_prints_one_json_line(quick_run):
    stdout, result, _ = quick_run
    lines = stdout.splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert set(printed) == _result_keys_of_bench_main()
    assert printed == json.loads(json.dumps(result))
    assert printed["metric"] == "pt_rays_per_s_per_chip"
    assert printed["unit"] == "rays/s"
    assert printed["vs_baseline"] == round(printed["value"] / 1e8, 4)
    d = printed["detail"]
    assert d["device"] == "cpu" and d["graph"] is False
    assert d["build_seconds"] is None
    assert (d["resolution"], d["iterations"]) == ("128x128", 4)


def test_write_perf_names_the_device_and_nothing_of_perf_notes(quick_run):
    _, result, table = quick_run
    assert "on `cpu`" in table
    rows = [ln for ln in table.splitlines() if ln.startswith("| pt |")]
    assert rows == [rows[0]] and rows[0].startswith(
        f"| pt | CornellSmall | 128x128 | "
        f"{result['detail']['ms_per_iteration']:.3f} |")
    notes = (REPO / "PERF_NOTES.md").read_text().splitlines()
    assert not [ln for ln in notes if len(ln) > 30 and ln in table]


def test_write_perf_refuses_the_repos_perf_md():
    with pytest.raises(SystemExit):
        bench_torch.main(["--quick", "--device", "cpu", "--write-perf",
                          str(REPO / "PERF.md")])


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--quick", "--method", "pt"])


@pytest.mark.parametrize("load, want", [
    ((3.0, 1.0, 1.0), (3.0, False)),
    ((bench_torch.LOAD_THRESHOLD - 0.01, 0.0, 0.0),
     (bench_torch.LOAD_THRESHOLD - 0.01, True)),
    (OSError, (None, True)),
    ((0.0, 0.0, 0.0), (None, True)),    # a host that reports no load
])
def test_load_guard(monkeypatch, capsys, load, want):
    def getloadavg():
        if load is OSError:
            raise OSError("no load average")
        return load
    monkeypatch.setattr(bench_torch.os, "getloadavg", getloadavg)
    assert bench_torch._load_ok() == want
    warned = "a competing process is running" in capsys.readouterr().err
    assert warned == (want[1] is False)


def test_pass_timing_prints_the_jax_names(monkeypatch, capsys):
    """The eight names of JAX's script, in its order, at 32^2 (PPM with
    1<<12 photons a pass, to keep the CPU run short)."""
    src = (REPO / "scripts" / "pass_timing.py").read_text()
    jax_names = tuple(re.findall(r'results\["(\w+)"\] = ', src))
    assert jax_names == pass_timing.NAMES
    monkeypatch.setattr(config, "RenderConfig", functools.partial(
        RenderConfig, photons_per_iteration=1 << 12))
    res = pass_timing.main(["--cpu", "--size", "32", "--reps", "1",
                            "--method", "both"])
    lines = capsys.readouterr().out.splitlines()
    timed = [ln.split()[0] for ln in lines if ln.endswith(" ms")]
    assert tuple(timed) == tuple(res) == jax_names
    assert any(ln.startswith("note: ppm_gather") and "tile gather (B3" in ln
               for ln in lines)
    assert all(r["seconds"] > 0 and r["launches"] == {}
               for r in res.values())


def test_vcm_modes_prints_four_modes_with_the_jax_store_formula(capsys):
    recs = vcm_modes_bench.main(["--cpu", "--size", "16", "--reps", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("vm=")]
    assert len(recs) == len(lines) == 4
    for rec, line in zip(recs, lines):
        cfg = JConfig(width=16, height=16, vcm_use_vm=rec["vm"],
                      vcm_uniform_vertex_sampling=rec["uniform"])
        # scripts/vcm_modes_bench.py:66-72
        slots = 16 * 16 * (cfg.vcm_max_path_length - 1)
        store_mb = slots * 20 * 4 / 1e6
        assert rec["store_mb"] == store_mb
        assert line.startswith(f"vm={int(rec['vm'])} "
                               f"uniform={int(rec['uniform'])}: ")
        assert line.endswith(
            f"(global-store regime gathers ~{store_mb:.0f} MB/device)"
            if rec["vm"] or rec["uniform"] else "(local store, no gather)")
        assert rec["seconds"] > 0
    assert [(r["vm"], r["uniform"]) for r in recs] == [
        (False, False), (False, True), (True, False), (True, True)]


def test_the_port_imports_nothing_of_jax():
    """No module of the port, nor its top-level scripts and the test data
    the kernel table shares with the card tests, imports JAX, the JAX
    bench or the JAX package."""
    files = sorted((REPO / "oppositerenderer_tpu_torch").rglob("*.py"))
    files += [REPO / f for f in ("chip_smoke.py", "bench_torch.py",
                                 "milestone4_torch.py",
                                 "tests/_torch_cases.py")]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN_ROOTS]
    assert len(files) > 50
    assert not bad
