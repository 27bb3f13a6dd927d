"""The benchmark's files: BENCHMARK.json against its contract, each cell
resolved by name to its configuration, mix and metric readers, and a
throwaway cell added from files alone."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench.harness import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|per_tok)")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_are_files_of_their_own_and_cut_no_width():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
        assert used, f"{c['name']} is used by no cell"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_by_name(workload):
    cell = cells.resolve(workload, benchmark=BENCH)
    entry = {w["name"]: w for w in BENCH["workloads"]}[workload]
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        entry["config"], entry["traffic"], entry["chips"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))
    assert cell.limits, "every compared number has a limit"


def test_per_layer_metrics_name_a_layer_and_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moves = e2e[m["moves"]]
        for w in m.get("workloads", []):
            assert w in moves.get("workloads", [w])


def test_a_throwaway_cell_resolves_from_files_alone(tmp_path):
    """A configuration, a mix, a loop, a reference, a cell and a metric,
    each a new file: the harness finds every one by name."""
    bench_dir = tmp_path / "bench"
    for sub in ("cells", "configs", "traffic", "metrics", "loops",
                "reference"):
        (bench_dir / sub).mkdir(parents=True)
    shutil.copy(ROOT / "port_bench/configs/cornell_small.json",
                bench_dir / "configs/tiny_box.json")
    (bench_dir / "traffic/slow_pt.json").write_text(json.dumps(
        {"loop": "every_other", "render_method": "PATH_TRACING",
         "reference": "flat_box", "warmup_steps": 1}))
    (bench_dir / "loops/every_other.py").write_text(
        "def run(cell, seed, seconds, trace, device, t0, rehearsal=False):\n"
        "    return 'every other frame'\n")
    (bench_dir / "reference/flat_box.py").write_text(
        "def iteration_tiles(s, fields, check, iteration, gen):\n"
        "    return None, None\n")
    (bench_dir / "cells/tiny_box.slow_pt.json").write_text(json.dumps(
        {"config": "tiny_box", "traffic": "slow_pt", "chips": 1,
         "check": {"tile": 8}, "limits": {"tile_z": 1.0}}))
    (bench_dir / "metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    bench = {"workloads": [{"name": "tiny_box.slow_pt", "config": "tiny_box",
                            "traffic": "slow_pt", "chips": 1}],
             "end_to_end": [{"name": "setup_s"},
                            {"name": "iter_ms",
                             "workloads": ["tiny_box.slow_pt"]}],
             "per_layer": [{"name": "frames_seen", "moves": "iter_ms"}]}
    cell = cells.resolve("tiny_box.slow_pt", bench_dir, bench)
    assert cell.traffic["render_method"] == "PATH_TRACING"
    assert cell.config["scene"] == "CornellSmall"
    assert [m["name"] for m in cell.per_layer] == ["frames_seen"]
    assert cells.reader("frames_seen", bench_dir)(None) == 7.0
    run = cells.loop(cell.traffic["loop"], bench_dir)
    assert run(cell, 1, 1.0, False, None, 0.0) == "every other frame"
    ref = cells.reference(cell.traffic["reference"], bench_dir)
    assert ref.iteration_tiles(None, {}, cell.check, 0, None) == (None, None)
    with pytest.raises(FileNotFoundError):
        cells.loop("no_such_loop", bench_dir)
    bench["workloads"][0]["chips"] = 4
    with pytest.raises(ValueError):
        cells.resolve("tiny_box.slow_pt", bench_dir, bench)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_mix_names_a_loop_and_a_reference_that_exist(workload):
    cell = cells.resolve(workload, benchmark=BENCH)
    assert callable(cells.loop(cell.traffic["loop"]))
    ref = cells.reference(cell.traffic["reference"])
    wanted = ("loss_and_grad" if cell.traffic["loop"] == "gradient"
              else "iteration_tiles")
    assert callable(getattr(ref, wanted))
