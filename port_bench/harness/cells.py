"""Cells, configurations, traffic mixes and metric readers, found by name.

A cell ``<cell>`` is the file ``cells/<cell>.json`` under the benchmark's
directory: the configuration and the traffic mix it runs, the cards it
needs, and what its check compares (``check``) with each number's limit
(``limits``). The configuration ``<config>`` is ``configs/<config>.json``
(the scene, the resolution, the ``RenderConfig`` fields as the upstream
project sets them), the traffic mix ``<mix>`` is ``traffic/<mix>.json``
(the loop the window drives, the plain reference that checks it, and
their parameters), the loop ``<loop>`` is ``loops/<loop>.py``, the plain
reference ``<name>`` is ``reference/<name>.py``, and a per-layer metric
``<metric>`` is the reader ``metrics/<metric>.py``, whose ``read(ctx)``
returns the metric's value or None. ``BENCHMARK.json`` says which metrics
each cell reports. A later cell, mix, loop, reference, configuration or
metric is a new file and a new entry there: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    limits: dict
    rehearsal_check: dict  # the check's parameters at the rehearsal size
    end_to_end: list       # BENCHMARK.json's entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict | None:
    path = root / "BENCHMARK.json"
    return load_json(path) if path.exists() else None


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``,
    or, without that key, reporting the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def resolve(name: str, bench_dir: Path = BENCH_DIR,
            benchmark: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, its traffic mix and, from
    ``benchmark`` (BENCHMARK.json's content), the metrics it reports.
    Raises where a file is missing or BENCHMARK.json's entry for the cell
    names another configuration, mix or card count."""
    spec = load_json(bench_dir / "cells" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{spec['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{spec['traffic']}.json")
    e2e, per_layer = [], []
    if benchmark is not None:
        entry = {w["name"]: w for w in benchmark["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        for key, ours in (("config", spec["config"]),
                          ("traffic", spec["traffic"]),
                          ("chips", spec["chips"])):
            if entry[key] != ours:
                raise ValueError(f"cell {name}: BENCHMARK.json's {key} "
                                 f"{entry[key]!r}, cells/{name}.json's "
                                 f"{ours!r}")
        e2e = [m for m in benchmark["end_to_end"]
               if name in m.get("workloads", [name])]
        names = {m["name"] for m in e2e}
        per_layer = [m for m in benchmark["per_layer"]
                     if _reports(m, name, names)]
        for m in per_layer:
            if not (bench_dir / "metrics" / f"{m['name']}.py").exists():
                raise FileNotFoundError(f"no reader metrics/{m['name']}.py")
    return Cell(name=name, config_name=spec["config"],
                traffic_name=spec["traffic"], chips=int(spec["chips"]),
                config=config, traffic=traffic,
                check=spec.get("check", {}), limits=spec.get("limits", {}),
                rehearsal_check=spec.get("rehearsal_check", {}),
                end_to_end=e2e, per_layer=per_layer)


def _module(kind: str, name: str, bench_dir: Path):
    """The module ``<kind>/<name>.py`` under ``bench_dir``, loaded once.
    Under the benchmark's own directory it is imported as a module of
    the package; elsewhere (a throwaway directory) from its file."""
    path = bench_dir / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind}/{name}.py")
    if bench_dir == BENCH_DIR and "." not in name:
        return importlib.import_module(f"port_bench.{kind}.{name}")
    key = f"port_bench_{kind}_{bench_dir.name}_{name.replace('.', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric, bench_dir).read


def loop(name: str, bench_dir: Path = BENCH_DIR):
    """The ``run`` function of ``loops/<name>.py``: the loop a traffic mix
    names."""
    return _module("loops", name, bench_dir).run


def reference(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``reference/<name>.py``: the plain reference a traffic
    mix names."""
    return _module("reference", name, bench_dir)
