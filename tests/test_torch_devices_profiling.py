"""The port's device repository (ComputeDeviceRepository analog) and
profiling utilities: ``tests/test_devices_profiling.py``'s checks on the
port. The repository lists the CUDA cards, then the CPU; the profiler's
events carry a ``pass_scope``'s name where JAX's lowered HLO does.
"""
import json
import time

import pytest
import torch

from oppositerenderer_tpu_torch import cli
from oppositerenderer_tpu_torch.config import RenderConfig
from oppositerenderer_tpu_torch.core.profiling import (BenchmarkTimer,
                                                       pass_scope, trace)
from oppositerenderer_tpu_torch.devices import ComputeDeviceRepository
from oppositerenderer_tpu_torch.integrators import pt
from oppositerenderer_tpu_torch.core.rng import make_root_key
from oppositerenderer_tpu_torch.scene import get_scene_by_name


def test_repository_enumerates_all_devices():
    repo = ComputeDeviceRepository.enumerate()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert len(repo) == n_cards + 1          # the cards, then the CPU
    for i, d in enumerate(repo.devices):
        assert d.ordinal == i
        assert d.platform == ("gpu" if i < n_cards else "cpu")
    assert repo.devices[-1].device == "cpu"
    assert len(repo.table().splitlines()) == len(repo)


def test_repository_pick_returns_live_device():
    repo = ComputeDeviceRepository.enumerate()
    dev = repo.pick(len(repo) - 1)
    assert dev == torch.device("cpu")
    x = torch.ones(4, device=dev)
    assert x.device == dev
    for bad in (len(repo), -1):
        with pytest.raises(ValueError):
            repo.pick(bad)


def test_pass_scope_inside_profiler():
    with torch.profiler.profile() as prof:
        with pass_scope("my_render_pass") as out:
            y = out(torch.tensor(3.0) * 2.0)
    assert float(y) == 6.0
    # the scope is a named range of the profile, as in JAX's HLO
    assert "my_render_pass" in {e.name for e in prof.events()}


def test_trace_none_is_noop():
    with trace(None) as prof:
        pass
    assert prof is None


def test_trace_captures_to_logdir(tmp_path):
    logdir = tmp_path / "prof"
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(width=8, height=8)
    with trace(str(logdir)):
        pt.render_iteration(scene, cam, cfg, 0, make_root_key(0))
    assert any(logdir.rglob("*")), "no profile output written"
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert "pt_raytrace_pass" in {e.get("name") for e in events}


def test_benchmark_timer_pausable():
    t = BenchmarkTimer(start=True)
    time.sleep(0.02)
    t.pause()
    s1 = t.seconds
    assert s1 >= 0.015
    time.sleep(0.02)
    assert t.seconds == s1  # paused: no accumulation
    t.start()
    time.sleep(0.01)
    assert t.seconds > s1
    assert t.running
    t.restart()
    assert t.seconds < 0.01


def test_cli_lists_the_cpu_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--list-devices"]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert rows == ["[0] cpu (cpu, cpu)"]


def test_cli_profile_writes_a_trace(tmp_path):
    assert cli.main(["--cpu", "--method", "pt", "--size", "8", "-n", "1",
                     "-q", "-o", str(tmp_path / "x.png"), "--profile",
                     str(tmp_path / "prof")]) == 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "pt_raytrace_pass" in {e.get("name")
                                  for e in events["traceEvents"]}
