"""Each cell once on the card, a short window: the result line is
correct and names the card. Marked ``cuda``; skips without a card.

    python -m pytest -m cuda port_bench/tests/test_port_bench_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]
                                      if w["chips"] == 1])
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          workload, "--seed", str(2 ** 31 + 7), "--seconds",
                          "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
