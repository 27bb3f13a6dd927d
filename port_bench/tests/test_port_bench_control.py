"""The control comes out as not correct: the plain reference with its
rays held in bfloat16, the precision below the configuration's float32,
put in the program's place, fails a limit of each cell (at the
rehearsal size here; ``port_bench/control.py`` reads it on the card at
the cell's own size)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import control
from port_bench.harness import cells, compare

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(workload):
    cell = cells.resolve(workload, benchmark=BENCH)
    device, seed = torch.device("cpu"), 2 ** 31 + 99
    numbers = (control.gradient_numbers(cell, seed, device, True)
               if cell.traffic["loop"] == "gradient" else
               control.render_numbers(cell, seed, device, True, 30))
    ok, table = compare.judge(numbers, cell.limits)
    assert not ok, table
