"""The readings a cell's limits are set from, beside the program's own
(each benchmark run prints the numbers it compared).

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3
        [--faults] [--n-iter 200] [--device cpu]

For each seed it puts the control in the program's place and prints the
numbers the cell's check compares: the plain reference with its rays
held in bfloat16 (the precision below the float32 that the
configuration states), drawn as the program would be (a render cell's
tiles over ``--n-iter`` iterations, a gradient cell's one draw a checked
step), against the reference in float32. The smallest of those is a
limit's upper reading. With ``--faults`` a gradient cell also reads each
fault of its loop in the float32 reference put in the program's place
(:data:`FAULTS`). One JSON line a reading, then a summary line with each
number's smallest. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

FAULTS = ("unchanged", "half", "altered")
ALTERED = 1.05      # an altered answer: 5% off where it is produced


def _gen(seed: int, salt: int, device):
    g = torch.Generator(device=device)
    g.manual_seed((seed * 7919 + salt) % (1 << 63))
    return g


def render_numbers(cell, seed: int, device, rehearsal: bool,
                   n_iter: int) -> dict:
    """The control's numbers: the bfloat16 reference's tiles as the
    program's window, batched as the window is, against the float32
    reference's."""
    from port_bench.harness import compare
    from port_bench.harness.window import check_of, render_fields
    from port_bench.loops import progressive

    scene_name, fields = render_fields(cell, rehearsal)
    check = check_of(cell, rehearsal)
    low, _ = progressive.reference_rows(cell, seed + 1, scene_name, fields,
                                        check, n_iter, device,
                                        low_precision=True)
    ref, _ = progressive.reference_rows(cell, seed, scene_name, fields,
                                        check, n_iter, device)
    b = int(check["batches"])
    per = low.shape[0] // b
    batches = low[:per * b].reshape(b, per, -1).mean(1)
    return compare.tile_numbers(low.mean(0), batches, ref)


def gradient_numbers(cell, seed: int, device, rehearsal: bool,
                     kind: str = "control") -> dict:
    """The numbers of one draw a checked step in the program's place: the
    bfloat16 reference (``kind`` "control"), or the float32 reference
    broken by a fault: "unchanged", the steps leave the values as they
    were; "half", the lower half of the image's rows left out and the
    mean taken over the rest; "altered", the loss and gradients 5% off
    where they are produced."""
    from port_bench.harness import cells, compare
    from port_bench.harness.window import check_of, render_fields
    from port_bench.loops import gradient
    from port_bench.reference import scene as ref_scene

    scene_name, fields = render_fields(cell, rehearsal)
    check = check_of(cell, rehearsal)
    wrt = [tuple(k) for k in cell.traffic["wrt"]]
    lr = float(cell.traffic["learning_rate"])
    n_first = int(cell.traffic["checked_steps"])
    passes = int(check["passes"])
    method = cells.reference(cell.traffic["reference"])
    s = ref_scene.load(scene_name, device)
    placed = ref_scene.load(scene_name, device,
                            low_precision=(kind == "control"))
    rows = (fields["height"] // 2, fields["height"]) if kind == "half" \
        else None
    gen = _gen(seed, 1, device)
    draws, ref_change = gradient.reference_start(cell, fields, wrt, lr,
                                                 n_first, passes, s, gen)
    mine, _ = gradient.reference_start(cell, fields, wrt, lr, n_first, 1,
                                       placed, _gen(seed, 2, device), rows)
    steps = []
    change = torch.zeros_like(ref_change["mean"])
    for d, m in zip(draws, mine):
        prog = m[0] * (ALTERED if kind == "altered" else 1.0)
        steps.append({"program": prog, "reference": d})
        change = change - lr * prog[1:]
    values = gradient.initial_values(s, wrt)
    for _ in range(int(check["window_steps"])):
        d = gradient.reference_draws(method, s, fields, wrt, values, passes,
                                     gen)
        m = gradient.reference_draws(method, placed, fields, wrt, values, 1,
                                     gen, rows)[0]
        steps.append({"program": m * (ALTERED if kind == "altered" else 1.0),
                      "reference": d})
    if kind == "unchanged":
        change = torch.zeros_like(change)
    return compare.gradient_numbers(steps, {"program": change, **ref_change})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--n-iter", type=int, default=200)
    ap.add_argument("--device", choices=("cpu",), default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench.harness import card, cells

    cell = cells.resolve(args.workload, benchmark=cells.load_benchmark())
    rehearsal = args.device == "cpu"
    if not rehearsal:
        card.require(cell.chips)
    device = torch.device("cpu" if rehearsal else "cuda:0")
    grad = cell.traffic["loop"] == "gradient"
    kinds = ["control"] + (list(FAULTS) if grad and args.faults else [])
    least: dict = {}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        for kind in kinds:
            t = time.perf_counter()
            numbers = (gradient_numbers(cell, s, device, rehearsal, kind)
                       if grad else
                       render_numbers(cell, s, device, rehearsal,
                                      args.n_iter))
            print(json.dumps({"run": kind, "seed": s, "numbers": numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            for k, v in numbers.items():
                least.setdefault(kind, {})
                least[kind][k] = min(least[kind].get(k, v), v)
    print(json.dumps({"workload": cell.name, "least": least,
                      "device": card.describe(device, cell.chips)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
