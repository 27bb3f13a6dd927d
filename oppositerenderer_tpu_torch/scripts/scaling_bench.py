"""Multi-process scaling of iteration-sharded rendering: the port of
``scripts/scaling_bench.py`` and its worker ``tests/distributed_worker.py``.

Runs the same iteration-sharded job with 1 and then N worker processes
(``parallel.worker``'s ``scaling`` case: a ``MultiHostRenderer`` of
CornellSmall, 1<<12 photons, photon grid 16, gather budget 64, seed 5,
warmed up outside the clock; the processes barrier, process w renders
iterations w, w + N, ... and the films merge by one all-reduce). Each
process is pinned to one core with ``taskset`` (``--no-pin`` turns that
off), so the 1-process run and each of the N run on the same host share.

On the card rank r renders on ``cuda:r`` where the machine has N cards
(``--backend nccl``: the four-card run is ``--nproc 4 --backend nccl``);
with fewer cards the processes share ``cuda:0`` over gloo, and then the
speedup measures the protocol's overhead on one card, not scaling. Each
record's ``backend`` says which ran.

Prints one JSON line a method with the JAX record's keys; ``--table``
also prints the JAX script's markdown rows, ``--out PATH`` writes the
JSON list there. It never writes ``SCALING.md`` or ``scaling.json``.

Usage:
  python -m oppositerenderer_tpu_torch.scripts.scaling_bench \\
      [--nproc 2] [--iters 16] [--size 64] [--method pt[,ppm]] \\
      [--device cuda|cpu] [--backend nccl|gloo] [--no-pin] [--table] \\
      [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

METHODS = {"pt": "PATH_TRACING", "ppm": "PROGRESSIVE_PHOTON_MAPPING",
           "vcm": "VCM_BIDIRECTIONAL_PATH_TRACING"}
SEED = 5


def scaling_case(iters: int, size: int, method: str) -> dict:
    """``tests/distributed_worker.py``'s job as a ``scaling`` case."""
    return dict(name="scaling", kind="scaling", seed=SEED, iterations=iters,
                cfg=dict(width=size, height=size,
                         render_method=METHODS[method],
                         photons_per_iteration=1 << 12,
                         photon_grid_resolution=16,
                         gather_photon_budget=64))


def run_farm(nproc: int, iters: int, size: int, method: str,
             pin_cores: bool = True, device: str = "cuda",
             backend: str | None = None, threads: int = 0,
             timeout: float = 1200.0) -> tuple[float, dict]:
    """The job over ``nproc`` worker processes: (process 0's seconds,
    the workers' arrays, keys ``scaling.<key>``)."""
    from ..parallel.worker import spawn_ranks
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "merged.npz"
        spawn_ranks(nproc, [scaling_case(iters, size, method)], out,
                    device=device, backend=backend, threads=threads,
                    timeout=timeout, pin_cores=pin_cores)
        z = dict(np.load(out))
    return float(z["scaling.seconds"]), z


def method_iterations(method: str, iters: int) -> int:
    """The JAX script's iteration count: ``iters`` for PT, half (at
    least 4) for the others."""
    return iters if method == "pt" else max(4, iters // 2)


def measure(method: str, nproc: int, iters: int, size: int,
            pin_cores: bool = True, device: str = "cuda",
            backend: str | None = None, threads: int = 0
            ) -> tuple[dict, dict]:
    """One method over 1 and ``nproc`` processes: (the JAX record, the
    ``nproc`` run's arrays)."""
    from ..parallel.worker import describe_ranks
    desc = describe_ranks(device, backend, nproc)
    iters = method_iterations(method, iters)
    t1, _ = run_farm(1, iters, size, method, pin_cores, device, backend,
                     threads)
    tn, zn = run_farm(nproc, iters, size, method, pin_cores, device,
                      backend, threads)
    merge_s = float(zn["scaling.merge_seconds"])
    rec = {
        "method": method, "iterations": iters,
        "resolution": f"{size}x{size}",
        "seconds_1proc": round(t1, 3),
        f"seconds_{nproc}proc": round(tn, 3),
        "speedup": round(t1 / tn, 3),
        "scaling_efficiency": round(t1 / tn / nproc, 4),
        "merge_seconds": round(merge_s, 3),
        "protocol_overhead_fraction": round(merge_s / tn, 4),
        "backend": desc,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    return rec, zn


def table_rows(results: list[dict], nproc: int) -> str:
    """The JAX script's markdown rows (its SCALING.md table)."""
    return "\n".join(
        f"| {r['method']} | {r['resolution']} / {r['iterations']} it | "
        f"{r['seconds_1proc']} s | {r[f'seconds_{nproc}proc']} s | "
        f"{r['speedup']}x | {r['scaling_efficiency'] * 100:.1f}% | "
        f"{r['merge_seconds'] * 1e3:.0f} ms |"
        for r in results)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--method", default="pt",
                    help="comma list, e.g. pt,ppm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a process where there are enough) "
                         "or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: the device's)")
    ap.add_argument("--no-pin", action="store_true",
                    help="do not pin each process to one core")
    ap.add_argument("--table", action="store_true",
                    help="also print the markdown rows")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the JSON list of records here")
    return ap


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    results = []
    for method in args.method.split(","):
        rec, _ = measure(method, args.nproc, args.iters, args.size,
                         not args.no_pin, args.device, args.backend)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.table:
        print(f"| method | job | 1-proc | {args.nproc}-proc | speedup | "
              "efficiency | merge |\n|---|---|---|---|---|---|---|\n"
              + table_rows(results, args.nproc), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(results, indent=2) + "\n")
    return results


if __name__ == "__main__":
    main()
