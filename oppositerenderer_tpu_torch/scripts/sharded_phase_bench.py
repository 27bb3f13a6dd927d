"""The cost of one sharded iteration in each exchange regime: the port of
``scripts/sharded_phase_bench.py``.

Times one sharded iteration (``parallel.render``'s step, a ``render``
case of ``parallel.worker``) of CornellSmall at iteration 0, seed 0,
r^2 = 0.002, in the JAX script's four regimes:

* PPM, photon exchange ``ALL_TO_ALL`` (each photon to the rank owning its
  grid row);
* PPM, photon exchange ``ALL_GATHER`` (every rank gets every photon);
* VCM with 1:1 paired stores (light subpaths stay on their rank);
* VCM with uniform vertex sampling (the store is all-gathered).

All four run in one spawn of ``--ranks`` worker processes
(``worker.spawn_ranks``). A regime's wall time is the median over 3
steps after one warm-up, each step synchronized on its own and timed as
the slowest rank's. On a
CUDA rank over NCCL the step replays a captured CUDA graph after its
first call; gloo ranks run it eagerly. Where ranks share one card (gloo
with fewer cards than ranks) the times measure the distribution's
overhead, not its scaling: the header says so.

Two byte columns:

* ``bytes sent``: what the port's exchange collectives carry in the
  step, summed over ranks. All-to-all: every rank sends its D slabs of
  ``exchange.slab_capacity`` rows of ``PHOTON_COLUMNS`` + 1 float32
  (validity travels as a column). All-gather: every rank sends its
  photon rows (one a deposit: ``max_photon_trace_depth`` x P/D; position,
  power and direction in float32, validity as a byte) to the D - 1
  others. VCM uniform: the step's own
  ``vcm_gathered_store_bytes_per_device``, the store each device holds
  after the all-gather, which the JAX script reports; VCM paired: 0.
* ``model``: the JAX script's model (``scripts/sharded_phase_bench.py:
  73-75``) at D ranks: a 37-byte photon row, P x 37 x (D - 1) / D for the
  all-to-all and P x 37 x (D - 1) for the all-gather; for VCM the stat.

Prints the JAX script's markdown table, its wall column naming the
device, the backend and D, then one JSON line with the same rows. Writes
no file in the repository.

Usage:
  python -m oppositerenderer_tpu_torch.scripts.sharded_phase_bench \\
      [--ranks 8] [--size 128] [--device cuda|cpu] [--backend nccl|gloo]

One card: ``--ranks 4 --backend gloo`` (the ranks share it); a machine
with four cards: ``--ranks 4 --backend nccl``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import tempfile
from pathlib import Path

import numpy as np

# the JAX script's photon row: position, power, direction, validity
MODEL_ROW_BYTES = 37
# bytes of a photon row as the port's all-gather carries it: nine float32
# and the validity flag as one byte (``Mesh._collective``)
GATHER_ROW_BYTES = 9 * 4 + 1
# (name, RenderConfig fields) in the JAX script's order
REGIMES = (
    ("ppm all_to_all", dict(render_method="PROGRESSIVE_PHOTON_MAPPING",
                            photon_exchange="ALL_TO_ALL")),
    ("ppm all_gather", dict(render_method="PROGRESSIVE_PHOTON_MAPPING",
                            photon_exchange="ALL_GATHER")),
    ("vcm paired (local stores)", dict(
        render_method="VCM_BIDIRECTIONAL_PATH_TRACING",
        vcm_uniform_vertex_sampling=False)),
    ("vcm uniform (global store)", dict(
        render_method="VCM_BIDIRECTIONAL_PATH_TRACING",
        vcm_uniform_vertex_sampling=True)),
)


def regime_cases(size: int = 128, photons: int = 1 << 16,
                 path_length: int = 6, reps: int = 3) -> list[dict]:
    """The four regimes as ``render`` cases of ``parallel.worker``."""
    cases = []
    for name, fields in REGIMES:
        cfg = dict(width=size, height=size, **fields)
        if fields["render_method"] == "PROGRESSIVE_PHOTON_MAPPING":
            cfg["photons_per_iteration"] = photons
        else:
            cfg["vcm_max_path_length"] = path_length
        # "vcm paired (local stores)" -> "vcm_paired"
        cases.append(dict(name=name.split(" (")[0].replace(" ", "_"),
                          kind="render", cfg=cfg, seed=0, iteration=0,
                          radius_sq=0.002, reps=reps, time_each_rep=True))
    return cases


def bytes_sent(case: dict, ranks: int, stats: dict) -> int:
    """The bytes the regime's exchange collectives carry in one step,
    summed over ranks (the module docstring)."""
    from ..parallel.exchange import PHOTON_COLUMNS, slab_capacity
    from ..parallel.worker import config_from
    cfg = config_from(case["cfg"])
    if cfg.render_method.name != "PROGRESSIVE_PHOTON_MAPPING":
        return int(stats.get("vcm_gathered_store_bytes_per_device", 0))
    rows = cfg.photons_per_iteration // ranks * cfg.max_photon_trace_depth
    if cfg.photon_exchange.name == "ALL_TO_ALL":
        cap = slab_capacity(rows, ranks, cfg.photon_exchange_capacity_factor)
        return ranks * ranks * cap * (PHOTON_COLUMNS + 1) * 4
    return ranks * (ranks - 1) * rows * GATHER_ROW_BYTES


def model_bytes(case: dict, ranks: int, stats: dict) -> int:
    """The JAX script's "data moved" at D = ``ranks``: its 37-byte model
    for PPM, the gathered-store stat for VCM."""
    cfg = case["cfg"]
    if cfg["render_method"] != "PROGRESSIVE_PHOTON_MAPPING":
        return int(stats.get("vcm_gathered_store_bytes_per_device", 0))
    p = cfg["photons_per_iteration"]
    if cfg["photon_exchange"] == "ALL_TO_ALL":
        return p * MODEL_ROW_BYTES * (ranks - 1) // ranks
    return p * MODEL_ROW_BYTES * (ranks - 1)


def rows_of(z: dict, cases: list[dict], ranks: int) -> list[dict]:
    """One row a regime from the workers' results ``z``."""
    rows = []
    for (regime, _), c in zip(REGIMES, cases):
        n = c["name"]
        stats = {k[len(n) + 6:]: float(v) for k, v in z.items()
                 if k.startswith(n + ".stat.")}
        extra = {k: int(v) for k, v in stats.items()
                 if "overflow" in k or "bytes" in k}
        rows.append({
            "regime": regime,
            "wall_ms": statistics.median(
                float(t) for t in z[n + ".ms_reps"]),
            "wall_ms_reps": [float(t) for t in z[n + ".ms_reps"]],
            "bytes_sent": bytes_sent(c, ranks, stats),
            "model_bytes": model_bytes(c, ranks, stats),
            "stats": extra,
            "launches": {k[len(n) + 10:]: int(v) for k, v in z.items()
                         if k.startswith(n + ".launches.") and int(v)}})
    return rows


def run(ranks: int, device: str = "cuda", backend: str | None = None,
        size: int = 128, photons: int = 1 << 16, path_length: int = 6,
        reps: int = 3, timeout: float = 900.0
        ) -> tuple[list[dict], dict, str]:
    """The four regimes over ``ranks`` worker processes: (rows, the
    workers' arrays, the ranks' description). Raises before spawning
    where the ranks cannot run (no card, NCCL with fewer cards than
    ranks)."""
    from ..parallel.worker import describe_ranks, spawn_ranks
    desc = describe_ranks(device, backend, ranks)
    cases = regime_cases(size, photons, path_length, reps)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "regimes.npz"
        spawn_ranks(ranks, cases, out, device=device, backend=backend,
                    timeout=timeout)
        z = dict(np.load(out))
    return rows_of(z, cases, ranks), z, desc


def table(rows: list[dict], desc: str) -> str:
    """The JAX script's markdown table (``:94-98``), with the bytes the
    port sends beside the JAX script's model."""
    lines = [f"| regime | wall/iter ({desc}) | bytes sent | data moved "
             "(JAX's 37 B model) | stats |", "|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['regime']} | {r['wall_ms']:.3f} ms | "
                     f"{r['bytes_sent'] / 1e6:.3f} MB | "
                     f"{r['model_bytes'] / 1e6:.3f} MB | {r['stats']} |")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8,
                    help="worker processes (the JAX script's 8 devices)")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank where there are enough) or "
                         "cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: the device's)")
    return ap


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    rows, _, desc = run(args.ranks, args.device, args.backend, args.size)
    print(table(rows, desc), flush=True)
    print(json.dumps({"ranks": args.ranks, "device": desc,
                      "size": args.size, "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
