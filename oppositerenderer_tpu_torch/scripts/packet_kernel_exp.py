"""Microbenchmark of the packet node step (B6): the port of
``scripts/packet_kernel_exp.py``, with its arguments and its two lines.

G tiles of 1024 rays walk STEPS synthetic nodes of an [R, 128] float32
table, slab-testing 8 children a step
(``accel/packet_exp_kernels.py`` states the contract). The inputs are the
JAX script's: ``np.random.default_rng(0)`` draws the table, then the
origins, then the directions. One warm-up call, then ``--reps`` timed
calls (CUDA events around each on the card, the host clock on the CPU);
the median is printed as ns per node-step per tile and per ray-step.

Usage:
  python -m oppositerenderer_tpu_torch.scripts.packet_kernel_exp \
      [--steps 64] [--tiles 64] [--rows 49152] [--reps 5] \
      [--variant scalar] [--cpu]

On the card it launches the CUDA kernel (``csrc/packet_exp.cu``); with
``--cpu`` it runs the plain PyTorch version. ``--variant`` takes the JAX
script's choices, the ablation of the step, each mapped onto Hopper:

- ``scalar``: the row prefetched by ``cp.async`` a step ahead (both
  candidate next rows), one tile-wide parity count a step.
- ``vmem_smem``: the row staged at its own step by plain loads and a
  barrier, no prefetch (the first design's staging).
- ``hbm_vmem``: the row by a TMA bulk copy at its own step, waited.
- ``hbm_smem``: the row by ``cp.async`` at its own step, waited. It is
  ``vmem_smem``'s code with another copy instruction: on this card every
  row comes from L2, so the TPU's memory spaces have no separate
  counterparts.
- ``noscalar``: no staging; every thread reads the row from global memory.
- ``fixedrow``: the tile's first row staged once: the slab tests and the
  count alone (the TPU variant leaves its row unwritten; this one defines
  it).
- ``dmaonly``: the row's load and one read a step, no slab test.
- ``noreduce``: no count and no barrier (each warp prefetches its own row).
- ``onereduce``: one tile-wide max of the rays' 8-bit hit masks a step.

The first five give the same ``best``; the others their own.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from ..accel.packet_exp_kernels import VARIANTS, packet_steps
from ..devices import resolve_device


def make_inputs(rows: int, tiles: int, device) -> tuple[torch.Tensor, ...]:
    """(table [R, 128], o, d [G, 3, 8, 128]) float32, drawn as the JAX
    script draws them."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(rows, 128)).astype(np.float32)
    o = rng.normal(size=(tiles, 3, 8, 128)).astype(np.float32)
    d = rng.normal(size=(tiles, 3, 8, 128)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (table, o, d))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--tiles", type=int, default=64)
    ap.add_argument("--rows", type=int, default=48 * 1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variant", default="scalar", choices=VARIANTS)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch version on the CPU")
    return ap


def timed_call(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn``, finished on the device."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be >= 1")
    device = resolve_device("cpu" if args.cpu else None)
    table, o, d = make_inputs(args.rows, args.tiles, device)
    G, STEPS, R = args.tiles, args.steps, args.rows

    def run():
        return packet_steps(table, o, d, STEPS, args.variant)

    out = run()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("packet_steps returned non-finite values")
    t = statistics.median(timed_call(run, device) for _ in range(args.reps))
    per_step = t / (G * STEPS)
    per_ray_step = per_step / 1024
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device={name} G={G} STEPS={STEPS} R={R}")
    print(f"total {t*1e3:.2f} ms -> {per_step*1e9:.1f} ns/node-step/tile "
          f"-> {per_ray_step*1e9:.3f} ns/ray/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
