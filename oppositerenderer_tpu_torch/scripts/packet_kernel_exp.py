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
      [--steps 64] [--tiles 64] [--rows 49152] [--reps 5] [--cpu]

On the card it launches the CUDA kernel (``csrc/packet_exp.cu``); with
``--cpu`` it runs the plain PyTorch version. ``--variant`` takes the JAX
script's choices, of which only ``scalar`` is ported.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from ..accel.packet_exp_kernels import packet_steps
from ..devices import resolve_device

VARIANTS = ("scalar", "vmem_smem", "hbm_vmem", "hbm_smem", "fixedrow",
            "dmaonly", "noreduce", "onereduce", "noscalar")


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
    if args.variant != "scalar":
        ap.error(f"--variant {args.variant} is not ported: only the scalar "
                 "variant is (ROADMAP.md queue B, B6, lists the others)")
    if args.reps < 1:
        ap.error("--reps must be >= 1")
    device = resolve_device("cpu" if args.cpu else None)
    table, o, d = make_inputs(args.rows, args.tiles, device)
    G, STEPS, R = args.tiles, args.steps, args.rows

    def run():
        return packet_steps(table, o, d, STEPS)

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
