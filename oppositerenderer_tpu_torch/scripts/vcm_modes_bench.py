"""The cost of the four VCM estimator modes: the port of
``scripts/vcm_modes_bench.py``.

Times one CornellSmall VCM iteration (``vcm.render_iteration`` at
iteration 1, seed 0, r^2 = 0.0004) for the four combinations of vertex
merging x uniform vertex sampling, and reports the gathered-store bytes
that the sharded path would all-gather in the global-store regimes
(``parallel/render.py``), by the JAX script's formula. On the card each
mode is one ``capture.CapturedCall``: its first call (eager, then the
capture) is printed as ``compile``, then the median of ``--reps``
replays; with ``--cpu`` the iteration runs eagerly.

Usage:
  python -m oppositerenderer_tpu_torch.scripts.vcm_modes_bench \
      [--size 512] [--reps 3] [--cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..devices import resolve_device
from .pass_timing import time_pass


def gathered_store_mb(size: int, cfg) -> float:
    """The store a device gathers in the sharded global-store regimes:
    n_pixels paths x (max_path_length - 1) slots of about 20 float32
    (LightVertexStore: pos3 + wo3 + thr3 + dVCM + dVC + dVM + mat + ns3 +
    ng3 + depth + valid)."""
    slots = size * size * (cfg.vcm_max_path_length - 1)
    return slots * 20 * 4 / 1e6


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    return ap


def main(argv=None) -> list[dict]:
    """Prints one line a mode; returns a record a mode (vm, uniform,
    seconds, first_seconds, store_mb, launches)."""
    args = build_parser().parse_args(argv)
    from ..config import RenderConfig, RenderMethod
    from ..core.rng import device_key, make_root_key
    from ..integrators import vcm
    from ..scene import get_scene_by_name

    device = resolve_device("cpu" if args.cpu else None)
    scene, cam = get_scene_by_name("CornellSmall", device)
    key = device_key(make_root_key(0), device)
    r2 = torch.full((), 0.0004, dtype=torch.float32, device=device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device={name} CornellSmall {args.size}^2", flush=True)

    records = []
    for use_vm in (False, True):
        for uniform in (False, True):
            cfg = RenderConfig(
                width=args.size, height=args.size,
                render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING,
                vcm_use_vm=use_vm, vcm_uniform_vertex_sampling=uniform)
            rec = time_pass(lambda cfg=cfg: vcm.render_iteration(
                scene, cam, cfg, 1, key, r2)[0], args.reps, device)
            med, compile_s = rec["seconds"], rec["first_seconds"]
            store_mb = gathered_store_mb(args.size, cfg)
            print(f"vm={int(use_vm)} uniform={int(uniform)}: "
                  f"{med*1e3:7.1f} ms/iter  compile {compile_s:6.1f}s  "
                  f"(global-store regime gathers ~{store_mb:.0f} MB/device)"
                  if (use_vm or uniform) else
                  f"vm={int(use_vm)} uniform={int(uniform)}: "
                  f"{med*1e3:7.1f} ms/iter  compile {compile_s:6.1f}s  "
                  f"(local store, no gather)", flush=True)
            records.append({"vm": use_vm, "uniform": uniform,
                            "seconds": med, "first_seconds": compile_s,
                            "store_mb": store_mb,
                            "launches": rec["launches"]})
    return records


if __name__ == "__main__":
    main()
