"""Per-pass device timing for PPM and VCM: the port of
``scripts/pass_timing.py``, with its passes, their inputs and its eight
names, so that optimization effort goes where the milliseconds are.

Each pass runs alone on the inputs of the JAX script: the pass keys
``iteration_key(root, 0, PASS_*)`` of seed 0, the gather's
``fold_in(estimate key, 55)`` stream and ``r2 = 0.002``. On the card a
pass is one ``capture.CapturedCall``, the counterpart of the script's
per-pass ``jax.jit``: its first call runs the pass eagerly and captures
it, and is left out, as JAX leaves out the compile; then the median of
``--reps`` replays, each on the host clock between synchronizes. With
``--cpu`` the pass runs eagerly: once to warm up, then ``--reps`` times.

One deliberate difference: ``ppm_gather`` times the gather that the
port's PPM iteration takes at that size (``ppm.gather_on_grid``): the
tile gather (B3) when the image splits into 16x16 blocks, as at 512^2,
else the budgeted gather. JAX's script times its budgeted XLA gather even
where its iteration runs the Pallas tile gather. The script prints this
on its own line.

Usage:
  python -m oppositerenderer_tpu_torch.scripts.pass_timing [--size 512] \
      [--reps 5] [--scene CornellSmall] [--method ppm|vcm|both] [--cpu]
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Callable

import torch

from ..capture import CapturedCall
from ..devices import resolve_device

NAMES = ("ppm_eye", "ppm_photon", "ppm_grid_build", "ppm_gather",
         "ppm_full_iteration", "vcm_light", "vcm_camera",
         "vcm_full_iteration")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_pass(fn: Callable[[], Any], reps: int, device: torch.device
              ) -> dict:
    """Times ``fn``: its first call (on the card eager, then the capture)
    and the median of ``reps`` later calls (on the card replays), each
    between synchronizes. Returns {"seconds": the median, "first_seconds",
    "launches": each wrapper's launches over the timed calls (none on the
    CPU, where no kernel launches), "out": the first call's result}."""
    call = CapturedCall(fn, device) if device.type == "cuda" else None
    run = call.run if call is not None else fn
    _sync(device)
    t0 = time.perf_counter()
    out = run()
    _sync(device)
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    launches = {}
    if call is not None:
        launches = call.launches()
        call.release()
    return {"seconds": statistics.median(ts), "first_seconds": first,
            "launches": launches, "out": out}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--scene", default="CornellSmall")
    ap.add_argument("--method", default="ppm", choices=["ppm", "vcm", "both"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    return ap


def main(argv=None) -> dict:
    """Prints one ``name  ms`` line a pass; returns {name: time_pass's
    record without its output}."""
    args = build_parser().parse_args(argv)
    from ..config import RenderConfig, RenderMethod
    from ..core.rng import device_key, iteration_key, make_root_key
    from ..integrators import ppm, vcm
    from ..integrators.common import pixel_coords, scene_epsilon
    from ..photon_map import build_photon_grid, min_cell_size_for_window
    from ..scene import get_scene_by_name

    device = resolve_device("cpu" if args.cpu else None)
    scene, cam = get_scene_by_name(args.scene, device)
    W = H = args.size
    n = W * H
    key = device_key(make_root_key(0), device)
    r2 = torch.full((), 0.002, dtype=torch.float32, device=device)
    radius = torch.sqrt(r2)
    eps = scene_epsilon(scene)
    px, py = pixel_coords(W, H, device)
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device={name} scene={args.scene} {W}x{H}", flush=True)

    results = {}

    def timed(label, fn):
        rec = time_pass(fn, args.reps, device)
        print(f"{label:24s} {rec['seconds'] * 1e3:9.2f} ms", flush=True)
        results[label] = {k: v for k, v in rec.items() if k != "out"}
        return rec["out"]

    if args.method in ("ppm", "both"):
        cfg = RenderConfig(width=W, height=H, render_method=RenderMethod.
                           PROGRESSIVE_PHOTON_MAPPING)
        ekey = iteration_key(key, 0, ppm.PASS_PPM_EYE)
        pkey = iteration_key(key, 0, ppm.PASS_PPM_PHOTON)
        gkey = iteration_key(key, 0, ppm.PASS_PPM_ESTIMATE)
        plane = torch.arange(cfg.photons_per_iteration, dtype=torch.int64,
                             device=device)
        tiled = W % 16 == 0 and H % 16 == 0
        print("note: ppm_gather times the port's gather at "
              f"{W}x{H}: the " + (
                  "tile gather (B3, gather_photons_tiled)" if tiled else
                  "budgeted gather (the image has no 16x16 blocks)")
              + "; JAX's script times its budgeted XLA gather", flush=True)

        hp = timed("ppm_eye", lambda: ppm.trace_eye_pass(
            scene, cam, cfg, ekey, eps, px, py, lanes))
        photons, _vol, _stats = timed("ppm_photon", lambda: ppm.
                                      trace_photon_pass(scene, cfg, pkey,
                                                        eps, plane))
        mcs = min_cell_size_for_window(radius, 4)
        grid = timed("ppm_grid_build", lambda: build_photon_grid(
            photons, cfg.photon_grid_resolution, min_cell_size=mcs))
        timed("ppm_gather", lambda: ppm.gather_on_grid(
            cfg, hp, grid, radius, gkey, lanes))
        timed("ppm_full_iteration", lambda: ppm.render_iteration(
            scene, cam, cfg, 0, key, r2))

    if args.method in ("vcm", "both"):
        cfg = RenderConfig(width=W, height=H, render_method=RenderMethod.
                           VCM_BIDIRECTIONAL_PATH_TRACING)
        vm_w, vc_w = vcm.mis_factors(cfg, r2)
        lkey = iteration_key(key, 0, vcm.PASS_VCM_LIGHT)
        ckey = iteration_key(key, 0, vcm.PASS_VCM_CAMERA)
        store, _splat, _ = timed("vcm_light", lambda: vcm.trace_light_pass(
            scene, cam, cfg, lkey, eps, vc_w, vm_w, lanes, n))
        pair = torch.arange(n, dtype=torch.int64, device=device)
        timed("vcm_camera", lambda: vcm.trace_camera_pass(
            scene, cam, cfg, ckey, eps, vc_w, vm_w, store, n, px, py, lanes,
            pair))
        timed("vcm_full_iteration", lambda: vcm.render_iteration(
            scene, cam, cfg, 0, key, r2))
    return results


if __name__ == "__main__":
    main()
