"""Benchmark of the PyTorch port: rays/s per card on the classic Cornell
scenes and the BVH scenes. The port of ``bench.py``, with its six cases,
its ray accounting, its load guard, its protocol and its one JSON line.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}. The headline is PT rays/s on CornellSmall 512^2; the detail
holds the PPM, VCM, VCM+VM, Atrium and Conference cases of the same run.
Each case records bench.py's keys (median, min and spread of its reps,
the load guard's reading, the time to its first frames) and two of the
port's: ``graph``, whether its renders replayed a captured CUDA graph,
and ``launches``, each kernel wrapper's launches over its reps.

Ray accounting is bench.py's: every intersect call counts its full lane
width (closest-hit and shadow rays), live or not. ``vs_baseline`` is
measured against the same nominal 1e8 rays/s for one GPU of the
reference's era.

On the card a Renderer captures one iteration in a CUDA graph at its
first render and replays it (``renderer.CapturedStep``); the warm-up
render takes that capture, and its seconds are ``compile_seconds``, the
time to the first frames, as JAX's compile is. Each timed rep ends in
``torch.cuda.synchronize()``: a replay returns before the card has
finished. The kernels' nvcc build runs before the first case
(``detail["build_seconds"]``), so no case's first frames carry it.

Usage (the CUDA card by default; ``--quick --device cpu`` rehearses it on
the CPU, where the kernels' plain versions run):

    python3 bench_torch.py [--quick] [--size 512] [--iters 20]
        [--method all|pt|ppm|vcm] [--scene CornellSmall] [--no-atrium]
        [--cheap-rng] [--device cuda|cpu] [--write-perf PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from oppositerenderer_tpu_torch.devices import card_line

REPO = Path(__file__).resolve().parent
CASES = ("pt", "ppm", "vcm", "vcm_vm", "atrium_pt", "conference_pt")


def pt_rays_per_iteration(cfg) -> int:
    """Closest-hit + shadow ray lanes per PT iteration (bench.py:28-33)."""
    n = cfg.width * cfg.height
    segs = cfg.pt_max_segments
    shadow = segs * cfg.pt_shadow_samples
    return n * (segs + shadow)


def ppm_rays_per_iteration(cfg) -> int:
    """Eye, photon and shadow ray lanes per PPM iteration (bench.py:36-40)."""
    n = cfg.n_pixels
    return (n * cfg.max_radiance_trace_depth
            + cfg.photons_per_iteration * cfg.max_photon_trace_depth
            + n * cfg.ppm_direct_shadow_samples)


def vcm_rays_per_iteration(cfg) -> int:
    """Ray lanes per VCM iteration (bench.py:43-48): light pass trace and
    t=1 shadow rays, camera pass trace, s=1 shadow rays and (L-1) vertex
    connections per bounce."""
    n = cfg.n_pixels
    L = cfg.vcm_max_path_length
    return n * (L - 1) * 2 + n * L * (2 + (L - 1))


RAYS_PER_ITERATION = {"pt": pt_rays_per_iteration,
                      "ppm": ppm_rays_per_iteration,
                      "vcm": vcm_rays_per_iteration}

# Contention guard (bench.py:51-72). The load is sampled before each case;
# a 1-minute average at or above the threshold means that a second
# process competes with the bench, and its numbers carry it. The guard
# annotates and never refuses, so every run leaves a record, but
# `load_ok: false` marks the numbers as contended. bench.py's 1.25 was set
# for a 2-core host: the bench's own process keeps the average near 1.0,
# and a second busy process takes it to about 2.0. The card's host has 8
# cores, shared with other work, so a second process no longer saturates
# it, but the guard's question stays whether one runs: the threshold stays
# one process plus a margin, below the 2.0 of two, and the margin is
# wider, 0.5, for the threads and the background of a larger host. Some
# containers do not report the load: they read 0.00 for every average
# (and no process in /proc/loadavg) while the bench runs, which no host
# running the bench can; such a reading is recorded as not measured
# (None), as bench.py records a host without a load average.
LOAD_THRESHOLD = 1.5


def _load_ok():
    """(1-minute load average, or None where the host reports none;
    whether it is below the threshold); warns on stderr when it is not."""
    try:
        loads = os.getloadavg()
    except OSError:
        return None, True
    if not any(loads):
        return None, True
    load1 = loads[0]
    ok = load1 < LOAD_THRESHOLD
    if not ok:
        print(f"bench_torch.py: WARNING load1={load1:.2f} >= "
              f"{LOAD_THRESHOLD} - a competing process is running; numbers "
              "are contended", file=sys.stderr)
    return load1, ok


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts(r=None, graph_before: dict | None = None) -> dict:
    """Each render kernel's launches: its wrapper's count (eager
    iterations), plus the graph replays of the Renderer ``r`` since
    ``graph_before`` (``r.kernel_launches()``: capture counts x replays; a
    replay calls no wrapper)."""
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    graph = r.kernel_launches() if r is not None else {}
    before = graph_before or {}
    return {w.__name__: w.launches + graph.get(w.__name__, 0)
            - before.get(w.__name__, 0) for w in kernel_wrappers()}


def timed_renders(r, iters: int, reps: int):
    """bench.py's reps: ``reps`` renders of ``iters`` iterations, each
    after ``r.restart()``, each on the host clock between synchronizes.
    Every wrapper's count is set to 0 before a rep and read after it.
    Returns (the seconds of each rep, the launches of each rep)."""
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    times, launches = [], []
    for _ in range(max(1, reps)):
        r.restart()
        for w in kernel_wrappers():
            w.launches = 0
        graph_before = r.kernel_launches()
        _sync(r.device)
        t0 = time.perf_counter()
        r.render(iters)
        _sync(r.device)
        times.append(time.perf_counter() - t0)
        launches.append(launch_counts(r, graph_before))
    return times, launches


def run_case(scene_name: str, method_name: str, size: int, iters: int,
             cfg_extra: dict | None = None, reps: int = 3,
             device=None) -> dict:
    """Returns a metrics dict for one (scene, method) case (bench.py:79-136):
    one warm-up render, then ``reps`` timed renders, each after a
    restart; the MEDIAN, min and spread ((max - min) / median)."""
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    from oppositerenderer_tpu_torch.devices import resolve_device
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    device = resolve_device(device)
    method = {"pt": RenderMethod.PATH_TRACING,
              "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
              "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}[method_name]
    scene, camera = get_scene_by_name(scene_name, device)
    cfg = RenderConfig(width=size, height=size, render_method=method,
                       iterations_per_dispatch=iters, **(cfg_extra or {}))
    rays_per_iter = RAYS_PER_ITERATION[method_name](cfg)

    load1, load_ok = _load_ok()
    r = Renderer(scene, camera, cfg, seed=0)
    _sync(device)
    t0 = time.perf_counter()
    r.render(iters)           # the first frames: eager, then the capture
    _sync(device)
    compile_s = time.perf_counter() - t0   # = time to first frame(s)
    times, per_rep = timed_renders(r, iters, reps)
    dt = statistics.median(times)
    spread = (max(times) - min(times)) / dt if dt else 0.0
    launches = {k: sum(rep[k] for rep in per_rep) for k in per_rep[0]}

    rays_per_s = rays_per_iter * iters / dt
    return {
        "scene": scene_name,
        "method": method_name,
        "rays_per_s": round(rays_per_s),
        "resolution": f"{size}x{size}",
        "iterations": iters,
        "seconds": dt,
        "ms_per_iteration": dt / iters * 1000,
        "ms_per_iteration_min": min(times) / iters * 1000,
        "spread": spread,
        "reps": len(times),
        "load_1m": load1,
        "load_ok": load_ok,
        "compile_seconds": compile_s,
        "samples_per_s": round(cfg.n_pixels * iters / dt),
        "graph": r.uses_graph(),
        "launches": launches,
    }


def build_kernels(device: torch.device) -> float | None:
    """Seconds to build (nvcc, unless ``_build/`` holds this key's library)
    and load the kernel library on the card; None on the CPU, where
    nothing is built."""
    if device.type != "cuda":
        return None
    from oppositerenderer_tpu_torch.accel import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    return time.perf_counter() - t0


def write_perf_md(path, result) -> None:
    """A table of THIS run's JSON at ``path``, headed by the device. It
    holds nothing else: the repo's PERF.md is kept by hand."""
    import datetime
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True,
                             cwd=REPO).stdout.strip()
    except OSError:
        rev = ""
    d = result["detail"]
    lines = [
        "# bench_torch.py run (generated)",
        "",
        f"Generated by `python3 bench_torch.py --write-perf` at "
        f"{datetime.datetime.now():%Y-%m-%d %H:%M} on `{d['device']}`, "
        f"git `{rev or 'unknown'}`. Every number below comes from this "
        "run's JSON.",
        "",
        "| case | scene | resolution | ms/iter (median) | min | spread "
        "| rays/s | first frames s | load 1m | load ok | graph |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    # --method all: a row a case; one method: the detail is its case
    cases = [(k, d[k]) for k in CASES if k in d] or [(d["method"], d)]
    for key, c in cases:
        lines.append(
            f"| {key} | {c['scene']} | {c['resolution']} | "
            f"{c['ms_per_iteration']:.3f} | {c['ms_per_iteration_min']:.3f} "
            f"| {c['spread']:.4f} | {c['rays_per_s']:,} | "
            f"{c['compile_seconds']:.3f} | {c['load_1m']} | {c['load_ok']} "
            f"| {c['graph']} |")
    lines += ["",
              f"Headline: `{result['metric']}` = {result['value']:,} "
              f"rays/s ({result['vs_baseline']}x the nominal 1e8 "
              "reference-GPU baseline).", ""]
    Path(path).write_text("\n".join(lines))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="small + few iters")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--method", default="all",
                    choices=["all", "pt", "ppm", "vcm"])
    ap.add_argument("--scene", default="CornellSmall",
                    help="built-in scene name (e.g. Atrium = Sponza-class "
                         "260k-tri stress scene) or .dae/.obj path")
    ap.add_argument("--no-atrium", action="store_true",
                    help="skip the Atrium and Conference (BVH) cases in "
                         "--method all runs")
    ap.add_argument("--cheap-rng", action="store_true",
                    help="hash RNG (USE_CHEAP_RANDOM analog)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, which must "
                         "be present; cpu runs the plain PyTorch versions)")
    ap.add_argument("--write-perf", metavar="PATH", default=None,
                    help="write a table of THIS run at PATH (never the "
                         "repo's PERF.md, which is kept by hand)")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.write_perf and \
            Path(args.write_perf).resolve() == REPO / "PERF.md":
        ap.error("--write-perf may not overwrite the repo's PERF.md")
    from oppositerenderer_tpu_torch.devices import resolve_device
    device = resolve_device(args.device)

    size = 128 if args.quick else args.size
    iters = 4 if args.quick else args.iters

    extra = {}
    if args.cheap_rng:
        extra["use_cheap_random"] = True
    if args.quick:
        extra["photons_per_iteration"] = 1 << 16

    detail = {"device": card_line() if device.type == "cuda" else "cpu",
              "graph": False, "build_seconds": build_kernels(device)}

    def case(scene, method, sz, n, cfg_extra):
        return run_case(scene, method, sz, n, cfg_extra, device=device)

    if args.method != "all":
        headline = case(args.scene, args.method, size, iters, extra)
        detail.update(headline)
        metric = f"{args.method}_rays_per_s_per_chip"
    else:
        headline = case(args.scene, "pt", size, iters, extra)
        detail["pt"] = headline
        detail["ppm"] = case(
            args.scene, "ppm", size, max(2, iters // 4),
            {**extra, "photons_per_iteration":
             extra.get("photons_per_iteration", 1 << 20)})
        detail["vcm"] = case(args.scene, "vcm", size, max(2, iters // 4),
                             extra)
        # full VCM with vertex merging
        detail["vcm_vm"] = case(args.scene, "vcm", size, 2,
                                {**extra, "vcm_use_vm": True})
        if not args.no_atrium and not args.quick:
            detail["atrium_pt"] = case("Atrium", "pt", size,
                                       max(2, iters // 4), extra)
            # BASELINE.md's milestone-4 regime (Sponza/Conference-class
            # 1024^2) as a tracked number
            detail["conference_pt"] = case("Conference", "pt", 1024, 2,
                                           extra)
        detail["graph"] = all(detail[k]["graph"] for k in CASES
                              if k in detail)
        metric = "pt_rays_per_s_per_chip"

    result = {
        "metric": metric,
        "value": headline["rays_per_s"],
        "unit": "rays/s",
        "vs_baseline": round(headline["rays_per_s"] / 1e8, 4),
        "detail": detail,
    }
    if args.write_perf:
        write_perf_md(args.write_perf, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
