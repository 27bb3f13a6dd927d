"""Milestone configuration 4 on the PyTorch port: a Sponza-class scene
through a real Collada file at 1024^2, with PPM and VCM.

The port's counterpart of ``scripts/milestone4.py``. For each scene
(Atrium, Conference):

1. export the port's procedural scene at full detail to a Collada file
   and its PNG textures under ``chiprun_out/scenes/`` (``export_collada``);
2. import that file with ``get_scene_by_name(path)``: the XML parse, the
   material priority rules, the texture files and the BVH build
   (``LAST_LOAD_PHASES``); the camera is the factory's, as the file has
   none (``scripts/milestone4.py:82-89``);
3. render PPM and VCM at 1024^2, each with the default ``RenderConfig``
   (2^20 photons; VCM with L = 10 and without vertex merging): one
   warm-up iteration, then 2 timed iterations, each ending in a
   synchronize.

It prints one JSON line per scene: the load phases, the triangles, the
BVH's rows and depth, and per method ms per iteration (median and spread
of the timed iterations), the time to the first frame (import and BVH
build plus the warm-up iteration), the peak device memory and the
launches per iteration of the tile gather (B3) and the BVH traversal
(B5), and of B1 and B2, which must be none.

Usage (on the CUDA card; ``--device cpu --size 32 --detail 0.1`` runs a
small rehearsal on the CPU, where no kernel launches):

    python3 milestone4_torch.py [--size 1024] [--detail 1.0] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out" / "scenes"
SIZE = 1024
WARMUP_ITERS = 1
TIMED_ITERS = 2
SCENES = ("Atrium", "Conference")
METHODS = ("ppm", "vcm")


def export_scene(base: str, detail: float) -> tuple[Path, float, int]:
    """The procedural scene ``base`` at ``detail`` as a Collada file in
    OUT_DIR (built on the host: the export reads host arrays). Returns
    (path, seconds of the export alone, triangles)."""
    from oppositerenderer_tpu_torch.scene import (export_collada,
                                                  get_scene_by_name)
    name = base if detail >= 1.0 else f"{base}:{detail}"
    scene, _ = get_scene_by_name(name, "cpu")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = "full" if detail >= 1.0 else f"{detail:g}"
    path = export_collada(scene, OUT_DIR / f"{base.lower()}_{tag}.dae")
    return path, time.perf_counter() - t0, scene.geometry.n_triangles


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def method_config(method: str, size: int):
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    return RenderConfig(width=size, height=size, render_method={
        "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
        "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}[method])


def run_method(scene, cam, method: str, size: int, device: torch.device,
               load_s: float) -> dict:
    """One warm-up iteration, then TIMED_ITERS timed ones, each ended by a
    synchronize; the kernels' launch counts (B3, B5, and the dense
    route's B1 and B2, which a BVH scene never launches) are set to 0
    before the timed iterations and read after them."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.renderer import Renderer
    wrappers = (gk.gather_photons_tiled, bk.traverse, bk.traverse_any,
                ik.closest_hit_tris, ik.occluded_tris)
    cfg = method_config(method, size)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    r = Renderer(scene, cam, cfg, seed=0)
    _sync(device)
    t0 = time.perf_counter()
    r.render(WARMUP_ITERS)
    _sync(device)
    first_frame_s = load_s + time.perf_counter() - t0
    for w in wrappers:
        w.launches = 0
    graph_before = r.kernel_launches()
    times = []
    for _ in range(TIMED_ITERS):
        t0 = time.perf_counter()
        r.render(1)
        _sync(device)
        times.append(time.perf_counter() - t0)
    # on the card the iterations replay a CUDA graph: its launches are
    # the capture's counts times the replays, not wrapper calls
    graph = r.kernel_launches()
    launches = {w.__name__: w.launches + graph.get(w.__name__, 0)
                - graph_before.get(w.__name__, 0) for w in wrappers}
    img = r.film.mean_radiance()
    med = statistics.median(times)
    rec = {"iterations": WARMUP_ITERS + TIMED_ITERS,
           "ms_per_iteration": med * 1e3,
           "ms_per_iteration_min": min(times) * 1e3,
           "spread": (max(times) - min(times)) / med,
           "time_to_first_frame_s": first_frame_s,
           "launches": launches,
           "launches_per_iteration": {k: v / TIMED_ITERS
                                      for k, v in launches.items()},
           "image_mean": float(img.mean()),
           "image_finite": bool(torch.isfinite(img).all()),
           "metrics": {k: v for k, v in r.metrics.items()
                       if isinstance(v, (int, float))}}
    if device.type == "cuda":
        rec["peak_memory_gib"] = (torch.cuda.max_memory_allocated(device)
                                  / 2 ** 30)
    return rec


def run_case(base: str, device: torch.device, size: int = SIZE,
             detail: float = 1.0):
    """Export, import and render one scene. Returns (record, scene,
    camera)."""
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    from oppositerenderer_tpu_torch.scene.collada import LAST_LOAD_PHASES
    dae, export_s, factory_tris = export_scene(base, detail)
    _sync(device)
    t0 = time.perf_counter()
    scene, _ = get_scene_by_name(str(dae), device)
    _sync(device)
    load_s = time.perf_counter() - t0
    phases = {"export": export_s, **LAST_LOAD_PHASES}
    # the file carries no camera: the factory's viewpoint
    _, cam = get_scene_by_name(f"{base}:0.1", device)
    bvh = scene.bvh
    record = {"scene": base, "asset": str(dae.relative_to(REPO))
              if dae.is_relative_to(REPO) else str(dae),
              "asset_mb": dae.stat().st_size / 1e6,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "resolution": f"{size}x{size}",
              "factory_triangles": factory_tris,
              "triangles": scene.geometry.n_triangles,
              "bvh_rows": None if bvh is None else int(bvh.rows.shape[0]),
              "bvh_depth": None if bvh is None else bvh.max_stack - 1,
              "textures": int(scene.textures.shape[0]),
              "load_phases": phases, "load_s": load_s}
    for method in METHODS:
        record[method] = run_method(scene, cam, method, size, device, load_s)
    return record, scene, cam


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--detail", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    from oppositerenderer_tpu_torch.devices import resolve_device
    device = resolve_device(args.device)
    for base in SCENES:
        record, *_ = run_case(base, device, args.size, args.detail)
        print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
