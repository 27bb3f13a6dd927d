"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order, one line (or a few) of output each; any failure raises
and the script exits non-zero without printing the result line:

1. device  - a CUDA device must be present; prints its name, the torch and
             CUDA versions and ``nvidia-smi``'s name and power limit.
2. build   - compiles ``oppositerenderer_tpu_torch/csrc/intersect.cu`` with
             nvcc for sm_90a and prints the build time and ptxas report.
3. kernels - each kernel against its plain PyTorch version on the same
             CUDA tensors (random rays from a numpy seed) at the main path's
             shape and beyond; results must be equal bit for bit (the
             library is built with --fmad=false). Times both with CUDA
             events.
4. goldens - the port's Renderer at the golden PT configuration on the
             eight Cornell scenes against ``tests/goldens/goldens.npz``.
5. main    - PT on CornellSmall at 512x512 with the default RenderConfig,
             seed 0, 20 iterations: one warm-up render, then 3 timed reps.
             Each rep must launch each kernel 20 x 5 times.

The line before the last is a JSON object with the kernels' launches,
errors and times; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDENS = REPO / "tests" / "goldens" / "goldens.npz"

# scripts/make_goldens.py: golden_config("pt"), ITERS["pt"], SEED
GOLDEN_SEED = 7
GOLDEN_ITERS = 4
# tests/test_goldens.py: float16 storage + cross-platform float noise
GOLDEN_RTOL = 5e-3
# paths flipped by last-ulp differences (phase_goldens): at most 0.5% of
# the 64x64 pixels, and the image mean within 1e-3
GOLDEN_MAX_FLIPPED = 20
GOLDEN_MEAN_RTOL = 1e-3

MAIN_SCENE = "CornellSmall"
MAIN_SIZE = 512
MAIN_ITERS = 20
MAIN_REPS = 3
TIMING_REPS = 20

KERNELS = {
    "closest_hit_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:56",
    "occluded_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:82",
}
KERNEL_SOURCE = "oppositerenderer_tpu_torch/csrc/intersect.cu"


def golden_pt_config():
    """The PT golden configuration of scripts/make_goldens.py."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    return RenderConfig(
        width=64, height=64, pt_max_segments_nee=4,
        max_radiance_trace_depth=5, max_photon_trace_depth=4,
        photons_per_iteration=1 << 14, photon_grid_resolution=32,
        gather_photon_budget=64, vcm_max_path_length=6,
        iterations_per_dispatch=GOLDEN_ITERS)


def pt_rays_per_iteration(cfg) -> int:
    """Closest-hit + shadow ray lanes per PT iteration (bench.py:28-33)."""
    segs = cfg.pt_max_segments
    return cfg.width * cfg.height * (segs + segs * cfg.pt_shadow_samples)


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device available")
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])   # name, power limit
    return name


def phase_build() -> None:
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    path, seconds, log = ik.build_library()
    print(f"[build] {path.relative_to(REPO)} in {seconds:.2f} s (nvcc "
          f"{' '.join(ik.NVCC_FLAGS)})")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")


def _rays(n: int, seed: int, box_lo, box_hi, dev):
    """Random rays inside a box: a mix of unbounded, bounded and dead
    (tmax < tmin) lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(box_lo, box_hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    extent = float(np.max(np.asarray(box_hi) - np.asarray(box_lo)))
    tmax = rng.uniform(0.05, 1.5, n).astype(np.float32) * extent
    kind = rng.integers(0, 4, n)
    tmax[kind == 0] = 1e30
    tmax[kind == 1] = 0.0
    tmin = np.full(n, 1e-4, np.float32)
    return [torch.as_tensor(a, device=dev) for a in (o, d, tmin, tmax)]


def _max_abs(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    if not bool(mask.any()):
        return 0.0
    return float((a[mask].double() - b[mask].double()).abs().max())


def phase_kernels(dev) -> dict:
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.accel.intersect import occluder_mask
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    def scene_case(name):
        scene, _ = get_scene_by_name(name, dev)
        g = scene.geometry
        return (ik.tri9_from_geometry(g), occluder_mask(scene, g.tri_mat),
                scene.aabb_min.tolist(), scene.aabb_max.tolist())

    rng = np.random.default_rng(4096)
    v0 = rng.uniform(0.0, 10.0, (4096, 3))
    e1 = rng.normal(0.0, 0.5, (4096, 3))
    e2 = rng.normal(0.0, 0.5, (4096, 3))
    soup9 = torch.as_tensor(np.concatenate([v0.T, e1.T, e2.T]).astype(
        np.float32), device=dev).contiguous()
    soup_occ = torch.as_tensor(rng.random(4096) < 0.9, device=dev)
    n_main = MAIN_SIZE * MAIN_SIZE
    cases = [
        ("CornellSmall", n_main, *scene_case("CornellSmall")),
        ("CornellSmallLargeSphere", n_main,
         *scene_case("CornellSmallLargeSphere")),
        ("soup4096", n_main, soup9, soup_occ, [0.0] * 3, [10.0] * 3),
        ("CornellSmall", 131, *scene_case("CornellSmall")),
    ]
    out = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for i, (name, n, tri9, occ_mask, lo, hi) in enumerate(cases):
        o, d, tmin, tmax = _rays(n, 100 + i, lo, hi, dev)
        got = ik.closest_hit_tris(o, d, tmin, tmax, tri9)
        want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tri9)
        hit = want[1] >= 0
        err = max(_max_abs(got[k], want[k], hit) for k in (0, 2, 3))
        for label, a, b in zip(("t", "idx", "u", "v"), got, want):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(
                    f"closest_hit_tris differs from its plain version on "
                    f"{name} n={n}: {label} differs in {bad} rays "
                    f"(max |err| on hits {err:.3g})")
        occ = ik.occluded_tris(o, d, tmin, tmax, tri9, occ_mask)
        occ_plain = ik.occluded_tris_plain(o, d, tmin, tmax, tri9, occ_mask)
        if not torch.equal(occ, occ_plain):
            raise AssertionError(
                f"occluded_tris differs from its plain version on {name} "
                f"n={n} in {int((occ != occ_plain).sum())} rays")
        out["closest_hit_tris"]["max_abs_err"] = max(
            out["closest_hit_tris"]["max_abs_err"], err)
        timing = ""
        if n == n_main:
            ms = {
                "closest_hit_tris": (
                    cuda_ms(lambda: ik.closest_hit_tris(o, d, tmin, tmax,
                                                        tri9)),
                    cuda_ms(lambda: ik.closest_hit_tris_plain(o, d, tmin,
                                                              tmax, tri9))),
                "occluded_tris": (
                    cuda_ms(lambda: ik.occluded_tris(o, d, tmin, tmax, tri9,
                                                     occ_mask)),
                    cuda_ms(lambda: ik.occluded_tris_plain(
                        o, d, tmin, tmax, tri9, occ_mask)))}
            timing = "; ms kernel/plain " + ", ".join(
                f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in ms.items())
            if name == MAIN_SCENE:   # the main path's shape
                for k, (a, b) in ms.items():
                    out[k].update(ms=a, plain_ms=b)
        print(f"[kernels] {name} rays={n} tris={tri9.shape[1]}: equal to "
              f"plain (hits {int(hit.sum())}, occluded {int(occ.sum())})"
              f"{timing}")
    return out


def golden_agreement(img: np.ndarray, want: np.ndarray):
    """(pixels outside the golden tolerance, worst pixel's error as a
    multiple of its tolerance, relative error of the image mean)."""
    atol = GOLDEN_RTOL * max(float(want.mean()), 0.01)
    ratio = np.abs(img - want) / (atol + GOLDEN_RTOL * np.abs(want))
    return (int((ratio > 1.0).any(axis=-1).sum()), float(ratio.max()),
            abs(float(img.mean()) / float(want.mean()) - 1.0))


def phase_goldens(dev) -> None:
    """A last-ulp difference in a ray (the port's float arithmetic is not
    XLA's) can flip a path's decision where two surfaces almost touch:
    Cornell's light lies within two float32 ulps of its ceiling. Such a
    flip moves one pixel far beyond the golden tolerance and the image
    mean by ~1e-4, so each scene must keep all but GOLDEN_MAX_FLIPPED of
    its pixels within the golden tolerance and its mean within
    GOLDEN_MEAN_RTOL."""
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import SCENE_NAMES, \
        get_scene_by_name
    goldens = np.load(GOLDENS)
    for name in SCENE_NAMES:
        scene, cam = get_scene_by_name(name, dev)
        r = Renderer(scene, cam, golden_pt_config(), seed=GOLDEN_SEED)
        img = r.render(GOLDEN_ITERS).mean_radiance().cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite pixels")
        bad, worst, mean_err = golden_agreement(
            img, goldens[f"{name}__pt"].astype(np.float32))
        print(f"[goldens] {name}: {bad} of {img.shape[0] * img.shape[1]} "
              f"pixels outside the tolerance, worst pixel at {worst:.3f} of "
              f"it, image mean off by {mean_err:.2e}")
        if bad > GOLDEN_MAX_FLIPPED or mean_err > GOLDEN_MEAN_RTOL:
            raise AssertionError(f"{name} PT diverged from its golden")


def phase_main(dev) -> dict:
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.film import save_png
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    r = Renderer(scene, cam, cfg, seed=0)
    t0 = time.perf_counter()
    r.render(MAIN_ITERS)
    print(f"[main] warm-up: {MAIN_ITERS} iterations in "
          f"{time.perf_counter() - t0:.3f} s")
    wrappers = (ik.closest_hit_tris, ik.occluded_tris)
    # one closest-hit launch per segment, one any-hit per shadow sample
    expected = {"closest_hit_tris": MAIN_ITERS * cfg.pt_max_segments,
                "occluded_tris": (MAIN_ITERS * cfg.pt_max_segments
                                  * cfg.pt_shadow_samples)}
    launches = {w.__name__: 0 for w in wrappers}
    times = []
    for rep in range(MAIN_REPS):
        r.restart()
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = r.render(MAIN_ITERS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {w.__name__: w.launches for w in wrappers}
        print(f"[main] rep {rep}: {times[-1]:.4f} s, launches {counts}")
        for k, c in counts.items():
            if c != expected[k]:
                raise AssertionError(f"{k} launched {c} times in a rep, "
                                     f"expected {expected[k]}")
            launches[k] += c
    med = statistics.median(times)
    rays = pt_rays_per_iteration(cfg) * MAIN_ITERS
    print(f"[main] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE} PT: ms/iter median "
          f"{med / MAIN_ITERS * 1e3:.3f}, min "
          f"{min(times) / MAIN_ITERS * 1e3:.3f}, spread "
          f"{(max(times) - min(times)) / med:.4f}; rays/s {rays / med:.4g}")

    img = film.mean_radiance()
    if tuple(img.shape) != (MAIN_SIZE, MAIN_SIZE, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise AssertionError("main-path image is not finite and positive")
    png = Path(tempfile.gettempdir()) / "chip_smoke_cornellsmall_pt.png"
    save_png(film, png)
    print(f"[main] image mean {float(img.mean()):.5f}, saved {png}")
    return launches


def main() -> int:
    name = phase_device()   # first: no CUDA device, no result
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    phase_goldens(dev)
    launches = phase_main(dev)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNELS[k], "launches": launches[k], **kernels[k]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
