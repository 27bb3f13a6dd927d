"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order, one line (or a few) of output each; any failure raises
and the script exits non-zero without printing the result line:

1. device      - a CUDA device must be present; prints its name, the torch
                 and CUDA versions and ``nvidia-smi``'s name and power limit.
2. build       - one nvcc call compiles ``csrc/intersect.cu`` and
                 ``csrc/gather.cu`` for sm_90a into one library; prints its
                 cache key, the build time and ptxas' registers and spills.
3. kernels     - each kernel against its plain PyTorch version on the same
                 CUDA tensors. B1 and B2 (random rays from a numpy seed, at
                 the PT path's shape and beyond) must be equal bit for bit
                 (the library is built with --fmad=false). B3 on three
                 inputs: the synthetic case of tests/test_pallas_gather.py
                 (check_normal on and off), its clustered variant with
                 random u_rows (row and chunk subsampling), and the grid and
                 hitpoints of one CornellSmall 512^2 PPM iteration with 1<<20
                 photons; stats equal, sums within rtol 1e-4 + 1e-6 max|ref|.
                 Times kernels and plain versions with CUDA events.
4. goldens     - the port's Renderer at the golden PT configuration on the
                 eight Cornell scenes against ``tests/goldens/goldens.npz``.
5. main        - PT on CornellSmall at 512x512 with the default RenderConfig,
                 seed 0, 20 iterations: one warm-up render, then 3 timed reps.
                 Each rep must launch B1 and B2 20 x 5 times each.
6. ppm-goldens - PPM at the golden PPM configuration (3 iterations, seed 7)
                 on the eight scenes against the ``*__ppm`` goldens, which
                 JAX rendered with its budgeted gather: statistical bounds.
7. ppm-parity  - one PPM iteration of CornellSmall at 64^2, seed 7, on the
                 card and on the CPU (plain versions), pixel by pixel.
8. ppm-main    - PPM on CornellSmall at 512x512, 1<<20 photons, every other
                 RenderConfig field at its default, seed 0: one warm-up
                 render, then 3 timed reps of 5 iterations. Each rep must
                 launch B3 5 times, B1 5 x (9 + 7) and B2 5 x 4 times.

The line before the last is a JSON object with the kernels' launches over
the main phases (5 and 8), errors and times; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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

GOLDEN_PPM_ITERS = 3
# ppm-goldens: the *__ppm goldens come from JAX's budgeted gather, the
# port's PPM takes the tile gather, so the two agree statistically
# (tests/test_pallas_gather.py:98-100): the image mean within 12%, and the
# pixel correlation at least 0.97, or, where JAX's own tile gather at this
# configuration stays below 0.97 (its estimator's variance on these
# scenes: JAX_TILED_GOLDEN_CORR, measured on the CPU with
# use_pallas_gather=True), at least that value less 0.01
PPM_GOLDEN_MEAN_RTOL = 0.12
PPM_GOLDEN_MIN_CORR = 0.97
JAX_TILED_GOLDEN_CORR = {"CornellSmallSmallSpheres": 0.9621,
                         "CornellSmallPointDistant": 0.7712,
                         "CornellSmallPointTest": 0.9658}
# ppm-parity and tests/test_torch_ppm.py: the same estimator on two devices
PPM_PIXEL_RTOL = 1e-3
PPM_MIN_AGREEING = 0.99
PPM_MEAN_RTOL = 1e-3
# B3 against its plain version: the same terms summed in another order
GATHER_RTOL = 1e-4
GATHER_ATOL_REL = 1e-6

MAIN_SCENE = "CornellSmall"
MAIN_SIZE = 512
MAIN_ITERS = 20
MAIN_REPS = 3
TIMING_REPS = 20
# bench.py:232-235: the PPM case runs max(2, iterations // 4) iterations
PPM_MAIN_PHOTONS = 1 << 20
PPM_MAIN_ITERS = max(2, MAIN_ITERS // 4)
PLAIN_GATHER_REPS = 3

KERNELS = {
    "closest_hit_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:56",
    "occluded_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:82",
    "gather_photons_tiled": "oppositerenderer_tpu/accel/pallas_gather.py:180",
}
KERNEL_SOURCES = {
    "closest_hit_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "occluded_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "gather_photons_tiled": "oppositerenderer_tpu_torch/csrc/gather.cu",
}


def golden_pt_config():
    """The PT golden configuration of scripts/make_goldens.py."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    return RenderConfig(
        width=64, height=64, pt_max_segments_nee=4,
        max_radiance_trace_depth=5, max_photon_trace_depth=4,
        photons_per_iteration=1 << 14, photon_grid_resolution=32,
        gather_photon_budget=64, vcm_max_path_length=6,
        iterations_per_dispatch=GOLDEN_ITERS)


def golden_ppm_config():
    """The PPM golden configuration of scripts/make_goldens.py."""
    from oppositerenderer_tpu_torch.config import RenderMethod
    return golden_pt_config().replace(
        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
        iterations_per_dispatch=GOLDEN_PPM_ITERS)


def ppm_main_config():
    """The JAX bench's PPM case (bench.py:232-235) at 512^2."""
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    return RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE,
                        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                        photons_per_iteration=PPM_MAIN_PHOTONS)


def ppm_rays_per_iteration(cfg) -> int:
    """Eye, photon and shadow ray lanes per PPM iteration (bench.py:36-40)."""
    n = cfg.width * cfg.height
    return (n * cfg.max_radiance_trace_depth
            + cfg.photons_per_iteration * cfg.max_photon_trace_depth
            + n * cfg.ppm_direct_shadow_samples)


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
    from oppositerenderer_tpu_torch.accel import cuda_build
    path, seconds, log = cuda_build.build_library()
    sources = " ".join(str(src.relative_to(REPO))
                       for src in cuda_build.SOURCES)
    print(f"[build] cache key {cuda_build.cache_key()}: {sources} -> "
          f"{path.relative_to(REPO)} in {seconds:.2f} s (nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)})")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
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
    out["gather_photons_tiled"] = gather_kernel_cases(dev)
    return out


def gather_case(dev, n_photons=4096, n_tiles=2, radius=0.12, seed=0,
                cluster=False):
    """The synthetic case of tests/test_pallas_gather.py:16-41, drawn in the
    same order from numpy and built by the port: photons in the unit cube
    (``cluster`` piles half into a few cells, so rows overflow a chunk),
    queries clustered per tile. Returns (grid, qpos, qnormal, radius)."""
    from oppositerenderer_tpu_torch import photon_map as pm
    rng = np.random.default_rng(seed)

    def unit(k):
        d = rng.standard_normal((k, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    pos = rng.uniform(0, 1, (n_photons, 3)).astype(np.float32)
    if cluster:
        pos[: n_photons // 2] = (0.5 + 0.02 * rng.standard_normal(
            (n_photons // 2, 3))).astype(np.float32)
    power = rng.uniform(0, 1, (n_photons, 3)).astype(np.float32)
    direction = unit(n_photons)
    valid = rng.uniform(size=n_photons) < 0.9
    photons = pm.PhotonBatch(*(torch.as_tensor(a, device=dev) for a in (
        pos, power, direction, valid)))
    grid = pm.build_photon_grid(photons, 16, min_cell_size=(
        pm.min_cell_size_for_window(torch.tensor(radius, device=dev), 4)))
    centers = rng.uniform(0.25, 0.75, (n_tiles, 3)).astype(np.float32)
    jitter = (0.02 * rng.standard_normal((n_tiles, 256, 3))).astype(
        np.float32)
    qpos = np.clip(centers[:, None, :] + jitter, 0.0, 1.0).reshape(-1, 3)
    return (grid, torch.as_tensor(qpos, device=dev),
            torch.as_tensor(unit(n_tiles * 256), device=dev), radius)


def ppm_gather_inputs(dev):
    """The tile gather's inputs in one CornellSmall 512^2 PPM iteration
    (iteration 0, seed 0, the bench's PPM configuration), recorded where
    ``integrators/ppm.render_iteration`` calls the gather: (grid,
    tile-ordered hitpoint positions and normals, radius, u_rows, found)."""
    from oppositerenderer_tpu_torch.integrators import ppm
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    r = Renderer(scene, cam, ppm_main_config(), seed=0)
    calls = []
    gather = ppm.gather_photons_tiled

    def record(grid, position, normal, radius, *, u_rows, valid, **kw):
        calls.append((grid, position, normal, radius, u_rows, valid))
        return gather(grid, position, normal, radius, u_rows=u_rows,
                      valid=valid, **kw)

    ppm.gather_photons_tiled = record
    try:
        r.compute_iteration(0)
    finally:
        ppm.gather_photons_tiled = gather
    (call,) = calls
    return call


def _on_cpu(grid):
    return dataclasses.replace(grid, **{
        f.name: getattr(grid, f.name).cpu()
        for f in dataclasses.fields(grid) if f.name != "resolution"})


def gather_kernel_cases(dev) -> dict:
    """B3 against its plain version on the card: the tables (and so the
    stats) computed on the card must equal those computed on the CPU, and
    the kernel's sums the plain version's within GATHER_RTOL +
    GATHER_ATOL_REL * max|ref|."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    rng = np.random.default_rng(17)
    cases = []
    for check_normal in (True, False):
        grid, q, qn, r = gather_case(dev)
        cases.append((f"synthetic check_normal={check_normal}", grid, q, qn,
                      r, torch.zeros((2, gk.ROWS + 2), device=dev),
                      check_normal, None))
    grid, q, qn, r = gather_case(dev, n_photons=8192, cluster=True,
                                 radius=0.2)
    cases.append(("clustered", grid, q, qn, r, torch.as_tensor(
        rng.uniform(size=(2, gk.ROWS + 2)).astype(np.float32), device=dev),
        True, None))
    grid, q, qn, r, u_rows, found = ppm_gather_inputs(dev)
    cases.append((f"{MAIN_SCENE} {MAIN_SIZE}^2 PPM", grid, q, qn, r, u_rows,
                  True, found))

    out = {"max_abs_err": 0.0}
    for i, (label, grid, q, qn, r, u, check_normal, valid) in \
            enumerate(cases):
        tables = gk._tile_tables(grid, q, r, u, valid)
        cpu_tables = gk._tile_tables(
            _on_cpu(grid), q.cpu(), r.cpu() if torch.is_tensor(r) else r,
            u.cpu(), None if valid is None else valid.cpu())
        for name, a, b in zip(("starts", "lens", "weights", "visited",
                               "total"), tables, cpu_tables):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"B3 {label}: the card's {name} table "
                                     "differs from the CPU's")
        starts, lens, weights, visited, total = tables
        r2 = torch.square(torch.as_tensor(r, dtype=torch.float32,
                                          device=dev))
        args = (starts, lens, weights, r2, q, qn, grid.position, grid.power,
                grid.direction, check_normal)
        got = gk.gather_photons_tiled_kernel(*args)
        want = gk.gather_photons_tiled_plain(*args)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        scale = float(want.abs().max())
        bad = int((err > GATHER_RTOL * want.double().abs()
                   + GATHER_ATOL_REL * scale).sum())
        max_err = float(err.max())
        if bad or not bool(torch.isfinite(got).all()) or scale <= 0.0:
            raise AssertionError(
                f"B3 differs from its plain version on {label}: {bad} sums "
                f"outside the tolerance, max |err| {max_err:.3g} "
                f"(max |ref| {scale:.3g})")
        out["max_abs_err"] = max(out["max_abs_err"], max_err)
        timing = ""
        if i == len(cases) - 1:   # the main path's shape
            out["ms"] = cuda_ms(lambda: gk.gather_photons_tiled_kernel(*args))
            out["plain_ms"] = cuda_ms(
                lambda: gk.gather_photons_tiled_plain(*args),
                reps=PLAIN_GATHER_REPS, warmup=1)
            timing = (f"; ms kernel {out['ms']:.4f} (median of "
                      f"{TIMING_REPS}) / plain {out['plain_ms']:.4f} "
                      f"(median of {PLAIN_GATHER_REPS})")
        print(f"[kernels] B3 {label}: queries={q.shape[0]} photons="
              f"{grid.position.shape[0]} (valid {int(grid.n_valid)}), "
              f"visited {int(visited.sum())}, subsampled "
              f"{int((total - visited).clamp_min(0).sum())}; stats equal, "
              f"sums within tolerance (max |err| {max_err:.3g}, max |ref| "
              f"{scale:.4g}){timing}")
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


def image_agreement(img: np.ndarray, want: np.ndarray):
    """(share of pixels within PPM_PIXEL_RTOL on every channel, relative
    error of the image mean)."""
    agree = np.isclose(img, want, rtol=PPM_PIXEL_RTOL, atol=0.0).all(axis=-1)
    return float(agree.mean()), abs(float(img.mean()) / float(want.mean())
                                    - 1.0)


def phase_ppm_goldens(dev) -> None:
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import SCENE_NAMES, \
        get_scene_by_name
    goldens = np.load(GOLDENS)
    for name in SCENE_NAMES:
        scene, cam = get_scene_by_name(name, dev)
        r = Renderer(scene, cam, golden_ppm_config(), seed=GOLDEN_SEED)
        img = r.render(GOLDEN_PPM_ITERS).mean_radiance().cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite pixels")
        want = goldens[f"{name}__ppm"].astype(np.float32)
        mean_err = abs(float(img.mean()) / float(want.mean()) - 1.0)
        corr = float(np.corrcoef(img.ravel(), want.ravel())[0, 1])
        min_corr = min(PPM_GOLDEN_MIN_CORR,
                       JAX_TILED_GOLDEN_CORR.get(name, 1.0) - 0.01)
        print(f"[ppm-goldens] {name}: image mean off by {mean_err:.4f} "
              f"(bound {PPM_GOLDEN_MEAN_RTOL}), pixel correlation "
              f"{corr:.4f} (bound {min_corr:.4f})")
        if mean_err > PPM_GOLDEN_MEAN_RTOL or corr < min_corr:
            raise AssertionError(f"{name} PPM is further from its golden "
                                 "than the tile estimator allows")


def phase_ppm_parity(dev) -> None:
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    cfg = golden_ppm_config()
    imgs = []
    for d in (dev, torch.device("cpu")):
        scene, cam = get_scene_by_name(MAIN_SCENE, d)
        r = Renderer(scene, cam, cfg, seed=GOLDEN_SEED)
        imgs.append(r.render(1).mean_radiance().cpu().numpy())
    share, mean_err = image_agreement(*imgs)
    print(f"[ppm-parity] {MAIN_SCENE} {cfg.width}x{cfg.height}, one "
          f"iteration: {share:.4%} of the pixels within rtol "
          f"{PPM_PIXEL_RTOL} of the CPU port's, image mean off by "
          f"{mean_err:.2e}")
    if (not np.isfinite(imgs[0]).all() or share < PPM_MIN_AGREEING
            or mean_err > PPM_MEAN_RTOL):
        raise AssertionError("PPM on the card differs from the CPU port")


def phase_ppm_main(dev) -> dict:
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.film import save_png
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cfg = ppm_main_config()
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    r = Renderer(scene, cam, cfg, seed=0)
    t0 = time.perf_counter()
    r.render(PPM_MAIN_ITERS)
    print(f"[ppm-main] warm-up: {PPM_MAIN_ITERS} iterations in "
          f"{time.perf_counter() - t0:.3f} s")
    wrappers = (ik.closest_hit_tris, ik.occluded_tris,
                gk.gather_photons_tiled)
    # one closest-hit launch per eye and photon bounce, one any-hit per
    # direct shadow sample, one gather per iteration
    expected = {
        "closest_hit_tris": PPM_MAIN_ITERS * (cfg.max_radiance_trace_depth
                                              + cfg.max_photon_trace_depth),
        "occluded_tris": PPM_MAIN_ITERS * cfg.ppm_direct_shadow_samples,
        "gather_photons_tiled": PPM_MAIN_ITERS}
    launches = {w.__name__: 0 for w in wrappers}
    times = []
    for rep in range(MAIN_REPS):
        r.restart()
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = r.render(PPM_MAIN_ITERS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {w.__name__: w.launches for w in wrappers}
        print(f"[ppm-main] rep {rep}: {times[-1]:.4f} s, launches {counts}")
        for k, c in counts.items():
            if c != expected[k]:
                raise AssertionError(f"{k} launched {c} times in a PPM rep, "
                                     f"expected {expected[k]}")
            launches[k] += c
    med = statistics.median(times)
    rays = ppm_rays_per_iteration(cfg) * PPM_MAIN_ITERS
    per_it = {k: r.metrics[k] / PPM_MAIN_ITERS for k in (
        "photons_stored", "photons_visited", "photon_subsampled")}
    print(f"[ppm-main] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE} PPM, "
          f"{cfg.photons_per_iteration} photons: ms/iter median "
          f"{med / PPM_MAIN_ITERS * 1e3:.3f}, min "
          f"{min(times) / PPM_MAIN_ITERS * 1e3:.3f}, spread "
          f"{(max(times) - min(times)) / med:.4f}; rays/s {rays / med:.4g}; "
          "per iteration: " + ", ".join(f"{k} {v:.6g}"
                                        for k, v in per_it.items()))

    img = film.mean_radiance()
    if tuple(img.shape) != (MAIN_SIZE, MAIN_SIZE, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise AssertionError("PPM image is not finite and positive")
    if per_it["photons_stored"] <= 0 or per_it["photons_visited"] <= 0:
        raise AssertionError("PPM stored or gathered no photon")
    png = Path(tempfile.gettempdir()) / "chip_smoke_cornellsmall_ppm.png"
    save_png(film, png)
    print(f"[ppm-main] image mean {float(img.mean()):.5f}, saved {png}")
    return launches


def main() -> int:
    name = phase_device()   # first: no CUDA device, no result
    dev = torch.device("cuda", 0)
    # the plain versions' products in full float32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    kernels = phase_kernels(dev)
    phase_goldens(dev)
    launches = {k: 0 for k in KERNELS}
    launches.update(phase_main(dev))
    phase_ppm_goldens(dev)
    phase_ppm_parity(dev)
    for k, c in phase_ppm_main(dev).items():
        launches[k] += c
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCES[k],
         "replaces": KERNELS[k], "launches": launches[k], **kernels[k]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
