"""The kernel table of the PyTorch port on one NVIDIA GPU: each hand-written
CUDA kernel against its plain PyTorch version on the calls the render
paths make, timed against its bound. Run from the repository root with no
arguments:

    python3 chip_smoke.py

The card's other checks are the ``cuda`` tests (README: ``python -m pytest
--noconftest -m cuda ...``), and the end-to-end numbers the benchmark's
cells (``port_bench/run.py``). The kernels' inputs are built by
``tests/_torch_cases.py``, which the ``cuda`` tests check on the same
inputs.

Phases, in order, one line (or a few) of output each; any failure raises
and the script exits non-zero without printing the result line:

1. device      - a CUDA device must be present; prints its name, the torch
                 and CUDA versions, ``nvidia-smi``'s name and power limit,
                 and PIL's version (or "absent").
2. build       - one nvcc per source, all started together, compiles
                 ``csrc/intersect.cu``, ``csrc/gather.cu``, ``csrc/vm.cu``,
                 ``csrc/bvh.cu``, ``csrc/packet_exp.cu``, ``csrc/kd_stage.cu``,
                 ``csrc/rows.cu`` and ``csrc/rng.cu`` for sm_90a, and one
                 more links them into
                 one library; prints its cache key, the build time and
                 ptxas' registers and spills. Then g++ must build the
                 host libraries (``native/bvh_builder.cpp``,
                 ``kdtree_builder.cpp``, ``text_scan.cpp``).
3. kernels     - each kernel against its plain PyTorch version on the same
                 CUDA tensors. B1 and B2 (random rays from a numpy seed, at
                 the PT path's shape and beyond; both on tables of 32 and
                 4096 triangles with mixed, all dead and all live lanes;
                 B1 on every closest-hit call of one CornellSmall 512^2
                 PT, PPM and VCM iteration, B2 on every shadow-ray call of
                 one VCM iteration, each call timed against its live lanes
                 and its bound and summed per iteration) must be equal bit
                 for bit (the library is built with --fmad=false). B3 with
                 check_normal on and off on the synthetic case of
                 tests/test_pallas_gather.py, its clustered variant with
                 random u_rows (row and chunk subsampling), the grid and
                 hitpoints of one CornellSmall 512^2 PPM iteration with 1<<20
                 photons and the partial grids of a 2-way exchange of its
                 photons; stats equal, sums within rtol 1e-4 + 1e-6
                 max|ref|.
                 B4 on the synthetic case of tests/test_vcm_vm.py, its
                 clustered variant with random u_rows, and the vertex grid
                 and camera vertices of every merge round (camera bounce)
                 of one CornellSmall 512^2 VCM+VM iteration; query order
                 and slot tables equal to the CPU's, both sums within rtol
                 1e-4 + 1e-6 max|ref|. B5 (closest and any hit) bit for
                 bit on random rays in full Atrium's box (a quarter dead,
                 all dead, all live), every traversal call of one Atrium
                 512^2 PT iteration (262,144 lanes a call) and of one
                 Conference 1024^2 PT iteration (1,048,576 lanes), and
                 random rays in CornellSmall with a BVH, its live-lane
                 compaction against its plain version on each; prints the
                 rows, slab tests and triangle tests of each ray. The
                 flagship: milestone4_torch.py's Atrium and Conference
                 exported at full detail, imported from their .dae files
                 (under chiprun_out/scenes/, deleted after), PPM and VCM at
                 1024^2 (2^20 photons; L = 10, no merging): each kernel's
                 launches in one iteration (B5 16 + 4 or 19 + 19, B3 1 or
                 0, B1 and B2 never), B3 on the PPM iteration's gather and
                 B5 on every traversal call of both, bit for bit on a
                 sample of each call's lanes. Times
                 kernels (device time: medians of 20 replays of a CUDA
                 graph of 10 calls) and plain versions (enqueued from the
                 host) with CUDA events, B4 on every
                 merge round and B5 on every call of the PT and flagship
                 iterations (the sums: per-iteration kernel ms), and each
                 kernel's bound
                 (the least time of the card for the same work: for B3/B4
                 the pairs each query needs, for B5 the tests and row
                 floats the traversal needs, from the plain version's
                 counts). The row sums (the table-row gather's backward)
                 on every row sum of a 512^2 PT gradient's backward against
                 their plain version, aten's accumulate, at rtol 1e-5 and
                 repeatable bit for bit, timed against their bound (bytes),
                 the plain version and ``index_put_(accumulate=True)``
                 alone. Threefry's three entry points against their
                 plain version (the int64 chain on the same CUDA tensors)
                 bit for bit, each timed against its bound (bytes, or
                 INT32 operations) and the plain version, enqueued from
                 the host and replayed from a graph: the draw (a
                 LaneSampler's next3) at 262,144 and 2^20 lanes under a
                 0-d device key and under 4 groups' per-lane keys; the
                 key folds (iteration_key and fold_in_range on device
                 keys; a 0-d fold and a vector of 10); rng.uniform at
                 2^20 and 0-d. Then each wrapper's launches in one PT,
                 PPM and VCM iteration, equal to its capture's.
4. b6          - the packet node-step microbenchmark's kernel (B6) in each
                 of its nine variants against its plain version bit for
                 bit at the defaults (64 tiles, 64 steps, 49,152 rows) and
                 at 528 tiles (4 for each SM), each timed (kernel and
                 plain) with its bound (8 slab tests of 24 FP32 operations
                 a ray and step), with the CTAs a tile (2 when twice the
                 tiles fit the SMs) printed and checked; then the
                 microbenchmark's entry point (``python -m
                 oppositerenderer_tpu_torch.scripts.packet_kernel_exp``'s
                 main) at its defaults once per variant: its two lines,
                 (1 + 5) x 9 launches.

The line before the last is a JSON object with each kernel's errors, times
and bounds (per call at its timed shape, and per iteration of the render
paths: ``per_iteration``, with its launches as ``calls``); the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "tests"))

from _torch_cases import (GATHER_ATOL_REL, GATHER_RTOL,  # noqa: E402
                          MAIN_SCENE, MAIN_SIZE, VM_ATOL_REL, VM_RTOL,
                          _bits_differ, _rays, _to, dead_or_live, gather_case,
                          iteration_calls, loss_and_grad, partial_grids,
                          ppm_gather_inputs, ppm_main_config,
                          vcm_main_config, vm_case)
from oppositerenderer_tpu_torch.devices import card_line  # noqa: E402

TIMING_REPS = 20
LAUNCHES_PER_SAMPLE = 10   # cuda_ms: calls per timed sample of a kernel
PLAIN_GATHER_REPS = 3
PLAIN_VM_REPS = 3
# B5 on the JAX bench's BVH scenes (bench.py:244-255): Atrium PT at 512^2,
# Conference PT at 1024^2
ATRIUM_SIZE = 512
CONFERENCE_SIZE = 1024
PLAIN_BVH_REPS = 3
# the flagship: milestone4_torch.py's scenes imported from .dae files, PPM
# and VCM at 1024^2; B5 held bit for bit on a sample of at most this many
# lanes of each call (a VCM camera bounce's shadow rays are 10 x 2^20),
# each call timed over this many replays
FLAGSHIP_SAMPLE_LANES = 131072
FLAGSHIP_TIMING_REPS = 5
# the kernels phase's random triangle soup: B1 and B2 beyond the Cornell
# scenes' 36 triangles, up to the dense route's 4096
SOUP_TRIS = 4096
SOUP_BOX = ([0.0] * 3, [10.0] * 3)

# b6: the microbenchmark's defaults (scripts/packet_kernel_exp.py), and
# 528 = 4 x 132 tiles: 4 blocks for each SM of the H100
B6_STEPS, B6_TILES, B6_ROWS = 64, 64, 48 * 1024
B6_WIDE_TILES = 528
B6_SCRIPT_REPS = 5

# the card's peaks at the 700 W limit: HBM bytes/s (NVIDIA H100 SXM data
# sheet) and FP32 instructions/s outside the tensor cores. The data
# sheet's 67e12 counts a fused multiply-add as two operations; the kernels
# are built with --fmad=false and every operation counted below is one
# instruction, so the rate is one per lane and cycle: 128 lanes x 132 SMs
# x 1.98 GHz = 33.5e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 33.5e12
# 32-bit integer instructions/s outside the tensor cores: 64 INT32 lanes
# an SM x 132 SMs x 1.98 GHz (NVIDIA's Hopper white paper)
PEAK_INT32_PER_S = 16.7e12
# FP32 operations counted per unit of work for the bounds: one
# Moller-Trumbore test (9 + 5 + 1 + 3 + 6 + 9 + 6 + 6 + 1 arithmetic
# operations, comparisons not counted); one child's slab test (6 sub, 6
# mul, 6 min/max per axis pair, 4 for the three-way reductions, 2 against
# tmin/t_best); one photon/vertex pair's distance test (3 sub, 3 mul, 2 add)
MT_FLOPS = 46
SLAB_FLOPS = 24
PAIR_FLOPS = 8
# INT32 operations a threefry block, about: 20 rounds of an add, a funnel
# shift and an xor (60), the key's parity word (2 xors), six key
# injections (12 to 17 adds: a round constant may take a three-input add)
# and the draw's shift and conversion (2)
TF_INT_OPS = 80
# the draws timed: a next3 (two blocks a lane) at the PT path's lanes and
# at PPM's photon pass's, under one 0-d key and under the per-lane keys of
# RNG_GROUPS iterations stacked in one wavefront (N / RNG_GROUPS lanes
# each, as a batched PT's)
RNG_DRAW_LANES = (MAIN_SIZE * MAIN_SIZE, 1 << 20)
RNG_GROUPS = 4
# the key folds timed: a fold of a 0-d key (each half of iteration_key) and
# fold_in_range's vector at VCM's camera pass's count (L = 10 depth keys)
RNG_FOLD_RANGE = (4001, 10)
# rng.uniform's flat form: the stochastic hash map's priorities (one a
# photon, 2^20) and a 0-d draw (the all-to-all exchange's)
RNG_UNIFORM_SHAPES = ((1 << 20,), ())

KERNELS = {
    "closest_hit_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:56",
    "occluded_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:82",
    "gather_photons_tiled": "oppositerenderer_tpu/accel/pallas_gather.py:180",
    "merge_vertices_tiled": "oppositerenderer_tpu/accel/pallas_vm.py:64",
    "traverse": "oppositerenderer_tpu/accel/pallas_bvh.py:55",
    "traverse_any": "oppositerenderer_tpu/accel/pallas_bvh.py:55",
    "packet_steps": "scripts/packet_kernel_exp.py:124",
    "sum_rows": "none: the table-row gather's backward, aten's accumulate",
    "threefry_draw": "none: jax.random's threefry, which XLA fuses",
}
KERNEL_SOURCES = {
    "closest_hit_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "occluded_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "gather_photons_tiled": "oppositerenderer_tpu_torch/csrc/gather.cu",
    "merge_vertices_tiled": "oppositerenderer_tpu_torch/csrc/vm.cu",
    "traverse": "oppositerenderer_tpu_torch/csrc/bvh.cu",
    "traverse_any": "oppositerenderer_tpu_torch/csrc/bvh.cu",
    "packet_steps": "oppositerenderer_tpu_torch/csrc/packet_exp.cu",
    "sum_rows": "oppositerenderer_tpu_torch/csrc/rows.cu",
    "threefry_draw": "oppositerenderer_tpu_torch/csrc/rng.cu",
}


def bound(n_bytes: float, flops: float,
          ops_per_s: float = PEAK_FP32_PER_S) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes over the HBM rate and the operations over their instruction
    rate (FP32's unless given)."""
    ms_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    ms_ops = flops / ops_per_s * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations",
            "library_ms": None}


def covered_rows(starts: torch.Tensor, lens: torch.Tensor, n: int) -> int:
    """Distinct rows of [0, n) inside the windows [start, start + len)."""
    s, ln = starts.reshape(-1).long(), lens.reshape(-1).long()
    keep = ln > 0
    diff = torch.zeros(n + 1, dtype=torch.int64, device=starts.device)
    diff.index_add_(0, s[keep], torch.ones_like(s[keep]))
    diff.index_add_(0, (s + ln)[keep].clamp_max(n), -torch.ones_like(s[keep]))
    return int((torch.cumsum(diff, 0)[:n] > 0).sum())


def query_pairs(grid, qpos, radius, starts, lens, valid=None) -> int:
    """Pairs the tile gather (B3) or merge (B4) needs: each query against
    the staged photons or vertices of its tile's windows that lie in its
    own cell box (the cells within ``radius`` of it, as ``_tile_tables``
    computes them); any other staged element is beyond the radius on some
    axis. Queries with ``valid`` False or a non-finite position need
    none."""
    res = grid.resolution
    n, n_tiles = qpos.shape[0], starts.shape[0]
    tile = n // n_tiles
    dev = qpos.device
    ok_q = torch.isfinite(qpos).all(dim=1)
    if valid is not None:
        ok_q = ok_q & valid
    r = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                           device=dev), (n,))
    npos = torch.where(ok_q[:, None], qpos, grid.origin) - grid.origin
    inv = 1.0 / grid.cell_size
    lo = torch.clamp(torch.floor((npos - r[:, None]) * inv), 0,
                     res - 1).long().reshape(n_tiles, tile, 1, 3)
    hi = torch.clamp(torch.floor((npos + r[:, None]) * inv), 0,
                     res - 1).long().reshape(n_tiles, tile, 1, 3)
    offsets = grid.offsets.long()
    s = starts.long()[:, None, :]                      # [tiles, 1, slots]
    e = s + lens.long()[:, None, :]
    # each window lies in one (y, z) row of cells: that of its first element
    cell = torch.searchsorted(offsets, s.contiguous(), right=True) - 1
    y, z = (cell // res) % res, cell // (res * res)
    row = y * res + z * res * res
    in_box = ((y >= lo[..., 1]) & (y <= hi[..., 1]) & (z >= lo[..., 2])
              & (z <= hi[..., 2]) & (e > s) & ok_q.reshape(n_tiles, tile, 1))
    q_s = offsets[(lo[..., 0] + row).clamp(0, res ** 3 - 1)]
    q_e = offsets[(hi[..., 0] + row + 1).clamp(0, res ** 3)]
    overlap = torch.minimum(e, q_e) - torch.maximum(s, q_s)
    return int(torch.where(in_box, overlap.clamp_min(0), 0).sum())


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 3,
            batch: int = LAUNCHES_PER_SAMPLE, graph: bool = True) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    samples, each the CUDA-event time of one replay of a CUDA graph that
    holds ``batch`` calls in a row, divided by ``batch``. The graph leaves
    out the host's enqueue of each call (the wrapper's checks and
    allocations), which takes longer than the device's work on the B1 and
    B2 launches of the main paths. With ``graph`` False the ``batch`` calls
    are enqueued from the host, as a caller makes them: the time is the
    host's where the host is slower. Plain versions, which wait on the
    device, are timed so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(batch):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(batch):
                fn()
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)

# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device available")
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(card_line())   # name, power limit
    # film.save_png needs PIL; scene import will read images
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = "absent"
    print(f"[device] PIL {pil}")
    return name


def phase_build() -> None:
    from oppositerenderer_tpu_torch.accel import cuda_build
    path, seconds, log = cuda_build.build_library()
    sources = " ".join(str(src.relative_to(REPO))
                       for src in cuda_build.SOURCES)
    print(f"[build] cache key {cuda_build.cache_key()}: {sources} -> "
          f"{path.relative_to(REPO)} in {seconds:.2f} s (one nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)} -c per source, all at once; "
          f"then nvcc {' '.join(cuda_build.LINK_FLAGS)})")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print(f"[build] {line.strip()}")
    # the host libraries: g++ at first use, as on a user's machine; the
    # numpy and Python fallbacks would build other trees, and slowly
    from oppositerenderer_tpu_torch import native
    for stem in native.STEMS:
        t0 = time.perf_counter()
        if native.load(stem) is None:
            raise RuntimeError(f"g++ could not build native/{stem}.cpp")
        print(f"[build] host library {native.library_path(stem).name} ready "
              f"in {time.perf_counter() - t0:.2f} s (g++ "
              f"{' '.join(native.GXX_FLAGS)})")


def _max_abs(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    if not bool(mask.any()):
        return 0.0
    return float((a[mask].double() - b[mask].double()).abs().max())


def phase_kernels(dev) -> dict:
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.accel.intersect import dense_tables
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    def scene_case(name):
        scene, _ = get_scene_by_name(name, dev)
        return (*dense_tables(scene), scene.aabb_min.tolist(),
                scene.aabb_max.tolist())

    soup9 = soup_tri9(dev)
    rng = np.random.default_rng(4097)
    soup_occ = ik.triangle_records(soup9, torch.as_tensor(
        rng.random(SOUP_TRIS) < 0.9, device=dev))
    n_main = MAIN_SIZE * MAIN_SIZE
    cases = [
        ("CornellSmall", n_main, *scene_case("CornellSmall")),
        ("CornellSmallLargeSphere", n_main,
         *scene_case("CornellSmallLargeSphere")),
        ("soup4096", n_main, ik.triangle_records(soup9), soup_occ,
         *SOUP_BOX),
        ("CornellSmall", 131, *scene_case("CornellSmall")),
    ]
    out = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for i, (name, n, tris, occ_tab, lo, hi) in enumerate(cases):
        o, d, tmin, tmax = _rays(n, 100 + i, lo, hi, dev)
        got = ik.closest_hit_tris(o, d, tmin, tmax, tris)
        want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)
        hit = want[1] >= 0
        err = max(_max_abs(got[k], want[k], hit) for k in (0, 2, 3))
        for label, a, b in zip(("t", "idx", "u", "v"), got, want):
            if _bits_differ(a, b):
                raise AssertionError(
                    f"closest_hit_tris differs from its plain version on "
                    f"{name} n={n}: {label} differs in {_bits_differ(a, b)} "
                    f"rays (max |err| on hits {err:.3g})")
        occ = ik.occluded_tris(o, d, tmin, tmax, occ_tab)
        occ_plain = ik.occluded_tris_plain(o, d, tmin, tmax, occ_tab)
        if not torch.equal(occ, occ_plain):
            raise AssertionError(
                f"occluded_tris differs from its plain version on {name} "
                f"n={n} in {int((occ != occ_plain).sum())} rays")
        out["closest_hit_tris"]["max_abs_err"] = max(
            out["closest_hit_tris"]["max_abs_err"], err)
        timing = ""
        if name == MAIN_SCENE and n == n_main:   # the main path's shape
            out["closest_hit_tris"].update(dense_bound(o, d, tmin, tmax,
                                                       tris, False))
            out["occluded_tris"].update(dense_bound(o, d, tmin, tmax,
                                                    occ_tab, True))
        if n == n_main:
            ms = {
                "closest_hit_tris": (
                    cuda_ms(lambda: ik.closest_hit_tris(o, d, tmin, tmax,
                                                        tris)),
                    cuda_ms(lambda: ik.closest_hit_tris_plain(o, d, tmin,
                                                              tmax, tris),
                            batch=1, graph=False)),
                "occluded_tris": (
                    cuda_ms(lambda: ik.occluded_tris(o, d, tmin, tmax,
                                                     occ_tab)),
                    cuda_ms(lambda: ik.occluded_tris_plain(
                        o, d, tmin, tmax, occ_tab), batch=1, graph=False))}
            timing = "; ms kernel/plain " + ", ".join(
                f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in ms.items())
            if name == MAIN_SCENE:   # the main path's shape
                for k, (a, b) in ms.items():
                    out[k].update(ms=a, plain_ms=b)
            else:
                for k, (a, b) in ms.items():
                    out[k][name] = {"ms": a, "plain_ms": b}
        print(f"[kernels] {name} rays={n} tris={tris.shape[0]} occluders="
              f"{occ_tab.shape[0]}: equal to plain bit for bit (hits "
              f"{int(hit.sum())}, occluded {int(occ.sum())}){timing}")
    for k, v in dense_lane_cases(dev, soup9).items():
        out[k]["lane_cases"] = v
    out["closest_hit_tris"]["per_iteration"] = b1_iterations(dev)
    out["occluded_tris"]["per_iteration"] = {
        f"{MAIN_SCENE} {MAIN_SIZE}^2 VCM": b2_vcm_iteration(dev)}
    out["gather_photons_tiled"] = gather_kernel_cases(dev)
    out["merge_vertices_tiled"] = vm_kernel_cases(dev)
    out.update(bvh_kernel_cases(dev))
    flagship_iterations(dev, out)
    out["sum_rows"] = row_sum_cases(dev)
    out["threefry_draw"] = rng_draw_cases(dev)
    return out


def _rng_timed(label: str, kernel, plain, n_bytes: float, n_ops: float
               ) -> dict:
    """One threefry shape's row: the kernel (graph replays), its bound
    (``n_bytes`` over the bytes rate, ``n_ops`` INT32 operations over the
    INT32 rate) and the plain version, enqueued from the host
    (``plain_ms``) and replayed from a graph as a captured step runs it
    (``plain_graph_ms``); printed under ``label``."""
    row = {"ms": cuda_ms(kernel),
           **bound(n_bytes, n_ops, PEAK_INT32_PER_S),
           "plain_ms": cuda_ms(plain, batch=1, graph=False),
           "plain_graph_ms": cuda_ms(plain, batch=1)}
    print(f"[kernels] threefry {label}: equal to plain bit for bit; kernel "
          f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
          f"({row['bound_by']}), plain {row['plain_ms']:.4f} (enqueued), "
          f"{row['plain_graph_ms']:.4f} (a graph)")
    return row


def _same_words(label: str, got, want) -> None:
    for g, w in zip(got, want):
        if not torch.equal(torch.as_tensor(g), torch.as_tensor(w)):
            raise AssertionError(f"threefry {label} differs from its plain "
                                 f"version")


def rng_draw_cases(dev) -> dict:
    """The three entry points of ``csrc/rng.cu`` at the shapes the main
    paths give them, each equal to its plain version (the int64 chain of
    ``core/rng.py`` on the same CUDA tensors) bit for bit and timed
    (:func:`_rng_timed`):

    * ``threefry_draw``: a LaneSampler's next3 of N lanes from column
      counter 7, N in :data:`RNG_DRAW_LANES`, under a 0-d device key
      (``iteration_key`` of a device root and iteration, as a captured
      step derives it) and under per-lane keys (``lane_key_words`` of
      :data:`RNG_GROUPS` keys); bound: the lane ids (and keys) in and the
      floats out, two blocks a lane of :data:`TF_INT_OPS`. The first
      shape's figures are the row's.
    * ``threefry_words`` (``folds``): ``iteration_key`` and
      ``fold_in_range`` on device keys checked as the integrators call
      them; timed, a fold of a 0-d key and the vector of
      :data:`RNG_FOLD_RANGE`.
    * ``threefry_uniform`` (``uniform``): ``rng.uniform`` at
      :data:`RNG_UNIFORM_SHAPES`.

    ``launches``: each wrapper's launches in one iteration of the PT, PPM
    and VCM paths (:func:`rng_iteration_launches`)."""
    from oppositerenderer_tpu_torch.accel import rng_kernels as nk
    from oppositerenderer_tpu_torch.core import rng as trng
    root = trng.device_key(trng.make_root_key(2**31 + 26), dev)
    it = torch.full((), 3, dtype=torch.int64, device=dev)
    key = trng.iteration_key(root, it, 1)
    plain_key = trng.threefry2x32_plain(
        *trng.threefry2x32_plain(*root, 0, 1), 0, it)
    _same_words("iteration_key on a device key", key, plain_key)
    out = {"shapes": {}, "folds": {}, "uniform": {}}
    for n in RNG_DRAW_LANES:
        lanes = torch.arange(n, dtype=torch.int64, device=dev)
        per_lane = trng.lane_key_words(
            [trng.fold_in(key, g) for g in range(RNG_GROUPS)],
            n // RNG_GROUPS, dev)
        for form, (k0, k1), key_bytes in (
                ("a 0-d key", key, 0),
                (f"{RNG_GROUPS} groups' per-lane keys", per_lane, 2 * n * 8)):
            label = f"draw {n} x 3 under {form}"

            def kernel():
                return nk.threefry_draw(lanes, k0, k1, 7, 3)

            def plain():
                return trng.lane_uniform_plain(k0, k1, lanes, 7, 3)

            _same_words(label, [kernel().view(torch.int32)],
                        [plain().view(torch.int32)])
            out["shapes"][f"{n} x 3, {form}"] = _rng_timed(
                label, kernel, plain, n * 8 + key_bytes + n * 3 * 4,
                2 * n * TF_INT_OPS)
    out.update(out["shapes"][f"{RNG_DRAW_LANES[0]} x 3, a 0-d key"])

    start, count = RNG_FOLD_RANGE
    data = torch.arange(start, start + count, dtype=torch.int64, device=dev)
    _same_words(f"fold_in_range({start}, {count}) on a device key",
                [torch.stack(w) for w in zip(*trng.fold_in_range(
                    key, start, count))],
                trng.threefry2x32_plain(*key, 0, data))
    for label, x1, m in (("fold of a 0-d key", it, 1),
                         (f"fold_in_range vector of {count}", data, count)):
        _same_words(label, nk.threefry_words(*key, 0, x1),
                    trng.threefry2x32_plain(*key, 0, x1))
        out["folds"][label] = _rng_timed(
            label, lambda: nk.threefry_words(*key, 0, x1),
            lambda: trng.threefry2x32_plain(*key, 0, x1),
            (2 + 3 * m) * 8, m * TF_INT_OPS)

    for shape in RNG_UNIFORM_SHAPES:
        n = int(np.prod(shape))
        label = f"uniform {shape}"
        _same_words(label, [trng.uniform(key, shape, dev).view(torch.int32)],
                    [trng.uniform_plain(key, n, dev).reshape(shape)
                     .view(torch.int32)])
        out["uniform"][label] = _rng_timed(
            label, lambda: nk.threefry_uniform(*key, n, dev),
            lambda: trng.uniform_plain(key, n, dev), 2 * 8 + n * 4,
            n * TF_INT_OPS)
    out["launches"] = rng_iteration_launches(dev)
    return out


def rng_iteration_launches(dev) -> dict:
    """Each threefry wrapper's launches in one CornellSmall 512^2 iteration
    of PT, PPM and VCM (the configurations of :func:`closest_hit_calls`):
    the counters set to 0 just before a fresh Renderer's first
    ``render(1)``, whose eager iteration launches once for each tensor
    call, then read; the capture that follows must hold as many."""
    from oppositerenderer_tpu_torch.accel import rng_kernels as nk
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    wrappers = (nk.threefry_draw, nk.threefry_words, nk.threefry_uniform)
    out = {}
    for method, cfg in (
            ("PT", RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)),
            ("PPM", ppm_main_config()), ("VCM", vcm_main_config())):
        r = Renderer(*get_scene_by_name(MAIN_SCENE, dev), cfg, seed=0)
        for w in wrappers:
            w.launches = 0
        r.render(1)
        torch.cuda.synchronize(dev)
        launched = {w.__name__: w.launches for w in wrappers}
        captured = {w.__name__: r.captured_step.capture_launches[w.__name__]
                    for w in wrappers}
        if launched != captured or not launched["threefry_draw"]:
            raise AssertionError(f"{method}: threefry launches in the eager "
                                 f"iteration {launched}, in its capture "
                                 f"{captured}")
        print(f"[kernels] threefry launches per {MAIN_SCENE} {MAIN_SIZE}^2 "
              f"{method} iteration: {launched}")
        out[f"{MAIN_SCENE} {MAIN_SIZE}^2 {method}"] = launched
        del r
        torch.cuda.empty_cache()
    return out


def pt_grad_row_sums(dev) -> list:
    """(idx, g, rows) of every row sum in the backward of one CornellSmall
    512^2 PT gradient (kd of material 0 and the emission scale, eager): the
    backward of each gather of a field that requires grad."""
    from oppositerenderer_tpu_torch.accel import row_kernels as rk
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    calls = []
    real = rk.sum_rows

    def record(idx, g, rows):
        calls.append((idx, g.contiguous(), rows))
        return rk.sum_rows_plain(idx, g, rows)

    rk.sum_rows = record
    try:
        for param in ("kd", "emission_scale"):
            loss_and_grad(scene, cam, RenderConfig(width=MAIN_SIZE,
                                                   height=MAIN_SIZE), param)
    finally:
        rk.sum_rows = real
    return calls


def row_sum_cases(dev) -> dict:
    """The row-sum kernel on every row sum of a 512^2 PT gradient's
    backward (:func:`pt_grad_row_sums`) against its plain version (aten's
    accumulate) in float64 at rtol 1e-5 plus 1e-6 of the largest row's
    |sum|, the float32 plain version's own difference printed; two calls
    equal bit for bit. Per call and summed over the calls: the kernel
    (graph replays), its bound (the bytes: the indices, the cotangents,
    the blocks' partials written and read, the table), the plain version
    and the library call alone (``index_put_(accumulate=True)`` into a
    zeroed table), both enqueued from the host."""
    from oppositerenderer_tpu_torch.accel import cuda_build
    from oppositerenderer_tpu_torch.accel import row_kernels as rk
    calls = pt_grad_row_sums(dev)
    if not calls:
        raise AssertionError("rows: the PT gradient summed no rows")
    tot = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    err = err_f32 = 0.0
    shapes = {}
    for idx, g, rows in calls:
        got, again = rk.sum_rows(idx, g, rows), rk.sum_rows(idx, g, rows)
        if not torch.equal(got, again):
            raise AssertionError("rows: two calls of the kernel differ")
        exact = rk.sum_rows_plain(idx, g.double(), rows)
        # a row sum whose cotangents are all zero must come out zero
        scale = max(float(exact.abs().max()), 1e-30)
        torch.testing.assert_close(got.double(), exact, rtol=1e-5,
                                   atol=1e-6 * scale)
        f32 = rk.sum_rows_plain(idx, g, rows).double()
        err = max(err, float((got.double() - exact).abs().max()) / scale)
        err_f32 = max(err_f32, float((f32 - exact).abs().max()) / scale)
        n, c = idx.shape[0], g[0].numel()
        part = cuda_build.library().sum_rows_blocks(n) * rows * c * 4
        bnd = bound(n * 8 + n * c * 4 + 2 * part + rows * c * 4, 0)
        table = torch.zeros_like(got)
        ms = {"ms": cuda_ms(lambda: rk.sum_rows(idx, g, rows)),
              "bound_ms": bnd["bound_ms"],
              "plain_ms": cuda_ms(lambda: rk.sum_rows_plain(idx, g, rows),
                                  batch=1, graph=False),
              "library_ms": cuda_ms(lambda: table.index_put_(
                  (idx,), g, accumulate=True), batch=1, graph=False)}
        for k, v in ms.items():
            tot[k] += v
        shapes.setdefault((n, rows, c), ms)
    for (n, rows, c), ms in shapes.items():
        print(f"[kernels] rows {rows} x {c}, {n} lanes: kernel "
              f"{ms['ms']:.4f} ms, bound {ms['bound_ms']:.4f} (bytes), plain "
              f"{ms['plain_ms']:.4f}, index_put_ accumulate "
              f"{ms['library_ms']:.4f}")
    print(f"[kernels] sum_rows on the {len(calls)} row sums of a "
          f"{MAIN_SCENE} {MAIN_SIZE}^2 PT gradient's backward (kd, then the "
          f"emission scale): off the float64 sums by {err:.3g} of the "
          f"largest |sum| at most (aten's float32 accumulate {err_f32:.3g}), "
          f"repeatable bit for bit; summed: kernel {tot['ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f}, plain {tot['plain_ms']:.4f}, index_put_ "
          f"accumulate {tot['library_ms']:.4f}")
    return {"max_rel_err": err, "plain_rel_err": err_f32,
            "calls": len(calls), **{k: v / len(calls) for k, v in
                                    tot.items()},
            "per_step": tot, "bound_by": "bytes"}


def soup_tri9(dev, n_tris: int = SOUP_TRIS) -> torch.Tensor:
    """[9, n_tris]: the random triangle soup of the kernels phase (v0 in
    SOUP_BOX, edges normal with sigma 0.5), from a numpy seed."""
    rng = np.random.default_rng(4096)
    v0 = rng.uniform(0.0, 10.0, (n_tris, 3))
    e1 = rng.normal(0.0, 0.5, (n_tris, 3))
    e2 = rng.normal(0.0, 0.5, (n_tris, 3))
    return torch.as_tensor(np.concatenate([v0.T, e1.T, e2.T]).astype(
        np.float32), device=dev).contiguous()


def dense_lane_cases(dev, soup9) -> dict:
    """B1 and B2 bit for bit against their plain versions on the first 32
    and the 4096 triangles of the soup (every one an occluder for B2),
    with a mix of dead and live lanes, all lanes dead and all live; each
    one's time against its bound. Returns {kernel: {"T=.. kind": ...}}."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    n = MAIN_SIZE * MAIN_SIZE
    kernels = (("closest_hit_tris", ik.closest_hit_tris,
                ik.closest_hit_tris_plain),
               ("occluded_tris", ik.occluded_tris, ik.occluded_tris_plain))
    out = {name: {} for name, _, _ in kernels}
    for T in (32, SOUP_TRIS):
        tab = ik.triangle_records(soup9[:, :T].contiguous())
        rays = _rays(n, 200 + T, *SOUP_BOX, dev)
        for kind, (o, d, tmin, tmax) in (
                ("mixed", rays), ("all dead", dead_or_live(rays, False)),
                ("all live", dead_or_live(rays, True))):
            live = int((tmax > tmin).sum())
            for name, fn, plain in kernels:
                got, want = fn(o, d, tmin, tmax, tab), plain(o, d, tmin,
                                                             tmax, tab)
                if name == "occluded_tris":
                    got, want = (got,), (want,)
                bad = sum(_bits_differ(a, b) for a, b in zip(got, want))
                if bad:
                    raise AssertionError(
                        f"{name} differs from its plain version on T={T} "
                        f"{kind} in {bad} values")
                ms = cuda_ms(lambda: fn(o, d, tmin, tmax, tab))
                b = dense_bound(o, d, tmin, tmax, tab,
                                name == "occluded_tris")
                found = int((got[1] >= 0).sum() if len(got) > 1
                            else got[0].sum())
                out[name][f"T={T} {kind}"] = {
                    "live": live, "found": found, "ms": ms,
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
                print(f"[kernels] {name} T={T} {kind}: rays={n} live {live}, "
                      f"found {found}; equal bit for bit; ms kernel "
                      f"{ms:.4f}, bound {b['bound_ms']:.4f} "
                      f"({b['bound_by']})")
    return out


def closest_hit_calls(dev, method: str):
    """Every call of B1's wrapper in one CornellSmall 512^2 iteration of
    ``method`` ("PT" with the default RenderConfig, "PPM" with 1<<20
    photons, "VCM" with L = 10: the main phases' configurations), each
    (o, d, tmin, tmax, tris). PT calls it once a segment, PPM once an eye
    and once a photon bounce, VCM once a light and a camera bounce."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    cfg = {"PT": lambda: RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE),
           "PPM": ppm_main_config, "VCM": vcm_main_config}[method]()
    want = {"PT": cfg.pt_max_segments,
            "PPM": cfg.max_radiance_trace_depth + cfg.max_photon_trace_depth,
            "VCM": 2 * cfg.vcm_max_path_length - 1}[method]
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    calls = iteration_calls(scene, cam, cfg,
                            ("closest_hit_tris",))["closest_hit_tris"]
    if len(calls) != want:
        raise AssertionError(f"{len(calls)} closest-hit calls in one "
                             f"{method} iteration, expected {want}")
    return calls


def b1_iterations(dev) -> dict:
    """B1 on every closest-hit call of one CornellSmall 512^2 PT, PPM and
    VCM iteration: bit for bit against its plain version, each call timed
    against its live lanes and its bound; the sums are B1's time and bound
    per iteration."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    out = {}
    for method in ("PT", "PPM", "VCM"):
        it = {"calls": 0, "lanes": 0, "live": 0, "ms": 0.0, "bound_ms": 0.0}
        for i, (o, d, tmin, tmax, tris) in enumerate(
                closest_hit_calls(dev, method)):
            got = ik.closest_hit_tris(o, d, tmin, tmax, tris)
            want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)
            bad = sum(_bits_differ(a, b) for a, b in zip(got, want))
            if bad:
                raise AssertionError(
                    f"closest_hit_tris differs from its plain version on "
                    f"{method} call {i} in {bad} values")
            ms = cuda_ms(lambda: ik.closest_hit_tris(o, d, tmin, tmax, tris))
            b = dense_bound(o, d, tmin, tmax, tris, False)
            n, live = o.shape[0], int((tmax > tmin).sum())
            it["calls"] += 1
            it["lanes"] += n
            it["live"] += live
            it["ms"] += ms
            it["bound_ms"] += b["bound_ms"]
            print(f"[kernels] B1 {MAIN_SCENE} {MAIN_SIZE}^2 {method} call "
                  f"{i}: lanes {n}, live {live} ({live / n:.4f}), hits "
                  f"{int((got[1] >= 0).sum())}; equal bit for bit; ms "
                  f"kernel {ms:.4f}, bound {b['bound_ms']:.4f} "
                  f"({b['bound_by']})")
        print(f"[kernels] B1 per {MAIN_SCENE} {MAIN_SIZE}^2 {method} "
              f"iteration: {it['calls']} launches {it['ms']:.4f} ms over "
              f"{it['lanes']} lanes ({it['live']} live); bound "
              f"{it['bound_ms']:.4f} ms")
        out[f"{MAIN_SCENE} {MAIN_SIZE}^2 {method}"] = it
    return out


def vcm_shadow_calls(dev):
    """Every call of B2's wrapper in one CornellSmall 512^2 VCM iteration
    (the bench's VCM configuration, L = 10): the t=1 splats' shadow rays
    of each light bounce, then each camera bounce's batch of its s=1 and
    vertex-connection shadow rays. Returns (cfg, [(o, d, tmin, tmax,
    occ)] in call order)."""
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    cfg = vcm_main_config()
    calls = iteration_calls(scene, cam, cfg,
                            ("occluded_tris",))["occluded_tris"]
    L = cfg.vcm_max_path_length
    if len(calls) != (L - 1) + L:
        raise AssertionError(f"{len(calls)} shadow-ray calls in one VCM "
                             f"iteration, expected {(L - 1) + L}")
    return cfg, calls


def b2_vcm_iteration(dev) -> dict:
    """B2 on every shadow-ray call of one CornellSmall 512^2 VCM iteration:
    bit for bit against its plain version, each call timed against its
    live lanes and its bound; the sums are B2's time and bound per VCM
    iteration."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    _, calls = vcm_shadow_calls(dev)
    it = {"calls": 0, "lanes": 0, "live": 0, "ms": 0.0, "bound_ms": 0.0}
    for i, (o, d, tmin, tmax, occ_tab) in enumerate(calls):
        got = ik.occluded_tris(o, d, tmin, tmax, occ_tab)
        want = ik.occluded_tris_plain(o, d, tmin, tmax, occ_tab)
        if not torch.equal(got, want):
            raise AssertionError(
                f"occluded_tris differs from its plain version on VCM "
                f"shadow-ray call {i} in {int((got != want).sum())} rays")
        ms = cuda_ms(lambda: ik.occluded_tris(o, d, tmin, tmax, occ_tab))
        b = dense_bound(o, d, tmin, tmax, occ_tab, True)
        n, live = o.shape[0], int((tmax > tmin).sum())
        it["calls"] += 1
        it["lanes"] += n
        it["live"] += live
        it["ms"] += ms
        it["bound_ms"] += b["bound_ms"]
        print(f"[kernels] B2 {MAIN_SCENE} {MAIN_SIZE}^2 VCM shadow call {i}: "
              f"lanes {n}, live {live} ({live / n:.4f}), occluded "
              f"{int(got.sum())}; equal bit for bit; ms kernel {ms:.4f}, "
              f"bound {b['bound_ms']:.4f} ({b['bound_by']})")
    print(f"[kernels] B2 per {MAIN_SCENE} {MAIN_SIZE}^2 VCM iteration: "
          f"{it['calls']} launches {it['ms']:.4f} ms over {it['lanes']} "
          f"lanes ({it['live']} live); bound {it['bound_ms']:.4f} ms")
    return it


def _first_blocker(o, d, tmin, tmax, tab, chunk=16384):
    """Per ray, the tests any hit makes over the record table ``tab`` in
    order: up to and including its first hit, all of them on a miss, none
    on a dead lane (the plain version's arithmetic, in chunks of rays)."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    T = tab.shape[0]
    parts = []
    for s in range(0, o.shape[0], chunk):
        sl = slice(s, s + chunk)
        *_, valid = ik._mt_terms(o[sl], d[sl], tmin[sl], tmax[sl], tab)
        first = torch.where(valid.any(dim=1),
                            valid.int().argmax(dim=1) + 1, T)
        parts.append(torch.where(tmax[sl] > tmin[sl], first, 0))
    return torch.cat(parts)


def dense_bound(o, d, tmin, tmax, tab, any_hit: bool) -> dict:
    """B1's (``any_hit`` False) or B2's bound on these rays against the
    record table ``tab``: every lane's tmin, tmax and outputs (B1's four,
    16 bytes; B2's flag), the live lanes' o and d and the table's 48 bytes
    a triangle cross HBM once; B1's live rays test every triangle, B2's
    the occluders up to their first hit."""
    n, T = o.shape[0], tab.shape[0]
    live = int((tmax > tmin).sum())
    if any_hit:
        tests, out_bytes = int(_first_blocker(o, d, tmin, tmax, tab).sum()), 1
    else:
        tests, out_bytes = live * T, 16
    return bound(n * (8 + out_bytes) + live * 24 + T * 48, tests * MT_FLOPS)


def gather_kernel_cases(dev) -> dict:
    """B3 against its plain version on the card, with check_normal on and
    off: the synthetic case, its clustered variant, the PPM main shape and
    the partial grids of a 2-way exchange of its photons.
    The tables (and so the stats) computed on the card must equal those
    computed on the CPU, and the kernel's sums the plain version's within
    GATHER_RTOL + GATHER_ATOL_REL * max|ref|. The PPM main shape and its
    partial grids with check_normal on, the calls of a PPM iteration and of
    each rank of a sharded one, are timed and bounded."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    rng = np.random.default_rng(17)
    inputs = [("synthetic", *gather_case(dev),
               torch.zeros((2, gk.ROWS + 2), device=dev), None)]
    grid, q, qn, r = gather_case(dev, n_photons=8192, cluster=True,
                                 radius=0.2)
    inputs.append(("clustered", grid, q, qn, r, torch.as_tensor(
        rng.uniform(size=(2, gk.ROWS + 2)).astype(np.float32), device=dev),
        None))
    main = ppm_gather_inputs(dev)
    inputs.append((f"{MAIN_SCENE} {MAIN_SIZE}^2 PPM", *main))
    inputs += [(f"{MAIN_SCENE} {MAIN_SIZE}^2 PPM owner {i}'s partial grid",
                part, *main[1:])
               for i, part in enumerate(partial_grids(main[0]))]

    out = {"max_abs_err": 0.0}
    for label, grid, q, qn, r, u, valid in inputs:
        tables = gk._tile_tables(grid, q, r, u, valid)
        cpu_tables = gk._tile_tables(
            _to(grid, "cpu"), q.cpu(), r.cpu() if torch.is_tensor(r) else r,
            u.cpu(), None if valid is None else valid.cpu())
        for name, a, b in zip(("starts", "lens", "weights", "visited",
                               "total", "rows"), tables, cpu_tables):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"B3 {label}: the card's {name} table "
                                     "differs from the CPU's")
        starts, lens, weights, visited, total, rows = tables
        r2 = torch.square(torch.as_tensor(r, dtype=torch.float32,
                                          device=dev))
        for check_normal in (True, False):
            args = (starts, lens, weights, rows, r2, q, qn, grid,
                    check_normal)
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
                    f"B3 differs from its plain version on {label} "
                    f"check_normal={check_normal}: {bad} sums outside the "
                    f"tolerance, max |err| {max_err:.3g} (max |ref| "
                    f"{scale:.3g})")
            out["max_abs_err"] = max(out["max_abs_err"], max_err)
            timing = ""
            if valid is not None and check_normal:   # a PPM iteration's call
                # each query against the staged photons in its own cell
                # box; the photons in the windows, the queries, tables and
                # sums cross HBM once
                rec = out if grid is main[0] else out.setdefault(
                    "partial_grids", {}).setdefault(label, {})
                n_q, n_p = q.shape[0], grid.position.shape[0]
                pairs = query_pairs(grid, q, r, starts, lens)
                k0, k1 = gk.culled_windows_plain(grid, q, r2, starts, lens,
                                                 rows)
                rec.update(bound(
                    covered_rows(starts, lens, n_p) * 36 + n_q * (24 + 12)
                    + starts.numel() * 16, pairs * PAIR_FLOPS))
                timing = (f"; pairs needed {pairs}, walked "
                          f"{int((k1 - k0).sum())} of "
                          f"{int(lens.long().sum()) * gk.TILE} staged")
                rec["ms"] = cuda_ms(
                    lambda: gk.gather_photons_tiled_kernel(*args))
                rec["plain_ms"] = cuda_ms(
                    lambda: gk.gather_photons_tiled_plain(*args),
                    reps=PLAIN_GATHER_REPS, warmup=1, batch=1, graph=False)
                timing += (f"; ms kernel {rec['ms']:.4f} (median of "
                           f"{TIMING_REPS}) / plain {rec['plain_ms']:.4f} "
                           f"(median of {PLAIN_GATHER_REPS}), bound "
                           f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
            print(f"[kernels] B3 {label} check_normal={check_normal}: "
                  f"queries={q.shape[0]} photons={grid.position.shape[0]} "
                  f"(valid {int(grid.n_valid)}), visited "
                  f"{int(visited.sum())}, subsampled "
                  f"{int((total - visited).clamp_min(0).sum())}; stats "
                  f"equal, sums within tolerance (max |err| {max_err:.3g}, "
                  f"max |ref| {scale:.4g}){timing}")
    return out


def vcm_merge_inputs(dev):
    """The merge's inputs at every camera bounce of one CornellSmall 512^2
    VCM+VM iteration (iteration 0, seed 0, the bench's VCM+VM
    configuration), recorded where ``integrators/vcm._merge_vertices``
    calls the tile merge. Returns (cfg, [kwargs with ``u_rows``] in call
    order)."""
    from oppositerenderer_tpu_torch.integrators import vcm
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    cfg = vcm_main_config(use_vm=True)
    r = Renderer(scene, cam, cfg, seed=0)
    calls = []
    merge = vcm.merge_vertices_tiled

    def record(vgrid, cfg, cam_bsdf, cam_pos, cam_thr, cam_dVCM, cam_dVM,
               active, radius_sq, mis_vc_w, n_light_paths, u_rows, depth1,
               mesh=None):
        calls.append(dict(
            vgrid=vgrid, cam_bsdf=cam_bsdf, cam_pos=cam_pos,
            cam_thr=cam_thr, cam_dVCM=cam_dVCM, cam_dVM=cam_dVM,
            active=active, radius_sq=radius_sq, mis_vc_w=mis_vc_w,
            n_light_paths=n_light_paths, u_rows=u_rows, depth1=depth1))
        return merge(vgrid, cfg, cam_bsdf, cam_pos, cam_thr, cam_dVCM,
                     cam_dVM, active, radius_sq, mis_vc_w, n_light_paths,
                     u_rows, depth1, mesh=mesh)

    vcm.merge_vertices_tiled = record
    try:   # the eager body: a replay would call no wrapper
        r._iteration(0, r._radius_sq(0))
    finally:
        vcm.merge_vertices_tiled = merge
    if len(calls) != cfg.vcm_max_path_length:
        raise AssertionError(f"{len(calls)} merge rounds in one VCM+VM "
                             f"iteration, expected {cfg.vcm_max_path_length}")
    return cfg, calls


def vm_bound(k, args) -> tuple[dict, int]:
    """B4's bound on one merge round, and the pairs it needs: each valid
    query (a 128-byte table row, two float3 sums out) against the staged
    vertices (52 bytes of fields) in its own cell box; the slot tables
    (16 bytes a slot) once."""
    starts, lens, _, _, scal, qtab, vgrid = args
    pairs = query_pairs(k["vgrid"], qtab[:, 0:3], torch.sqrt(scal[0]),
                        starts, lens, qtab[:, 24] > 0.5)
    n_v = vgrid.packed.shape[0]
    return bound(covered_rows(starts, lens, n_v) * 52
                 + qtab.shape[0] * (128 + 24) + starts.numel() * 16,
                 pairs * PAIR_FLOPS), pairs


def vm_kernel_cases(dev) -> dict:
    """B4 against its plain version on the card: the query order and slot
    tables computed on the card must equal those computed on the CPU, and
    each of the kernel's two sums the plain version's within VM_RTOL +
    VM_ATOL_REL * max|ref|; on the synthetic cases and on every merge
    round of one CornellSmall 512^2 VCM+VM iteration. The second bounce is
    the timed shape (against the plain version too); every round is timed,
    and the sum is the kernel's time per iteration."""
    from oppositerenderer_tpu_torch.accel import vm_kernels as vk
    cases = []
    for label, cluster in (("synthetic", False), ("clustered", True)):
        _, cfg, k = vm_case(dev, 0, cluster)
        n = k["cam_pos"].shape[0]
        k["u_rows"] = k.pop("u_stride").reshape(n // vk.TILE, vk.TILE)[
            :, :vk.ROWS + 2]
        cases.append((label, cfg, k))
    cfg, rounds = vcm_merge_inputs(dev)
    cases += [(f"{MAIN_SCENE} {MAIN_SIZE}^2 VCM+VM bounce {k['depth1']}",
               cfg, k) for k in rounds]

    def tables(cfg, k):
        return vk.merge_tables(
            k["vgrid"], cfg, k["cam_bsdf"], k["cam_pos"], k["cam_dVCM"],
            k["cam_dVM"], k["active"], k["radius_sq"], k["mis_vc_w"],
            k["u_rows"], k["depth1"])

    out = {"max_abs_err": 0.0}
    it = {"calls": 0, "ms": 0.0, "bound_ms": 0.0, "pairs": 0, "staged": 0}
    for label, cfg, k in cases:
        order, args, _, _ = tables(cfg, k)
        cpu_order, cpu_args, _, _ = tables(cfg, _to(k, "cpu"))
        for name, a, b in (("order", order, cpu_order),
                           *zip(("starts", "lens", "weights", "rows"),
                                args[:4], cpu_args[:4])):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"B4 {label}: the card's {name} "
                                     "differs from the CPU's")
        got = vk.merge_vertices_tiled_kernel(*args)
        want = vk.merge_vertices_tiled_plain(*args)
        torch.cuda.synchronize()
        errs, scales = [], []
        for which, g, w in zip(("out1", "out2"), got, want):
            err = (g.double() - w.double()).abs()
            scale = float(w.abs().max())
            bad = int((err > VM_RTOL * w.double().abs()
                       + VM_ATOL_REL * scale).sum())
            if bad or not bool(torch.isfinite(g).all()):
                raise AssertionError(
                    f"B4 {which} differs from its plain version on {label}:"
                    f" {bad} sums outside the tolerance, max |err| "
                    f"{float(err.max()):.3g} (max |ref| {scale:.3g})")
            errs.append(float(err.max()))
            scales.append(scale)
        if label.startswith(("synthetic", "clustered")) and scales[0] <= 0.0:
            raise AssertionError(f"B4 {label}: no merge energy")
        out["max_abs_err"] = max(out["max_abs_err"], *errs)
        lens, qtab = args[1], args[5]
        timing = ""
        if "VCM+VM" in label:   # the main path's rounds
            b, pairs = vm_bound(k, args)
            ms = cuda_ms(lambda: vk.merge_vertices_tiled_kernel(*args))
            staged = int(lens.long().sum()) * vk.TILE
            it["calls"] += 1
            it["ms"] += ms
            it["bound_ms"] += b["bound_ms"]
            it["pairs"] += pairs
            it["staged"] += staged
            timing = (f"; pairs needed {pairs} of {staged} staged; ms kernel "
                      f"{ms:.4f} (median of {TIMING_REPS}), bound "
                      f"{b['bound_ms']:.4f} ({b['bound_by']})")
            if k["depth1"] == 2:   # the timed shape of earlier PRs
                out.update(b)
                out["ms"] = ms
                out["plain_ms"] = cuda_ms(
                    lambda: vk.merge_vertices_tiled_plain(*args),
                    reps=PLAIN_VM_REPS, warmup=1, batch=1, graph=False)
                timing += (f" / plain {out['plain_ms']:.4f} (median of "
                           f"{PLAIN_VM_REPS})")
        print(f"[kernels] B4 {label}: queries={qtab.shape[0]} (valid "
              f"{int((qtab[:, 24] > 0.5).sum())}) vertices="
              f"{args[6].packed.shape[0]}, staged {int(lens.sum())}, slots "
              f"subsampled {int((args[2] > 1.0).sum())}; tables equal, sums "
              f"within tolerance (max |err| out1 {errs[0]:.3g} of "
              f"{scales[0]:.4g}, out2 {errs[1]:.3g} of {scales[1]:.4g})"
              f"{timing}")
    # the packed records, built once per grid: its fields read, the
    # records written
    g = rounds[0]["vgrid"]
    fields = {f: getattr(g, f) for f in vk.VERTEX_FIELDS}
    cell = g.packed[:, 13].long()   # the x cells: a stand-in of the same size
    pack_ms = cuda_ms(lambda: vk.pack_vertex_records(
        **fields, cell=cell, resolution=g.resolution))
    pack_b = bound(g.packed.shape[0] * (52 + 4 * vk.RECORD), 0)
    it.update(pack_ms=pack_ms, pack_bound_ms=pack_b["bound_ms"])
    it["bound_ms"] += pack_b["bound_ms"]
    out["per_iteration"] = {f"{MAIN_SCENE} {MAIN_SIZE}^2 VCM+VM": it}
    print(f"[kernels] B4 per VCM+VM iteration: {it['calls']} launches "
          f"{it['ms']:.4f} ms, packing the grid {pack_ms:.4f} ms; bound "
          f"{it['bound_ms']:.4f} ms (packing {pack_b['bound_ms']:.4f}); "
          f"pairs needed {it['pairs']} of {it['staged']} staged")
    return out


def pt_traversal_calls(scene, cam, size: int):
    """The traversal calls of one PT iteration of a BVH scene at size^2
    (the default RenderConfig): (closest-hit inputs, any-hit inputs), each
    a list of (bvh, o, d, tmin, tmax) per call."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    calls = iteration_calls(scene, cam, RenderConfig(width=size, height=size),
                            ("traverse", "traverse_any"))
    return ([c[1:] for c in calls["traverse"]],
            [c[1:] for c in calls["traverse_any"]])


def bvh_bound(bvh, n: int, any_hit: bool, visits, row_floats) -> dict:
    """B5's bound on one call from the plain version's counts: the rays and
    results cross HBM once, and so do the floats of each row that some ray
    read and whose traversal uses them; the slab tests of the children in
    ``cmask & valid`` of each inner visit and the triangles each ray
    tested (any hit: the flagged ones up to its first hit)."""
    return bound(n * (32 + (1 if any_hit else 17))
                 + 4 * int(row_floats.sum()),
                 float(visits[:, 2].sum()) * SLAB_FLOPS
                 + float(visits[:, 3].sum()) * MT_FLOPS)


def bvh_kernel_cases(dev) -> dict:
    """B5 (closest and any hit) against its plain version on the card, bit
    for bit: random rays in full Atrium's box (a quarter dead, then all
    dead and all live), every traversal call of one Atrium 512^2 and one
    Conference 1024^2 PT iteration (each scene's full table at its main
    path's lane count), and random rays in CornellSmall with a BVH; on
    every input the live-lane compaction finds the lanes its plain version
    finds. The timed and bounded shapes are Atrium's main path's: its
    primary rays and first shadow rays; every call of both iterations is
    timed, and the sums are the kernels' times per iteration."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel.bvh import build_scene_bvh
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cornell, _ = get_scene_by_name(MAIN_SCENE, dev)
    cornell_b, cbvh = build_scene_bvh(cornell)
    cases = []
    for name, size, key in (("Atrium", ATRIUM_SIZE, True),
                            ("Conference", CONFERENCE_SIZE, False)):
        scene, cam = get_scene_by_name(name, dev)
        closest_calls, any_calls = pt_traversal_calls(scene, cam, size)
        it = f"{name} {size}^2"
        if name == "Atrium":
            rays = _rays(65536, 300, scene.aabb_min.tolist(),
                         scene.aabb_max.tolist(), dev)
            cases += [("Atrium random", scene.bvh, rays, None, False, None),
                      ("Atrium random all dead", scene.bvh,
                       dead_or_live(rays, False), None, False, None),
                      ("Atrium random all live", scene.bvh,
                       dead_or_live(rays, True), None, False, None)]
        cases += [(f"{it} PT segment {i} closest", scene.bvh, list(c),
                   "traverse" if i == 0 else None, key, it)
                  for i, c in enumerate(closest_calls)]
        cases += [(f"{it} PT segment {i} shadow", scene.bvh, list(c),
                   "traverse_any" if i == 0 else None, key, it)
                  for i, c in enumerate(any_calls)]
    cases.append((f"{MAIN_SCENE} with a BVH random", cbvh,
                  _rays(MAIN_SIZE * MAIN_SIZE, 301, cornell.aabb_min.tolist(),
                        cornell.aabb_max.tolist(), dev), None, False, None))
    out = {"traverse": {"max_abs_err": 0.0, "per_iteration": {}},
           "traverse_any": {"max_abs_err": 0.0, "per_iteration": {}}}
    for label, bvh, (o, d, tmin, tmax), timed, key, it in cases:
        n = o.shape[0]
        got_c = bk.compact_live(tmin, tmax)
        want_c = bk.compact_live_plain(tmin, tmax)
        if not all(torch.equal(a, b) for a, b in zip(got_c, want_c)):
            raise AssertionError(f"B5's live-lane compaction differs from "
                                 f"its plain version on {label}")
        c = int(want_c[1].sum())
        kinds = ("traverse_any",) if "shadow" in label else (
            ("traverse",) if "closest" in label else ("traverse",
                                                      "traverse_any"))
        lines = []
        for k in kinds:
            any_hit = k == "traverse_any"
            got = getattr(bk, k)(bvh, o, d, tmin, tmax)
            torch.cuda.synchronize()
            t, prim, u, v, found, visits, row_floats = bk.plain_traversal(
                bvh, o, d, tmin, tmax, any_hit)
            want = found if any_hit else (t, prim, u, v, found)
            pairs = ([("found", got, want)] if any_hit else
                     list(zip(("t", "prim", "u", "v", "found"), got, want)))
            for field, a, b in pairs:
                bad = _bits_differ(a, b)
                if bad:
                    raise AssertionError(
                        f"B5 {k} differs from its plain version on {label}:"
                        f" {field} differs in {bad} of {n} rays")
            live = tmax > tmin
            vis = visits[live].double() if c else torch.zeros((1, 4))
            b = bvh_bound(bvh, n, any_hit, visits, row_floats)
            line = (f"{k}: equal bit for bit ({int(found.sum())} of "
                    f"{int(live.sum())} live rays {'blocked' if any_hit else 'hit'}); "
                    f"per live ray: inner rows {float(vis[:, 0].mean()):.3f}, "
                    f"leaf rows {float(vis[:, 1].mean()):.3f}, slab tests "
                    f"{float(vis[:, 2].mean()):.3f}, triangle tests "
                    f"{float(vis[:, 3].mean()):.3f}; "
                    f"{int((row_floats > 0).sum())} of {bvh.rows.shape[0]} "
                    f"rows read, {4 * int(row_floats.sum())} bytes of them "
                    f"used; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            if it is not None:   # a call of a main path's iteration
                fn = getattr(bk, k)
                ms = cuda_ms(lambda: fn(bvh, o, d, tmin, tmax))
                line += f"; ms kernel {ms:.4f} (median of {TIMING_REPS})"
                acc = out[k]["per_iteration"].setdefault(
                    it, {"calls": 0, "ms": 0.0, "bound_ms": 0.0})
                acc["calls"] += 1
                acc["ms"] += ms
                acc["bound_ms"] += b["bound_ms"]
                if timed == k and key:
                    plain = bk.traverse_any_plain if any_hit else \
                        bk.traverse_plain
                    out[k].update(b)
                    out[k]["ms"] = ms
                    out[k]["plain_ms"] = cuda_ms(
                        lambda: plain(bvh, o, d, tmin, tmax),
                        reps=PLAIN_BVH_REPS, warmup=1, batch=1, graph=False)
                    line += (f" / plain {out[k]['plain_ms']:.4f} (median of "
                             f"{PLAIN_BVH_REPS})")
            lines.append(line)
        print(f"[kernels] B5 {label}: rays={n}; " + "; ".join(lines))
    for k in ("traverse", "traverse_any"):
        for it, acc in out[k]["per_iteration"].items():
            print(f"[kernels] B5 {k} per {it} PT iteration: {acc['calls']} "
                  f"launches {acc['ms']:.4f} ms, bound {acc['bound_ms']:.4f}"
                  " ms")
    return out


def flagship_b3(dev, scene, cam, cfg, label: str) -> dict:
    """B3 on the gather of one flagship PPM iteration: against its plain
    version (GATHER_RTOL + GATHER_ATOL_REL max|ref|), timed, bounded."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    grid, q, qn, r, u, valid = ppm_gather_inputs(dev, scene=scene, cam=cam,
                                                 cfg=cfg)
    starts, lens, weights, visited, _, rows = gk._tile_tables(grid, q, r, u,
                                                              valid)
    r2 = torch.square(torch.as_tensor(r, dtype=torch.float32, device=dev))
    args = (starts, lens, weights, rows, r2, q, qn, grid, True)
    got = gk.gather_photons_tiled_kernel(*args)
    want = gk.gather_photons_tiled_plain(*args)
    err = (got.double() - want.double()).abs()
    scale = float(want.abs().max())
    bad = int((err > GATHER_RTOL * want.double().abs()
               + GATHER_ATOL_REL * scale).sum())
    if bad or not bool(torch.isfinite(got).all()) or scale <= 0.0:
        raise AssertionError(f"B3 differs from its plain version on {label}:"
                             f" {bad} sums outside the tolerance (max |ref| "
                             f"{scale:.3g})")
    n_q, n_p = q.shape[0], grid.position.shape[0]
    pairs = query_pairs(grid, q, r, starts, lens)
    out = bound(covered_rows(starts, lens, n_p) * 36 + n_q * (24 + 12)
                + starts.numel() * 16, pairs * PAIR_FLOPS)
    out.update(calls=1, max_abs_err=float(err.max()),
               ms=cuda_ms(lambda: gk.gather_photons_tiled_kernel(*args)),
               plain_ms=cuda_ms(lambda: gk.gather_photons_tiled_plain(*args),
                                reps=PLAIN_GATHER_REPS, warmup=1, batch=1,
                                graph=False))
    print(f"[kernels] B3 {label}: queries={n_q} photons={n_p} (valid "
          f"{int(grid.n_valid)}), tiles {starts.shape[0]}, visited "
          f"{int(visited.sum())}, pairs needed {pairs}; sums within "
          f"tolerance (max |err| {out['max_abs_err']:.3g}, max |ref| "
          f"{scale:.4g}); ms kernel {out['ms']:.4f} / plain "
          f"{out['plain_ms']:.4f}, bound {out['bound_ms']:.4f} "
          f"({out['bound_by']})")
    return out


def flagship_b5(dev, calls: dict, label: str) -> dict:
    """B5 on every traversal call of one flagship iteration (``calls``, as
    ``iteration_calls`` records them): each call's results against its
    plain version, bit for bit, on a 1-in-k sample of its lanes (at most
    FLAGSHIP_SAMPLE_LANES; each ray is traversed alone, so a sample checks
    the call's bits where it falls); each call timed (median of
    FLAGSHIP_TIMING_REPS graph replays); its bound from the sample's
    counts, scaled to the call's lanes (the rows are those the sample
    read: a lower bound). Returns per kernel the summed calls, ms and
    bound."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    out = {}
    for k, ks in calls.items():
        any_hit = k == "traverse_any"
        fn = getattr(bk, k)
        acc = {"calls": 0, "lanes": 0, "ms": 0.0, "bound_ms": 0.0}
        for i, (bvh, o, d, tmin, tmax) in enumerate(ks):
            n = o.shape[0]
            sample = torch.arange(0, n, -(-n // FLAGSHIP_SAMPLE_LANES),
                                  device=dev)
            got = fn(bvh, o, d, tmin, tmax)
            t, prim, u, v, found, visits, row_floats = bk.plain_traversal(
                bvh, o[sample], d[sample], tmin[sample], tmax[sample],
                any_hit)
            want = (found,) if any_hit else (t, prim, u, v, found)
            got = (got,) if any_hit else got
            bad = sum(_bits_differ(a[sample], b) for a, b in zip(got, want))
            if bad:
                raise AssertionError(f"B5 {k} differs from its plain version "
                                     f"on {label} call {i} in {bad} values")
            scale = n / sample.shape[0]
            b = bound(n * (32 + (1 if any_hit else 17))
                      + 4 * int(row_floats.sum()),
                      scale * (float(visits[:, 2].sum()) * SLAB_FLOPS
                               + float(visits[:, 3].sum()) * MT_FLOPS))
            acc["calls"] += 1
            acc["lanes"] += n
            acc["ms"] += cuda_ms(lambda: fn(bvh, o, d, tmin, tmax),
                                 reps=FLAGSHIP_TIMING_REPS, batch=2)
            acc["bound_ms"] += b["bound_ms"]
        print(f"[kernels] B5 {k} per {label} iteration: {acc['calls']} "
              f"launches over {acc['lanes']} lanes, equal bit for bit on "
              f"1-in-k samples, {acc['ms']:.4f} ms, bound "
              f"{acc['bound_ms']:.4f} ms")
        out[k] = acc
    return out


def flagship_launches(cfg) -> dict:
    """A BVH scene's launches per iteration: B5 once per eye and photon
    bounce and once per direct shadow sample, and B3 once (PPM); B5 once
    per light and camera bounce and once per light bounce's and camera
    bounce's shadow rays (VCM, no merging); B1 and B2 never."""
    from oppositerenderer_tpu_torch.config import RenderMethod
    if cfg.render_method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
        return {"traverse": (cfg.max_radiance_trace_depth
                             + cfg.max_photon_trace_depth),
                "traverse_any": cfg.ppm_direct_shadow_samples,
                "gather_photons_tiled": 1, "closest_hit_tris": 0,
                "occluded_tris": 0}
    L = cfg.vcm_max_path_length
    return {"traverse": 2 * L - 1, "traverse_any": (L - 1) + L,
            "gather_photons_tiled": 0, "closest_hit_tris": 0,
            "occluded_tris": 0}


def flagship_iterations(dev, kernels: dict) -> None:
    """milestone4_torch.py's Atrium and Conference, each exported at full
    detail and imported from its .dae (with its native BVH), PPM and VCM
    at 1024^2 with the default RenderConfig: the kernels' launches in one
    iteration of each (``flagship_launches``), B3 on the PPM iteration's
    gather and B5 on every traversal call of both, added to ``kernels``'
    per-iteration figures."""
    import milestone4_torch as m4
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    wrappers = (bk.traverse, bk.traverse_any, gk.gather_photons_tiled,
                ik.closest_hit_tris, ik.occluded_tris)
    for base in m4.SCENES:
        dae, _, factory_tris = m4.export_scene(base, 1.0)
        scene, _ = get_scene_by_name(str(dae), dev)
        _, cam = get_scene_by_name(f"{base}:0.1", dev)   # the file has none
        if (scene.geometry.n_triangles != factory_tris or scene.bvh is None
                or scene.bvh.builder != "native"):
            raise AssertionError(f"{base}: the import lost triangles or its "
                                 "native BVH")
        for method in m4.METHODS:
            cfg = m4.method_config(method, m4.SIZE)
            label = f"{base} import {m4.SIZE}^2 {method.upper()}"
            before = [w.launches for w in wrappers]
            calls = iteration_calls(scene, cam, cfg,
                                    ("traverse", "traverse_any"))
            launched = {w.__name__: w.launches - c
                        for w, c in zip(wrappers, before)}
            if launched != flagship_launches(cfg):
                raise AssertionError(f"{label}: launches per iteration "
                                     f"{launched}, expected "
                                     f"{flagship_launches(cfg)}")
            print(f"[kernels] {label}: {scene.geometry.n_triangles} "
                  f"triangles, BVH rows {scene.bvh.rows.shape[0]}; launches "
                  f"per iteration {launched}")
            if method == "ppm":
                b3 = flagship_b3(dev, scene, cam, cfg, label)
                k3 = kernels["gather_photons_tiled"]
                k3["max_abs_err"] = max(k3["max_abs_err"], b3["max_abs_err"])
                k3.setdefault("per_iteration", {})[label] = b3
            for k, acc in flagship_b5(dev, calls, label).items():
                kernels[k]["per_iteration"][label] = acc
            del calls
        # the exports are rebuilt from the factories: keep chiprun_out small
        for f in (dae, *dae.parent.glob(f"{dae.stem}_tex*.png")):
            f.unlink()
        del scene
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the packet node-step microbenchmark (B6)
def b6_bound(steps: int, tiles: int, variant: str = "scalar") -> dict:
    """B6's least time in ``variant``: 8 slab tests of SLAB_FLOPS operations
    a ray and step (dmaonly: one addition); the bytes are the rows the
    steps read (48 floats each; fixedrow one a tile), the rays' origins
    and directions (not read by dmaonly), and best."""
    rays = tiles * 1024
    if variant == "dmaonly":
        return bound((steps * tiles * 48 + rays) * 4, rays * steps)
    rows_read = tiles * (1 if variant == "fixedrow" else steps)
    return bound((rows_read * 48 + 2 * 3 * rays + rays) * 4,
                 rays * steps * 8 * SLAB_FLOPS)


def phase_b6(dev) -> dict:
    """B6 in every variant against its plain version bit for bit at the
    microbenchmark's defaults and at B6_WIDE_TILES tiles, each timed with
    its bound, and the CTAs a tile checked against the rule (2 when twice
    the tiles fit the SMs); then the microbenchmark's entry point
    (``python -m oppositerenderer_tpu_torch.scripts.packet_kernel_exp``'s
    main) at its defaults once per variant, its two lines printed and its
    launches counted. Returns scalar's entry (the 528-tile one and the
    other variants' under it), with the script's launches."""
    import io

    from oppositerenderer_tpu_torch.accel import packet_exp_kernels as pk
    from oppositerenderer_tpu_torch.scripts import packet_kernel_exp as script
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"max_abs_err": 0.0, "variants": {v: {} for v in pk.VARIANTS[1:]}}
    for tiles in (B6_TILES, B6_WIDE_TILES):
        cluster = pk.cluster_size(tiles, dev)
        if cluster != (2 if 2 * tiles <= sms else 1):
            raise AssertionError(f"B6 at {tiles} tiles on {sms} SMs takes "
                                 f"{cluster} CTAs a tile")
        print(f"[b6] {tiles} tiles x 1024 rays, {B6_STEPS} steps, "
              f"{B6_ROWS} rows, {sms} SMs: {cluster} CTA(s) a tile")
        table, o, d = script.make_inputs(B6_ROWS, tiles, dev)
        for v in pk.VARIANTS:
            got = pk.packet_steps(table, o, d, B6_STEPS, v)
            want = pk.plain_packet_steps(table, o, d, B6_STEPS, v)
            bad = _bits_differ(got, want)
            if bad:
                raise AssertionError(f"packet_steps {v} differs from its "
                                     f"plain version at {tiles} tiles in "
                                     f"{bad} rays")
            entry = {"ms": cuda_ms(lambda: pk.packet_steps(
                         table, o, d, B6_STEPS, v)),
                     "plain_ms": cuda_ms(lambda: pk.plain_packet_steps(
                         table, o, d, B6_STEPS, v), reps=3, warmup=1,
                         batch=1, graph=False),
                     **b6_bound(B6_STEPS, tiles, v),
                     "hit_share": float((got < 1e30).float().mean()),
                     "ctas_per_tile": cluster}
            if v == "scalar":
                scalar_ms = entry["ms"]
                if tiles == B6_TILES:
                    out.update(entry)
                else:
                    out[f"{tiles} tiles"] = entry
            else:
                entry["of_scalar"] = entry["ms"] / scalar_ms
                out["variants"][v][f"{tiles} tiles"] = entry
            print(f"[b6] {tiles} tiles {v}: equal to plain bit for bit "
                  f"(rays with a hit {entry['hit_share']:.4f}); ms kernel "
                  f"{entry['ms']:.4f} ({entry['ms'] / scalar_ms:.3f} of "
                  f"scalar), plain {entry['plain_ms']:.4f}, bound "
                  f"{entry['bound_ms']:.4f} ({entry['bound_by']})")
    pk.packet_steps.launches = 0
    want_head = (f"device={torch.cuda.get_device_name(dev)} G={B6_TILES} "
                 f"STEPS={B6_STEPS} R={B6_ROWS}")
    for v in pk.VARIANTS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            script.main(["--reps", str(B6_SCRIPT_REPS), "--variant", v])
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"[b6] packet_kernel_exp --variant {v}: {line}")
        if len(lines) != 2 or lines[0] != want_head:
            raise AssertionError(f"packet_kernel_exp --variant {v} printed "
                                 f"{lines}")
    launches = pk.packet_steps.launches
    if launches != (1 + B6_SCRIPT_REPS) * len(pk.VARIANTS):
        raise AssertionError(f"packet_kernel_exp launched B6 {launches} "
                             f"times, not (1 + {B6_SCRIPT_REPS}) x "
                             f"{len(pk.VARIANTS)}")
    out["script_launches"] = launches
    return out


def timed(tag: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
    return out



def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    name = phase_device()   # first: no CUDA device, no result
    dev = torch.device("cuda", 0)
    # the plain versions' products in full float32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    kernels = timed("kernels", phase_kernels, dev)
    kernels["packet_steps"] = timed("b6", phase_b6, dev)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCES[k],
         "replaces": KERNELS[k], **kernels[k]} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
