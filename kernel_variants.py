"""Design variants of the port's kernels B1, B2 and B3, timed on the card
in turns with the kernels as built, on the main paths' inputs.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 kernel_variants.py

* B1 and B2 (``csrc/intersect.cu``): each variant is the source with a
  few text substitutions, built with the port's nvcc flags into
  ``_chip_tree/variants/`` and launched through the port's own wrappers
  (``chip_smoke.kernels_of``):
  - ``two_rays``: a B1 thread tests two live rays against each staged
    triangle; ``two_rays_block128`` the same with 128-thread blocks;
  - ``one_group``: a block compacts one group of 256 lanes whatever the
    launch size (the built kernels take up to 8); ``b1_min4`` and
    ``b1_min8``: B1 takes as many groups as keep 4 or 8 blocks per SM
    (the built kernel 16, B2 4);
  - ``unroll4``: B1's triangle loop unrolled by 4 (the built kernel 2);
  - ``div_if_ok``: 1/det computed only where |det| > 1e-12, behind a
    branch (the built kernels divide on every pair and then select);
  - ``block128``: 128-lane blocks and groups;
  - ``double_buffer``: B1 stages 256-triangle chunks with cp.async into
    two buffers, the next chunk's copy overlapping the current one's tests;
    ``chunk256``: 256-triangle chunks in one buffer (its yardstick);
  - ``u_reject``: a pair whose u is certainly negative (num_u and det of
    opposite signs, det finite, |num_u| >= 1e-6 so that num_u / det
    cannot underflow to -0.0) is rejected before the division;
  - ``rcp_rn``: 1/det as ``__frcp_rn(det)``; ``fast_div`` as
    ``__fdividef(1.0f, det)`` (not IEEE: it times the division and counts
    the results it changes).
  B1 runs every closest-hit call of one CornellSmall 512^2 PPM iteration
  (summed), the 262,144 random rays of ``chip_smoke.py``'s table shape and
  the 4096-triangle soup; B2 every shadow-ray call of one VCM iteration
  and the table shape. Each prints the results that differ from the plain
  version. Then one kernel compares ``__frcp_rn(x)`` with ``1.0f / x`` on
  all 2^32 float32 bit patterns.
* B3 (``csrc/gather.cu``): the same library launched with 2, 4, 16 and
  32 slot groups per tile, against the built 8, at the PPM main shape.

Prints one line per variant and shape: its ms and the built kernel's, in
turns (built, variant, variant, built; device time, medians of 20 replays
of a CUDA graph of 10 calls, as ``chip_smoke.cuda_ms``).
"""
from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from oppositerenderer_tpu_torch.accel import cuda_build
from oppositerenderer_tpu_torch.accel import gather_kernels as gk
from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
from oppositerenderer_tpu_torch.accel.intersect import dense_tables
from oppositerenderer_tpu_torch.scene import get_scene_by_name

OUT = Path(__file__).resolve().parent / "_chip_tree" / "variants"
_RCP_DET = "  const float rcp_det = 1.0f / det;\n"
_INV_DET = "  const float inv_det = ok_det ? rcp_det : 0.0f;\n"
_TRI_LOOP = "        for (int k = 0; k < cnt; ++k) {\n"
VARIANTS = {
    "two_rays": [("constexpr int kRaysPerThread = 1;",
                  "constexpr int kRaysPerThread = 2;")],
    "two_rays_block128": [
        ("constexpr int kRaysPerThread = 1;",
         "constexpr int kRaysPerThread = 2;"),
        ("constexpr int kBlock = 256;", "constexpr int kBlock = 128;")],
    "one_group": [("constexpr int kGroups = 8;", "constexpr int kGroups = 1;")],
    "b1_min4": [("constexpr int kTriMinBlocks = 16;",
                 "constexpr int kTriMinBlocks = 4;")],
    "b1_min8": [("constexpr int kTriMinBlocks = 16;",
                 "constexpr int kTriMinBlocks = 8;")],
    "unroll4": [("#pragma unroll 2\n" + _TRI_LOOP,
                 "#pragma unroll 4\n" + _TRI_LOOP)],
    "div_if_ok": [(_RCP_DET + _INV_DET,
                   "  const float inv_det = ok_det ? 1.0f / det : 0.0f;\n")],
    "block128": [("constexpr int kBlock = 256;", "constexpr int kBlock = 128;")],
    "double_buffer": [
        ("constexpr int kTriChunk = 512;", "constexpr int kTriChunk = 256;"),
        ("constexpr int kTriStages = 1;", "constexpr int kTriStages = 2;")],
    "chunk256": [("constexpr int kTriChunk = 512;",
                  "constexpr int kTriChunk = 256;")],
    "u_reject": [(_RCP_DET,
                  "  if (fabsf(det) <= 3.402823466e38f && fabsf(num_u) >= "
                  "1e-6f &&\n      (num_u < 0.0f) != (det < 0.0f))\n"
                  "    return false;\n" + _RCP_DET)],
    "rcp_rn": [("1.0f / det", "__frcp_rn(det)")],
    "fast_div": [("1.0f / det", "__fdividef(1.0f, det)")],
}
# variants that change only B1's code: not timed on B2
B1_ONLY = {"two_rays", "two_rays_block128", "b1_min4", "b1_min8", "unroll4",
           "double_buffer", "chunk256"}
RCP_CHECK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void rcp_check(unsigned long long* bad) {
  unsigned long long n = 0;
  for (uint64_t b = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
       b < (1ull << 32); b += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float(static_cast<unsigned>(b));
    const float a = __frcp_rn(x), c = 1.0f / x;
    if (__float_as_uint(a) != __float_as_uint(c) && !(isnan(a) && isnan(c)))
      ++n;
  }
  atomicAdd(bad, n);
}
extern "C" int rcp_mismatches(unsigned long long* bad, cudaStream_t s) {
  rcp_check<<<1056, 256, 0, s>>>(bad);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_variants() -> dict:
    """Every variant's library and the reciprocal check's, built by the
    port's nvcc flags, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = cuda_build.SOURCES[0].read_text()
    sources = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the "
                                   "source")
            text = text.replace(old, new)
        sources[name] = text
    sources["rcp_check"] = RCP_CHECK
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(
            lambda name: cuda_build.compile_sources(
                [OUT / f"{name}.cu"], OUT / f"{name}.so"), sources)))
    libs = {}
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line and name != "rcp_check":
                print(f"[variants] {name} build: {line.strip()}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if name == "rcp_check":
            lib.rcp_mismatches.argtypes = [ctypes.c_void_p] * 2
            lib.rcp_mismatches.restype = ctypes.c_int
        else:
            for entry in ("closest_hit_tris", "occluded_tris"):
                getattr(lib, entry).argtypes = cuda_build.ENTRY_POINTS[entry]
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(fn, calls, lib=None):
    """A function calling wrapper ``fn`` on every call (launching ``lib``'s
    kernels, if given), returning its outputs as one tuple of tensors."""
    def run():
        outs = [fn(*c) for c in calls]
        return tuple(x for out in outs
                     for x in (out if isinstance(out, tuple) else (out,)))

    if lib is None:
        return run

    def run_lib():
        with cs.kernels_of(lib):
            return run()
    return run_lib


def main() -> int:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    libs = build_variants()

    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    rc = libs["rcp_check"].rcp_mismatches(
        bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"rcp_check failed: cudaError {rc}")
    print(f"[variants] __frcp_rn(x) against 1.0f / x on all 2^32 float32 "
          f"bit patterns: {int(bad)} differ (NaN against NaN counts equal)")

    scene, _ = get_scene_by_name(cs.MAIN_SCENE, dev)
    tris, occ = dense_tables(scene)
    table_rays = cs._rays(cs.MAIN_SIZE ** 2, 100, scene.aabb_min.tolist(),
                          scene.aabb_max.tolist(), dev)
    soup = (*cs._rays(cs.MAIN_SIZE ** 2, 102, *cs.SOUP_BOX, dev),
            ik.triangle_records(cs.soup_tri9(dev)))
    shapes = [
        ("B1", "PPM iteration", ik.closest_hit_tris, ik.closest_hit_tris_plain,
         cs.closest_hit_calls(dev, "PPM")),
        ("B1", "table shape", ik.closest_hit_tris, ik.closest_hit_tris_plain,
         [(*table_rays, tris)]),
        ("B1", "soup4096", ik.closest_hit_tris, ik.closest_hit_tris_plain,
         [soup]),
        ("B2", "VCM iteration", ik.occluded_tris, ik.occluded_tris_plain,
         cs.vcm_shadow_calls(dev)[1]),
        ("B2", "table shape", ik.occluded_tris, ik.occluded_tris_plain,
         [(*table_rays, occ)]),
    ]
    for kernel, label, fn, plain, calls in shapes:
        want = caller(plain, calls)()
        built = caller(fn, calls)
        for name in VARIANTS:
            if kernel == "B2" and name in B1_ONLY:
                continue
            run = caller(fn, calls, libs[name])
            got = run()
            torch.cuda.synchronize()
            differ = sum(cs._bits_differ(g, w) for g, w in zip(got, want))
            t_built, t_var = cs.in_turns(built, run)
            print(f"[variants] {kernel} {label} ({len(calls)} launches): "
                  f"built {t_built:.4f} ms, {name} {t_var:.4f} ms "
                  f"({t_var / t_built:.3f}x); results differing from the "
                  f"plain version: {differ}")

    grid, q, qn, r, u, valid = cs.ppm_gather_inputs(dev)
    starts, lens, weights, _, _, rows = gk._tile_tables(grid, q, r, u, valid)
    r2 = torch.square(torch.as_tensor(r, dtype=torch.float32, device=dev))
    args = (starts, lens, weights, rows, r2, q, qn, grid, True)
    want = gk.gather_photons_tiled_plain(*args)
    default = gk.SLOT_GROUPS

    def with_groups(g):
        def run():
            gk.SLOT_GROUPS = g
            try:
                return gk.gather_photons_tiled_kernel(*args)
            finally:
                gk.SLOT_GROUPS = default
        return run

    for g in (2, 4, 16, 32):
        got = with_groups(g)()
        scale = float(want.abs().max())
        ok = torch.allclose(got, want, rtol=cs.GATHER_RTOL,
                            atol=cs.GATHER_ATOL_REL * scale)
        t_built, t_var = cs.in_turns(with_groups(default), with_groups(g))
        print(f"[variants] B3 PPM main shape: {default} slot groups "
              f"{t_built:.4f} ms, {g} groups {t_var:.4f} ms; within "
              f"tolerance of the plain version: {ok}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
