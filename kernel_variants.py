"""Design variants of the port's kernels B2 and B3, timed on the card in
turns with the kernels as built, on the main paths' inputs.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 kernel_variants.py

* B2 (``csrc/intersect.cu``): each variant is the source with one text
  substitution, built with the port's nvcc flags into
  ``_chip_tree/variants/``: ``rcp_rn`` takes 1/det as ``__frcp_rn(det)``,
  ``fast_div`` as ``__fdividef(1.0f, det)`` (not IEEE: it times the
  division path and counts the booleans it changes), ``block128`` gives a
  block 128 lanes, ``one_group`` compacts one group of 256 lanes per
  block whatever the launch size. Each runs every shadow-ray call of one
  CornellSmall
  512^2 VCM iteration (summed) and the 262,144 random rays of
  ``chip_smoke.py``'s table shape. Then one kernel compares
  ``__frcp_rn(x)`` with ``1.0f / x`` on all 2^32 float32 bit patterns.
* B3 (``csrc/gather.cu``): the same library launched with 2, 4, 16 and
  32 slot groups per tile, against the built 8, at the PPM main shape.

Prints one line per variant: its ms and the built kernel's, in turns
(built, variant, variant, built; device time, medians of 20 replays of a
CUDA graph of 10 calls, as ``chip_smoke.cuda_ms``).
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
B2_VARIANTS = {
    "rcp_rn": ("1.0f / det", "__frcp_rn(det)"),
    "fast_div": ("1.0f / det", "__fdividef(1.0f, det)"),
    "block128": ("constexpr int kBlock = 256;", "constexpr int kBlock = 128;"),
    "one_group": ("constexpr int kOccGroups = 8;",
                  "constexpr int kOccGroups = 1;"),
}
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
    """Every B2 variant's library and the reciprocal check's, built by the
    port's nvcc flags, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = cuda_build.SOURCES[0].read_text()
    sources = {}
    for name, (old, new) in B2_VARIANTS.items():
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        sources[name] = src.replace(old, new)
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
            lib.occluded_tris.argtypes = cuda_build.ENTRY_POINTS[
                "occluded_tris"]
            lib.occluded_tris.restype = ctypes.c_int
        libs[name] = lib
    return libs


def b2_caller(lib, calls):
    """A function launching ``lib``'s B2 on every call, and its outputs."""
    outs = [torch.empty(c[0].shape[0], dtype=torch.bool, device=c[0].device)
            for c in calls]

    def run():
        for (o, d, tmin, tmax, occ), res in zip(calls, outs):
            rc = lib.occluded_tris(
                o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                occ.data_ptr(), o.shape[0], occ.shape[0], res.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"variant launch failed: cudaError {rc}")
        return outs
    return run


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

    _, vcm_calls = cs.vcm_shadow_calls(dev)
    scene, _ = get_scene_by_name(cs.MAIN_SCENE, dev)
    table = [(*cs._rays(cs.MAIN_SIZE ** 2, 100, scene.aabb_min.tolist(),
                        scene.aabb_max.tolist(), dev), dense_tables(scene)[1])]
    for label, calls in (("VCM iteration", vcm_calls),
                         ("table shape", table)):
        built = b2_caller(cuda_build.library(), calls)
        want = [ik.occluded_tris_plain(*c) for c in calls]
        for name in B2_VARIANTS:
            run = b2_caller(libs[name], calls)
            got = run()
            torch.cuda.synchronize()
            differ = sum(int((g != w).sum()) for g, w in zip(got, want))
            t_built, t_var = cs.in_turns(built, run)
            print(f"[variants] B2 {label} ({len(calls)} launches): built "
                  f"{t_built:.4f} ms, {name} {t_var:.4f} ms; booleans "
                  f"differing from the plain version: {differ}")

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
