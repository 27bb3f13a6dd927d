"""Design variants of the port's kernels B1, B2 and B3, timed on the card
in turns with the kernels as built, on the main paths' inputs.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 kernel_variants.py [--only {b1b2,b3,b6}]

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
* B6 (``csrc/packet_exp.cu``): the redesign's steps undone one at a time,
  by text substitutions launched through the port's own wrapper, on
  ``scalar`` at the microbenchmark's defaults (64 tiles) and at 528 tiles:
  - ``b6_one_cta``: one CTA a tile at any tile count (no cluster);
  - ``b6_cluster_sync``: a 2-CTA cluster's reduction as each warp's byte
    written into both CTAs' shared memory (``map_shared_rank``) and one
    ``cluster.sync()`` a step, in place of a block count and one
    ``st.async`` message to the other CTA;
  - ``b6_modulo``: the next node by an integer ``%`` in place of three
    conditional subtractions; ``b6_all_track``: every thread computes the
    node chain, not warp 0 alone; ``b6_plain_chain``: both;
  - ``b6_mask_popc``: each ray's 8 hits packed into a mask and its
    popcount's parity counted, in place of the count of hits;
  - ``b6_spread``: a 2-CTA cluster's CTAs reserve 116 KB of shared memory
    each, more than half an SM's, so that no two of them can share an SM;
  - ``b6_minmax_as_add``: the slab test's 10 min/max a child as additions
    and subtractions (the same count of FP32 instructions; its results
    differ): timed on ``fixedrow``, the slab tests and the count alone, it
    shows what min/max cost against additions.

Prints one line per variant and shape: its ms and the built kernel's, in
turns (built, variant, variant, built; device time, medians of 20 replays
of a CUDA graph of 10 calls, as ``chip_smoke.cuda_ms``).
"""
from __future__ import annotations

import ctypes
import sys
import argparse
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
# B6's slab test, and its tile reduction in a 2-CTA cluster as the
# redesign had it first (each warp's byte into both CTAs, cluster.sync())
_B6_SLAB = """  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
"""
_B6_REDUCE = """template <int kCluster, Reduce kOp>
__device__ __forceinline__ unsigned tile_reduce(unsigned v, uint8_t* slot,
                                                Exchange& x, int k) {
  const unsigned mine = block_reduce<kRays / kCluster, kOp>(v, slot);
  if constexpr (kCluster == 1) {
    return mine;
  } else {
    const unsigned other = x.swap(mine, k);
    return kOp == Reduce::kParity ? (mine ^ other) : max(mine, other);
  }
}

"""
_B6_CLUSTER_SYNC = """template <int kCluster, Reduce kOp>
__device__ __forceinline__ unsigned tile_reduce(unsigned v, uint8_t* slot,
                                                Exchange& x, int k) {
  if constexpr (kCluster == 1) {
    return block_reduce<kRays, kOp>(v, slot);
  } else {
    const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
    const unsigned w = kOp == Reduce::kParity
        ? static_cast<unsigned>(__popc(__ballot_sync(0xffffffffu, v))) & 1u
        : __reduce_max_sync(0xffffffffu, v);
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    if (lane == 0) {
      const unsigned i = rank * 16 + warp;
      slot[i] = static_cast<uint8_t>(w);
      *cluster.map_shared_rank(slot + i, rank ^ 1u) = static_cast<uint8_t>(w);
    }
    cluster.sync();
    const uint4 a = reinterpret_cast<const uint4*>(slot)[0];
    const uint4 b = reinterpret_cast<const uint4*>(slot)[1];
    if constexpr (kOp == Reduce::kParity) {
      return static_cast<unsigned>(
          __popc(a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w)) & 1u;
    } else {
      const unsigned m = __vmaxu4(__vmaxu4(__vmaxu4(a.x, a.y),
                                           __vmaxu4(a.z, a.w)),
                                  __vmaxu4(__vmaxu4(b.x, b.y),
                                           __vmaxu4(b.z, b.w)));
      return max(max(m & 255u, (m >> 8) & 255u),
                 max((m >> 16) & 255u, m >> 24));
    }
  }
}

"""
_B6_MODULO = ("""  const unsigned r = static_cast<unsigned>(rows);
  unsigned x = 5u * static_cast<unsigned>(node) + 1u;
  x = min(x, x - 4u * r);
  x = min(x, x - 2u * r);
  return static_cast<int>(min(x, x - r));
""", "  return (5 * node + 1) % rows;\n")
_B6_ALL_TRACK = ("const bool tracks = kVariant == kNoScalar || t < 32;",
                 "const bool tracks = true;")
B6_VARIANTS = {
    "b6_one_cta": [("return 2 * tiles <= sms ? 2 : 1;", "return 1;")],
    "b6_cluster_sync": [(_B6_REDUCE, _B6_CLUSTER_SYNC)],
    "b6_modulo": [_B6_MODULO],
    "b6_all_track": [_B6_ALL_TRACK],
    "b6_plain_chain": [_B6_MODULO, _B6_ALL_TRACK],
    "b6_mask_popc": [
        ("      acc += h0 + h1;\n",
         "      acc |= (h0 << (2 * p)) | (h1 << (2 * p + 1));\n"),
        ("kMask ? hits : (hits & 1u)", "kMask ? hits : (__popc(hits) & 1u)")],
    "b6_spread": [("  if constexpr (kCluster > 1) {\n    attr[0].id",
                   "  if constexpr (kCluster > 1) {\n"
                   "    const cudaError_t e = cudaFuncSetAttribute(kernel, "
                   "cudaFuncAttributeMaxDynamicSharedMemorySize, 116 << 10);\n"
                   "    if (e != cudaSuccess) return e;\n"
                   "    cfg.dynamicSmemBytes = 116 << 10;\n    attr[0].id")],
    "b6_minmax_as_add": [(_B6_SLAB, """  const float tn = __fadd_rn(__fadd_rn(__fadd_rn(t0x, t1x),
                                   __fadd_rn(t0y, t1y)), __fadd_rn(t0z, t1z));
  const float tf = __fsub_rn(__fsub_rn(__fsub_rn(t0x, t1x),
                                   __fsub_rn(t0y, t1y)), __fsub_rn(t0z, t1z));
""")],
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


def build_variants(only: str | None = None) -> dict:
    """Every variant's library (B1/B2's and the reciprocal check's unless
    ``only`` is "b6", B6's unless it is "b1b2"), built by the port's nvcc
    flags, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    groups = []
    if only != "b6":
        groups.append(("intersect.cu", VARIANTS))
    if only != "b1b2":
        groups.append(("packet_exp.cu", B6_VARIANTS))
    sources = {}
    for file, variants in groups:
        src = next(p for p in cuda_build.SOURCES
                   if p.name == file).read_text()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {old!r} not in "
                                       "the source")
                text = text.replace(old, new)
            sources[name] = text
    if only != "b6":
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
            if "registers" in line and name in VARIANTS:
                print(f"[variants] {name} build: {line.strip()}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if name == "rcp_check":
            lib.rcp_mismatches.argtypes = [ctypes.c_void_p] * 2
            lib.rcp_mismatches.restype = ctypes.c_int
        else:
            for entry, argtypes in cuda_build.ENTRY_POINTS.items():
                if hasattr(lib, entry):
                    getattr(lib, entry).argtypes = argtypes
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


def time_b6(dev, libs: dict) -> None:
    """B6's variants in turns with the built kernel (``scalar``;
    ``b6_minmax_as_add`` on ``fixedrow``) at 64 and 528 tiles."""
    from oppositerenderer_tpu_torch.accel import packet_exp_kernels as pk
    from oppositerenderer_tpu_torch.scripts.packet_kernel_exp import \
        make_inputs
    for tiles in (cs.B6_TILES, cs.B6_WIDE_TILES):
        table, o, d = make_inputs(cs.B6_ROWS, tiles, dev)
        for name in B6_VARIANTS:
            variant = "fixedrow" if name == "b6_minmax_as_add" else "scalar"
            want = pk.plain_packet_steps(table, o, d, cs.B6_STEPS, variant)

            def built(variant=variant):
                return pk.packet_steps(table, o, d, cs.B6_STEPS, variant)

            run = caller(built, [()], libs[name])
            differ = cs._bits_differ(run()[0], want)
            t_built, t_var = cs.in_turns(built, run)
            print(f"[variants] B6 {variant} {tiles} tiles: built "
                  f"{t_built:.4f} ms, {name} {t_var:.4f} ms "
                  f"({t_var / t_built:.3f}x); rays differing from the plain "
                  f"version: {differ}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("b1b2", "b3", "b6"),
                    help="time one kernel's variants (default: all)")
    only = ap.parse_args().only
    cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    libs = build_variants(only) if only != "b3" else {}
    if only in (None, "b1b2"):
        time_b1b2(dev, libs)
    if only in (None, "b3"):
        time_b3(dev)
    if only in (None, "b6"):
        time_b6(dev, libs)
    return 0


def time_b1b2(dev, libs: dict) -> None:
    """The reciprocal check, and B1's and B2's variants in turns with the
    built kernels on their shapes."""
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


def time_b3(dev) -> None:
    """The B3 library at other slot-group counts in turns with the built
    8, at the PPM main shape."""
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


if __name__ == "__main__":
    sys.exit(main())
