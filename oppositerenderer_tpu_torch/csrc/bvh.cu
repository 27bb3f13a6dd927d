// Wide-BVH traversal kernel for Hopper (sm_90a), closest hit and any hit.
//
// Replaces the Pallas TPU kernel
//   oppositerenderer_tpu/accel/pallas_bvh.py  _packet_kernel  (B5)
// and the JAX package's XLA wavefront loop
//   oppositerenderer_tpu/accel/bvh.py         _run_until (f32 loop)
// with one kernel for every ray population. The plain PyTorch version with
// the same contract is plain_traversal in
// oppositerenderer_tpu_torch/accel/bvh_kernels.py; the wrappers there call
// these entry points through ctypes for CUDA tensors.
//
// Design. The TPU kernel walked the tree with one shared stack per
// 1024-ray tile because the TPU has no per-lane gather: a tile paid for
// the union of its rays' nodes (2.5x the per-ray visits for camera tiles,
// ~100x for random bounce rays). A GPU thread owns its own stack, and the
// L1/L2 caches absorb divergent row reads, so here one thread walks one
// ray, blocks of 128. Each step reads one 512-byte row of the unified
// table with 16-byte __ldg loads: an inner row's 57 used floats as 15
// float4, a leaf's triangles four at a time as 9 float4 (36 floats). Codes
// and the valid mask are int32 bit patterns read with __float_as_int. The
// stack of (node << 8) | remaining-child-mask entries holds one entry per
// wide-tree level (the wrapper checks depth + 1 <= kMaxStack); it lives in
// local memory, which the L1 caches. No shared memory.
//
// Visit order. The JAX wavefront's float32 loop, step by step: a dry
// cursor pops (node, mask); a leaf runs Moller-Trumbore over its
// triangles in index order in the operation order of _mt_terms, and a hit
// counts only if tmin < t < t_best (the lowest index wins a tie; any hit
// takes occluder flags > 0.5 and stops at the first); an inner node
// slab-tests the children in mask & valid against the current t_best,
// goes to the nearest (argmin over the children, non-hit ones keyed BIG,
// the lowest index among equal keys) and pushes (node, rest) when two or
// more children are hit. min/max propagate NaN as torch's and XLA's do.
// Built with --fmad=false, the results equal the plain version's bit for
// bit.
//
// What bounds it. A ray on Atrium reads ~16 rows one after another (14-15
// inner, 1.3-2.4 leaf rows; chip_smoke.py counts them), each a trip of
// hundreds of cycles to L2 when it misses L1, against ~140 flops per
// inner row (about 6 of its 8 children slab-tested) and ~46 per triangle:
// the kernel is latency-bound on those chains, far from both the FP32 and
// the HBM limits (for Atrium's 262,144 primary rays 0.29-0.33 ms against
// a 0.010 ms bound on an H100 80GB HBM3 at 700 W; the table, 16-22 MB,
// fits the 50 MB L2). The design answers
// with occupancy: no shared memory, a small register file per thread and
// blocks of 128, so each SM keeps many rays' reads in flight. Divergence
// between the 32 rays of a warp (different depths, leaf vs inner steps)
// costs idle lanes; the first kernel accepts it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kArity = 8;
constexpr int kFullMask = (1 << kArity) - 1;
constexpr int kWidth = 128;      // floats per row
constexpr int kMaxStack = 32;    // bvh_kernels.KERNEL_MAX_STACK
constexpr int kBlock = 128;
constexpr float kBig = 1e30f;

// NaN-propagating min/max (torch.minimum/maximum, jnp.minimum/maximum)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
bvh_kernel(const float* __restrict__ rows, int n_rows, int root_code,
           int leaf_size, const float* __restrict__ o,
           const float* __restrict__ d, const float* __restrict__ tmin_in,
           const float* __restrict__ tmax_in, int n_rays,
           float* __restrict__ t_out, int32_t* __restrict__ prim_out,
           float* __restrict__ u_out, float* __restrict__ v_out,
           uint8_t* __restrict__ found_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tmin = tmin_in[i], tmax = tmax_in[i];
  const int L = leaf_size;

  float t_best = nmin(tmax, kBig);
  float u_best = 0.0f, v_best = 0.0f;
  int i_best = -1;
  bool found = false;

  if (tmax > tmin) {
    const float ix = 1.0f / (fabsf(dx) < 1e-12f ? 1e-12f : dx);
    const float iy = 1.0f / (fabsf(dy) < 1e-12f ? 1e-12f : dy);
    const float iz = 1.0f / (fabsf(dz) < 1e-12f ? 1e-12f : dz);
    int stack[kMaxStack];
    int sp = 0;
    int cur = root_code;
    int cmask = kFullMask;
    bool cur_ok = true;
    while (true) {
      if (!cur_ok) {
        if (sp == 0) break;
        const int top = stack[--sp];
        cur = top >> kArity;
        cmask = top & kFullMask;
      }
      if (cur < 0) {
        // ---- leaf: Moller-Trumbore over its triangles, index order ----
        const int dec = -cur - 1;
        const int count = dec & 31;
        const float* row = rows + (size_t)min(dec >> 5, n_rows - 1) * kWidth;
        const float4* row4 = reinterpret_cast<const float4*>(row);
        const int first = static_cast<int>(__ldg(row + 10 * L));
        for (int g = 0; g * 4 < count; ++g) {
          float tri[36];
#pragma unroll
          for (int q = 0; q < 9; ++q) {
            const float4 f = __ldg(row4 + 9 * g + q);
            tri[4 * q + 0] = f.x; tri[4 * q + 1] = f.y;
            tri[4 * q + 2] = f.z; tri[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int k = 4 * g + s;
            if (k >= count) break;
            if (kAnyHit && !(__ldg(row + 9 * L + k) > 0.5f)) continue;
            const float* tk = tri + 9 * s;
            const float v0x = tk[0], v0y = tk[1], v0z = tk[2];
            const float e1x = tk[3], e1y = tk[4], e1z = tk[5];
            const float e2x = tk[6], e2y = tk[7], e2z = tk[8];
            const float px = dy * e2z - dz * e2y;
            const float py = dz * e2x - dx * e2z;
            const float pz = dx * e2y - dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const bool ok_det = fabsf(det) > 1e-12f;
            const float inv_det = ok_det ? 1.0f / det : 0.0f;
            const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
            const float u = (tx * px + ty * py + tz * pz) * inv_det;
            const float qx = ty * e1z - tz * e1y;
            const float qy = tz * e1x - tx * e1z;
            const float qz = tx * e1y - ty * e1x;
            const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
            const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
            if (ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                t > tmin && t < t_best) {
              found = true;
              if (kAnyHit) break;
              t_best = t; u_best = u; v_best = v; i_best = first + k;
            }
          }
          if (kAnyHit && found) break;
        }
        if (kAnyHit && found) break;
        cur_ok = false;
      } else {
        // ---- inner: slab-test the children in cmask & valid -----------
        const float4* row4 = reinterpret_cast<const float4*>(
            rows + (size_t)min(cur, n_rows - 1) * kWidth);
        float b[60];
#pragma unroll
        for (int q = 0; q < 15; ++q) {
          const float4 f = __ldg(row4 + q);
          b[4 * q + 0] = f.x; b[4 * q + 1] = f.y;
          b[4 * q + 2] = f.z; b[4 * q + 3] = f.w;
        }
        const int live = cmask & __float_as_int(b[7 * kArity]);
        int hits = 0;
        int j = 0;
        float key_j = kBig;
#pragma unroll
        for (int c = 0; c < kArity; ++c) {
          const float* bc = b + 6 * c;
          const float t0x = (bc[0] - ox) * ix;
          const float t0y = (bc[1] - oy) * iy;
          const float t0z = (bc[2] - oz) * iz;
          const float t1x = (bc[3] - ox) * ix;
          const float t1y = (bc[4] - oy) * iy;
          const float t1z = (bc[5] - oz) * iz;
          const float tn = nmax(nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
                                     nmin(t0z, t1z)), tmin);
          const float tf = nmin(nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
                                     nmax(t0z, t1z)), t_best);
          const bool hit = (tn <= tf) && ((live >> c) & 1);
          const float key = hit ? tn : kBig;
          if (hit) hits |= 1 << c;
          // argmin over the children: child 0 starts, a strictly smaller
          // key replaces, so the lowest index wins a tie
          if (c == 0 || key < key_j) {
            j = c;
            key_j = key;
          }
        }
        int go = 0;
#pragma unroll
        for (int c = 0; c < kArity; ++c)
          if (c == j) go = __float_as_int(b[6 * kArity + c]);
        if (__popc(hits) >= 2) stack[sp++] = (cur << kArity) | (hits & ~(1 << j));
        cur = go;
        cmask = kFullMask;
        cur_ok = hits != 0;
      }
    }
  }
  if (kAnyHit) {
    found_out[i] = found ? 1 : 0;
  } else {
    t_out[i] = t_best;
    prim_out[i] = i_best;
    u_out[i] = u_best;
    v_out[i] = v_best;
    found_out[i] = found ? 1 : 0;
  }
}

inline int n_blocks(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError(),
// so a refused launch is reported at the call, not at a later sync.
int bvh_closest(const float* rows, int n_rows, int root_code, int leaf_size,
                const float* o, const float* d, const float* tmin,
                const float* tmax, int n_rays, float* t_out,
                int32_t* prim_out, float* u_out, float* v_out,
                uint8_t* found_out, cudaStream_t stream) {
  bvh_kernel<false><<<n_blocks(n_rays), kBlock, 0, stream>>>(
      rows, n_rows, root_code, leaf_size, o, d, tmin, tmax, n_rays, t_out,
      prim_out, u_out, v_out, found_out);
  return static_cast<int>(cudaGetLastError());
}

int bvh_any(const float* rows, int n_rows, int root_code, int leaf_size,
            const float* o, const float* d, const float* tmin,
            const float* tmax, int n_rays, uint8_t* found_out,
            cudaStream_t stream) {
  bvh_kernel<true><<<n_blocks(n_rays), kBlock, 0, stream>>>(
      rows, n_rows, root_code, leaf_size, o, d, tmin, tmax, n_rays, nullptr,
      nullptr, nullptr, nullptr, found_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
