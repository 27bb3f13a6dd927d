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
// bit: every ray runs the same float32 operations in the same order,
// whichever thread walks it.
//
// What bounded the first version (PR 4's: one thread per lane, blocks of
// 128): a ray reads ~16 rows one after another (14-15 inner, 1.3-2.4 leaf
// rows on Atrium), each 15 float4 loads and ~8 slab tests, and
// * every lane got a thread: only 53,705 of the 262,144 lanes of Atrium's
//   first shadow rays are live, and a warp with one live ray costs as much
//   as a full one;
// * each NaN-propagating min/max of the slab tests took a compare, a NaN
//   test and a select: 12 of them a child, ~100 an inner visit;
// * every ray read the top of the tree from L1/L2.
// 0.33 ms (closest) and 0.22 ms (any hit) against 0.010 / 0.0033 ms
// bounds on Atrium 512^2 (H100 80GB HBM3, 700 W).
//
// Design.
// * Live lanes compacted in each block: a block owns 128 consecutive
//   lanes; a ballot and a prefix sum over its warps list the live ones
//   (tmax > tmin) in lane order in shared memory, and thread t walks the
//   t-th live ray, so the live rays fill the first warps and the warps
//   past the count exit at once. The dead lanes get the contract's
//   outputs (t = min(tmax, BIG), prim -1, u = v = 0, found false) there.
//   No second kernel and no host sync.
// * The slab tests' min/max as min.NaN / max.NaN instructions: NaN when
//   either operand is, as torch.minimum/maximum, in one instruction.
//   (They differ from the select only in the sign of a zero result and in
//   the payload of a NaN, neither of which a comparison downstream sees.)
// * The top of the tree in shared memory: rows 0..8 (the root, row 0, and
//   the rows the collapse numbers next, its inner children) as 16 float4
//   of which 15 are used, 2.3 KB per block.
// Tried on the card and left out (PERF.md, PR 5): a global compaction
// over all lanes (warp-aggregated atomics, or count, scan and scatter
// kernels), whose extra launches cost more than they saved on Atrium;
// persistent warps fetching 32 rays at a time from one global counter
// (Aila & Laine, HPG 2009), which lost to the counter's contention on
// sparse calls; and a per-lane refill from the block's list, slower on
// coherent primary rays.
// Each step reads one 512-byte row of the unified table with 16-byte
// loads: an inner row's 57 used floats as 15 float4, a leaf's triangles
// four at a time as 9 float4 (36 floats). Codes and the valid mask are
// int32 bit patterns read with __float_as_int. The stack of
// (node << 8) | remaining-child-mask entries holds one entry per wide-tree
// level (the wrapper checks depth + 1 <= kMaxStack) in local memory.
// What bounds it now: each ray's chain of dependent row reads, and on
// sparse calls the longest rays of the call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kArity = 8;
constexpr int kFullMask = (1 << kArity) - 1;
constexpr int kWidth = 128;      // floats per row
constexpr int kMaxStack = 32;    // bvh_kernels.KERNEL_MAX_STACK
constexpr int kBlock = 128;      // lanes (and threads) per block
constexpr int kTop = 9;          // rows held in shared memory
constexpr int kInner4 = 15;      // float4 of an inner row that are used
constexpr float kBig = 1e30f;

// NaN-propagating min (torch.minimum, jnp.minimum), bit for bit
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// The same for the slab tests in one instruction each
__device__ __forceinline__ float smin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float smax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The live lanes of this block's kBlock lanes, in lane order, into
// s_list; returns their count (to every thread). Writes the dead lanes'
// outputs where the pointers are not null.
__device__ __forceinline__ int compact_block(
    const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
    int* s_list, int* s_warp, float* __restrict__ t_out,
    int32_t* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, uint8_t* __restrict__ found_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in = i < n;
  const float mx = in ? tmax[i] : 0.0f;
  const bool is_live = in && mx > tmin[i];
  if (in && !is_live) {
    if (found_out) found_out[i] = 0;
    if (t_out) {
      t_out[i] = nmin(mx, kBig);
      prim_out[i] = -1;
      u_out[i] = 0.0f;
      v_out[i] = 0.0f;
    }
  }
  const unsigned m = __ballot_sync(0xffffffffu, is_live);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    count += s_warp[w];
  }
  if (is_live) s_list[before + __popc(m & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return count;
}

// One live ray, start to end: the visit order of the plain version.
template <bool kAnyHit>
__device__ __forceinline__ void trace(
    const float* __restrict__ rows, int n_rows, int n_top,
    float4 (*s_top)[16], int root_code, int L,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    int i, float* __restrict__ t_out, int32_t* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    uint8_t* __restrict__ found_out) {
  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tmin = tmin_in[i], tmax = tmax_in[i];

  float t_best = nmin(tmax, kBig);
  float u_best = 0.0f, v_best = 0.0f;
  int i_best = -1;
  bool found = false;

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
      // ---- leaf: Moller-Trumbore over its triangles, index order ------
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
      // ---- inner: slab-test the children in cmask & valid -------------
      const int r = min(cur, n_rows - 1);
      float b[4 * kInner4];
      if (r < n_top) {
#pragma unroll
        for (int q = 0; q < kInner4; ++q) {
          const float4 f = s_top[r][q];
          b[4 * q + 0] = f.x; b[4 * q + 1] = f.y;
          b[4 * q + 2] = f.z; b[4 * q + 3] = f.w;
        }
      } else {
        const float4* row4 = reinterpret_cast<const float4*>(
            rows + (size_t)r * kWidth);
#pragma unroll
        for (int q = 0; q < kInner4; ++q) {
          const float4 f = __ldg(row4 + q);
          b[4 * q + 0] = f.x; b[4 * q + 1] = f.y;
          b[4 * q + 2] = f.z; b[4 * q + 3] = f.w;
        }
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
        const float tn = smax(smax(smax(smin(t0x, t1x), smin(t0y, t1y)),
                                   smin(t0z, t1z)), tmin);
        const float tf = smin(smin(smin(smax(t0x, t1x), smax(t0y, t1y)),
                                   smax(t0z, t1z)), t_best);
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
bvh_kernel(const float* __restrict__ rows, int n_rows, int root_code,
           int leaf_size, const float* __restrict__ o,
           const float* __restrict__ d, const float* __restrict__ tmin_in,
           const float* __restrict__ tmax_in, int n,
           float* __restrict__ t_out, int32_t* __restrict__ prim_out,
           float* __restrict__ u_out, float* __restrict__ v_out,
           uint8_t* __restrict__ found_out) {
  __shared__ float4 s_top[kTop][16];
  __shared__ int s_list[kBlock];
  __shared__ int s_warp[kBlock / 32];
  const int n_top = min(kTop, n_rows);
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  for (int k = threadIdx.x; k < n_top * kInner4; k += kBlock) {
    const int r = k / kInner4, q = k % kInner4;
    s_top[r][q] = __ldg(rows4 + r * (kWidth / 4) + q);
  }
  // (compact_block's barriers also publish s_top)
  const int count = compact_block(tmin_in, tmax_in, n, s_list, s_warp,
                                  t_out, prim_out, u_out, v_out, found_out);
  if (threadIdx.x < count)
    trace<kAnyHit>(rows, n_rows, n_top, s_top, root_code, leaf_size, o, d,
                   tmin_in, tmax_in, s_list[threadIdx.x], t_out, prim_out,
                   u_out, v_out, found_out);
}

// The compaction alone: block b's live lanes at live[b * kBlock ...], its
// count at counts[b].
__global__ void __launch_bounds__(kBlock)
bvh_compact_kernel(const float* __restrict__ tmin,
                   const float* __restrict__ tmax, int n,
                   int32_t* __restrict__ live, int32_t* __restrict__ counts) {
  __shared__ int s_list[kBlock];
  __shared__ int s_warp[kBlock / 32];
  const int count = compact_block(tmin, tmax, n, s_list, s_warp, nullptr,
                                  nullptr, nullptr, nullptr, nullptr);
  if (threadIdx.x < count)
    live[blockIdx.x * kBlock + threadIdx.x] = s_list[threadIdx.x];
  if (threadIdx.x == 0) counts[blockIdx.x] = count;
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

// live: int32 [n_blocks * 128]; counts: int32 [n_blocks], n_blocks =
// ceil(n_rays / 128).
int bvh_compact_live(const float* tmin, const float* tmax, int n_rays,
                     int32_t* live, int32_t* counts, cudaStream_t stream) {
  bvh_compact_kernel<<<n_blocks(n_rays), kBlock, 0, stream>>>(
      tmin, tmax, n_rays, live, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
