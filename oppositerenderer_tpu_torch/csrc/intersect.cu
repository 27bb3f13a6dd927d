// Dense ray-triangle intersection kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// oppositerenderer_tpu/accel/pallas_intersect_t.py:
//   closest_hit_tris_kernel  <- _closest_kernel_t  (closest hit, B1)
//   occluded_tris_kernel     <- _occluded_kernel_t (any hit, B2)
// Plain PyTorch versions with the same contract live in
// oppositerenderer_tpu_torch/accel/intersect_kernels.py; the wrappers there
// call these entry points through ctypes for CUDA tensors.
//
// B1. One thread per ray; each block of 256 rays stages the triangle table
// ([9, T] rows v0, e1, e2) through shared memory in chunks of 256
// triangles (9 KB), so any T up to the dense path's 4096 works. Triangles
// are tested in increasing index order and a hit replaces the best only on
// a strictly smaller t: the lowest index among equal t wins, which is the
// TPU kernel's tie rule and torch.argmin's. u, v of the best hit stay in
// registers, so no second pass recomputes them. Rays with tmax <= tmin are
// misses that skip the loop; a block whose rays are all dead skips the
// staging too.
//
// B2 takes the scene's occluder table: only the triangles whose occluder
// flag is set, each as three float4 (v0, e1, e2, each padded), built once
// per scene (accel/intersect.dense_tables). An any-hit answer is a
// boolean, so testing only the occluders gives the answer of testing every
// triangle with its flag. What bounded its first version (the
// [9, T] table and a flag byte per triangle, one thread per lane): VCM
// launched it once per connection, 109 times an iteration at L = 10, with
// most lanes dead (not connectable, or no light vertex), and a dead lane
// idled in a warp whose live lanes walked the table. Now VCM gathers a
// camera bounce's shadow rays into one launch (integrators/vcm.py), and
// * each block compacts the live lanes (tmax > tmin) of up to 8 groups of
//   256 lanes into one list in shared memory, with ballots and a prefix
//   over its warps, as bvh.cu does for one group: its threads then walk
//   the list in full warps of live rays, and a block without a live lane
//   writes its zeros and leaves. The entry point takes as many groups as
//   keep 4 blocks per SM: a camera bounce's batch (2.6 M lanes at 512^2,
//   1-24% live) gets 8, one group left most blocks with a few live rays
//   each, staging the table for a warp or two;
// * the table is staged through shared memory as float4, 512 occluders
//   (24 KB) at a time, one pass for every scene of the dense route below
//   512 occluders;
// * a ray leaves at its first occluding hit, a warp once all its rays
//   have, and the block after a chunk in which every ray is blocked.
// What bounds it now: a light bounce's 262,144-lane launch is latency-
// bound (~0.014-0.023 ms); a camera bounce's batch, the live rays' tests,
// of which the IEEE division is about a tenth (__frcp_rn gives the same
// bits as 1.0f / det on every float and is no faster; PERF.md).
//
// Numerics. The Moller-Trumbore terms follow _mt_terms
// (pallas_intersect_t.py:39-52) operation by operation, with an IEEE
// round-to-nearest 1 / det, and the library is built with --fmad=false, so
// t, u, v, the winner and the any-hit flag equal the plain version's bit
// for bit on the card.
//
// Cost. At the Cornell scenes' T <= 32 and 262,144 rays per launch (one
// 512x512 wavefront) a launch is a few hundred MFLOP over ~8 MB of ray
// data: latency- and occupancy-bound, far from the bandwidth or FP32
// limits. At T = 4096 it becomes bound by the FP32 ALUs (~35 flops per
// ray-triangle test).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;      // rays per block
constexpr int kTriChunk = 256;   // B1: triangles staged per pass
constexpr int kOccChunk = 512;   // B2: occluders staged per pass (24 KB)
constexpr int kOccGroups = 8;    // B2: groups of kBlock lanes a block takes
constexpr int kWarps = kBlock / 32;
constexpr int kScan = (kOccGroups * kWarps + 31) / 32;   // counts a lane scans
constexpr float kBig = 1e30f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* tmin, const float* tmax,
                                        int i) {
  Ray r;
  r.ox = o[3 * i + 0]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.tmin = tmin[i]; r.tmax = tmax[i];
  return r;
}

// Stage triangles [base, base + cnt) of the [9, n_tris] table.
__device__ __forceinline__ void stage(float (*s_tri)[kTriChunk],
                                      const float* tri9, int n_tris,
                                      int base, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
#pragma unroll
    for (int r = 0; r < 9; ++r) s_tri[r][k] = tri9[r * n_tris + base + k];
  }
}

// Moller-Trumbore for one (ray, triangle) pair, in _mt_terms' order.
__device__ __forceinline__ bool mt_terms(const Ray& r, float v0x, float v0y,
                                         float v0z, float e1x, float e1y,
                                         float e1z, float e2x, float e2y,
                                         float e2z, float* t_out,
                                         float* u_out, float* v_out) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t_out = t; *u_out = u; *v_out = v;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > r.tmin && t < r.tmax;
}

// B1's triangle k of the staged [9, kTriChunk] chunk.
__device__ __forceinline__ bool mt_hit(const Ray& r,
                                       const float (*s_tri)[kTriChunk],
                                       int k, float* t_out, float* u_out,
                                       float* v_out) {
  return mt_terms(r, s_tri[0][k], s_tri[1][k], s_tri[2][k], s_tri[3][k],
                  s_tri[4][k], s_tri[5][k], s_tri[6][k], s_tri[7][k],
                  s_tri[8][k], t_out, u_out, v_out);
}

__global__ void __launch_bounds__(kBlock)
closest_hit_tris_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tmin,
                        const float* __restrict__ tmax,
                        const float* __restrict__ tri9, int n_rays,
                        int n_tris, float* __restrict__ t_out,
                        int32_t* __restrict__ idx_out,
                        float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  __shared__ float s_tri[9][kTriChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  bool live = false;
  if (i < n_rays) {
    r = load_ray(o, d, tmin, tmax, i);
    live = r.tmax > r.tmin;
  }
  float t_best = kBig, u_best = 0.0f, v_best = 0.0f;
  int i_best = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tris; base += kTriChunk) {
      const int cnt = min(kTriChunk, n_tris - base);
      __syncthreads();  // previous chunk fully consumed
      stage(s_tri, tri9, n_tris, base, cnt);
      __syncthreads();
      if (live) {
        for (int k = 0; k < cnt; ++k) {
          float t, u, v;
          if (mt_hit(r, s_tri, k, &t, &u, &v) && t < t_best) {
            t_best = t; u_best = u; v_best = v; i_best = base + k;
          }
        }
      }
    }
  }
  if (i < n_rays) {
    t_out[i] = t_best;
    idx_out[i] = i_best;
    u_out[i] = u_best;
    v_out[i] = v_best;
  }
}

// B2: occluder k of the staged chunk, three float4 (v0, e1, e2, padded).
__device__ __forceinline__ bool occluder_hit(const Ray& r,
                                             const float4* s_occ, int k) {
  const float4 v0 = s_occ[3 * k], e1 = s_occ[3 * k + 1],
               e2 = s_occ[3 * k + 2];
  float t, u, v;
  return mt_terms(r, v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x, e2.y,
                  e2.z, &t, &u, &v);
}

__global__ void __launch_bounds__(kBlock)
occluded_tris_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax,
                     const float4* __restrict__ occ, int n_rays, int n_occ,
                     int groups, uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_occ[3 * kOccChunk];
  __shared__ int s_list[kOccGroups * kBlock];     // live lanes, in order
  __shared__ uint8_t s_blocked[kOccGroups * kBlock];
  __shared__ int s_count[kOccGroups * kWarps];    // per (group, warp)
  __shared__ int s_before[32 * kScan];            // exclusive prefix
  __shared__ int s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * groups * kBlock;
  // ---- the block's live lanes (tmax > tmin), in lane order, to s_list;
  // dead lanes answer false here
  unsigned live_bits = 0;
  int rank[kOccGroups];
#pragma unroll
  for (int g = 0; g < kOccGroups; ++g) {
    rank[g] = 0;
    if (g < groups) {         // uniform across the block
      const int i = first + g * kBlock + threadIdx.x;
      const bool live = i < n_rays && tmax[i] > tmin[i];
      if (i < n_rays && !live) occ_out[i] = 0;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (lane == 0) s_count[g * kWarps + warp] = __popc(m);
      rank[g] = __popc(m & ((1u << lane) - 1u));
      live_bits |= (live ? 1u : 0u) << g;
    }
  }
  __syncthreads();
  if (warp == 0) {            // scan the groups * kWarps counts
    int c[kScan], sum = 0;
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int j = lane * kScan + k;
      c[k] = j < groups * kWarps ? s_count[j] : 0;
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      s_before[lane * kScan + k] = run;
      run += c[k];
    }
    if (lane == 31) s_total = incl;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kOccGroups; ++g) {
    if ((live_bits >> g) & 1u)
      s_list[s_before[g * kWarps + warp] + rank[g]] =
          first + g * kBlock + threadIdx.x;
  }
  const int count = s_total;
  if (count == 0) return;     // uniform across the block
  __syncthreads();
  // ---- thread t walks live rays t, t + kBlock, ...: full warps of live
  // rays; each leaves at its first occluding hit
  for (int k = threadIdx.x; k < count; k += kBlock) s_blocked[k] = 0;
  for (int base = 0; base < n_occ; base += kOccChunk) {
    const int cnt = min(kOccChunk, n_occ - base);
    for (int k = threadIdx.x; k < 3 * cnt; k += kBlock)
      s_occ[k] = occ[3 * base + k];
    __syncthreads();
    bool open = false;
    for (int k = threadIdx.x; k < count; k += kBlock) {
      if (s_blocked[k]) continue;
      const Ray r = load_ray(o, d, tmin, tmax, s_list[k]);
      bool blocked = false;
      for (int j = 0; j < cnt; ++j) {
        if (occluder_hit(r, s_occ, j)) {
          blocked = true;
          break;
        }
      }
      s_blocked[k] = blocked ? 1 : 0;
      open = open || !blocked;
    }
    // leave once every live ray is blocked; the barrier also orders this
    // chunk's reads before the next chunk's staging
    if (!__syncthreads_or(open)) break;
  }
  for (int k = threadIdx.x; k < count; k += kBlock)
    occ_out[s_list[k]] = s_blocked[k];
}

inline int n_blocks(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError(),
// so a refused launch is reported at the call, not at a later sync. occ
// holds n_occ records of 12 floats, 16-byte aligned.
int closest_hit_tris(const float* o, const float* d, const float* tmin,
                     const float* tmax, const float* tri9, int n_rays,
                     int n_tris, float* t_out, int32_t* idx_out,
                     float* u_out, float* v_out, cudaStream_t stream) {
  closest_hit_tris_kernel<<<n_blocks(n_rays), kBlock, 0, stream>>>(
      o, d, tmin, tmax, tri9, n_rays, n_tris, t_out, idx_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

int occluded_tris(const float* o, const float* d, const float* tmin,
                  const float* tmax, const float* occ, int n_rays,
                  int n_occ, uint8_t* occ_out, cudaStream_t stream) {
  // lanes a block compacts: up to kOccGroups groups of kBlock, while the
  // launch keeps at least 4 blocks per SM
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int groups =
      max(1, min(kOccGroups, n_rays / (kBlock * 4 * max(sms, 1))));
  const int lanes = groups * kBlock;
  occluded_tris_kernel<<<(n_rays + lanes - 1) / lanes, kBlock, 0, stream>>>(
      o, d, tmin, tmax, reinterpret_cast<const float4*>(occ), n_rays, n_occ,
      groups, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
