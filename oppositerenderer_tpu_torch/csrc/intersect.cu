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
// Both take a table of triangle records built once per scene
// (accel/intersect.dense_tables): each triangle as three float4, v0, e1
// and e2, each padded, in index order. B1 takes every triangle; B2 only
// the occluders (the triangles that are no emitter): an any-hit answer is
// a boolean, so testing only the occluders gives the answer of testing
// every triangle with its flag.
//
// Shared by both: compact_live. A block takes up to kGroups groups of
// kBlock consecutive lanes, lists its live lanes (tmax > tmin) in lane
// order in shared memory with ballots and a prefix over its warps, and
// answers the dead lanes at once; a block without a live lane leaves
// after one barrier. Its threads then walk the list in full warps of live
// rays. What this saves: a dead lane used to idle in a warp whose live
// lanes walked the whole table. How many groups a block takes is set per
// kernel, from the launch size: as many as keep kOccMinBlocks = 4 blocks
// per SM for B2, whose camera-bounce batches (2.6 M lanes at 512^2, 1-24%
// live) need 8 groups to fill a block's warps (one group: 2.0x slower a
// VCM iteration); kTriMinBlocks = 16 for B1, whose live rays all cost T
// tests, so dense 1,048,576-lane photon bounces balance better over 4096
// one-group blocks than over 586 of seven groups (9-13% a PPM iteration).
//
// B1. What bounded its first design (one thread per lane, the [9, T]
// table staged as 9 scalar loads per triangle in chunks of 256, 9 scalar
// shared-memory reads a test, three barriers a chunk): the dead lanes
// (tmax = 0 at the end of a path; late bounces are mostly dead), and the
// instructions of the tests. Now
// * the live lanes are compacted as above, and dead lanes write
//   (1e30, -1, 0, 0) directly; live results go back through the list;
// * the records are staged with 16-byte cp.async copies, 512 triangles
//   (24 KB) a chunk: every Cornell scene is one chunk, staged once a block
//   and kept for all its rounds of kBlock live rays; above one chunk the
//   chunks are staged again for each round (kTriStages = 2 would prefetch
//   the next chunk while the current one is tested: slower, see
//   kernel_variants.py);
// * a test reads its triangle as three float4 from shared memory (one
//   broadcast each); the loop is unrolled by 2, two barriers a chunk;
// * triangles are tested in increasing index order and a hit replaces the
//   best only on a strictly smaller t: the lowest index among equal t
//   wins, which is the TPU kernel's tie rule and torch.argmin's. t, u, v
//   and the index of the best hit stay in registers.
// What bounds it now: the issue of the live rays' test instructions, ~75
// a test in the compiled loop (46 FP32 multiplies and adds, uncontracted
// under --fmad=false; MUFU.RCP, two FFMA and a range check for the IEEE
// 1 / det; 7 compares, 4 selects, three 128-bit shared loads and the
// loop), issued at ~89% of 128 a clock per SM when every lane is live
// (PERF.md). The bound counts a test's 46 operations at 67 TFLOP/s (a
// fused multiply-add as two), so B1 can come no closer than ~3.3x to it.
// Sparse launches are latency-bound.
//
// B2. Each ray leaves at its first occluding hit, a warp once all its
// rays have, and the block after a chunk in which every ray is blocked;
// the staged chunk is 512 occluders. What bounds it: a light bounce's
// 262,144-lane launch is latency-bound (~0.014-0.023 ms); a camera
// bounce's batch, the live rays' tests.
//
// Numerics. The Moller-Trumbore terms follow _mt_terms
// (pallas_intersect_t.py:39-52) operation by operation, with an IEEE
// round-to-nearest 1 / det (__frcp_rn gives the same bits and is no
// faster; __fdividef gives other bits), and the library is built with
// --fmad=false, so t, u, v, the winner and the any-hit flag equal the
// plain version's bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;      // threads a block, lanes a group
constexpr int kGroups = 8;       // groups of kBlock lanes a block takes
constexpr int kWarps = kBlock / 32;
constexpr int kScan = (kGroups * kWarps + 31) / 32;   // counts a lane scans
constexpr int kTriChunk = 512;   // B1: triangles staged per pass (24 KB)
constexpr int kTriStages = 1;    // B1: staging buffers (2: prefetch)
constexpr int kRaysPerThread = 1;  // B1: live rays a thread tests at once
constexpr int kTriMinBlocks = 16;  // B1: blocks per SM a launch keeps
constexpr int kOccMinBlocks = 4;   // B2: blocks per SM a launch keeps
constexpr int kOccChunk = 512;   // B2: occluders staged per pass (24 KB)
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

// ---- the block's live lanes ------------------------------------------------

struct LiveList {
  int lane[kGroups * kBlock];     // live lanes, in lane order
  int count[kGroups * kWarps];    // live lanes per (group, warp)
  int before[32 * kScan];         // exclusive prefix of count
  int total;
};

// Lists the live lanes (tmax > tmin) of the `groups` groups of kBlock
// lanes from `first` in L.lane, in lane order, and calls dead(i) for every
// dead lane i < n_rays. Returns the number of live lanes, the same in
// every thread; ends with a barrier, after which L.lane may be read (a
// block without a live lane returns 0 after the first barrier).
template <class Dead>
__device__ __forceinline__ int compact_live(const float* __restrict__ tmin,
                                            const float* __restrict__ tmax,
                                            int n_rays, int first,
                                            int groups, LiveList& L,
                                            Dead dead) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned live_bits = 0;
  int rank[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    rank[g] = 0;
    if (g < groups) {         // uniform across the block
      const int i = first + g * kBlock + threadIdx.x;
      const bool live = i < n_rays && tmax[i] > tmin[i];
      if (i < n_rays && !live) dead(i);
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (lane == 0) L.count[g * kWarps + warp] = __popc(m);
      rank[g] = __popc(m & ((1u << lane) - 1u));
      live_bits |= (live ? 1u : 0u) << g;
    }
  }
  if (!__syncthreads_or(live_bits != 0u)) return 0;   // no live lane
  if (warp == 0) {            // scan the groups * kWarps counts
    int c[kScan], sum = 0;
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int j = lane * kScan + k;
      c[k] = j < groups * kWarps ? L.count[j] : 0;
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
      L.before[lane * kScan + k] = run;
      run += c[k];
    }
    if (lane == 31) L.total = incl;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if ((live_bits >> g) & 1u)
      L.lane[L.before[g * kWarps + warp] + rank[g]] =
          first + g * kBlock + threadIdx.x;
  }
  __syncthreads();
  return L.total;
}

// Moller-Trumbore for one (ray, triangle) pair, in _mt_terms' order, on a
// record's v0, e1, e2 (the .w components are padding).
__device__ __forceinline__ bool mt_terms(const Ray& r, const float4& v0,
                                         const float4& e1, const float4& e2,
                                         float* t_out, float* u_out,
                                         float* v_out) {
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const bool ok_det = fabsf(det) > 1e-12f;
  const float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
  const float num_u = tx * px + ty * py + tz * pz;
  // divided on every pair and then selected: no branch skips the division
  // where |det| <= 1e-12 (9-13% faster; the same bits)
  const float rcp_det = 1.0f / det;
  const float inv_det = ok_det ? rcp_det : 0.0f;
  const float u = num_u * inv_det;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  *t_out = t; *u_out = u; *v_out = v;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > r.tmin && t < r.tmax;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---- B1 ----------------------------------------------------------------------

struct Best {
  float t, u, v;
  int idx;
};

__global__ void __launch_bounds__(kBlock)
closest_hit_tris_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tmin,
                        const float* __restrict__ tmax,
                        const float4* __restrict__ tri, int n_rays,
                        int n_tris, int groups, float* __restrict__ t_out,
                        int32_t* __restrict__ idx_out,
                        float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  constexpr int kAhead = kTriStages - 1;   // chunks staged ahead
  constexpr int kRound = kBlock * kRaysPerThread;   // live rays a round
  __shared__ __align__(16) float4 s_tri[kTriStages][3 * kTriChunk];
  __shared__ LiveList s_live;
  const int count = compact_live(
      tmin, tmax, n_rays, blockIdx.x * groups * kBlock, groups, s_live,
      [&](int i) {
        t_out[i] = kBig; idx_out[i] = -1; u_out[i] = 0.0f; v_out[i] = 0.0f;
      });
  const int n_chunks = (n_tris + kTriChunk - 1) / kTriChunk;
  // one chunk stays staged for all rounds; more are staged again each round
  const bool resident = n_chunks <= 1;
  auto stage = [&](int c) {   // chunk c into its buffer, then commit
    if (c < n_chunks) {
      const int cnt = min(kTriChunk, n_tris - c * kTriChunk);
      const float4* src = tri + 3 * c * kTriChunk;
      float4* dst = s_tri[c % kTriStages];
      for (int k = threadIdx.x; k < 3 * cnt; k += kBlock)
        cp_async16(dst + k, src + k);
    }
    cp_async_commit();
  };
  for (int r0 = 0; r0 < count; r0 += kRound) {   // uniform across the block
    Ray r[kRaysPerThread];
    Best b[kRaysPerThread];
    int at[kRaysPerThread];
#pragma unroll
    for (int j = 0; j < kRaysPerThread; ++j) {
      const int k = r0 + j * kBlock + threadIdx.x;
      at[j] = k < count ? s_live.lane[k] : -1;
      // an idle slot gets a null ray: det = 0, so it never hits
      r[j] = at[j] >= 0 ? load_ray(o, d, tmin, tmax, at[j]) : Ray{};
      b[j] = Best{kBig, 0.0f, 0.0f, -1};
    }
    const bool stage_now = !resident || r0 == 0;
    if (stage_now)
      for (int c = 0; c < kAhead; ++c) stage(c);
    for (int c = 0; c < n_chunks; ++c) {
      if (stage_now) stage(c + kAhead);
      cp_async_wait<kAhead>();   // chunk c's copies (this thread's) ...
      __syncthreads();           // ... and every thread's are done
      if (at[0] >= 0) {          // slot 0 idle: every slot idle
        const float4* s = s_tri[c % kTriStages];
        const int base = c * kTriChunk;
        const int cnt = min(kTriChunk, n_tris - base);
#pragma unroll 2
        for (int k = 0; k < cnt; ++k) {
          const float4 v0 = s[3 * k], e1 = s[3 * k + 1], e2 = s[3 * k + 2];
#pragma unroll
          for (int j = 0; j < kRaysPerThread; ++j) {
            float t, u, v;
            if (mt_terms(r[j], v0, e1, e2, &t, &u, &v) && t < b[j].t)
              b[j] = Best{t, u, v, base + k};
          }
        }
      }
      if (!resident) __syncthreads();   // chunk c read before restaging
    }
#pragma unroll
    for (int j = 0; j < kRaysPerThread; ++j) {
      if (at[j] >= 0) {
        t_out[at[j]] = b[j].t;
        idx_out[at[j]] = b[j].idx;
        u_out[at[j]] = b[j].u;
        v_out[at[j]] = b[j].v;
      }
    }
  }
}

// ---- B2 ----------------------------------------------------------------------

__global__ void __launch_bounds__(kBlock)
occluded_tris_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax,
                     const float4* __restrict__ occ, int n_rays, int n_occ,
                     int groups, uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_occ[3 * kOccChunk];
  __shared__ uint8_t s_blocked[kGroups * kBlock];
  __shared__ LiveList s_live;
  // dead lanes answer false
  const int count = compact_live(tmin, tmax, n_rays,
                                 blockIdx.x * groups * kBlock, groups,
                                 s_live, [&](int i) { occ_out[i] = 0; });
  if (count == 0) return;     // uniform across the block
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
      const Ray r = load_ray(o, d, tmin, tmax, s_live.lane[k]);
      bool blocked = false;
      for (int j = 0; j < cnt; ++j) {
        float t, u, v;
        if (mt_terms(r, s_occ[3 * j], s_occ[3 * j + 1], s_occ[3 * j + 2],
                     &t, &u, &v)) {
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
    occ_out[s_live.lane[k]] = s_blocked[k];
}

// Groups of kBlock lanes a block compacts: up to kGroups, while the launch
// keeps at least min_blocks blocks per SM.
int live_groups(int n_rays, int min_blocks) {
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return max(1, min(kGroups, n_rays / (kBlock * min_blocks * max(sms, 1))));
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError(),
// so a refused launch is reported at the call, not at a later sync. tri
// and occ hold n_tris / n_occ records of 12 floats, 16-byte aligned.
int closest_hit_tris(const float* o, const float* d, const float* tmin,
                     const float* tmax, const float* tri, int n_rays,
                     int n_tris, float* t_out, int32_t* idx_out,
                     float* u_out, float* v_out, cudaStream_t stream) {
  const int groups = live_groups(n_rays, kTriMinBlocks);
  const int lanes = groups * kBlock;
  closest_hit_tris_kernel<<<(n_rays + lanes - 1) / lanes, kBlock, 0,
                            stream>>>(
      o, d, tmin, tmax, reinterpret_cast<const float4*>(tri), n_rays,
      n_tris, groups, t_out, idx_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

int occluded_tris(const float* o, const float* d, const float* tmin,
                  const float* tmax, const float* occ, int n_rays,
                  int n_occ, uint8_t* occ_out, cudaStream_t stream) {
  const int groups = live_groups(n_rays, kOccMinBlocks);
  const int lanes = groups * kBlock;
  occluded_tris_kernel<<<(n_rays + lanes - 1) / lanes, kBlock, 0, stream>>>(
      o, d, tmin, tmax, reinterpret_cast<const float4*>(occ), n_rays, n_occ,
      groups, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
