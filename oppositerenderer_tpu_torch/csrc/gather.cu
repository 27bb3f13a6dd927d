// Tile-shared photon gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _gather_kernel of
// oppositerenderer_tpu/accel/pallas_gather.py (kernel B3), the indirect
// radiance estimate of progressive photon mapping. The plain PyTorch
// version with the same contract is gather_photons_tiled_plain in
// oppositerenderer_tpu_torch/accel/gather_kernels.py; the wrapper there
// computes the per-tile slot tables (_tile_tables) and calls this entry
// point through ctypes for CUDA tensors.
//
// Contract. Queries come in tiles of 256 (a 16x16 pixel block each).
// Tile t owns 64 slots; slot s is the photon window
// [starts[t,s], starts[t,s] + lens[t,s]) of the cell-sorted photon arrays
// (lens <= 256) with weight weights[t,s]. For every query q of the tile
// and photon p of its slots:
//   d2 = dx*dx + dy*dy + dz*dz   (per axis: q - p of nearby floats is
//                                 exact, the expanded q2 + p2 - 2 q.p
//                                 cancels catastrophically at scene scale)
//   keep if d2 <= r2 and, with check_normal, n_q . dir_p <= 0
//   out[q] += alpha * (1 - (1 - exp(-beta d2 / (2 r2))) / (1 - e^-beta))
//             * weights[t,s] * power_p
//
// Design. One CTA of 256 threads per tile, one query per thread, held in
// registers with its three sums. The TPU grid's sequential slot loop
// becomes a loop inside the CTA: for each slot with len > 0 (the test is
// uniform across the CTA, the tables sit in shared memory) the CTA stages
// the slot's photons into shared memory, one photon per thread (position,
// direction and power as float4: 12 KB), and after __syncthreads every
// thread walks them; all threads read the same photon at a time, a shared
// memory broadcast. No atomics: a query's sum is owned by one thread.
//
// Cost. At the main shape (CornellSmall 512^2, 1<<20 photons per
// iteration: 1,024 tiles, up to 64 x 256 photons each) a tile tests up to
// 4.2M query-photon pairs at ~20 FP32 operations, ~10 more and an expf
// where the pair is kept: bound by the FP32 pipes and the shared-memory
// reads of the inner loop, not by device memory (each photon window is
// read once per tile, <= 768 KB a tile). 1,024 CTAs of 256 threads are
// about one wave on 132 SMs.
//
// Numerics. Built with --fmad=false like the intersection kernels; each
// pair's weight is computed in the plain version's operation order, but
// the sum runs photon by photon where the plain version reduces by a
// matrix product, so the two agree to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;    // queries per tile (= threads per CTA)
constexpr int kRows = 64;     // slots per tile
constexpr int kChunk = 256;   // photons per slot at most
// Jensen gaussian (IndirectRadianceEstimation.cu:60-67), the constants of
// oppositerenderer_tpu_torch/photon_map.py in float32
constexpr float kAlpha = 1.818f;
constexpr float kBeta = 1.953f;
constexpr float kDenom = static_cast<float>(1.0 - 0.141847);

static_assert(kChunk <= kTile, "one photon per thread when staging");

__global__ void __launch_bounds__(kTile)
gather_tiled_kernel(const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ lens,
                    const float* __restrict__ weights,
                    const float* __restrict__ r2_ptr,
                    const float* __restrict__ qpos,
                    const float* __restrict__ qnormal,
                    const float* __restrict__ ppos,
                    const float* __restrict__ ppow,
                    const float* __restrict__ pdir, int check_normal,
                    float* __restrict__ out) {
  __shared__ float4 s_pos[kChunk];   // x, y, z, unused
  __shared__ float4 s_dir[kChunk];
  __shared__ float4 s_pow[kChunk];
  __shared__ int s_start[kRows];
  __shared__ int s_len[kRows];
  __shared__ float s_w[kRows];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kRows) {
    s_start[tid] = starts[tile * kRows + tid];
    s_len[tid] = lens[tile * kRows + tid];
    s_w[tid] = weights[tile * kRows + tid];
  }
  const int q = tile * kTile + tid;
  const float qx = qpos[3 * q + 0], qy = qpos[3 * q + 1],
              qz = qpos[3 * q + 2];
  const float nx = qnormal[3 * q + 0], ny = qnormal[3 * q + 1],
              nz = qnormal[3 * q + 2];
  const float r2 = *r2_ptr;
  const float two_r2 = 2.0f * r2;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  __syncthreads();

  for (int s = 0; s < kRows; ++s) {
    const int len = s_len[s];
    if (len <= 0) continue;   // uniform across the CTA
    const int start = s_start[s];
    const float ws = s_w[s];
    __syncthreads();          // the previous slot is consumed
    if (tid < len) {
      const int64_t j = 3 * (static_cast<int64_t>(start) + tid);
      s_pos[tid] = make_float4(ppos[j], ppos[j + 1], ppos[j + 2], 0.0f);
      s_dir[tid] = make_float4(pdir[j], pdir[j + 1], pdir[j + 2], 0.0f);
      s_pow[tid] = make_float4(ppow[j], ppow[j + 1], ppow[j + 2], 0.0f);
    }
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      const float4 p = s_pos[k];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      bool ok = d2 <= r2;
      if (check_normal) {
        const float4 pd = s_dir[k];
        ok = ok && (nx * pd.x + ny * pd.y + nz * pd.z <= 0.0f);
      }
      if (ok) {
        const float e = expf(-kBeta * d2 / two_r2);
        const float c = kAlpha * (1.0f - (1.0f - e) / kDenom) * ws;
        const float4 pw = s_pow[k];
        ax += c * pw.x;
        ay += c * pw.y;
        az += c * pw.z;
      }
    }
  }
  out[3 * q + 0] = ax;
  out[3 * q + 1] = ay;
  out[3 * q + 2] = az;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(), so a refused launch
// is reported at the call. qpos, qnormal and out hold n_tiles * 256 rows.
int gather_photons_tiled(const int32_t* starts, const int32_t* lens,
                         const float* weights, const float* r2,
                         const float* qpos, const float* qnormal,
                         const float* ppos, const float* ppow,
                         const float* pdir, int n_tiles, int check_normal,
                         float* out, cudaStream_t stream) {
  gather_tiled_kernel<<<n_tiles, kTile, 0, stream>>>(
      starts, lens, weights, r2, qpos, qnormal, ppos, ppow, pdir,
      check_normal, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
