// Fixed-order row sums for Hopper (sm_90a): the backward of the per-lane
// table-row gather.
//
// Replaces no TPU kernel. The integrators read per-lane rows of the
// material and light tables (MaterialTable.row, LightTable.row, VCM's
// emitter gather): out[i] = table[idx[i]] for 262,144 lanes over a few
// rows. Where a row field requires grad, the gather's backward is
//   out[m, c] = sum over i with idx[i] = m of g[i, c]
// for idx [N] int64, g [N, C] float32 and out [M, C]. aten's accumulate
// (index_put_ with accumulate=True) sorts the indices and then sums each
// run of equal ones serially: with the lanes skewed onto a handful of rows
// each run is tens of thousands of lanes long, and a call took about 30
// ms against the 1.6 us in which the card reads its N * (8 + 4C) bytes
// (5.2 MB at N = 262,144, C = 3; H100 80GB HBM3). The plain version with
// the same contract is sum_rows_plain in
// oppositerenderer_tpu_torch/accel/row_kernels.py, whose wrapper calls this
// entry point through ctypes for CUDA tensors.
//
// Design: bounded by the bytes, so every lane is read once, by a grid that
// fills the card, and the skew costs nothing.
// * Pass 1. Block b walks its own contiguous range of lanes, each warp 32
//   lanes at a time, kUnroll groups of them loaded before any is summed.
//   In a warp the lanes that hold one row are found with
//   __match_any_sync; each such group, lowest lane first, is summed by a
//   butterfly of shuffles over the whole warp (the other lanes add
//   zeros), and the group's lowest lane adds the sum into the warp's own
//   copy of the [M, C] table in shared memory. A warp takes as many
//   rounds as it holds rows: one where the lanes share a row. The block
//   then adds its warps' copies in warp order and writes one partial
//   [M, C] table.
// * Pass 2. The partials are added in a fixed order: 8 warps each sum
//   every 8th block, and then the 8 sums are added in warp order.
// No atomics and no order that depends on the schedule: the same inputs
// give the same bits on every call, so a replay of a captured gradient
// equals its eager call. No host synchronisation and no allocation: the
// wrapper allocates the partials, and both passes capture into a graph.
//
// Limits. The warps' copies take kWarps * M * C floats of shared memory,
// at most the block's opt-in 227 KB (M * C <= 14,528); C is 1 to 4.
//
// Numerics. The sums run in another order than the plain version's, so the
// two agree to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int sum_rows_blocks(int64_t n);

namespace {

constexpr int kWarps = 4;            // warps a pass-1 block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;           // 32-lane groups a warp loads at once
constexpr int kStep = kThreads * kUnroll;  // lanes a block takes a round
constexpr int kMaxBlocks = 264;      // two for each of the H100's 132 SMs
constexpr int kReduceWarps = 8;      // pass 2: warps that split the blocks
constexpr unsigned kFull = 0xffffffffu;

// lanes a pass-1 block walks: n over kMaxBlocks, rounded up to kStep
int64_t rows_per_block(int64_t n) {
  const int64_t share = (n + kMaxBlocks - 1) / kMaxBlocks;
  return (share + kStep - 1) / kStep * kStep;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
rows_partial_kernel(const int64_t* __restrict__ idx,
                    const float* __restrict__ g, int64_t n, int m,
                    int64_t per_block, float* __restrict__ part) {
  extern __shared__ float tables[];    // [kWarps][m * C]
  const int mc = m * C;
  for (int j = threadIdx.x; j < kWarps * mc; j += kThreads) tables[j] = 0.0f;
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = tables + warp * mc;
  const int64_t begin = blockIdx.x * per_block;
  const int64_t end = begin + per_block < n ? begin + per_block : n;
  for (int64_t base = begin + warp * 32 * kUnroll; base < end;
       base += kStep) {
    int key[kUnroll];
    float v[kUnroll][C];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * 32 + lane;
      key[u] = -1;
#pragma unroll
      for (int c = 0; c < C; ++c) v[u][c] = 0.0f;
      if (i < end) {
        int64_t k = idx[i];
        if (k < 0) k += m;   // a negative index counts from the end
        // the forward's indexing has refused any other row
        key[u] = k >= 0 && k < m ? static_cast<int>(k) : -1;
#pragma unroll
        for (int c = 0; c < C; ++c) v[u][c] = g[i * C + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned group = __match_any_sync(kFull, key[u]);
      unsigned left = __ballot_sync(kFull, key[u] >= 0);
      while (left) {                     // warp-uniform: one round a row
        const int leader = __ffs(left) - 1;
        const unsigned members = __shfl_sync(kFull, group, leader);
        const bool in = (members >> lane) & 1u;
        float s[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[c] = in ? v[u][c] : 0.0f;
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            s[c] += __shfl_xor_sync(kFull, s[c], off);
        }
        if (lane == leader) {
#pragma unroll
          for (int c = 0; c < C; ++c) mine[key[u] * C + c] += s[c];
        }
        __syncwarp();   // the next round's leader may add to the same row
        left &= ~members;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < mc; j += kThreads) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += tables[w * mc + j];
    part[static_cast<int64_t>(blockIdx.x) * mc + j] = a;
  }
}

// out[j] = the blocks' partials added in a fixed order; a block takes 32
// consecutive j, warp w the blocks w, w + 8, ...
__global__ void __launch_bounds__(32 * kReduceWarps)
rows_reduce_kernel(const float* __restrict__ part, int blocks, int mc,
                   float* __restrict__ out) {
  __shared__ float sums[kReduceWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * 32 + lane;
  float a = 0.0f;
  if (j < mc)
    for (int b = warp; b < blocks; b += kReduceWarps)
      a += part[static_cast<int64_t>(b) * mc + j];
  sums[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && j < mc) {
    float t = 0.0f;
    for (int w = 0; w < kReduceWarps; ++w) t += sums[w][lane];
    out[j] = t;
  }
}

template <int C>
int launch_rows(const int64_t* idx, const float* g, int64_t n, int m,
                float* part, float* out, cudaStream_t stream) {
  const int mc = m * C;
  const size_t smem = sizeof(float) * kWarps * mc;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_partial_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t per_block = rows_per_block(n);
  const int blocks = sum_rows_blocks(n);
  rows_partial_kernel<C><<<blocks, kThreads, smem, stream>>>(
      idx, g, n, m, per_block, part);
  rows_reduce_kernel<<<(mc + 31) / 32, 32 * kReduceWarps, 0, stream>>>(
      part, blocks, mc, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The pass-1 blocks for n lanes: what the caller allocates partials for,
// blocks * m * c floats.
int sum_rows_blocks(int64_t n) {
  if (n < 1) return 0;
  const int64_t per_block = rows_per_block(n);
  return static_cast<int>((n + per_block - 1) / per_block);
}

// out [m, c] = the rows of g [n, c] summed by idx [n] (int64; negative
// indices count from the end). Launches on `stream` and returns
// cudaGetLastError(), so a refused launch is reported at the call; n >= 1,
// 1 <= c <= 4, part holds sum_rows_blocks(n) * m * c floats.
int sum_rows(const int64_t* idx, const float* g, int64_t n, int m, int c,
             float* part, float* out, cudaStream_t stream) {
  if (n < 1 || m < 1) return cudaErrorInvalidValue;
  switch (c) {
    case 1: return launch_rows<1>(idx, g, n, m, part, out, stream);
    case 2: return launch_rows<2>(idx, g, n, m, part, out, stream);
    case 3: return launch_rows<3>(idx, g, n, m, part, out, stream);
    case 4: return launch_rows<4>(idx, g, n, m, part, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
