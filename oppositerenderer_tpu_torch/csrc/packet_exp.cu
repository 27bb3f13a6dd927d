// Packet node-step microbenchmark kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   scripts/packet_kernel_exp.py  kernel (in main(); slab_all; its
//   pl.pallas_call)  (B6), the default "scalar" variant
// a synthetic version of B5's packet step (oppositerenderer_tpu/accel/
// pallas_bvh.py): a tile of 1024 rays walks a chain of nodes of a
// [rows, 128] float32 table; each step reads the node's row, slab-tests
// every ray against its 8 children (bounds at columns 6c .. 6c+5), keeps
// best = min(best, tn + 1) on a hit and steers the chain by the parity of
// the tile's hit count. The plain PyTorch version with the same contract
// is plain_packet_steps in
// oppositerenderer_tpu_torch/accel/packet_exp_kernels.py; the wrapper
// there calls packet_steps through ctypes for CUDA tensors.
//
// Exactness. A single flipped hit changes the node chain, so the kernel
// equals the plain version bit for bit: the same float32 operations in
// the same order (built with --fmad=false, so no multiply-add is
// contracted), 1 / x as an IEEE division, and the child loop in order.
// fminf/fmaxf differ from torch.minimum/maximum and jnp.minimum/maximum
// only when an operand is NaN, and none arises: |inv| <= 1e12 and the
// bounds and origins are finite, so every t is a finite product.
//
// What bounds it. Per ray and step: 8 slab tests of 24 FP32 operations;
// the bytes (48 floats a step, the rays once, best once) are ~70x less
// than the operations at the card's rates, so the bound is the FP32 rate.
// The design is the simple one the contract allows, and far from that
// bound: the steps are a serial chain, each ending in one block-wide
// count per child; one block per tile, so 64 tiles fill 64 of 132 SMs;
// the table (25 MB at the defaults) is read one row a step, from L2.
//
// Design. One 1024-thread block per tile, one ray per thread: o, 1/d and
// best stay in registers. Each step the first 48 threads stage the row's
// 48 floats in shared memory; after a barrier every thread runs the 8 slab
// tests in child order, and __syncthreads_count(hit) after each child
// gives every thread the tile's count, so every thread computes the same
// next node. The last count's barrier also orders the next step's row
// writes after this step's reads.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 1024;     // rays a tile: [8, 128]
constexpr int kWidth = 128;     // floats a table row
constexpr int kChildren = 8;
constexpr int kBounds = 6 * kChildren;

__global__ void __launch_bounds__(kRays)
packet_steps_kernel(const float* __restrict__ table, int rows,
                    const float* __restrict__ o, const float* __restrict__ d,
                    int steps, float* __restrict__ best_out) {
  __shared__ float row[kBounds];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const float* og = o + static_cast<size_t>(g) * 3 * kRays;
  const float* dg = d + static_cast<size_t>(g) * 3 * kRays;
  const float ox = og[t], oy = og[kRays + t], oz = og[2 * kRays + t];
  float dx = dg[t], dy = dg[kRays + t], dz = dg[2 * kRays + t];
  // where(|d| < 1e-12, 1e-12, d): a tiny negative component becomes +1e-12
  dx = fabsf(dx) < 1e-12f ? 1e-12f : dx;
  dy = fabsf(dy) < 1e-12f ? 1e-12f : dy;
  dz = fabsf(dz) < 1e-12f ? 1e-12f : dz;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best = 1e30f;
  int node = static_cast<int>((static_cast<long long>(g) * 40503) % rows);
  for (int k = 0; k < steps; ++k) {
    if (t < kBounds) row[t] = table[static_cast<size_t>(node) * kWidth + t];
    __syncthreads();
    int nxt = 0;
#pragma unroll
    for (int c = 0; c < kChildren; ++c) {
      const float* b = row + 6 * c;
      const float t0x = (b[0] - ox) * ix;
      const float t0y = (b[1] - oy) * iy;
      const float t0z = (b[2] - oz) * iz;
      const float t1x = (b[3] - ox) * ix;
      const float t1y = (b[4] - oy) * iy;
      const float t1z = (b[5] - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z));
      const bool hit = (tn <= tf) && (tn < best);
      if (hit) best = fminf(best, tn + 1.0f);
      nxt += __syncthreads_count(hit);
    }
    node = (node * 5 + 1 + nxt % 2) % rows;
  }
  best_out[static_cast<size_t>(g) * kRays + t] = best;
}

}  // namespace

extern "C" {

// table: f32 [rows, 128]; o, d: f32 [tiles, 3, 8, 128]; best: f32
// [tiles, 8, 128]. Launches on `stream` and returns cudaGetLastError().
int packet_steps(const float* table, int rows, const float* o,
                 const float* d, int tiles, int steps, float* best,
                 cudaStream_t stream) {
  packet_steps_kernel<<<tiles, kRays, 0, stream>>>(table, rows, o, d, steps,
                                                   best);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
