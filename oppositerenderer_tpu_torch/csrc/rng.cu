// Threefry-2x32 for Hopper (sm_90a): one launch a tensor call of the
// port's counter-based RNG.
//
// Replaces no Pallas kernel: the JAX package draws through jax.random's
// threefry, which XLA fuses into one loop. The port's plain version
// (threefry2x32_plain, lane_uniform_plain and uniform_plain in
// oppositerenderer_tpu_torch/core/rng.py) holds the 32-bit words in int64
// tensors and runs the 20 rounds and 5 key injections as separate aten
// operations, each add and shift masked to 32 bits: about 175 elementwise
// launches a call, each reading and writing int64 arrays over every lane.
// Those took 38% of a PT iteration and a third of a PPM one (H100 80GB
// HBM3). This file computes the same words, bit for bit, in one launch.
// The wrapper is oppositerenderer_tpu_torch/accel/rng_kernels.py, which
// calls these entry points through ctypes for CUDA tensors.
//
// Design: one thread computes the blocks of one output element (a lane's
// draw, a key fold, a flat uniform), with the words as uint32_t in
// registers, the rounds unrolled with compile-time rotations by
// __funnelshift_l, and the epilogue (JAX's column order, the float
// conversion) fused. Each operand is a device pointer with a stride of 0
// (a 0-d key or datum) or 1 (per-lane words), or, where the pointer is
// null, a value passed at the launch: a step whose keys are device
// tensors reads nothing from the host and captures into a CUDA graph. No
// allocation and no synchronisation; each entry point launches on the
// given stream and returns cudaGetLastError().
//
// Bound: the larger of the bytes over 3.35 TB/s and the 32-bit integer
// operations over the card's INT32 rate: about 80 a block (20 rounds of an
// add, a funnel shift and an xor; the key schedule's adds), at 64 INT32
// lanes an SM x 132 SMs x 1.98 GHz = 16.7e12 a second (NVIDIA's Hopper
// white paper). A draw of 262,144 lanes x 3 columns (two blocks a lane)
// is bounded by the operations, about 2.5 us; its bytes (the lane ids in,
// the floats out) take 1.6 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// four rounds of the mix with rotations R0..R3
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32, 20 rounds: the block (x0, x1) under the key (k0, k1)
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// element i of an operand: p[i * stride] where p is set, else the value;
// the low 32 bits either way
__device__ __forceinline__ uint32_t word(const int64_t* __restrict__ p,
                                         int64_t value, int stride,
                                         int64_t i) {
  return static_cast<uint32_t>(p != nullptr ? p[i * stride] : value);
}

// top 24 bits -> [0, 1): exact in float32
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint2float_rn(bits >> 8) * (1.0f / 16777216.0f);
}

// out[i, c] for c < cols: lane i's blocks (lanes[i], counter + j), block j
// giving column 2j its first word and column 2j + 1 its second
__global__ void __launch_bounds__(kThreads)
draw_kernel(const int64_t* __restrict__ lanes, int64_t n,
            const int64_t* __restrict__ k0p, int64_t k0v, int k0s,
            const int64_t* __restrict__ k1p, int64_t k1v, int k1s,
            int64_t counter, int cols, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = word(k0p, k0v, k0s, i);
  const uint32_t k1 = word(k1p, k1v, k1s, i);
  const uint32_t lane = static_cast<uint32_t>(lanes[i]);
  float* row = out + i * cols;
  for (int c = 0; c < cols; c += 2) {
    const uint2 b = threefry(k0, k1, lane,
                             static_cast<uint32_t>(counter + c / 2));
    row[c] = bits_to_uniform(b.x);
    if (c + 1 < cols) row[c + 1] = bits_to_uniform(b.y);
  }
}

// out[0][i], out[1][i]: the two words of the block (x0[i], x1[i]) under
// the key (k0[i], k1[i]), as int64 in [0, 2^32)
__global__ void __launch_bounds__(kThreads)
words_kernel(const int64_t* __restrict__ k0p, int64_t k0v, int k0s,
             const int64_t* __restrict__ k1p, int64_t k1v, int k1s,
             const int64_t* __restrict__ x0p, int64_t x0v, int x0s,
             const int64_t* __restrict__ x1p, int64_t x1v, int x1s,
             int64_t n, int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint2 b = threefry(word(k0p, k0v, k0s, i), word(k1p, k1v, k1s, i),
                           word(x0p, x0v, x0s, i), word(x1p, x1v, x1s, i));
  out[i] = b.x;
  out[n + i] = b.y;
}

// jax.random.uniform's flat form: element i takes the block
// (i >> 32, i mod 2^32); the top 23 bits of its two words' xor are the
// mantissa of a float in [1, 2), less one
__global__ void __launch_bounds__(kThreads)
uniform_kernel(const int64_t* __restrict__ k0p, int64_t k0v,
               const int64_t* __restrict__ k1p, int64_t k1v, int64_t n,
               float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint2 b = threefry(word(k0p, k0v, 0, 0), word(k1p, k1v, 0, 0),
                           static_cast<uint32_t>(i >> 32),
                           static_cast<uint32_t>(i));
  out[i] = __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.0f;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

bool bad_stride(int s) { return s != 0 && s != 1; }

}  // namespace

extern "C" {

// out [n, cols] float32: the draw of n lanes (lane ids int64) from the
// column counter `counter`; each key word a pointer (stride 0 or 1) or,
// where null, a value. n >= 1, cols >= 1.
int threefry_draw(const int64_t* lanes, int64_t n, const int64_t* k0,
                  int64_t k0_value, int k0_stride, const int64_t* k1,
                  int64_t k1_value, int k1_stride, int64_t counter, int cols,
                  float* out, cudaStream_t stream) {
  if (n < 1 || cols < 1 || bad_stride(k0_stride) || bad_stride(k1_stride))
    return cudaErrorInvalidValue;
  draw_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      lanes, n, k0, k0_value, k0_stride, k1, k1_value, k1_stride, counter,
      cols, out);
  return static_cast<int>(cudaGetLastError());
}

// out [2, n] int64: the two output words of n blocks; each of the key
// words and the counter words a pointer (stride 0 or 1) or a value. n >= 1.
int threefry_words(const int64_t* k0, int64_t k0_value, int k0_stride,
                   const int64_t* k1, int64_t k1_value, int k1_stride,
                   const int64_t* x0, int64_t x0_value, int x0_stride,
                   const int64_t* x1, int64_t x1_value, int x1_stride,
                   int64_t n, int64_t* out, cudaStream_t stream) {
  if (n < 1 || bad_stride(k0_stride) || bad_stride(k1_stride) ||
      bad_stride(x0_stride) || bad_stride(x1_stride))
    return cudaErrorInvalidValue;
  words_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      k0, k0_value, k0_stride, k1, k1_value, k1_stride, x0, x0_value,
      x0_stride, x1, x1_value, x1_stride, n, out);
  return static_cast<int>(cudaGetLastError());
}

// out [n] float32: jax.random.uniform(key, (n,)) under one key, each word
// a pointer to one value or, where null, a value. n >= 1.
int threefry_uniform(const int64_t* k0, int64_t k0_value, const int64_t* k1,
                     int64_t k1_value, int64_t n, float* out,
                     cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  uniform_kernel<<<blocks_for(n), kThreads, 0, stream>>>(k0, k0_value, k1,
                                                         k1_value, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
