// Packet node-step microbenchmark kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   scripts/packet_kernel_exp.py  kernel (in main(); slab_all; its
//   pl.pallas_call)  (B6), every --variant of it
// a synthetic version of B5's packet step (oppositerenderer_tpu/accel/
// pallas_bvh.py): a tile of 1024 rays walks a chain of nodes of a
// [rows, 128] float32 table; each step reads the node's row, slab-tests
// every ray against its 8 children (bounds at columns 6c .. 6c+5), keeps
// best = min(best, tn + 1) on a hit and steers the chain by the parity of
// the tile's hit count. The plain PyTorch version with the same contract
// is plain_packet_steps in
// oppositerenderer_tpu_torch/accel/packet_exp_kernels.py; the wrapper
// there calls packet_steps (scalar) and packet_steps_variant (the others)
// through ctypes for CUDA tensors.
//
// Exactness. A single flipped hit changes the node chain, so the kernel
// equals the plain version bit for bit: the same float32 operations in
// the same order (built with --fmad=false, so no multiply-add is
// contracted), 1 / x as an IEEE division, and the children in order per
// ray. fminf/fmaxf differ from torch.minimum/maximum and jnp.minimum/
// maximum only when an operand is NaN, and none arises: |inv| <= 1e12 and
// the bounds and origins are finite, so every t is a finite product. The
// step's reduction is exact too: only the parity of the tile's hit count
// steers the chain, and it is the parity of the number of rays with an
// odd count of their own.
//
// What bounds it. Per ray and step: 8 slab tests of 24 FP32 operations,
// each one instruction (26 issued a child: 6 FADD, 6 FMUL, 11 FMNMX, 2
// FSETP and the hit's FADD); the bytes (48 floats a step, the rays once,
// best once) are far less than the operations at the card's rates. So the
// bound is the FP32 instruction rate. What keeps the kernel from it is
// the serial chain (each step's row depends on the step before's count),
// which costs most when few tiles leave the SMs idle between steps.
//
// Design (the redesign of the first design, which ran one block-wide
// count per child, staged the row after the count was known, and used a
// 1024-thread block a tile, so 64 tiles filled 64 of the 132 SMs):
// - One reduction a step. Each thread counts its hits over the 8
//   children, and one __syncthreads_count(count & 1) ends the step; no
//   warp waits for another between children.
// - The next row prefetched off the chain. The next node is one of two,
//   (node * 5 + 1) % rows or the one after it; before its slab tests a
//   step starts cp.async.cg copies (16 bytes each, 24 threads of warp 0)
//   of both candidates' 48 floats into the other half of a
//   double-buffered shared slot, and waits for them only before its
//   reduction, which publishes them. After the count the chosen candidate
//   is read. The table (25 MB at the defaults) stays in the 50 MB L2.
// - The chain's integer work kept short: (5 * node + 1) % rows by three
//   conditional subtractions (next_node) in place of a division, and only
//   warp 0, which issues the copies, keeps the node; the other warps need
//   only which candidate was chosen. Each alone moves the time by at most
//   a few percent, both together by 6-10% (kernel_variants.py, b6_modulo,
//   b6_all_track, b6_plain_chain).
// - The row read as broadcasts: 12 LDS.128 a step, every thread on the
//   same words.
// - A tile split over two SMs when twice the tiles fit the SMs: a cluster
//   of 2 CTAs of 512 rays each (ray rank * 512 + thread, so ray s * 128 + l
//   of the tile stays where the first design had it). Each CTA counts its
//   half with its own block barrier; thread 0 then sends the half's parity
//   to the other CTA by one st.async into its shared memory, which
//   completes the other CTA's mbarrier for the step (Exchange), and every
//   thread waits on its own mbarrier for the other half. A step ends in
//   one block barrier and one one-way message; a cluster-wide barrier a
//   step (each warp's byte written into both CTAs through map_shared_rank,
//   then cluster.sync()) took half as long again (kernel_variants.py,
//   b6_cluster_sync). Reserving shared memory so that no two CTAs can
//   share an SM gains nothing (b6_spread). The cluster size is chosen
//   here, from the current device's SM count (packet_steps_cluster): the
//   C entry point packet_steps keeps the arguments it had before the
//   redesign.
//
// Variants (the JAX script's --variant, each differing from scalar in
// what the TPU variant changes; VARIANTS in the wrapper gives the ids):
// - vmem_smem: the row staged at its own step by plain loads (12 threads,
//   16 bytes each) and a block barrier, no prefetch: the first design's
//   staging. Result = scalar.
// - hbm_vmem: the row by one TMA bulk copy (cp.async.bulk, 192 bytes) at
//   its own step, every thread waiting on its mbarrier. Result = scalar.
// - hbm_smem: the row by cp.async.cg at its own step, waited, then a block
//   barrier. Result = scalar.
// - noscalar: no staging; every thread reads the row's 12 float4 from
//   global memory itself (read-only path). Result = scalar.
// - fixedrow: the tile's first row, (g * 40503) % rows, staged once before
//   the loop and read every step: the slab tests and the reduction alone.
//   (The TPU variant never writes its row scratch; the port defines it.)
// - dmaonly: the row's cp.async copy at its own step, a block barrier and
//   one read of its first float; nxt = row[0] > 1e30, best += 1e-9 (so
//   best stays 1e30): the load's latency alone, kept on the chain.
// - noreduce: no barrier and no count (nxt = 0, the chain node * 5 + 1):
//   each warp prefetches its own copy of the next row and waits only on
//   its own copies (cp.async.wait_all, __syncwarp).
// - onereduce: one tile-wide max of the rays' 8-bit hit masks (warp
//   redux.max, a byte a warp in shared memory, one block barrier; in a
//   2-CTA cluster the halves' maxima exchanged as scalar's parities are);
//   nxt = the max.
// vmem_smem, hbm_smem and hbm_vmem keep scalar's reduction and differ from
// each other only in the instruction that moves the row (LDG + STS,
// LDGSTS, or a TMA bulk copy waited on an mbarrier by every thread): on
// this card every row comes from L2, so the TPU's memory spaces (HBM,
// VMEM, SMEM) have no separate counterparts, and the three are one design
// with three copy instructions.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRays = 1024;     // rays a tile: [8, 128]
constexpr int kWidth = 128;     // floats a table row
constexpr int kChildren = 8;
constexpr int kBounds = 6 * kChildren;  // 48 floats a row's children use
constexpr int kChunks = kBounds / 4;    // 12 float4 (16-byte copies)
constexpr int kNodeMult = 40503;

enum Variant : int {
  kScalar = 0, kVmemSmem, kHbmVmem, kHbmSmem, kFixedRow, kDmaOnly,
  kNoReduce, kOneReduce, kNoScalar, kVariants
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: a bulk copy of `bytes` from global memory into shared
// memory, completing the mbarrier's current phase
__device__ __forceinline__ void tma_row(void* dst, const void* src,
                                        uint32_t bytes, uint64_t* bar) {
  // order earlier generic-proxy reads of dst before the async-proxy write
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// (5 * node + 1) % rows for 0 <= node < rows: 5 * node + 1 < 5 * rows, so
// three conditional subtractions (of 4, 2 and 1 rows) reach it, each as an
// unsigned min that a wrap-around leaves alone; rows <= MAX_ROWS keeps
// 4 * rows below 2^32
__device__ __forceinline__ int next_node(int node, int rows) {
  const unsigned r = static_cast<unsigned>(rows);
  unsigned x = 5u * static_cast<unsigned>(node) + 1u;
  x = min(x, x - 4u * r);
  x = min(x, x - 2u * r);
  return static_cast<int>(min(x, x - r));
}

// the node after `cand`, the step's first candidate: cand + 1 wrapped
__device__ __forceinline__ int second(int cand, int rows) {
  return cand + 1 == rows ? 0 : cand + 1;
}

struct Ray {
  float ox, oy, oz, ix, iy, iz;
};

// one child's slab test; on a hit best = min(best, tn + 1)
__device__ __forceinline__ unsigned slab(float b0, float b1, float b2,
                                         float b3, float b4, float b5,
                                         const Ray& r, float& best) {
  const float t0x = (b0 - r.ox) * r.ix;
  const float t0y = (b1 - r.oy) * r.iy;
  const float t0z = (b2 - r.oz) * r.iz;
  const float t1x = (b3 - r.ox) * r.ix;
  const float t1y = (b4 - r.oy) * r.iy;
  const float t1z = (b5 - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  const bool hit = (tn <= tf) && (tn < best);
  if (hit) best = fminf(best, tn + 1.0f);
  return hit ? 1u : 0u;
}

// the 8 slab tests of a row in child order, the row's 12 float4 from
// load(i); returns the 8-bit hit mask (bit c: child c) if kMask, else the
// number of hits
template <bool kMask, class Load>
__device__ __forceinline__ unsigned slab_row(Load load, const Ray& r,
                                             float& best) {
  unsigned acc = 0;
#pragma unroll
  for (int p = 0; p < kChildren / 2; ++p) {   // children 2p, 2p + 1
    const float4 a = load(3 * p), b = load(3 * p + 1), c = load(3 * p + 2);
    const unsigned h0 = slab(a.x, a.y, a.z, a.w, b.x, b.y, r, best);
    const unsigned h1 = slab(b.z, b.w, c.x, c.y, c.z, c.w, r, best);
    if constexpr (kMask) {
      acc |= (h0 << (2 * p)) | (h1 << (2 * p + 1));
    } else {
      acc += h0 + h1;
    }
  }
  return acc;
}

template <int kCluster>
__device__ __forceinline__ void sync_tile() {
  if constexpr (kCluster == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

enum class Reduce { kParity, kMax };

// The CTA's parity of v (v in {0, 1}) or max of v (v < 256) over its
// threads, behind one block barrier. `slot` (the max's): 32 bytes of
// shared memory, 16-byte aligned, that this call alone writes (callers
// alternate two).
template <int kThreads, Reduce kOp>
__device__ __forceinline__ unsigned block_reduce(unsigned v, uint8_t* slot) {
  if constexpr (kOp == Reduce::kParity) {
    return static_cast<unsigned>(__syncthreads_count(v)) & 1u;
  } else {
    const unsigned m = __reduce_max_sync(0xffffffffu, v);
    if ((threadIdx.x & 31u) == 0) slot[threadIdx.x >> 5] = static_cast<uint8_t>(m);
    __syncthreads();
    unsigned w = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32 / 16; ++i) {   // 16 warps a uint4
      const uint4 a = reinterpret_cast<const uint4*>(slot)[i];
      w = __vmaxu4(w, __vmaxu4(__vmaxu4(a.x, a.y), __vmaxu4(a.z, a.w)));
    }
    return max(max(w & 255u, (w >> 8) & 255u), max((w >> 16) & 255u, w >> 24));
  }
}

// A 2-CTA cluster's exchange of one value a step: each CTA's thread 0
// writes its value into the other CTA's shared memory by one st.async that
// completes the other's mbarrier of the step, and every thread waits on
// its own. Two slots alternate by step: the other CTA writes a slot again
// two steps later, which it reaches only after this CTA's message of the
// step between, sent after this CTA's reads of the slot.
struct Exchange {
  uint32_t value[2];
  uint64_t bar[2];

  __device__ __forceinline__ void init() {   // thread 0, then a cluster sync
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }

  __device__ __forceinline__ unsigned swap(unsigned mine, int k) {
    const int s = k & 1;
    if (threadIdx.x == 0) {
      uint32_t rank, value_at, bar_at;
      asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 4;\n"
                   :: "r"(smem_addr(&bar[s])) : "memory");
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(value_at) : "r"(smem_addr(&value[s])), "r"(rank ^ 1u));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(bar_at) : "r"(smem_addr(&bar[s])), "r"(rank ^ 1u));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
          "[%0], %1, [%2];\n"
          :: "r"(value_at), "r"(mine), "r"(bar_at) : "memory");
    }
    mbar_wait(&bar[s], static_cast<uint32_t>((k >> 1) & 1));
    return value[s];
  }
};

// the tile's parity or max of v: the block's, then, in a 2-CTA cluster,
// combined with the other CTA's through `x`
template <int kCluster, Reduce kOp>
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

// best [tiles, 8, 128]: kCluster CTAs a tile, 1024 / kCluster rays each
template <int kVariant, int kCluster>
__global__ void __launch_bounds__(kRays / kCluster, kCluster == 1 ? 2 : 1)
packet_kernel(const float* __restrict__ table, int rows,
              const float* __restrict__ o, const float* __restrict__ d,
              int steps, float* __restrict__ best_out) {
  constexpr int kThreads = kRays / kCluster;
  constexpr int kWarps = kThreads / 32;
  // [buffer][candidate][48]: the double-buffered rows
  __shared__ __align__(16) float row_buf[2][2][kBounds];
  __shared__ __align__(16) uint8_t slots[2][32];    // onereduce's bytes
  __shared__ __align__(8) uint64_t bar;             // hbm_vmem's mbarrier
  __shared__ __align__(8) Exchange xchg;            // a 2-CTA cluster's
  // noreduce: each warp's own double-buffered row
  __shared__ __align__(16) float warp_rows[kVariant == kNoReduce ? kWarps : 1]
                                          [2][kBounds];

  const int t = threadIdx.x;
  const int rank = kCluster == 1 ? 0 : static_cast<int>(blockIdx.x % kCluster);
  const int g = blockIdx.x / kCluster;
  const int ray = rank * kThreads + t;
  const float* og = o + static_cast<size_t>(g) * 3 * kRays;
  const float* dg = d + static_cast<size_t>(g) * 3 * kRays;
  float dx = dg[ray], dy = dg[kRays + ray], dz = dg[2 * kRays + ray];
  // where(|d| < 1e-12, 1e-12, d): a tiny negative component becomes +1e-12
  dx = fabsf(dx) < 1e-12f ? 1e-12f : dx;
  dy = fabsf(dy) < 1e-12f ? 1e-12f : dy;
  dz = fabsf(dz) < 1e-12f ? 1e-12f : dz;
  const Ray r{og[ray], og[kRays + ray], og[2 * kRays + ray],
              1.0f / dx, 1.0f / dy, 1.0f / dz};

  float best = 1e30f;
  int node = static_cast<int>((static_cast<long long>(g) * kNodeMult) % rows);
  auto row_of = [&](int n) {
    return table + static_cast<size_t>(n) * kWidth;
  };

  if constexpr (kVariant == kNoReduce) {
    float (*wr)[kBounds] = warp_rows[t >> 5];
    const int lane = t & 31;
    if (lane < kChunks) cp_async16(&wr[0][4 * lane], row_of(node) + 4 * lane);
    cp_async_commit();
    for (int k = 0; k < steps; ++k) {
      cp_async_wait_all();
      __syncwarp();   // the warp's copies of this row, and its last reads
      const int next = next_node(node, rows);
      if (lane < kChunks && k + 1 < steps)
        cp_async16(&wr[(k + 1) & 1][4 * lane], row_of(next) + 4 * lane);
      cp_async_commit();
      const float4* row = reinterpret_cast<const float4*>(wr[k & 1]);
      slab_row<false>([&](int i) { return row[i]; }, r, best);
      node = next;
    }
  } else if constexpr (kVariant == kDmaOnly) {
    for (int k = 0; k < steps; ++k) {
      float* row = row_buf[k & 1][0];
      if (t < kChunks) cp_async16(row + 4 * t, row_of(node) + 4 * t);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();   // also: the reads of this buffer two steps back
      const int nxt = row[0] > 1e30f ? 1 : 0;
      best = best + 1e-9f;
      node = nxt ? second(next_node(node, rows), rows)
                 : next_node(node, rows);
    }
  } else {
    constexpr Reduce kOp =
        kVariant == kOneReduce ? Reduce::kMax : Reduce::kParity;
    constexpr bool kPrefetch =
        kVariant == kScalar || kVariant == kOneReduce;
    // the rows staged before the loop: the first (scalar, onereduce) or
    // the only one (fixedrow)
    if constexpr (kPrefetch || kVariant == kFixedRow) {
      if (t < kChunks) cp_async16(&row_buf[0][0][4 * t], row_of(node) + 4 * t);
      cp_async_commit();
      cp_async_wait_all();
    }
    if (t == 0) {
      if constexpr (kVariant == kHbmVmem) mbar_init(&bar);
      if constexpr (kCluster > 1) xchg.init();
    }
    // the barriers set up, and every CTA of the cluster started
    sync_tile<kCluster>();
    // the threads that read the node: noscalar's all, warp 0 otherwise (the
    // copies); the others need only the chosen candidate, sel
    const bool tracks = kVariant == kNoScalar || t < 32;
    int cand = tracks ? next_node(node, rows) : 0;   // the next node or, +1
    int sel = 0;
    for (int k = 0; k < steps; ++k) {
      const int cur = k & 1;
      const float4* row;
      if constexpr (kPrefetch) {
        // both candidates of the next node, into the other buffer, whose
        // reads ended before the last step's barrier
        if (t < 2 * kChunks && k + 1 < steps) {
          const int c = t / kChunks, i = t - c * kChunks;
          cp_async16(&row_buf[cur ^ 1][c][4 * i],
                     row_of(c ? second(cand, rows) : cand) + 4 * i);
        }
        cp_async_commit();
        row = reinterpret_cast<const float4*>(row_buf[cur][sel]);
      } else if constexpr (kVariant == kFixedRow) {
        row = reinterpret_cast<const float4*>(row_buf[0][0]);
      } else if constexpr (kVariant == kVmemSmem) {
        if (t < kChunks)
          reinterpret_cast<float4*>(row_buf[0][0])[t] =
              reinterpret_cast<const float4*>(row_of(node))[t];
        __syncthreads();
        row = reinterpret_cast<const float4*>(row_buf[0][0]);
      } else if constexpr (kVariant == kHbmSmem) {
        if (t < kChunks) cp_async16(&row_buf[0][0][4 * t], row_of(node) + 4 * t);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        row = reinterpret_cast<const float4*>(row_buf[0][0]);
      } else if constexpr (kVariant == kHbmVmem) {
        if (t == 0) tma_row(row_buf[0][0], row_of(node), kBounds * 4, &bar);
        mbar_wait(&bar, static_cast<uint32_t>(k & 1));
        row = reinterpret_cast<const float4*>(row_buf[0][0]);
      } else {   // kNoScalar
        row = reinterpret_cast<const float4*>(row_of(node));
      }
      constexpr bool kMask = kOp == Reduce::kMax;
      unsigned hits;   // the mask (onereduce) or the count of hits
      if constexpr (kVariant == kNoScalar) {
        hits = slab_row<kMask>([&](int i) { return __ldg(row + i); }, r, best);
      } else {
        hits = slab_row<kMask>([&](int i) { return row[i]; }, r, best);
      }
      if constexpr (kPrefetch) cp_async_wait_all();
      // the barrier publishes the prefetched rows and ends this step's
      // reads of the staged row before the next step writes it
      const unsigned nxt = tile_reduce<kCluster, kOp>(
          kMask ? hits : (hits & 1u), slots[cur], xchg, k);
      const int p = static_cast<int>(nxt & 1u);
      if (tracks) {
        node = p ? second(cand, rows) : cand;
        cand = next_node(node, rows);
      }
      sel = p;
    }
    // no CTA leaves while the other may still write into its memory
    if constexpr (kCluster > 1) cg::this_cluster().sync();
  }
  best_out[static_cast<size_t>(g) * kRays + ray] = best;
}

// the cluster size a launch of `tiles` tiles takes on the current device
// (2 when 2 * tiles <= its SMs), or -cudaError
int cluster_for(int tiles) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return 2 * tiles <= sms ? 2 : 1;
}

template <int kVariant, int kCluster>
cudaError_t launch_cluster(const float* table, int rows, const float* o,
                           const float* d, int tiles, int steps, float* best,
                           cudaStream_t stream) {
  auto kernel = packet_kernel<kVariant, kCluster>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles) * kCluster);
  cfg.blockDim = dim3(kRays / kCluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (kCluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, table, rows, o, d,
                                       steps, best);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kVariant>
int launch_variant(const float* table, int rows, const float* o,
                   const float* d, int tiles, int steps, float* best,
                   cudaStream_t stream) {
  const int cluster = cluster_for(tiles);
  if (cluster < 0) return -cluster;
  const cudaError_t err =
      cluster == 2
          ? launch_cluster<kVariant, 2>(table, rows, o, d, tiles, steps,
                                        best, stream)
          : launch_cluster<kVariant, 1>(table, rows, o, d, tiles, steps,
                                        best, stream);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// table: f32 [rows, 128], 16-byte aligned; o, d: f32 [tiles, 3, 8, 128];
// best: f32 [tiles, 8, 128]. The scalar variant. Launches on `stream` and
// returns the cudaError of the launch.
int packet_steps(const float* table, int rows, const float* o,
                 const float* d, int tiles, int steps, float* best,
                 cudaStream_t stream) {
  return launch_variant<kScalar>(table, rows, o, d, tiles, steps, best,
                                 stream);
}

// packet_steps for variant 0 .. 8 (the wrapper's VARIANTS order);
// cudaErrorInvalidValue for another.
int packet_steps_variant(const float* table, int rows, const float* o,
                         const float* d, int tiles, int steps, float* best,
                         int variant, cudaStream_t stream) {
  switch (variant) {
#define PACKET_CASE(V) \
    case V: return launch_variant<V>(table, rows, o, d, tiles, steps, best, \
                                     stream);
    PACKET_CASE(kScalar)
    PACKET_CASE(kVmemSmem)
    PACKET_CASE(kHbmVmem)
    PACKET_CASE(kHbmSmem)
    PACKET_CASE(kFixedRow)
    PACKET_CASE(kDmaOnly)
    PACKET_CASE(kNoReduce)
    PACKET_CASE(kOneReduce)
    PACKET_CASE(kNoScalar)
#undef PACKET_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The CTAs a tile takes (1 or 2) in a launch of `tiles` tiles on the
// current device, or -cudaError.
int packet_steps_cluster(int tiles) { return cluster_for(tiles); }

}  // extern "C"
