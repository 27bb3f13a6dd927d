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
// [starts[t,s], starts[t,s] + lens[t,s]) of the cell-sorted photon grid
// (lens <= 256) with weight weights[t,s], inside the grid row (y,z) whose
// x = 0 cell is rows[t,s]. The photons come as the grid's packed records
// [P, 12] (PhotonGrid.packed: position + x cell, direction + 0, power +
// 0). For every query q of the tile and photon p of its slots:
//   d2 = dx*dx + dy*dy + dz*dz   (per axis: q - p of nearby floats is
//                                 exact, the expanded q2 + p2 - 2 q.p
//                                 cancels catastrophically at scene scale)
//   keep if d2 <= r2 and, with check_normal, n_q . dir_p <= 0
//   out[q] += alpha * (1 - (1 - exp(-beta d2 / (2 r2))) / (1 - e^-beta))
//             * weights[t,s] * power_p
//
// What bounded the first version (one CTA of 256 threads per tile,
// one query per thread, every staged photon of the tile against every
// query, each slot staged from three arrays between two barriers): at the
// main shape (CornellSmall 512^2 PPM, 1<<20 photons: 1,024 tiles) the
// tiles tested 431 M staged pairs of which the queries' own cell boxes
// hold 71 M, every slot paid its load latency and its walk in sequence,
// and the densest tiles set the time: 1.14 ms against a 0.014 ms bound by
// bytes (H100 80GB HBM3, 700 W).
//
// Design: B4's (vm.cu) carried across. Per tile, one CTA of 256 threads per
// group of its slots, one query per thread, its position, normal and sums
// in registers; no atomics.
// * Split the heavy tiles. A tile's 64 slots go to `groups` CTAs (the
//   wrapper's SLOT_GROUPS); each writes its partial sums and a second
//   kernel adds them in group order.
// * Cull by cell. Each query's cell box comes by _tile_tables' rule
//   (floor((pos -/+ r - origin) / cell_size), clamped), on a radius
//   widened by 2^-10 so that rounding never drops a cell. A slot is one
//   (y,z) grid row sorted by x. The CTA stages of each slot only the
//   union over its warps of the x cells of the queries whose box holds
//   that row, and skips slots no query needs. Each query then walks only
//   the staged photons of its own x cells (a binary search on the x cell
//   the packed record carries), and none if its box misses the row.
//   Every pair left out lies beyond the radius on some axis and would have
//   failed d2 <= r2, so each query sums the same terms in the same order
//   as the first version did within a slot group.
// * Overlap staging with the walk. A slot's records (48 bytes a photon,
//   one per thread) go to shared memory with cp.async into one of two
//   buffers while the threads walk the previous slot from the other; a
//   thread takes the distances of four photons before it tests them.
//
// Numerics. Built with --fmad=false like the other kernels; each kept
// pair's weight is computed in the plain version's operation order, but
// the sum runs photon by photon and then over the slot groups where the
// plain version reduces by a matrix product, so the two agree to float
// rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;    // queries per tile (= threads per CTA)
constexpr int kWarps = kTile / 32;
constexpr int kRows = 64;     // slots per tile
constexpr int kChunk = 256;   // photons per slot at most
constexpr int kRecord = 3;    // float4 per packed photon record
constexpr int kUnroll = 4;    // distances a thread takes at once
// the cull box's radius: r (1 + 2^-10)
constexpr float kBoxSlack = 1.0f + 0.0009765625f;
// Jensen gaussian (IndirectRadianceEstimation.cu:60-67), the constants of
// oppositerenderer_tpu_torch/photon_map.py in float32
constexpr float kAlpha = 1.818f;
constexpr float kBeta = 1.953f;
constexpr float kDenom = static_cast<float>(1.0 - 0.141847);

static_assert(kChunk <= kTile, "one photon per thread when staging");

struct __align__(16) Record {
  float4 pos;   // position, the photon's x cell
  float4 dir;   // direction, unused
  float4 pwr;   // power, unused
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The first of buf[0, n) whose x cell is >= x (the cells ascend)
__device__ __forceinline__ int first_at_or_after(const Record* buf, int n,
                                                 float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (buf[mid].pos.w < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int cell_of(float x, float inv, int res) {
  return static_cast<int>(fminf(fmaxf(floorf(x * inv), 0.0f),
                                static_cast<float>(res - 1)));
}

__global__ void __launch_bounds__(kTile)
gather_tiled_kernel(const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ lens,
                    const float* __restrict__ weights,
                    const int32_t* __restrict__ rows,
                    const float* __restrict__ r2_ptr,
                    const float* __restrict__ qpos,
                    const float* __restrict__ qnormal,
                    const float4* __restrict__ packed,
                    const int32_t* __restrict__ offsets,
                    const float* __restrict__ origin,
                    const float* __restrict__ cell_size, int res, int per,
                    int check_normal, float* __restrict__ part) {
  __shared__ Record s_buf[2][kChunk];
  __shared__ int s_start[kRows], s_len[kRows], s_row[kRows];
  __shared__ int s_y[kRows], s_z[kRows];
  __shared__ float s_w[kRows];
  __shared__ int s_a[kWarps][kRows];       // a warp's part of a slot
  __shared__ int s_b[kWarps][kRows];
  __shared__ int s_cs[kRows], s_ce[kRows]; // the CTA's staged range
  __shared__ int s_list[kRows];            // slots to stage, in order
  __shared__ int s_n;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int slot0 = tile * kRows + blockIdx.y * per;   // this CTA's slots
  if (tid < per) {
    s_start[tid] = starts[slot0 + tid];
    s_len[tid] = lens[slot0 + tid];
    s_row[tid] = rows[slot0 + tid];
    s_w[tid] = weights[slot0 + tid];
    s_y[tid] = (s_row[tid] / res) % res;
    s_z[tid] = s_row[tid] / (res * res);
  }
  const int64_t q = static_cast<int64_t>(tile) * kTile + tid;
  const float qx = qpos[3 * q + 0], qy = qpos[3 * q + 1],
              qz = qpos[3 * q + 2];
  const float nx = qnormal[3 * q + 0], ny = qnormal[3 * q + 1],
              nz = qnormal[3 * q + 2];
  const float r2 = *r2_ptr;
  const float two_r2 = 2.0f * r2;

  // ---- per slot, the x cells the warp needs: the union over its queries
  // whose cell box holds the slot's (y,z) row ------------------------------
  const int lane = tid & 31;
  int lo[3], hi[3];
  {
    const float rc = sqrtf(r2) * kBoxSlack;
    const float inv = 1.0f / cell_size[0];
    const float p[3] = {qx - origin[0], qy - origin[1], qz - origin[2]};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = cell_of(p[ax] - rc, inv, res);
      hi[ax] = cell_of(p[ax] + rc, inv, res);
    }
  }
  __syncthreads();            // the slot tables are in shared memory
  for (int s = 0; s < per; ++s) {
    int xlo = res, xhi = -1;
    if (s_len[s] > 0) {       // uniform across the CTA
      const int y = s_y[s], z = s_z[s];
      const bool in = lo[1] <= y && y <= hi[1] && lo[2] <= z && z <= hi[2];
      xlo = __reduce_min_sync(0xffffffffu, in ? lo[0] : res);
      xhi = __reduce_max_sync(0xffffffffu, in ? hi[0] : -1);
    }
    if (lane == 0) {
      s_a[warp][s] = xlo;     // cells for now; rows of the grid below
      s_b[warp][s] = xhi;
    }
  }
  __syncthreads();

  // ---- each warp's sub-window of each slot: its cells' rows of the grid,
  // clipped to the slot's window ------------------------------------------
  for (int k = tid; k < kWarps * per; k += kTile) {
    const int w = k / per, s = k % per;
    const int xlo = s_a[w][s], xhi = s_b[w][s];
    int a = 0, b = 0;
    if (xlo <= xhi) {
      const int base = s_row[s], st = s_start[s];
      a = max(st, offsets[base + xlo]);
      b = min(st + s_len[s], offsets[base + xhi + 1]);
    }
    s_a[w][s] = a;
    s_b[w][s] = a < b ? b : a;
  }
  __syncthreads();
  if (tid < per) {
    int cs = 0x7fffffff, ce = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_a[w][tid] < s_b[w][tid]) {
        cs = min(cs, s_a[w][tid]);
        ce = max(ce, s_b[w][tid]);
      }
    }
    s_cs[tid] = cs;
    s_ce[tid] = ce;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < per; ++s)
      if (s_cs[s] < s_ce[s]) s_list[n++] = s;
    s_n = n;
  }
  __syncthreads();
  const int n_slots = s_n;

  // ---- stage slot i+1 while the warps walk slot i -------------------------
  auto stage = [&](int i, int buf) {
    const int s = s_list[i];
    const int cs = s_cs[s];
    if (tid < s_ce[s] - cs) {
      const float4* src = packed + static_cast<int64_t>(cs + tid) * kRecord;
      Record* dst = &s_buf[buf][tid];
      cp_async16(&dst->pos, src + 0);
      cp_async16(&dst->dir, src + 1);
      cp_async16(&dst->pwr, src + 2);
    }
  };
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (n_slots > 0) stage(0, 0);
  cp_async_commit();
  for (int i = 0; i < n_slots; ++i) {
    if (i + 1 < n_slots) stage(i + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();      // slot i's copies (this thread's) are done
    __syncthreads();          // ... and every thread's
    const int s = s_list[i];
    const float ws = s_w[s];
    const Record* buf = s_buf[i & 1];
    // this query's part of the staged window: the photons in its own cells
    // of the slot's row (none if its box misses the row)
    int k0 = 0, k1 = 0;
    if (lo[1] <= s_y[s] && s_y[s] <= hi[1] && lo[2] <= s_z[s] &&
        s_z[s] <= hi[2]) {
      const int cnt = s_ce[s] - s_cs[s];
      k0 = first_at_or_after(buf, cnt, static_cast<float>(lo[0]));
      k1 = first_at_or_after(buf, cnt, static_cast<float>(hi[0] + 1));
    }
    for (int k4 = k0; k4 < k1; k4 += kUnroll) {
      // the distances of kUnroll photons first: their shared loads and
      // arithmetic overlap; then the pairs within r2, in order
      float d2s[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const float4 p = buf[min(k4 + j, k1 - 1)].pos;
        const float dx = qx - p.x;
        const float dy = qy - p.y;
        const float dz = qz - p.z;
        d2s[j] = dx * dx + dy * dy + dz * dz;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = k4 + j;
        const float d2 = d2s[j];
        if (k >= k1 || !(d2 <= r2)) continue;
        if (check_normal) {
          const float4 pd = buf[k].dir;
          if (!(nx * pd.x + ny * pd.y + nz * pd.z <= 0.0f)) continue;
        }
        const float e = expf(-kBeta * d2 / two_r2);
        const float c = kAlpha * (1.0f - (1.0f - e) / kDenom) * ws;
        const float4 pw = buf[k].pwr;
        ax += c * pw.x;
        ay += c * pw.y;
        az += c * pw.z;
      }
    }
    __syncthreads();          // the buffer is free for slot i + 2
  }
  // this CTA's partial sums: group blockIdx.y of [groups, N, 3]
  const int64_t o = 3 * (static_cast<int64_t>(blockIdx.y) * gridDim.x * kTile
                         + q);
  part[o + 0] = ax;
  part[o + 1] = ay;
  part[o + 2] = az;
}

// out[i] = the groups' partial sums added in group order
__global__ void __launch_bounds__(kTile)
gather_reduce_kernel(const float* __restrict__ part, int groups, int64_t n3,
                     float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i >= n3) return;
  float a = 0.0f;
  for (int g = 0; g < groups; ++g) a += part[g * n3 + i];
  out[i] = a;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(), so a refused launch
// is reported at the call. qpos, qnormal and out hold n_tiles * 256 rows
// of 3; packed the grid's photons as 12-float records (16-byte aligned).
// Each tile's 64 slots go to `groups` CTAs (a divisor of 64); part holds
// their partial sums, groups * n_tiles * 256 * 3 floats, which a second
// kernel adds.
int gather_photons_tiled(const int32_t* starts, const int32_t* lens,
                         const float* weights, const int32_t* rows,
                         const float* r2, const float* qpos,
                         const float* qnormal, const float* packed,
                         const int32_t* offsets, const float* origin,
                         const float* cell_size, int res, int n_tiles,
                         int groups, int check_normal, float* part,
                         float* out, cudaStream_t stream) {
  if (groups < 1 || kRows % groups != 0) return cudaErrorInvalidValue;
  const int64_t n3 = 3 * static_cast<int64_t>(n_tiles) * kTile;
  gather_tiled_kernel<<<dim3(n_tiles, groups), kTile, 0, stream>>>(
      starts, lens, weights, rows, r2, qpos, qnormal,
      reinterpret_cast<const float4*>(packed), offsets, origin, cell_size,
      res, kRows / groups, check_normal, part);
  gather_reduce_kernel<<<static_cast<unsigned>((n3 + kTile - 1) / kTile),
                         kTile, 0, stream>>>(part, groups, n3, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
