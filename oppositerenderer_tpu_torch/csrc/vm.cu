// Tile-shared VCM vertex merge for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _vm_kernel of
// oppositerenderer_tpu/accel/pallas_vm.py (kernel B4), one vertex-merging
// round of VCM at one camera bounce. The plain PyTorch version with the
// same contract is merge_vertices_tiled_plain in
// oppositerenderer_tpu_torch/accel/vm_kernels.py; the wrapper there
// cell-sorts the camera vertices, builds the per-query table
// (_query_table) and the per-tile slot tables (gather_kernels._tile_tables
// over the vertex grid), calls this entry point through ctypes for CUDA
// tensors, and combines the two sums as kd/pi * out1 + rho * out2.
//
// Contract. Queries come in tiles of 256 consecutive (cell-sorted) rows
// of qtab [N, 32]: cols 0-2 position, 9-11 shading normal, 12-14 the
// geometric normal turned toward the incident side, 15-17 the world Phong
// mirror direction, 18 the Lambert reverse pdf term, 19/20 the Lambert and
// Phong pick weights, 21 the Phong exponent, 22 a_cam = dVCM * mis_vc_w,
// 23 b_cam = dVM * cont, 24 the valid flag. Tile t owns 64 slots; slot s
// is the light-vertex window [starts[t,s], starts[t,s] + lens[t,s]) of the
// cell-sorted vertex grid (lens <= 256) with weight weights[t,s], inside
// the grid row (y,z) whose x = 0 cell is rows[t,s]. The vertices come as
// the grid's packed records [M, 16] (VertexGrid.packed: position + dVCM,
// wo + dVM, throughput + cont, depth + 3 zeros). scal holds r2, mis_vc_w,
// depth1 (the camera vertex's path length) and the maximum path length.
// For every valid query q and vertex v of its tile's slots, with dz = q - v
// summed per axis and the dots taken with v's wo:
//   keep if d2 <= r2, ng.wo > 0, n.wo >= 1e-6, depth_v + depth1 <= max_len
//   kw    = alpha * (1 - (1 - exp(-beta d2 / (2 r2))) / (1 - e^-beta))
//   powe  = exp(e * log(max(refl.wo, 1e-3)))        (Phong lobe, not powf)
//   pdf_p = refl.wo > 1e-3 ? (e + 1) / (2 pi) * powe : 0
//   dpdf  = (wl * max(n.wo, 0) / pi + wp * pdf_p) * cont_v
//   rpdf  = wl * col18 + wp * pdf_p
//   misw  = 1 / (dVCM_v * mis_vc_w + dVM_v * dpdf + 1 + a_cam + b_cam rpdf)
//   base  = misw * kw * weights[t,s]
//   out1[q] += base * thr_v;  out2[q] += (refl.wo > 1e-3 ? base * powe : 0)
//                                         * thr_v
// in the operation order of the Pallas body (pallas_vm.py:106-146) and of
// the plain version.
//
// What bounded the first version (PR 3's: one CTA of 256 threads per tile,
// one query per thread, every staged vertex of the tile against every
// query, each slot staged from seven arrays between two barriers): at the
// main shape (CornellSmall 512^2, L = 10, second bounce: 262,144 queries in
// 1,024 tiles, 2,359,296 vertex rows) the tiles tested 326,467,840 pairs
// of which the queries' own cell boxes hold 10,810,840, and every slot paid
// its load latency and its walk in sequence: 1.07 ms against a 0.020 ms
// bound by bytes (H100 80GB HBM3, 700 W).
//
// Design. Per tile, one CTA of 256 threads per group of its slots, one
// query per thread, its table row and its two float3 sums in registers;
// no atomics.
// * Split the heavy tiles. A tile's 64 slots go to `groups` CTAs (the
//   wrapper's SLOT_GROUPS); each writes its partial sums and a second
//   kernel adds them in group order. One CTA per tile left the heaviest
//   tiles, whose queries sit in the densest cells, to set the time alone.
// * Cull by cell. Each query's cell box comes by _tile_tables' rule
//   (floor((pos -/+ r - origin) / cell_size), clamped), on a radius
//   widened by 2^-10 so that rounding never drops a cell. A slot is one
//   (y,z) grid row sorted by x. The CTA stages of each slot only the
//   union over its warps of the x cells of the queries whose box holds
//   that row, and skips slots no query needs. Each query then walks only
//   the staged vertices of its own x cells (a binary search on the x cell
//   the packed record carries), and none if its box misses the row.
//   Every pair left out lies beyond the radius on some axis and would have
//   failed d2 <= r2, so each query sums the same terms in the same order.
// * Overlap staging with the walk. A slot's records (64 bytes a vertex,
//   one per thread) go to shared memory with cp.async into one of two
//   buffers while the threads walk the previous slot from the other; a
//   thread takes the distances of four vertices before it tests them.
// What bounds it now: the walk of the threads whose cells are densest,
// in a tile group's slots, and the staging and two barriers of each
// slot.
//
// Numerics. Built with --fmad=false like the other kernels, so each kept
// pair's terms round as the plain version's do; the sums run vertex by
// vertex where the plain version reduces by a matrix product, so the two
// agree to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;    // queries per tile (= threads per CTA)
constexpr int kWarps = kTile / 32;
constexpr int kRows = 64;     // slots per tile
constexpr int kChunk = 256;   // vertices per slot at most
constexpr int kQCols = 32;    // query table columns
constexpr int kRecord = 4;    // float4 per packed vertex record
constexpr int kUnroll = 4;    // distances a thread takes at once
// the cull box's radius: r (1 + 2^-10)
constexpr float kBoxSlack = 1.0f + 0.0009765625f;
// Jensen gaussian (IndirectRadianceEstimation.cu:60-67), the constants of
// oppositerenderer_tpu_torch/photon_map.py in float32
constexpr float kAlpha = 1.818f;
constexpr float kBeta = 1.953f;
constexpr float kDenom = static_cast<float>(1.0 - 0.141847);
constexpr float kInvPi = static_cast<float>(0.3183098861837907);
constexpr float kHalfInvPi = static_cast<float>(0.5 * 0.3183098861837907);
constexpr float kEpsCosine = 1e-6f;   // bsdf.py EPS_COSINE
constexpr float kEpsPhong = 1e-3f;    // bsdf.py EPS_PHONG

static_assert(kChunk <= kTile, "one vertex per thread when staging");

struct __align__(16) Record {
  float4 pos;   // position, dVCM
  float4 wo;    // wo, dVM
  float4 thr;   // throughput, cont
  float4 dep;   // depth, the vertex's x cell, unused
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
    if (buf[mid].dep.y < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int cell_of(float x, float inv, int res) {
  return static_cast<int>(fminf(fmaxf(floorf(x * inv), 0.0f),
                                static_cast<float>(res - 1)));
}

__global__ void __launch_bounds__(kTile)
vm_tiled_kernel(const int32_t* __restrict__ starts,
                const int32_t* __restrict__ lens,
                const float* __restrict__ weights,
                const int32_t* __restrict__ rows,
                const float* __restrict__ scal,
                const float* __restrict__ qtab,
                const float4* __restrict__ packed,
                const int32_t* __restrict__ offsets,
                const float* __restrict__ origin,
                const float* __restrict__ cell_size, int res, int per,
                float* __restrict__ out1, float* __restrict__ out2) {
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
  const float* row = qtab + q * kQCols;
  const float qx = row[0], qy = row[1], qz = row[2];
  const float nx = row[9], ny = row[10], nz = row[11];
  const float gx = row[12], gy = row[13], gz = row[14];
  const float rx = row[15], ry = row[16], rz = row[17];
  const float lam_rev = row[18];
  const float wl = row[19], wp = row[20], e = row[21];
  const float a_cam = row[22], b_cam = row[23];
  const bool valid = row[24] > 0.5f;
  const float r2 = scal[0], mis_vc_w = scal[1], depth1 = scal[2],
              max_len = scal[3];
  const float two_r2 = 2.0f * r2;

  // ---- per slot, the x cells the warp needs: the union over its valid
  // queries whose cell box holds the slot's (y,z) row -------------------
  const int lane = tid & 31;
  int lo[3], hi[3];
  {
    const float rc = sqrtf(r2) * kBoxSlack;
    const float inv = 1.0f / cell_size[0];
    const float p[3] = {qx - origin[0], qy - origin[1], qz - origin[2]};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = valid ? cell_of(p[ax] - rc, inv, res) : res;
      hi[ax] = valid ? cell_of(p[ax] + rc, inv, res) : -1;
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
      cp_async16(&dst->wo, src + 1);
      cp_async16(&dst->thr, src + 2);
      cp_async16(&dst->dep, src + 3);
    }
  };
  float a1x = 0.0f, a1y = 0.0f, a1z = 0.0f;
  float a2x = 0.0f, a2y = 0.0f, a2z = 0.0f;
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
    // this query's part of the staged window: the vertices in its own
    // cells of the slot's row (none if its box misses the row)
    int k0 = 0, k1 = 0;
    if (valid && lo[1] <= s_y[s] && s_y[s] <= hi[1] && lo[2] <= s_z[s] &&
        s_z[s] <= hi[2]) {
      const int cnt = s_ce[s] - s_cs[s];
      k0 = first_at_or_after(buf, cnt, static_cast<float>(lo[0]));
      k1 = first_at_or_after(buf, cnt, static_cast<float>(hi[0] + 1));
    }
    for (int k4 = k0; k4 < k1; k4 += kUnroll) {
      // the distances of kUnroll vertices first: their shared loads and
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
        const float4 p = buf[k].pos;
        const float4 w = buf[k].wo;
        const float lgz = nx * w.x + ny * w.y + nz * w.z;
        const bool same = gx * w.x + gy * w.y + gz * w.z > 0.0f;
        if (!same || !(lgz >= kEpsCosine)) continue;
        if (!(buf[k].dep.x + depth1 <= max_len)) continue;
        const float dot_r = rx * w.x + ry * w.y + rz * w.z;
        const bool ph_ok = dot_r > kEpsPhong;
        const float powe = expf(e * logf(fmaxf(dot_r, kEpsPhong)));
        const float d_l = fmaxf(lgz, 0.0f) * kInvPi;
        const float pdf_p = ph_ok ? (e + 1.0f) * kHalfInvPi * powe : 0.0f;
        const float4 t = buf[k].thr;
        const float dpdf = (wl * d_l + wp * pdf_p) * t.w;
        const float rpdf = wl * lam_rev + wp * pdf_p;
        const float w_light = p.w * mis_vc_w + w.w * dpdf;
        const float w_cam = a_cam + b_cam * rpdf;
        const float misw = 1.0f / (w_light + 1.0f + w_cam);
        const float ex = expf(-kBeta * d2 / two_r2);
        const float kw = kAlpha * (1.0f - (1.0f - ex) / kDenom);
        const float base = misw * kw * ws;
        a1x += base * t.x;
        a1y += base * t.y;
        a1z += base * t.z;
        if (ph_ok) {
          const float s2 = base * powe;
          a2x += s2 * t.x;
          a2y += s2 * t.y;
          a2z += s2 * t.z;
        }
      }
    }
    __syncthreads();          // the buffer is free for slot i + 2
  }
  // this CTA's partial sums: group blockIdx.y of [groups, N, 3]
  const int64_t o = 3 * (static_cast<int64_t>(blockIdx.y) * gridDim.x * kTile
                         + q);
  out1[o + 0] = a1x;
  out1[o + 1] = a1y;
  out1[o + 2] = a1z;
  out2[o + 0] = a2x;
  out2[o + 1] = a2y;
  out2[o + 2] = a2z;
}

// out[i] = the groups' partial sums added in group order
__global__ void __launch_bounds__(kTile)
vm_reduce_kernel(const float* __restrict__ part1,
                 const float* __restrict__ part2, int groups, int64_t n3,
                 float* __restrict__ out1, float* __restrict__ out2) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i >= n3) return;
  float a = 0.0f, b = 0.0f;
  for (int g = 0; g < groups; ++g) {
    a += part1[g * n3 + i];
    b += part2[g * n3 + i];
  }
  out1[i] = a;
  out2[i] = b;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(), so a refused launch
// is reported at the call. qtab holds n_tiles * 256 rows of 32 floats;
// packed the grid's vertices as 16-float records (16-byte aligned); out1
// and out2 n_tiles * 256 rows of 3. Each tile's 64 slots go to `groups`
// CTAs (a divisor of 64); part holds their partial sums, 2 * groups *
// n_tiles * 256 * 3 floats, which a second kernel adds.
int merge_vertices_tiled(const int32_t* starts, const int32_t* lens,
                         const float* weights, const int32_t* rows,
                         const float* scal, const float* qtab,
                         const float* packed, const int32_t* offsets,
                         const float* origin, const float* cell_size,
                         int res, int n_tiles, int groups, float* part,
                         float* out1, float* out2, cudaStream_t stream) {
  if (groups < 1 || kRows % groups != 0) return cudaErrorInvalidValue;
  const int64_t n3 = 3 * static_cast<int64_t>(n_tiles) * kTile;
  float* p1 = part;
  float* p2 = part + groups * n3;
  vm_tiled_kernel<<<dim3(n_tiles, groups), kTile, 0, stream>>>(
      starts, lens, weights, rows, scal, qtab,
      reinterpret_cast<const float4*>(packed), offsets, origin, cell_size,
      res, kRows / groups, p1, p2);
  vm_reduce_kernel<<<static_cast<unsigned>((n3 + kTile - 1) / kTile), kTile,
                     0, stream>>>(p1, p2, groups, n3, out1, out2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
