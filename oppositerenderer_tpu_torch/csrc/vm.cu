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
// cell-sorted vertex grid (lens <= 256) with weight weights[t,s]. scal
// holds r2, mis_vc_w, depth1 (the camera vertex's path length) and the
// maximum path length. For every valid query q and vertex v of its tile's
// slots, with dz = q - v summed per axis and the dots taken with v's wo:
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
// Design. B3's (csrc/gather.cu): one CTA of 256 threads per tile, one
// query per thread with its table row and its two float3 sums in
// registers. The TPU grid's sequential slot loop becomes a loop inside the
// CTA: for each slot with len > 0 (uniform across the CTA, the tables sit
// in shared memory) the CTA stages the slot's vertices, one per thread, as
// four float4 (position + dVCM, wo + dVM, throughput + cont, depth: 16 KB)
// and every thread walks them as shared-memory broadcasts. No atomics: a
// query's sums are owned by one thread. The TPU workarounds are not
// ported: no transposed [16, M_pad] packing, no 128-aligned DMA window, no
// static 64-slot unroll; the kernel reads the grid's own arrays.
//
// Cost. At the main shape (CornellSmall 512^2, L = 10: 262,144 camera
// vertices in 1,024 tiles, a grid of 2,359,296 light-vertex rows) a tile
// tests up to 64 x 256 vertices per query, ~25 FP32 operations a pair to
// the rejection tests and ~50 more with an expf and a logf where the pair
// is kept: bound by the FP32 pipes and the shared-memory reads of the
// inner loop, not by device memory (each window is read once per tile).
// 1,024 CTAs of 256 threads are about one wave on 132 SMs.
//
// Numerics. Built with --fmad=false like the other kernels, so each kept
// pair's terms round as the plain version's do; the sums run vertex by
// vertex where the plain version reduces by a matrix product, so the two
// agree to float rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;    // queries per tile (= threads per CTA)
constexpr int kRows = 64;     // slots per tile
constexpr int kChunk = 256;   // vertices per slot at most
constexpr int kQCols = 32;    // query table columns
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

__global__ void __launch_bounds__(kTile)
vm_tiled_kernel(const int32_t* __restrict__ starts,
                const int32_t* __restrict__ lens,
                const float* __restrict__ weights,
                const float* __restrict__ scal,
                const float* __restrict__ qtab,
                const float* __restrict__ vpos,
                const float* __restrict__ vwo,
                const float* __restrict__ vthr,
                const float* __restrict__ vdvcm,
                const float* __restrict__ vdvm,
                const float* __restrict__ vcont,
                const float* __restrict__ vdepth,
                float* __restrict__ out1, float* __restrict__ out2) {
  __shared__ float4 s_pos[kChunk];   // position, dVCM
  __shared__ float4 s_wo[kChunk];    // wo, dVM
  __shared__ float4 s_thr[kChunk];   // throughput, cont
  __shared__ float4 s_dep[kChunk];   // depth, unused
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
  float a1x = 0.0f, a1y = 0.0f, a1z = 0.0f;
  float a2x = 0.0f, a2y = 0.0f, a2z = 0.0f;
  __syncthreads();

  for (int s = 0; s < kRows; ++s) {
    const int len = s_len[s];
    if (len <= 0) continue;   // uniform across the CTA
    const int start = s_start[s];
    const float ws = s_w[s];
    __syncthreads();          // the previous slot is consumed
    if (tid < len) {
      const int64_t v = static_cast<int64_t>(start) + tid;
      s_pos[tid] = make_float4(vpos[3 * v], vpos[3 * v + 1],
                               vpos[3 * v + 2], vdvcm[v]);
      s_wo[tid] = make_float4(vwo[3 * v], vwo[3 * v + 1], vwo[3 * v + 2],
                              vdvm[v]);
      s_thr[tid] = make_float4(vthr[3 * v], vthr[3 * v + 1],
                               vthr[3 * v + 2], vcont[v]);
      s_dep[tid] = make_float4(vdepth[v], 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    if (!valid) continue;     // no barrier below: the thread may skip
    for (int k = 0; k < len; ++k) {
      const float4 p = s_pos[k];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (!(d2 <= r2)) continue;
      const float4 w = s_wo[k];
      const float lgz = nx * w.x + ny * w.y + nz * w.z;
      const bool same = gx * w.x + gy * w.y + gz * w.z > 0.0f;
      if (!same || !(lgz >= kEpsCosine)) continue;
      if (!(s_dep[k].x + depth1 <= max_len)) continue;
      const float dot_r = rx * w.x + ry * w.y + rz * w.z;
      const bool ph_ok = dot_r > kEpsPhong;
      const float powe = expf(e * logf(fmaxf(dot_r, kEpsPhong)));
      const float d_l = fmaxf(lgz, 0.0f) * kInvPi;
      const float pdf_p = ph_ok ? (e + 1.0f) * kHalfInvPi * powe : 0.0f;
      const float4 t = s_thr[k];
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
  out1[3 * q + 0] = a1x;
  out1[3 * q + 1] = a1y;
  out1[3 * q + 2] = a1z;
  out2[3 * q + 0] = a2x;
  out2[3 * q + 1] = a2y;
  out2[3 * q + 2] = a2z;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(), so a refused launch
// is reported at the call. qtab holds n_tiles * 256 rows of 32 floats;
// out1 and out2 n_tiles * 256 rows of 3.
int merge_vertices_tiled(const int32_t* starts, const int32_t* lens,
                         const float* weights, const float* scal,
                         const float* qtab, const float* vpos,
                         const float* vwo, const float* vthr,
                         const float* vdvcm, const float* vdvm,
                         const float* vcont, const float* vdepth,
                         int n_tiles, float* out1, float* out2,
                         cudaStream_t stream) {
  vm_tiled_kernel<<<n_tiles, kTile, 0, stream>>>(
      starts, lens, weights, scal, qtab, vpos, vwo, vthr, vdvcm, vdvm,
      vcont, vdepth, out1, out2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
