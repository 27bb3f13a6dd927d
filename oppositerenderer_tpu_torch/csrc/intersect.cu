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
// Design. One thread per ray; each block of 256 rays stages the triangle
// table ([9, T] rows v0, e1, e2) through shared memory in chunks of 256
// triangles (9 KB), so any T up to the dense path's 4096 works. Triangles
// are tested in increasing index order and a hit replaces the best only on
// a strictly smaller t: the lowest index among equal t wins, which is the
// TPU kernel's tie rule and torch.argmin's. u, v of the best hit stay in
// registers, so no second pass recomputes them. Rays with tmax <= tmin are
// misses that skip the loop; a block whose rays are all dead skips the
// staging too. The any-hit kernel leaves the loop at the first occluding
// hit.
//
// Numerics. The Moller-Trumbore terms follow _mt_terms
// (pallas_intersect_t.py:39-52) operation by operation, and the library is
// built with --fmad=false, so t, u, v and the winner equal the plain
// version's bit for bit on the card.
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
constexpr int kTriChunk = 256;   // triangles staged per pass
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
__device__ __forceinline__ bool mt_hit(const Ray& r,
                                       const float (*s_tri)[kTriChunk],
                                       int k, float* t_out, float* u_out,
                                       float* v_out) {
  const float v0x = s_tri[0][k], v0y = s_tri[1][k], v0z = s_tri[2][k];
  const float e1x = s_tri[3][k], e1y = s_tri[4][k], e1z = s_tri[5][k];
  const float e2x = s_tri[6][k], e2y = s_tri[7][k], e2z = s_tri[8][k];
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

__global__ void __launch_bounds__(kBlock)
occluded_tris_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax,
                     const float* __restrict__ tri9,
                     const uint8_t* __restrict__ occluder, int n_rays,
                     int n_tris, uint8_t* __restrict__ occ_out) {
  __shared__ float s_tri[9][kTriChunk];
  __shared__ uint8_t s_occ[kTriChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  bool live = false;
  if (i < n_rays) {
    r = load_ray(o, d, tmin, tmax, i);
    live = r.tmax > r.tmin;
  }
  bool blocked = false;
  for (int base = 0; __syncthreads_or(live && !blocked) && base < n_tris;
       base += kTriChunk) {
    const int cnt = min(kTriChunk, n_tris - base);
    stage(s_tri, tri9, n_tris, base, cnt);
    for (int k = threadIdx.x; k < cnt; k += blockDim.x)
      s_occ[k] = occluder[base + k];
    __syncthreads();
    if (live && !blocked) {
      for (int k = 0; k < cnt; ++k) {
        float t, u, v;
        if (s_occ[k] && mt_hit(r, s_tri, k, &t, &u, &v)) {
          blocked = true;
          break;
        }
      }
    }
    // the loop condition's __syncthreads_or orders this chunk's reads
    // before the next chunk's staging
  }
  if (i < n_rays) occ_out[i] = blocked ? 1 : 0;
}

inline int n_blocks(int n_rays) { return (n_rays + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError(),
// so a refused launch is reported at the call, not at a later sync.
int closest_hit_tris(const float* o, const float* d, const float* tmin,
                     const float* tmax, const float* tri9, int n_rays,
                     int n_tris, float* t_out, int32_t* idx_out,
                     float* u_out, float* v_out, cudaStream_t stream) {
  closest_hit_tris_kernel<<<n_blocks(n_rays), kBlock, 0, stream>>>(
      o, d, tmin, tmax, tri9, n_rays, n_tris, t_out, idx_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

int occluded_tris(const float* o, const float* d, const float* tmin,
                  const float* tmax, const float* tri9,
                  const uint8_t* occluder, int n_rays, int n_tris,
                  uint8_t* occ_out, cudaStream_t stream) {
  occluded_tris_kernel<<<n_blocks(n_rays), kBlock, 0, stream>>>(
      o, d, tmin, tmax, tri9, occluder, n_rays, n_tris, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
