// The kd-tree photon map's host build, enqueued in stream order.
//
// The JAX package builds its kd-tree inside the jitted PPM step with a
// jax.pure_callback (oppositerenderer_tpu/photon_map.py:419-447): the
// photons go to the host, the native builder orders them, and the tree
// comes back. This is that callback on a CUDA stream: two copies of the
// photons into pinned host memory, the build as a host function
// (native/kdtree_builder.cpp's kd_build_host, a cudaHostFn_t), and two
// copies of the tree back to device buffers. Under CUDA graph capture the
// four calls become two memcpy nodes, a host node and two memcpy nodes,
// so a replay runs the whole build. Nothing here is a kernel: the bound is
// the bytes over PCIe and the host's build.
//
// The copies are made here rather than by torch so that no allocator event
// is recorded on pinned memory inside a capture. Every buffer is allocated
// by the caller (photon_map.KdHostStage), outside any capture.

#include <cuda_runtime.h>

#include <cstddef>

extern "C" int kd_stage_enqueue(const float* pos, const unsigned char* valid,
                                float* pos_host, unsigned char* valid_host,
                                const int* perm_host, const int* axis_host,
                                int* perm, int* axis, int rows, int m,
                                void* host_fn, void* stage,
                                cudaStream_t stream) {
  const size_t nr = static_cast<size_t>(rows);
  const size_t nm = static_cast<size_t>(m);
  cudaError_t err = cudaMemcpyAsync(pos_host, pos, nr * 3 * sizeof(float),
                                    cudaMemcpyDeviceToHost, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(valid_host, valid, nr, cudaMemcpyDeviceToHost,
                          stream);
  if (err == cudaSuccess)
    err = cudaLaunchHostFunc(stream, reinterpret_cast<cudaHostFn_t>(host_fn),
                             stage);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(perm, perm_host, nm * sizeof(int),
                          cudaMemcpyHostToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(axis, axis_host, nm * sizeof(int),
                          cudaMemcpyHostToDevice, stream);
  return static_cast<int>(err);
}
