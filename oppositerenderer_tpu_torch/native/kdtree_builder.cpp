// Left-balanced photon kd-tree builder (host, C++).
//
// Native equivalent of the reference's CPU kd-tree photon-map builder
// (RenderEngine/renderer/OptixRenderer_CPUKdTree.cpp:27-129 buildKDTree /
// createPhotonKdTreeOnCPU, with select.h's nth_element-style median
// select): median split on the largest-extent axis, left-balanced
// array layout (children of slot i at 2i+1 / 2i+2), axis flags per slot.
//
// Called from Python via ctypes (native/__init__.py); the TPU-side range
// query walks the flat arrays with a fixed stack (photon_map.py).
//
// Axis flag encoding (mirrors PPM_X/PPM_Y/PPM_Z/PPM_LEAF/PPM_NULL):
//   0,1,2 = split axis X/Y/Z;  3 = leaf;  4 = null slot.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kLeaf = 3;
constexpr int kNull = 4;

// size of the left subtree of a left-balanced complete tree with n nodes
int left_subtree_size(int n) {
  if (n <= 1) return 0;
  int h = 0;                       // height: 2^h - 1 < n
  while ((1 << (h + 1)) - 1 < n) ++h;
  int full_upper = (1 << h) - 1;   // nodes above the last level
  int last = n - full_upper;       // nodes on the last level
  int half_leaves = 1 << (h - 1);
  return ((1 << (h - 1)) - 1) + std::min(last, half_leaves);
}

struct Builder {
  const float* pos;  // [n,3]
  int* perm;         // [m] photon index per tree slot (-1 = null)
  int* axis;         // [m]
  int m;
  std::vector<int> idx;

  void build(int lo, int hi, int slot) {
    int n = hi - lo;
    if (n <= 0 || slot >= m) return;
    if (n == 1) {
      perm[slot] = idx[lo];
      axis[slot] = kLeaf;
      return;
    }
    // largest-extent split axis over the range
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = lo; i < hi; ++i) {
      const float* p = pos + 3 * idx[i];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], p[a]);
        mx[a] = std::max(mx[a], p[a]);
      }
    }
    int ax = 0;
    float best = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a)
      if (mx[a] - mn[a] > best) { best = mx[a] - mn[a]; ax = a; }

    int med = lo + left_subtree_size(n);
    std::nth_element(idx.begin() + lo, idx.begin() + med, idx.begin() + hi,
                     [&](int a, int b) {
                       return pos[3 * a + ax] < pos[3 * b + ax];
                     });
    perm[slot] = idx[med];
    axis[slot] = ax;
    build(lo, med, 2 * slot + 1);
    build(med + 1, hi, 2 * slot + 2);
  }
};

}  // namespace

extern "C" {

// pos: [n,3]; perm/axis: output [m] (caller-allocated, m >= n slots of a
// left-balanced complete layout). Returns number of filled slots, or -1.
int build_photon_kdtree(const float* pos, int n, int* perm, int* axis,
                        int m) {
  if (n < 0 || m < n) return -1;
  for (int i = 0; i < m; ++i) {
    perm[i] = -1;
    axis[i] = kNull;
  }
  if (n == 0) return 0;
  Builder b;
  b.pos = pos;
  b.perm = perm;
  b.axis = axis;
  b.m = m;
  b.idx.resize(n);
  for (int i = 0; i < n; ++i) b.idx[i] = i;
  b.build(0, n, 0);
  return n;
}

}  // extern "C"
