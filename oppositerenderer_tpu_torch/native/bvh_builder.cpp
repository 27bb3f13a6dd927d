// Binned-SAH BVH builder (native).
//
// TPU-native replacement for the role OptiX's "Trbvh" builder plays in the
// reference (scene/Scene.cpp:353: acceleration structure built by the
// runtime). Scenes are static, so the build runs once on the host in C++;
// the traversal happens on-device (accel/bvh.py) over the flattened arrays
// this emits.
//
// Output layout (flattened, depth-first):
//   nodes_min[n][3], nodes_max[n][3]  - node AABBs
//   nodes_a[n], nodes_b[n]            - inner: a = left child, b = right
//                                       child; leaf: a = ~first_prim,
//                                       b = prim_count
//   prim_order[num_prims]             - permutation into leaf-contiguous
//                                       order
//
// Build: top-down, 16-bin SAH over the centroid extent's longest axis,
// falling back to median split when SAH finds no gain; leaves capped at
// leaf_size primitives.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Aabb {
  float mn[3] = {1e30f, 1e30f, 1e30f};
  float mx[3] = {-1e30f, -1e30f, -1e30f};
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], p[k]);
      mx[k] = std::max(mx[k], p[k]);
    }
  }
  void grow(const Aabb& o) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], o.mn[k]);
      mx[k] = std::max(mx[k], o.mx[k]);
    }
  }
  float half_area() const {
    float e[3] = {std::max(0.f, mx[0] - mn[0]), std::max(0.f, mx[1] - mn[1]),
                  std::max(0.f, mx[2] - mn[2])};
    return e[0] * e[1] + e[1] * e[2] + e[2] * e[0];
  }
};

struct Builder {
  const float* prim_min;  // [n][3]
  const float* prim_max;
  const float* centroid;  // [n][3]
  int leaf_size;
  std::vector<int> order;
  std::vector<float> nodes_min, nodes_max;
  std::vector<int> nodes_a, nodes_b;

  int new_node() {
    nodes_min.insert(nodes_min.end(), {0, 0, 0});
    nodes_max.insert(nodes_max.end(), {0, 0, 0});
    nodes_a.push_back(0);
    nodes_b.push_back(0);
    return static_cast<int>(nodes_a.size()) - 1;
  }

  void set_bounds(int node, const Aabb& b) {
    std::memcpy(&nodes_min[3 * node], b.mn, 12);
    std::memcpy(&nodes_max[3 * node], b.mx, 12);
  }

  // build over order[first..first+count), returns node index
  int build(int first, int count) {
    Aabb bounds, cbounds;
    for (int i = first; i < first + count; ++i) {
      int p = order[i];
      bounds.grow(&prim_min[3 * p]);
      Aabb pb;
      pb.grow(&prim_max[3 * p]);
      bounds.grow(pb);
      cbounds.grow(&centroid[3 * p]);
    }
    int node = new_node();
    set_bounds(node, bounds);

    if (count <= leaf_size) {
      nodes_a[node] = ~first;
      nodes_b[node] = count;
      return node;
    }

    // choose longest centroid axis
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cbounds.mx[k] - cbounds.mn[k];
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] < 1e-12f) {
      mid = first + count / 2;  // degenerate: median
    } else {
      // 16-bin SAH
      constexpr int kBins = 16;
      Aabb bin_bounds[kBins];
      int bin_count[kBins] = {0};
      const float scale = kBins / ext[axis];
      auto bin_of = [&](int p) {
        int b = static_cast<int>((centroid[3 * p + axis] -
                                  cbounds.mn[axis]) * scale);
        return std::min(b, kBins - 1);
      };
      for (int i = first; i < first + count; ++i) {
        int p = order[i];
        int b = bin_of(p);
        ++bin_count[b];
        bin_bounds[b].grow(&prim_min[3 * p]);
        Aabb pb;
        pb.grow(&prim_max[3 * p]);
        bin_bounds[b].grow(pb);
      }
      // sweep for best split
      float right_area[kBins];
      Aabb acc;
      int right_count[kBins];
      int rc = 0;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bin_bounds[b]);
        rc += bin_count[b];
        right_area[b] = acc.half_area();
        right_count[b] = rc;
      }
      acc = Aabb();
      int lc = 0;
      float best_cost = 1e30f;
      int best_bin = -1;
      for (int b = 0; b < kBins - 1; ++b) {
        acc.grow(bin_bounds[b]);
        lc += bin_count[b];
        if (lc == 0 || right_count[b + 1] == 0) continue;
        float cost = acc.half_area() * lc +
                     right_area[b + 1] * right_count[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_bin = b;
        }
      }
      if (best_bin < 0) {
        mid = first + count / 2;
        std::nth_element(order.begin() + first, order.begin() + mid,
                         order.begin() + first + count, [&](int a, int b) {
                           return centroid[3 * a + axis] <
                                  centroid[3 * b + axis];
                         });
      } else {
        auto it = std::partition(
            order.begin() + first, order.begin() + first + count,
            [&](int p) { return bin_of(p) <= best_bin; });
        mid = static_cast<int>(it - order.begin());
        if (mid == first || mid == first + count) mid = first + count / 2;
      }
    }

    int left = build(first, mid - first);
    int right = build(mid, first + count - mid);
    nodes_a[node] = left;
    nodes_b[node] = right;
    return node;
  }
};

}  // namespace

extern "C" {

// Returns node count. Caller passes output buffers sized for the worst case
// (2*n nodes). prim_* are [n*3] row-major.
int build_bvh(const float* prim_min, const float* prim_max,
              const float* centroid, int n, int leaf_size,
              float* out_nodes_min, float* out_nodes_max, int* out_nodes_a,
              int* out_nodes_b, int* out_order, int max_nodes) {
  Builder b;
  b.prim_min = prim_min;
  b.prim_max = prim_max;
  b.centroid = centroid;
  b.leaf_size = leaf_size < 1 ? 1 : leaf_size;
  b.order.resize(n);
  for (int i = 0; i < n; ++i) b.order[i] = i;
  b.nodes_min.reserve(6 * n);
  b.build(0, n);
  int node_count = static_cast<int>(b.nodes_a.size());
  if (node_count > max_nodes) return -node_count;  // caller re-allocates
  std::memcpy(out_nodes_min, b.nodes_min.data(), 12 * node_count);
  std::memcpy(out_nodes_max, b.nodes_max.data(), 12 * node_count);
  std::memcpy(out_nodes_a, b.nodes_a.data(), 4 * node_count);
  std::memcpy(out_nodes_b, b.nodes_b.data(), 4 * node_count);
  std::memcpy(out_order, b.order.data(), 4 * n);
  return node_count;
}

}  // extern "C"
