// Binned-SAH BVH2 builder, the host side of the port's clustered scenes:
// its primitive order is the scene's leaf order, so it decides every
// triangle id of the clustered traversal. accel_build_bvh2 and its Box
// are the JAX package's native builder (tpu_restir/accel/native/
// accel.cpp) copied without change, so that both packages put the
// triangles in the same order; the Morton-cluster builder of that file is
// left out, the port does not use it. Compiled by
// tpu_restir_torch/accel/bvh.py with the JAX package's flags (-O3
// -march=native -fopenmp): other flags can contract other multiply-adds
// and move a SAH split.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const float* p) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], p[a]);
      hi[a] = std::max(hi[a], p[a]);
    }
  }
  void grow(const Box& b) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], b.lo[a]);
      hi[a] = std::max(hi[a], b.hi[a]);
    }
  }
  float area() const {
    float e0 = std::max(hi[0] - lo[0], 0.f);
    float e1 = std::max(hi[1] - lo[1], 0.f);
    float e2 = std::max(hi[2] - lo[2], 0.f);
    return e0 * e1 + e1 * e2 + e2 * e0;
  }
};

}  // namespace

extern "C" {

// Binned-SAH BVH2. Outputs sized by caller to capacity 2n nodes:
// node_min/node_max (2n,3), left/right/start/count (2n,), order (n).
// Returns node count; max_depth written to *max_depth_out.
int accel_build_bvh2(const float* tri_v, int n, int leaf_size, int n_bins,
                     float* node_min, float* node_max, int* left, int* right,
                     int* start, int* count, int* order, int* max_depth_out) {
  if (n <= 0) return 0;
  std::vector<Box> tbox(n);
  std::vector<float> cent(3 * n);
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    Box b;
    b.grow(tri_v + (size_t)i * 9);
    b.grow(tri_v + (size_t)i * 9 + 3);
    b.grow(tri_v + (size_t)i * 9 + 6);
    tbox[i] = b;
    for (int a = 0; a < 3; ++a)
      cent[i * 3 + a] = 0.5f * (b.lo[a] + b.hi[a]);
  }
  for (int i = 0; i < n; ++i) order[i] = i;

  struct Task { int node, lo, hi, depth; };
  std::vector<Task> stack;
  int n_nodes = 1;
  int max_depth = 1;
  stack.push_back({0, 0, n, 1});

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    max_depth = std::max(max_depth, t.depth);
    Box nb;
    for (int i = t.lo; i < t.hi; ++i) nb.grow(tbox[order[i]]);
    std::memcpy(node_min + t.node * 3, nb.lo, 12);
    std::memcpy(node_max + t.node * 3, nb.hi, 12);
    int m = t.hi - t.lo;
    if (m <= leaf_size) {
      left[t.node] = -1;
      right[t.node] = -1;
      start[t.node] = t.lo;
      count[t.node] = m;
      continue;
    }
    // centroid bounds + widest axis
    Box cb;
    for (int i = t.lo; i < t.hi; ++i) cb.grow(&cent[order[i] * 3]);
    int axis = 0;
    float ext = -1;
    for (int a = 0; a < 3; ++a) {
      float e = cb.hi[a] - cb.lo[a];
      if (e > ext) { ext = e; axis = a; }
    }
    int mid;
    if (ext <= 1e-12f) {
      mid = t.lo + m / 2;
    } else {
      std::vector<int> bin_count(n_bins, 0);
      std::vector<Box> bin_box(n_bins);
      auto bin_of = [&](int prim) {
        int b = (int)((cent[prim * 3 + axis] - cb.lo[axis]) / ext * n_bins);
        return std::min(b, n_bins - 1);
      };
      for (int i = t.lo; i < t.hi; ++i) {
        int b = bin_of(order[i]);
        bin_count[b]++;
        bin_box[b].grow(tbox[order[i]]);
      }
      // sweep for best split
      std::vector<float> rarea(n_bins);
      Box acc;
      int best = -1;
      float best_cost = FLT_MAX;
      for (int b = n_bins - 1; b >= 1; --b) {
        acc.grow(bin_box[b]);
        rarea[b] = acc.area();
      }
      acc = Box();
      int nl = 0;
      for (int b = 1; b < n_bins; ++b) {
        acc.grow(bin_box[b - 1]);
        nl += bin_count[b - 1];
        int nr = m - nl;
        if (nl == 0 || nr == 0) continue;
        float cost = nl * acc.area() + nr * rarea[b];
        if (cost < best_cost) { best_cost = cost; best = b; }
      }
      if (best < 0) {
        mid = t.lo + m / 2;
      } else {
        auto it = std::stable_partition(
            order + t.lo, order + t.hi,
            [&](int prim) { return bin_of(prim) < best; });
        mid = (int)(it - order);
        if (mid == t.lo || mid == t.hi) mid = t.lo + m / 2;
      }
    }
    int l_node = n_nodes++;
    int r_node = n_nodes++;
    left[t.node] = l_node;
    right[t.node] = r_node;
    start[t.node] = 0;
    count[t.node] = 0;
    stack.push_back({l_node, t.lo, mid, t.depth + 1});
    stack.push_back({r_node, mid, t.hi, t.depth + 1});
  }
  *max_depth_out = max_depth;
  return n_nodes;
}

}  // extern "C"
