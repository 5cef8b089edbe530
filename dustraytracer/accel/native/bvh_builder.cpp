// Native binned-SAH BVH builder (C ABI, driven via ctypes).
//
// Host-side equivalent of the reference's builder
// (DustRayTracer/src/Core/BVH/BVHBuilder.cu:11-92,257-346)
// re-designed rather than translated: single-pass binning per node (the
// reference rescans the whole range once per candidate bin), explicit
// work stack, contiguous leaf ranges via index permutation, and a flat
// SoA output that matches accel/bvh.py's numpy builder bit-for-layout.
// Leaf size is enforced <= leaf_target for the vectorized leaf test of the
// threaded walk (ops/traverse.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kTraversalCost = 1.0f;  // reference: BVHNode.cuh:26-27
constexpr float kIntersectCost = 2.0f;

struct Vec3 {
  double x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double surface_area(const Vec3& lo, const Vec3& hi) {
  double dx = std::max(hi.x - lo.x, 0.0);
  double dy = std::max(hi.y - lo.y, 0.0);
  double dz = std::max(hi.z - lo.z, 0.0);
  return 2.0 * (dx * dy + dy * dz + dz * dx);
}
inline double axis_get(const Vec3& v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct Item {
  int64_t node, start, end, depth;
};

}  // namespace

extern "C" int drt_build_bvh(
    const float* tri_pos,  // (n, 3, 3) row-major corner positions
    int64_t n, int leaf_target, int bins,
    float* node_min, float* node_max,  // (cap, 3)
    int32_t* node_left, int32_t* node_right, int32_t* node_first,
    int32_t* node_count, int64_t* perm, int64_t cap, int64_t* n_nodes_out,
    int64_t* depth_out) {
  if (n <= 0 || bins < 2 || bins > 256 || leaf_target < 1) return 1;

  std::vector<Vec3> tmin(n), tmax(n), cent(n);
  for (int64_t i = 0; i < n; ++i) {
    const float* p = tri_pos + i * 9;
    Vec3 lo{p[0], p[1], p[2]}, hi = lo;
    for (int c = 1; c < 3; ++c) {
      Vec3 v{p[c * 3 + 0], p[c * 3 + 1], p[c * 3 + 2]};
      lo = vmin(lo, v);
      hi = vmax(hi, v);
    }
    tmin[i] = lo;
    tmax[i] = hi;
    cent[i] = {0.5 * (lo.x + hi.x), 0.5 * (lo.y + hi.y), 0.5 * (lo.z + hi.z)};
  }

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::vector<int64_t> scratch(n);

  int64_t n_nodes = 0;
  auto alloc = [&]() -> int64_t {
    if (n_nodes >= cap) return -1;
    int64_t id = n_nodes++;
    node_left[id] = node_right[id] = -1;
    node_first[id] = 0;
    node_count[id] = 0;
    return id;
  };

  const double kInf = std::numeric_limits<double>::infinity();
  int64_t max_depth = 1;
  std::vector<Item> stack;
  stack.push_back({alloc(), 0, n, 1});

  std::vector<int> bin_of(n);
  std::vector<int64_t> bin_n(bins);
  std::vector<Vec3> bin_lo(bins), bin_hi(bins);
  std::vector<double> sweep_sa_l(bins), sweep_n_l(bins);

  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    max_depth = std::max(max_depth, it.depth);
    int64_t count = it.end - it.start;

    Vec3 blo{kInf, kInf, kInf}, bhi{-kInf, -kInf, -kInf};
    Vec3 clo{kInf, kInf, kInf}, chi{-kInf, -kInf, -kInf};
    for (int64_t k = it.start; k < it.end; ++k) {
      int64_t i = order[k];
      blo = vmin(blo, tmin[i]);
      bhi = vmax(bhi, tmax[i]);
      clo = vmin(clo, cent[i]);
      chi = vmax(chi, cent[i]);
    }
    node_min[it.node * 3 + 0] = static_cast<float>(blo.x);
    node_min[it.node * 3 + 1] = static_cast<float>(blo.y);
    node_min[it.node * 3 + 2] = static_cast<float>(blo.z);
    node_max[it.node * 3 + 0] = static_cast<float>(bhi.x);
    node_max[it.node * 3 + 1] = static_cast<float>(bhi.y);
    node_max[it.node * 3 + 2] = static_cast<float>(bhi.z);

    if (count <= leaf_target) {
      node_first[it.node] = static_cast<int32_t>(it.start);
      node_count[it.node] = static_cast<int32_t>(count);
      continue;
    }

    int best_axis = -1, best_bin = -1;
    double best_cost = kInf;
    double parent_sa = std::max(surface_area(blo, bhi), 1e-30);

    for (int axis = 0; axis < 3; ++axis) {
      double extent = axis_get(chi, axis) - axis_get(clo, axis);
      if (extent < 1e-12) continue;
      double scale = bins / extent;
      std::fill(bin_n.begin(), bin_n.end(), 0);
      std::fill(bin_lo.begin(), bin_lo.end(), Vec3{kInf, kInf, kInf});
      std::fill(bin_hi.begin(), bin_hi.end(), Vec3{-kInf, -kInf, -kInf});
      for (int64_t k = it.start; k < it.end; ++k) {
        int64_t i = order[k];
        int b = std::min<int>(
            static_cast<int>((axis_get(cent[i], axis) - axis_get(clo, axis)) *
                             scale),
            bins - 1);
        bin_of[k - it.start] = b;
        ++bin_n[b];
        bin_lo[b] = vmin(bin_lo[b], tmin[i]);
        bin_hi[b] = vmax(bin_hi[b], tmax[i]);
      }
      // left-to-right prefix
      Vec3 lo{kInf, kInf, kInf}, hi{-kInf, -kInf, -kInf};
      int64_t nl = 0;
      for (int b = 0; b < bins - 1; ++b) {
        nl += bin_n[b];
        if (bin_n[b] > 0) {
          lo = vmin(lo, bin_lo[b]);
          hi = vmax(hi, bin_hi[b]);
        }
        sweep_n_l[b] = static_cast<double>(nl);
        sweep_sa_l[b] = nl > 0 ? surface_area(lo, hi) : 0.0;
      }
      // right-to-left suffix + cost
      lo = {kInf, kInf, kInf};
      hi = {-kInf, -kInf, -kInf};
      int64_t nr = 0;
      for (int b = bins - 1; b >= 1; --b) {
        nr += bin_n[b];
        if (bin_n[b] > 0) {
          lo = vmin(lo, bin_lo[b]);
          hi = vmax(hi, bin_hi[b]);
        }
        int64_t nl_b = static_cast<int64_t>(sweep_n_l[b - 1]);
        if (nl_b == 0 || nr == 0) continue;
        double sa_r = surface_area(lo, hi);
        double cost = kTraversalCost +
                      (sweep_sa_l[b - 1] * nl_b + sa_r * nr) / parent_sa *
                          kIntersectCost;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b - 1;
        }
      }
    }

    int64_t n_left = 0;
    if (best_axis >= 0) {
      double extent = axis_get(chi, best_axis) - axis_get(clo, best_axis);
      double scale = bins / extent;
      int64_t w = 0;
      for (int64_t k = it.start; k < it.end; ++k) {
        int64_t i = order[k];
        int b = std::min<int>(
            static_cast<int>(
                (axis_get(cent[i], best_axis) - axis_get(clo, best_axis)) *
                scale),
            bins - 1);
        if (b <= best_bin) scratch[w++] = i;
      }
      n_left = w;
      for (int64_t k = it.start; k < it.end; ++k) {
        int64_t i = order[k];
        int b = std::min<int>(
            static_cast<int>(
                (axis_get(cent[i], best_axis) - axis_get(clo, best_axis)) *
                scale),
            bins - 1);
        if (b > best_bin) scratch[w++] = i;
      }
      std::memcpy(order.data() + it.start, scratch.data(),
                  sizeof(int64_t) * count);
    }
    if (n_left == 0 || n_left == count) {
      n_left = count / 2;  // degenerate: median split keeps leaves bounded
    }

    int64_t l = alloc(), r = alloc();
    if (l < 0 || r < 0) return 2;
    node_left[it.node] = static_cast<int32_t>(l);
    node_right[it.node] = static_cast<int32_t>(r);
    int64_t mid = it.start + n_left;
    stack.push_back({r, mid, it.end, it.depth + 1});
    stack.push_back({l, it.start, mid, it.depth + 1});
  }

  std::memcpy(perm, order.data(), sizeof(int64_t) * n);
  *n_nodes_out = n_nodes;
  *depth_out = max_depth;
  return 0;
}
