// Native host-side ops for the data pipeline (the port's own copy of
// umeregrobust_tpu/native/hostops.cpp; the same code, so both packages
// give the same answers).
//
// The reference leans on external native libraries for its host hot path:
// MinkowskiEngine's sparse_quantize (C++), scipy's cKDTree (C) for mutual
// matches and SEM label copy-back, and scipy's linear_sum_assignment
// (Hungarian, C). This translation unit provides them as a small,
// dependency-free C ABI consumed through ctypes
// (umeregrobust_tpu_torch/native/__init__.py), with numpy / scipy
// fallbacks when the shared object cannot be built.
//
// Build (at first use, into build/host/):
//   g++ -O3 -shared -fPIC hostops.cpp -o libhostops_<hash>.so

#include <cstdint>
#include <cmath>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

// Pack three voxel coordinates (|c| < 2^20) into a 64-bit key.
inline uint64_t pack3(int32_t x, int32_t y, int32_t z) {
  const uint64_t bias = 1u << 20;
  return ((uint64_t)(x + bias) << 42) | ((uint64_t)(y + bias) << 21) |
         (uint64_t)(z + bias);
}

struct GridHash {
  std::unordered_map<uint64_t, std::vector<int64_t>> cells;
  float cell;

  GridHash(const float* pts, int64_t n, float cell_size) : cell(cell_size) {
    cells.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
      int32_t cx = (int32_t)std::floor(pts[3 * i + 0] / cell);
      int32_t cy = (int32_t)std::floor(pts[3 * i + 1] / cell);
      int32_t cz = (int32_t)std::floor(pts[3 * i + 2] / cell);
      cells[pack3(cx, cy, cz)].push_back(i);
    }
  }
};

}  // namespace

extern "C" {

// Voxel quantization with first-occurrence representatives.
// pts: (n, 3) float32. Fills out_coords (n, 3) int32 and out_idx (n) int64
// with the unique voxels in first-occurrence input order. Returns the
// number of unique voxels.
int64_t umr_quantize(const float* pts, int64_t n, float voxel,
                     int32_t* out_coords, int64_t* out_idx) {
  std::unordered_map<uint64_t, int64_t> seen;
  seen.reserve((size_t)n);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t cx = (int32_t)std::floor(pts[3 * i + 0] / voxel);
    int32_t cy = (int32_t)std::floor(pts[3 * i + 1] / voxel);
    int32_t cz = (int32_t)std::floor(pts[3 * i + 2] / voxel);
    uint64_t key = pack3(cx, cy, cz);
    auto it = seen.find(key);
    if (it == seen.end()) {
      seen.emplace(key, m);
      out_coords[3 * m + 0] = cx;
      out_coords[3 * m + 1] = cy;
      out_coords[3 * m + 2] = cz;
      out_idx[m] = i;
      ++m;
    }
  }
  return m;
}

// Radius-bounded 1-NN: for each query, the nearest point within `radius`
// (exact; grid cell = radius, 27-neighborhood scan). idx = -1 when none.
void umr_nn_radius(const float* q, int64_t nq, const float* p, int64_t np_,
                   float radius, int64_t* idx, float* dist) {
  GridHash grid(p, np_, radius);
  const float r2 = radius * radius;
  for (int64_t i = 0; i < nq; ++i) {
    const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
    int32_t cx = (int32_t)std::floor(qx / radius);
    int32_t cy = (int32_t)std::floor(qy / radius);
    int32_t cz = (int32_t)std::floor(qz / radius);
    float best = std::numeric_limits<float>::max();
    int64_t best_j = -1;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          auto it = grid.cells.find(pack3(cx + dx, cy + dy, cz + dz));
          if (it == grid.cells.end()) continue;
          for (int64_t j : it->second) {
            const float ddx = qx - p[3 * j], ddy = qy - p[3 * j + 1],
                        ddz = qz - p[3 * j + 2];
            const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < best && d2 <= r2) {
              best = d2;
              best_j = j;
            }
          }
        }
    idx[i] = best_j;
    dist[i] = best_j >= 0 ? std::sqrt(best) : -1.0f;
  }
}

// Unbounded 1-NN (for SEM label copy-back, <= 3 m rule applied by the
// caller): coarse grid + expanding ring search.
void umr_nn_1(const float* q, int64_t nq, const float* p, int64_t np_,
              float cell, int64_t* idx, float* dist) {
  GridHash grid(p, np_, cell);
  for (int64_t i = 0; i < nq; ++i) {
    const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
    int32_t cx = (int32_t)std::floor(qx / cell);
    int32_t cy = (int32_t)std::floor(qy / cell);
    int32_t cz = (int32_t)std::floor(qz / cell);
    float best = std::numeric_limits<float>::max();
    int64_t best_j = -1;
    for (int ring = 0; ring < 64; ++ring) {
      // scan the shell at Chebyshev distance `ring`
      for (int dx = -ring; dx <= ring; ++dx)
        for (int dy = -ring; dy <= ring; ++dy)
          for (int dz = -ring; dz <= ring; ++dz) {
            if (std::max(std::abs(dx), std::max(std::abs(dy), std::abs(dz)))
                != ring)
              continue;
            auto it = grid.cells.find(pack3(cx + dx, cy + dy, cz + dz));
            if (it == grid.cells.end()) continue;
            for (int64_t j : it->second) {
              const float ddx = qx - p[3 * j], ddy = qy - p[3 * j + 1],
                          ddz = qz - p[3 * j + 2];
              const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
              if (d2 < best) {
                best = d2;
                best_j = j;
              }
            }
          }
      // correctness: a hit in ring k can be beaten by ring k+1; stop once
      // the found distance is inside the guaranteed-covered radius
      if (best_j >= 0 && std::sqrt(best) <= cell * ring) break;
    }
    idx[i] = best_j;
    dist[i] = best_j >= 0 ? std::sqrt(best) : -1.0f;
  }
}

// Hungarian assignment (Jonker-Volgenant shortest augmenting path,
// O(n^2 m)); cost is (n, m) row-major with n <= m. Fills row_to_col (n).
void umr_hungarian(const double* cost, int64_t n, int64_t m,
                   int64_t* row_to_col) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int64_t> p(m + 1, 0), way(m + 1, 0);
  for (int64_t i = 1; i <= n; ++i) {
    p[0] = i;
    int64_t j0 = 0;
    std::vector<double> minv(m + 1, INF);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int64_t i0 = p[j0], j1 = 0;
      double delta = INF;
      for (int64_t j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int64_t j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int64_t j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int64_t j = 1; j <= m; ++j)
    if (p[j] > 0 && p[j] <= n) row_to_col[p[j] - 1] = j - 1;
}

}  // extern "C"
