// Native host-side geometry of the PyTorch port: exact CPU versions of
// FPS, kNN, one-directional chamfer and unit-sphere normalisation, for data
// preprocessing, the evaluation tooling and as an independent ground truth
// for the card's kernels (the FPS and kNN of point_sam_tpu_torch/ops).
// Multi-threaded with std::thread.
//
// Built as a plain shared library with g++ and bound with ctypes:
// point_sam_tpu_torch/utils/native.py. Not a CUDA source: the kernels'
// nvcc build (ops/_cuda.py) takes only the .cu / .cuh files of this folder.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(start, end) over [0, total) split across threads.
template <typename F>
void parallel_for(int64_t total, F fn) {
  int nt = std::min<int64_t>(hardware_threads(), std::max<int64_t>(total, 1));
  if (nt <= 1) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (total + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t s = t * chunk;
    int64_t e = std::min<int64_t>(s + chunk, total);
    if (s >= e) break;
    threads.emplace_back([=] { fn(s, e); });
  }
  for (auto& th : threads) th.join();
}

inline float sq_dist3(const float* a, const float* b) {
  float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

// Farthest point sampling, the selection rule of ops.fps without a valid
// mask: start at point 0, greedy argmax of min distance, first index wins
// ties. points: [n, 3] fp32; out_idx: [g] int32.
void psam_fps(const float* points, int64_t n, int64_t g, int32_t* out_idx) {
  if (n == 0 || g == 0) return;
  std::vector<float> mind(n, FLT_MAX);
  int32_t sel = 0;
  out_idx[0] = sel;
  for (int64_t s = 1; s < g; ++s) {
    const float* c = points + 3 * sel;
    parallel_for(n, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        float d = sq_dist3(points + 3 * i, c);
        if (d < mind[i]) mind[i] = d;
      }
    });
    // serial argmax (one linear scan; keeps first-index tie semantics exact)
    float best = -FLT_MAX;
    int32_t arg = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (mind[i] > best) {
        best = mind[i];
        arg = static_cast<int32_t>(i);
      }
    }
    sel = arg;
    out_idx[s] = sel;
  }
}

// Exact kNN: for each of nq queries, the k nearest of nk keys (ascending).
// query: [nq, 3]; key: [nk, 3]; out_idx: [nq, k]; out_d2: [nq, k].
void psam_knn(const float* query, int64_t nq, const float* key, int64_t nk,
              int64_t k, int32_t* out_idx, float* out_d2) {
  parallel_for(nq, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<float, int32_t>> heap;  // max-heap of size k
    for (int64_t qi = lo; qi < hi; ++qi) {
      heap.clear();
      const float* q = query + 3 * qi;
      for (int64_t ki = 0; ki < nk; ++ki) {
        float d = sq_dist3(q, key + 3 * ki);
        if (static_cast<int64_t>(heap.size()) < k) {
          heap.emplace_back(d, static_cast<int32_t>(ki));
          std::push_heap(heap.begin(), heap.end());
        } else if (d < heap.front().first) {
          std::pop_heap(heap.begin(), heap.end());
          heap.back() = {d, static_cast<int32_t>(ki)};
          std::push_heap(heap.begin(), heap.end());
        }
      }
      std::sort_heap(heap.begin(), heap.end());
      for (int64_t j = 0; j < k; ++j) {
        out_d2[qi * k + j] = heap[j].first;
        out_idx[qi * k + j] = heap[j].second;
      }
    }
  });
}

// One-directional chamfer: for each source point, min squared distance to
// the target set (the reference's border-distance primitive).
void psam_chamfer(const float* src, int64_t ns, const float* tgt, int64_t nt,
                  float* out_d2) {
  parallel_for(ns, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float best = FLT_MAX;
      const float* p = src + 3 * i;
      for (int64_t j = 0; j < nt; ++j) {
        float d = sq_dist3(p, tgt + 3 * j);
        if (d < best) best = d;
      }
      out_d2[i] = best;
    }
  });
}

// Unit-sphere normalization in place; returns scale, writes centroid shift.
float psam_normalize(float* points, int64_t n, float* shift_out) {
  double cx = 0, cy = 0, cz = 0;
  for (int64_t i = 0; i < n; ++i) {
    cx += points[3 * i];
    cy += points[3 * i + 1];
    cz += points[3 * i + 2];
  }
  cx /= n; cy /= n; cz /= n;
  float maxn = 0.f;
  for (int64_t i = 0; i < n; ++i) {
    points[3 * i] -= static_cast<float>(cx);
    points[3 * i + 1] -= static_cast<float>(cy);
    points[3 * i + 2] -= static_cast<float>(cz);
    float px = points[3 * i], py = points[3 * i + 1], pz = points[3 * i + 2];
    float r = std::sqrt(px * px + py * py + pz * pz);
    if (r > maxn) maxn = r;
  }
  if (maxn > 0) {
    float inv = 1.0f / maxn;
    parallel_for(n, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        points[3 * i] *= inv;
        points[3 * i + 1] *= inv;
        points[3 * i + 2] *= inv;
      }
    });
  }
  shift_out[0] = static_cast<float>(cx);
  shift_out[1] = static_cast<float>(cy);
  shift_out[2] = static_cast<float>(cz);
  return maxn;
}

int psam_version() { return 1; }

}  // extern "C"
