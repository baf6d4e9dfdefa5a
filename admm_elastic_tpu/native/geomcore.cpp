// Native host-side geometry helpers for admm_elastic_tpu.
//
// This framework keeps the device compute path in XLA; init-time host
// work with irregular memory access (graph coloring, adjacency) is faster
// in C++ than in Python, matching the reference's native posture
// (mcl::graphcolor::color_matrix consumed at src/NodalMultiColorGS.hpp:57).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 geomcore.cpp -o libgeomcore.so

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy graph coloring over CSR adjacency. Returns 0 on success.
int greedy_coloring(const int64_t* adj, const int64_t* starts, int64_t n,
                    int32_t* colors_out) {
  std::vector<int32_t> colors(static_cast<size_t>(n), -1);
  std::vector<int32_t> mark;  // color -> last vertex that used it
  mark.reserve(64);
  for (int64_t v = 0; v < n; ++v) {
    // Mark neighbor colors.
    for (int64_t e = starts[v]; e < starts[v + 1]; ++e) {
      int64_t u = adj[e];
      if (u < 0 || u >= n) return 1;
      int32_t c = colors[static_cast<size_t>(u)];
      if (c >= 0) {
        if (static_cast<size_t>(c) >= mark.size()) mark.resize(c + 1, -1);
        mark[static_cast<size_t>(c)] = static_cast<int32_t>(v);
      }
    }
    // First free color.
    int32_t c = 0;
    while (static_cast<size_t>(c) < mark.size() &&
           mark[static_cast<size_t>(c)] == static_cast<int32_t>(v)) {
      ++c;
    }
    colors[static_cast<size_t>(v)] = c;
  }
  for (int64_t v = 0; v < n; ++v) colors_out[v] = colors[static_cast<size_t>(v)];
  return 0;
}

// Greedy BFS aggregation of the vertex graph into clusters of at most
// `target` vertices (the coarse level of the two-grid PCG preconditioner,
// solvers/pcg.py). Semantics identical to the Python fallback in
// system/assembly.py: visit vertices in index order; an unaggregated
// vertex seeds a cluster and absorbs unaggregated neighbors breadth-first
// (neighbors in adjacency order) until the cluster reaches `target`.
// Returns 0 on success; agg_out[i] in [0, n_clusters).
int greedy_aggregates(const int64_t* adj, const int64_t* starts, int64_t n,
                      int32_t target, int32_t* agg_out) {
  std::vector<int32_t> agg(static_cast<size_t>(n), -1);
  std::vector<int64_t> frontier, next;
  int32_t c = 0;
  for (int64_t v = 0; v < n; ++v) {
    if (agg[static_cast<size_t>(v)] >= 0) continue;
    agg[static_cast<size_t>(v)] = c;
    int32_t members = 1;
    frontier.clear();
    frontier.push_back(v);
    while (!frontier.empty() && members < target) {
      next.clear();
      for (int64_t u : frontier) {
        for (int64_t e = starts[u]; e < starts[u + 1]; ++e) {
          int64_t w = adj[e];
          if (w < 0 || w >= n) return 1;
          if (agg[static_cast<size_t>(w)] < 0 && members < target) {
            agg[static_cast<size_t>(w)] = c;
            ++members;
            next.push_back(w);
          }
        }
      }
      frontier.swap(next);
    }
    ++c;
  }
  for (int64_t v = 0; v < n; ++v) agg_out[v] = agg[static_cast<size_t>(v)];
  return 0;
}

}  // extern "C"
