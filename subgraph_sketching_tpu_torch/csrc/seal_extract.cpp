// Native SEAL enclosing-subgraph extraction (host code).
//
// The reference's subgraph pipeline is a per-link python BFS over scipy CSR
// plus two scipy shortest_path calls per link (reference
// src/datasets/seal.py:291-348, src/labelling_tricks.py:63-94) — its own
// comment calls it "not parallelised".  This is the host-side hot loop of
// the SEAL tier: C++ BFS + DRNL labelling, OpenMP-parallel across links,
// writing directly into the dense padded batch layout the models consume
// (graph/seal.py SealBatchArrays).  The same source as the JAX package's
// native/seal_extract.cpp, so both packages extract the same batches.
//
// Build: ops/cuda_build.py (g++ -O3 -fopenmp -shared -fPIC), at first use.
// Binding: graph/native.py (ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int32_t kUnvisited = -1;

// deterministic per-link RNG for fringe subsampling (splitmix64)
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    state += 0x9E3779B97F4A7C15ull;
    uint64_t z = state;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // uniform in [0, n)
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
};

constexpr int32_t kInf = INT32_MAX / 2;  // unreachable sentinel

// BFS distances on the local subgraph, optionally with one node masked out
// (the DRNL/DE+ masking scheme: dist to src is computed with dst removed).
// Unreachable nodes (and the masked node) get kInf; callers clamp per the
// labelling scheme's rules.
void masked_bfs(const std::vector<std::vector<int32_t>>& adj, int32_t start,
                int32_t masked, std::vector<int32_t>* dist) {
  std::fill(dist->begin(), dist->end(), kInf);
  (*dist)[start] = 0;
  std::queue<int32_t> q;
  q.push(start);
  while (!q.empty()) {
    int32_t u = q.front();
    q.pop();
    int32_t du = (*dist)[u];
    for (int32_t v : adj[u]) {
      if (v == masked) continue;
      if ((*dist)[v] == kInf) {
        (*dist)[v] = du + 1;
        q.push(v);
      }
    }
  }
  if (masked >= 0) (*dist)[masked] = kInf;  // caller overrides
}

int64_t drnl_label(int64_t ds, int64_t dd) {
  // z = 1 + min(d) + (d/2)(d/2 + d%2 - 1), src/dst -> 1
  // (reference labelling_tricks.py:11-27)
  if (ds == 0 || dd == 0) return 1;
  int64_t d = ds + dd;
  int64_t d2 = d / 2, dm = d % 2;
  return 1 + (ds < dd ? ds : dd) + d2 * (d2 + dm - 1);
}

}  // namespace

extern "C" {

// node_label: 0 = drnl, 1 = hop, 2 = zo, 3 = degree, 4 = none,
//             5 = de, 6 = de+ (labels 5/6 write TWO int32 labels per node —
//             distances to src and dst, reference labelling_tricks.py:97-133
//             — so out_z must be [num_links x max_nodes x 2])
// Outputs are [num_links x max_nodes] / [num_links x max_edges] row-major,
// pre-zeroed by the caller; out_nodes pads with -1.
// Returns 0 on success.
int seal_extract_batch(
    const int32_t* indptr, const int32_t* indices, const float* weights,
    int32_t num_graph_nodes, const int32_t* links, int32_t num_links,
    int32_t num_hops, int32_t max_nodes, int32_t max_edges, int32_t max_dist,
    int32_t node_label, double ratio_per_hop, int32_t max_nodes_per_hop,
    uint64_t seed,
    int32_t* out_nodes, int32_t* out_z, int32_t* out_src, int32_t* out_dst,
    float* out_w, int32_t* out_counts) {
  // the two center nodes are visited unconditionally; a smaller cap would
  // write past the per-link output rows (heap corruption)
  if (max_nodes < 2 || max_edges < 1) return 1;
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    // per-thread scratch: global->local map as a stamped array
    std::vector<int32_t> local_id(num_graph_nodes, kUnvisited);
    std::vector<int32_t> stamp(num_graph_nodes, -1);
    std::vector<int32_t> nodes, fringe, next_fringe, dists;

#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int32_t li = 0; li < num_links; ++li) {
      const int32_t s = links[2 * li], t = links[2 * li + 1];
      Rng rng(seed ^ (0x9E3779B97F4A7C15ull * (uint64_t)(li + 1)));
      nodes.clear();
      dists.clear();

      auto visit = [&](int32_t v) {
        stamp[v] = li;
        local_id[v] = (int32_t)nodes.size();
        nodes.push_back(v);
      };
      visit(s);
      dists.push_back(0);
      // degenerate self-links (negative samples can draw (v, v)) have ONE
      // center node; target-edge removal and src/dst masking must not
      // treat local node 1 (an arbitrary neighbour) as the dst endpoint
      const bool two_centers = (t != s);
      if (two_centers) {
        visit(t);
        dists.push_back(0);
      }

      // k-hop expansion (reference k_hop_subgraph, seal.py:313-334)
      fringe.assign(nodes.begin(), nodes.end());
      for (int32_t hop = 1; hop <= num_hops; ++hop) {
        next_fringe.clear();
        for (int32_t u : fringe) {
          for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
            int32_t v = indices[e];
            if (stamp[v] != li) {
              stamp[v] = li;               // mark, add later (dedup)
              local_id[v] = kUnvisited;    // not yet accepted
              next_fringe.push_back(v);
            }
          }
        }
        // subsample the fringe (ratio_per_hop / max_nodes_per_hop,
        // reference seal.py:326-330) — Fisher-Yates prefix.  Dropped
        // candidates STAY stamped: the python path adds the whole fringe
        // to `visited` before sampling (graph/seal.py:44-45), so dropped
        // nodes can never re-enter at a later hop.
        size_t keep = next_fringe.size();
        if (ratio_per_hop < 1.0)
          keep = (size_t)(ratio_per_hop * (double)keep);
        if (max_nodes_per_hop >= 0 && (size_t)max_nodes_per_hop < keep)
          keep = (size_t)max_nodes_per_hop;
        if (keep < next_fringe.size()) {
          for (size_t i = 0; i < keep; ++i) {
            size_t j = i + (size_t)rng.below(next_fringe.size() - i);
            std::swap(next_fringe[i], next_fringe[j]);
          }
          next_fringe.resize(keep);
        } else {
          // no subsampling: sorted order like the python path's
          // `nodes + sorted(fringe)` (also makes max_nodes truncation
          // deterministic instead of discovery-order dependent)
          std::sort(next_fringe.begin(), next_fringe.end());
        }
        if (next_fringe.empty()) break;
        for (int32_t v : next_fringe) {
          if ((int32_t)nodes.size() >= max_nodes) break;
          visit(v);
          dists.push_back(hop);
        }
        fringe = next_fringe;
        if ((int32_t)nodes.size() >= max_nodes) break;
      }

      const int32_t n_sub = (int32_t)nodes.size();
      // local adjacency + padded edge output; target edge 0<->1 removed
      // (reference seal.py:338-341).  The adjacency is built FULLY even
      // past the max_edges output cap: labels (BFS distances, degrees) must
      // see the whole subgraph like the python path, which labels before
      // truncating the edge output.
      std::vector<std::vector<int32_t>> adj(n_sub);
      std::vector<float> wdeg(n_sub, 0.0f);
      int32_t n_edges = 0;
      for (int32_t ul = 0; ul < n_sub; ++ul) {
        int32_t u = nodes[ul];
        for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
          int32_t v = indices[e];
          if (stamp[v] != li || local_id[v] == kUnvisited) continue;
          int32_t vl = local_id[v];
          bool is_target = two_centers &&
              ((ul == 0 && vl == 1) || (ul == 1 && vl == 0));
          if (is_target) continue;
          if (n_edges < max_edges) {
            out_src[(int64_t)li * max_edges + n_edges] = ul;
            out_dst[(int64_t)li * max_edges + n_edges] = vl;
            out_w[(int64_t)li * max_edges + n_edges] =
                weights ? weights[e] : 1.0f;
            ++n_edges;
          }
          adj[ul].push_back(vl);
          wdeg[ul] += weights ? weights[e] : 1.0f;
        }
      }

      // labels
      const int32_t z_dim = node_label >= 5 ? 2 : 1;
      int32_t* z_row = out_z + (int64_t)li * max_nodes * z_dim;
      const bool masked_pair = two_centers && n_sub > 1;
      if (node_label == 0) {  // drnl with src/dst masking
        std::vector<int32_t> d2s(n_sub), d2t(n_sub);
        masked_bfs(adj, 0, masked_pair ? 1 : -1, &d2s);
        if (masked_pair) {
          masked_bfs(adj, 1, 0, &d2t);
          d2s[1] = 0;  // reference inserts dist 0 at the masked position
          d2t[0] = 0;
        } else {
          d2t = d2s;
        }
        for (int32_t i = 0; i < n_sub; ++i) {
          int32_t ds = d2s[i] > max_dist ? max_dist : d2s[i];
          int32_t dt = d2t[i] > max_dist ? max_dist : d2t[i];
          int64_t z = drnl_label(i == 1 && masked_pair ? 0 : ds,
                                 i == 0 ? 0 : dt);
          z_row[i] = (int32_t)z;
        }
        if (n_sub > 0) z_row[0] = 1;
        if (masked_pair) z_row[1] = 1;
      } else if (node_label == 5 || node_label == 6) {  // de / de+
        std::vector<int32_t> d2s(n_sub), d2t(n_sub);
        const bool plus = node_label == 6;
        // de: plain distances on the (target-edge-removed) subgraph;
        // de+: src/dst-masked distances with 1 at the masked positions
        masked_bfs(adj, 0, plus && masked_pair ? 1 : -1, &d2s);
        if (masked_pair) {
          masked_bfs(adj, 1, plus ? 0 : -1, &d2t);
          if (plus) {
            d2s[1] = 1;  // reference labelling_tricks.py:123,128
            d2t[0] = 1;
          }
        } else {
          d2t = d2s;
        }
        // de caps at max_dist with unreachable -> max_dist + 1
        // (labelling_tricks.py:105-106); de+ sends both to max_dist (:131-132)
        const int32_t unreach = plus ? max_dist : max_dist + 1;
        for (int32_t i = 0; i < n_sub; ++i) {
          int32_t a = d2s[i], b = d2t[i];
          z_row[2 * i] = a >= kInf ? unreach : (a > max_dist ? max_dist : a);
          z_row[2 * i + 1] = b >= kInf ? unreach : (b > max_dist ? max_dist : b);
        }
      } else if (node_label == 1) {  // hop distance
        for (int32_t i = 0; i < n_sub; ++i) z_row[i] = dists[i];
      } else if (node_label == 2) {  // zero-one
        for (int32_t i = 0; i < n_sub; ++i) z_row[i] = dists[i] == 0 ? 1 : 0;
      } else if (node_label == 3) {  // degree, capped at 100
        // weight SUM like the python path (seal.py label_nodes: z =
        // adj.sum(axis=0)), not edge count — they differ on weighted graphs
        for (int32_t i = 0; i < n_sub; ++i) {
          int32_t deg = (int32_t)wdeg[i];
          z_row[i] = deg > 100 ? 100 : deg;
        }
      }  // 4: zeros (pre-zeroed)

      for (int32_t i = 0; i < n_sub; ++i)
        out_nodes[(int64_t)li * max_nodes + i] = nodes[i];
      for (int32_t i = n_sub; i < max_nodes; ++i)
        out_nodes[(int64_t)li * max_nodes + i] = -1;
      out_counts[2 * li] = n_sub;
      out_counts[2 * li + 1] = n_edges;
    }
  }
  return 0;
}

int seal_extract_version() { return 3; }

}  // extern "C"
