// Host builder of the padded-tree plan's tables
// (subgraph_sketching_tpu_torch/ops/segment_scan.py SortedSegmentPlan).
// A copy of the JAX package's native/plan_build.cpp, built by
// ops/cuda_build.py with g++ at first use.
//
// The numpy construction (the plain version, kept in segment_scan.py) is a
// chain of E-element argsort / gather / scatter passes.  A counting sort by
// destination gives the same stable ordering in O(E) passes, parallel over
// destination ranges with OpenMP.
//
// Phase protocol (the caller allocates everything and reads S between):
//   plan_phase1: counts -> run_starts / sub_starts prefix sums; returns S
//   plan_phase2: fills order (stable placement) + gather_idx / sub_dst
//   plan_slot_edge: the slot -> edge-id table (SpMM staging only), derived
//                   from order, so phase2 carries no per-edge side table
//
// Stability: the cursor pass scans edges in original order, which
// reproduces numpy's stable argsort placement bit for bit.

#include <algorithm>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

int plan_build_version() { return 3; }

// dst[e], run_starts[n+1], sub_starts[n+1]; returns number of sub-runs S
// (or -1 on bad args).
int64_t plan_phase1(const int32_t* dst, int64_t num_edges, int32_t num_nodes,
                    int32_t sub_len, int64_t* run_starts,
                    int64_t* sub_starts) {
    // edge ids are written as int32 downstream (order/slot_edge tables);
    // past 2^31-1 edges they would wrap negative, so refuse (-1)
    if (sub_len <= 0 || num_nodes < 0 || num_edges > INT32_MAX) return -1;
    std::memset(run_starts, 0, sizeof(int64_t) * (num_nodes + 1));
    for (int64_t e = 0; e < num_edges; ++e) {
        int32_t d = dst[e];
        if (d < 0 || d >= num_nodes) return -1;
        ++run_starts[d + 1];
    }
    sub_starts[0] = 0;
    for (int32_t v = 0; v < num_nodes; ++v) {
        int64_t c = run_starts[v + 1];
        sub_starts[v + 1] = sub_starts[v] + (c + sub_len - 1) / sub_len;
        run_starts[v + 1] += run_starts[v];
    }
    return sub_starts[num_nodes];
}

// Outputs sized by the caller from phase1's S:
//   order      [E]   int32   dst-sorted edge ids, stable
//   gather_idx [S*L] int32   src per slot; padding slots -> num_nodes
//   sub_dst    [S]   int32
int plan_phase2(const int32_t* src, const int32_t* dst, int64_t num_edges,
                int32_t num_nodes, int32_t sub_len,
                const int64_t* run_starts, const int64_t* sub_starts,
                int64_t num_subruns, int32_t* order,
                int32_t* gather_idx, int32_t* sub_dst) {
    (void)num_subruns;
    // Stable placement, parallel over DESTINATION ranges: every thread
    // scans the whole edge list in original order but places only edges
    // whose dst falls in its range (edge-count-balanced via run_starts).
    // Ownership is per destination, so the per-dst cursors are race-free
    // and each thread's order/gather writes land in one contiguous region
    // (its cursor slice even fits L2 at citation2 scale).
    int64_t* cursor = new int64_t[num_nodes > 0 ? num_nodes : 1];
    std::memset(cursor, 0, sizeof(int64_t) * (num_nodes > 0 ? num_nodes : 1));
#pragma omp parallel
    {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
        const int T = omp_get_num_threads();
#else
        const int tid = 0, T = 1;
#endif
        const int64_t lo_edges = tid * num_edges / T;
        const int64_t hi_edges = (tid + 1) * num_edges / T;
        const int32_t n0 = (int32_t)(std::upper_bound(
            run_starts, run_starts + num_nodes + 1, lo_edges) - run_starts) - 1;
        const int32_t n1 = (int32_t)(std::upper_bound(
            run_starts, run_starts + num_nodes + 1, hi_edges) - run_starts) - 1;
        for (int64_t e = 0; e < num_edges; ++e) {
            const int32_t d = dst[e];
            if (d < n0 || d >= n1) continue;
            const int64_t p = cursor[d]++;
            order[run_starts[d] + p] = (int32_t)e;
            gather_idx[sub_starts[d] * sub_len + p] = src[e];
        }
    }
    delete[] cursor;
    // padding tails only (S*L - E writes instead of a full-size memset),
    // plus the per-sub-run destination — one pass over nodes
#pragma omp parallel for schedule(static)
    for (int32_t v = 0; v < num_nodes; ++v) {
        const int64_t c = run_starts[v + 1] - run_starts[v];
        const int64_t s0 = sub_starts[v], s1 = sub_starts[v + 1];
        for (int64_t s = s0; s < s1; ++s) sub_dst[s] = v;
        for (int64_t i = s0 * sub_len + c; i < s1 * sub_len; ++i)
            gather_idx[i] = num_nodes;
    }
    return 0;
}

// slot -> original edge id; padding slots -> num_edges (zero-weight row).
// Derived from order/prefix sums: per node the writes are sequential and
// node ranges are disjoint, so this is embarrassingly parallel.  Only the
// SpMM/stage_edge_data path needs this table.
int plan_slot_edge(const int32_t* order, const int64_t* run_starts,
                   const int64_t* sub_starts, int32_t num_nodes,
                   int32_t sub_len, int64_t num_edges, int32_t* slot_edge) {
#pragma omp parallel for schedule(static)
    for (int32_t v = 0; v < num_nodes; ++v) {
        const int64_t r0 = run_starts[v];
        const int64_t c = run_starts[v + 1] - r0;
        const int64_t base = sub_starts[v] * sub_len;
        const int64_t end = sub_starts[v + 1] * sub_len;
        for (int64_t i = 0; i < c; ++i) slot_edge[base + i] = order[r0 + i];
        for (int64_t i = base + c; i < end; ++i)
            slot_edge[i] = (int32_t)num_edges;
    }
    return 0;
}

}  // extern "C"
