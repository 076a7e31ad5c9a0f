// K3: fused row gather and segmented min/max over dst-sorted edges, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel studies/pallas_gather_reduce.py
// (gather_reduce, body _reduce_kernel).  That kernel walks the dst-sorted
// edge list in one sequential grid sweep, keeps a DMA_DEPTH-deep pipeline
// of single-row copies in flight and a one-row VMEM accumulator for the
// current destination, and writes into an output aliased to the input
// rows.  Here, with ptr the per-destination edge pointer that the host
// derives from the dst-sorted edges (studies/gather_reduce.py
// prepare_csr_edges; row n, the identity row, has no edges):
//
//   out[v, :] = op(rows[v, :], op_{e in [ptr[v], ptr[v+1])} rows[src[e], :])
//
// The output is a separate buffer: teams gather neighbours' input rows
// while others write their own results.  Row n is copied.
//
// Design (merge_path.cuh): the n + 1 row ends and the E_pad edges form one
// merge path, cut into shares of kShareSteps; pad edges lie past every row
// end, so they fall in no row.  A team of 32 lanes (16 for int8 W=256)
// walks one share: it first copies the share's src slab (at most
// kShareSteps int32, one coalesced read) to shared memory, then reduces
// every row that ends in the share and writes it, and leaves the open
// row's partial as a carry-out; a second launch folds each row's
// carry-outs into out in share order.  Each gathered row is read as
// 16-byte units when its bytes are a multiple of 16 (int32 W=128, int8
// W=256) and as 32-bit words otherwise (int32 W=40, int8 W=8), by the same
// kernel.  TMA cannot gather, so the pipeline is software: the source ids
// come from shared memory, never from a load in the chain, each lane
// issues kUnroll (8) independent gathers before it combines them, and the
// next row's own row is loaded while this row's gathers are in flight, so
// a team keeps up to 9 rows (4.5 KB at 512-byte rows) in flight;
// cp.async into a shared-memory ring would add a copy and a wait for the
// same bytes in flight.  Of 64, 128 and 256 steps a share, 256 was the
// fastest on the H100 at both the served graph and bench_hub.
//
// Bound: HBM bytes at best (rows read once, out written once, src and ptr
// read once), but every edge gathers one whole row, E*W*b bytes that come
// from L2 when the table fits there and from HBM when it does not.  A hub's
// edges are spread over ceil(its steps / kShareSteps) shares, so its time
// is its gathers at the card's rate plus the carry pass over its
// ~deg/kShareSteps carry-outs, no longer one warp walking 50k edges.
//
// Plain C interface (ctypes): each entry point launches both kernels on
// the given stream, allocates nothing (the caller passes carry [shares,
// words] and carry_row [shares]), and returns the first cudaError.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

using namespace merge_path;

constexpr int kShareSteps = 256;  // merge-path steps (rows + edges) a team
constexpr int kMaxWords = 128;    // the study's widest row

// Unit `col` of row src[item] (src from the team's shared-memory slab,
// whose first entry is edge j0).
template <class U>
struct GatherLoad {
  const U* rows;
  const int32_t* slab;
  int64_t j0;
  int64_t units;
  __device__ __forceinline__ U operator()(int64_t item, int64_t col) const {
    return __ldg(rows + static_cast<int64_t>(slab[item - j0]) * units + col);
  }
};

template <class Op, class U, int T>
__global__ void __launch_bounds__(kBlock)
gather_reduce_kernel(const U* __restrict__ rows,
                     const int32_t* __restrict__ src,
                     const int64_t* __restrict__ ptr, U* __restrict__ out,
                     U* __restrict__ carry, int64_t* __restrict__ carry_row,
                     int64_t num_rows, int64_t num_items, int64_t units,
                     int64_t shares) {
  __shared__ int32_t slabs[Team<T>::kPerBlock][kShareSteps];
  const Team<T> t;
  if (t.id >= shares) return;   // uniform across the team
  const Share s = find_share<T, kShareSteps>(t, ptr, num_rows, num_items);
  int32_t* slab = slabs[t.slot];
  for (int64_t o = t.lane; o < s.j1 - s.j0; o += T) {
    slab[o] = __ldg(src + s.j0 + o);
  }
  __syncwarp(t.mask);
  walk_share<Op, U, T, true>(t, s, ptr, rows, out, carry, carry_row, num_rows,
                             units, shares,
                             GatherLoad<U>{rows, slab, s.j0, units});
}

template <class Op, class U, int T>
cudaError_t run(const void* rows, const void* src, const void* ptr, void* out,
                void* carry, void* carry_row, int64_t num_rows,
                int64_t num_items, int64_t units, int64_t shares,
                cudaStream_t stream) {
  const dim3 grid = grid_for<T>(shares, units);
  gather_reduce_kernel<Op, U, T><<<grid, kBlock, 0, stream>>>(
      static_cast<const U*>(rows), static_cast<const int32_t*>(src),
      static_cast<const int64_t*>(ptr), static_cast<U*>(out),
      static_cast<U*>(carry), static_cast<int64_t*>(carry_row), num_rows,
      num_items, units, shares);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<Op, U, T><<<grid, kBlock, 0, stream>>>(
      static_cast<const U*>(carry), static_cast<const int64_t*>(carry_row),
      static_cast<U*>(out), units, shares);
  return cudaGetLastError();
}

template <class Op>
int launch(const void* rows, const void* src, const void* ptr, void* out,
           void* carry, void* carry_row, int64_t num_rows, int64_t num_items,
           int64_t words, int64_t shares, void* stream) {
  if (words < 1 || words > kMaxWords || num_items < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (shares != num_shares(num_rows, num_items, kShareSteps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = words % 4 == 0 && aligned16(rows) && aligned16(out) &&
                   aligned16(carry);
  const int64_t units = vec ? words / 4 : words;
  cudaError_t err;
  if (vec) {
    err = units <= 16
        ? run<Op, uint4, 16>(rows, src, ptr, out, carry, carry_row, num_rows,
                             num_items, units, shares, st)
        : run<Op, uint4, 32>(rows, src, ptr, out, carry, carry_row, num_rows,
                             num_items, units, shares, st);
  } else {
    err = units <= 16
        ? run<Op, uint32_t, 16>(rows, src, ptr, out, carry, carry_row,
                                num_rows, num_items, units, shares, st)
        : run<Op, uint32_t, 32>(rows, src, ptr, out, carry, carry_row,
                                num_rows, num_items, units, shares, st);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The merge-path steps of one share: the caller sizes the scratch as
// ceil((num_rows + num_items) / gather_reduce_share_steps()) rows.
int64_t gather_reduce_share_steps() { return kShareSteps; }

// rows/out [num_rows, words] 32-bit words (W for int32, W / 4 for int8),
// src int32 [num_items] (the padded edge list), ptr int64 [num_rows + 1],
// carry [shares, words], carry_row int64 [shares].

int gather_reduce_min_i32(const void* rows, const void* src, const void* ptr,
                          void* out, void* carry, void* carry_row,
                          int64_t num_rows, int64_t num_items, int64_t words,
                          int64_t shares, void* stream) {
  return launch<MinI32>(rows, src, ptr, out, carry, carry_row, num_rows,
                        num_items, words, shares, stream);
}

int gather_reduce_max_i8(const void* rows, const void* src, const void* ptr,
                         void* out, void* carry, void* carry_row,
                         int64_t num_rows, int64_t num_items, int64_t words,
                         int64_t shares, void* stream) {
  return launch<MaxI8x4>(rows, src, ptr, out, carry, carry_row, num_rows,
                         num_items, words, shares, stream);
}

}  // extern "C"
