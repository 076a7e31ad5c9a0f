// K4: the gather-rate study's kernel, for Hopper (sm_90a).
//
// Replaces the Pallas kernel studies/pallas_dma_gather_rate.py (dma_gather,
// body _kernel): per block of 2048 indices it gathers rows[idx[i]] with a
// pipeline of single-row DMAs issued by the scalar core and folds them into
// an elementwise min.  Its output block index is (0, 0) at every grid step,
// so each step overwrites the one output row and the result is the min over
// the LAST block's rows only.  Here one CTA owns one block and stores its
// block's min to row b of an [n_blocks, words] output; the wrapper
// (studies/dma_gather_rate.py) returns the last row, the study's function,
// and every block's gathers still land in the output, so none is dead work.
//
// What bounds it: the HBM bound is the distinct rows the indices touch,
// read once, plus the indices.  At the study's shape (200000 rows of 512
// bytes, 2^20 uniform indices) the table is twice the 50 MB L2 and each row
// is gathered ~5.2 times; gathered in index order, a row's later gathers
// come at random moments, about half of them miss L2, and HBM reads several
// times the distinct bytes.  The first version (gathers in index order, 4
// rows in flight per warp) ran at ~5x the bound.  The design:
//
// - Sort, then gather.  Each CTA sorts its 2048 indices in shared memory on
//   their top kSortBits bits (CUB's BlockRadixSort: two 4-bit passes), so
//   it walks the table upward in buckets of ~N/256 rows.  The grid is one
//   wave (512 CTAs at 4 a SM), so every CTA sweeps the table at once and a
//   row's gathers by several CTAs fall close together in time: the later
//   ones hit L2 and HBM bytes fall toward the distinct rows.  The min does
//   not depend on the order: the result is the same bits.  The warps take
//   consecutive groups of the sorted order, so a CTA walks it front to
//   back together.
// - Bytes in flight.  A warp reads one row as 16-byte units (one uint4 a
//   lane for a 512-byte row) where the row's bytes are a multiple of 16, as
//   32-bit words otherwise, and loads kRows (8) rows before it combines
//   them: 4 KB a warp, 32 KB a CTA, 128 KB an SM in flight.
// - The warps' partial mins meet in shared memory once, at the end.
//
// TMA's bulk copy (cp.async.bulk of one row into shared memory on an
// mbarrier) is the direct counterpart of the TPU kernel's single-row DMAs,
// but it adds a copy through shared memory for the same bytes in flight;
// the order of the gathers, not their issue, is what costs here.
//
// Plain C interface (ctypes): the entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

using merge_path::MinI32;
using merge_path::aligned16;
using merge_path::combine;
using merge_path::splat;

constexpr int kWarp = 32;
constexpr int kBlock = 2048;          // indices per CTA, as the study's BLOCK
constexpr int kThreads = 256;
constexpr int kItems = kBlock / kThreads;
constexpr int kWarps = kThreads / kWarp;
constexpr int kRows = 8;              // rows a warp loads before it combines
constexpr int kSortBits = 8;          // the index bits each CTA sorts on
constexpr int kMaxWords = 128;

template <class U>
struct Words;

template <>
struct Words<uint32_t> {
  static constexpr int kPerUnit = 1;
  static __device__ __forceinline__ void put(uint32_t* p, uint32_t u) {
    p[0] = u;
  }
};

template <>
struct Words<uint4> {
  static constexpr int kPerUnit = 4;
  static __device__ __forceinline__ void put(uint32_t* p, const uint4& u) {
    p[0] = u.x;
    p[1] = u.y;
    p[2] = u.z;
    p[3] = u.w;
  }
};

// kPer units a lane: rows of at most kWarp * kPer units.
template <class U, int kPer>
__global__ void __launch_bounds__(kThreads, 4)
block_min_kernel(const U* __restrict__ rows, const int32_t* __restrict__ idx,
                 int32_t* __restrict__ out, int64_t units, int words,
                 int begin_bit, int end_bit) {
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems>;
  __shared__ union {
    typename Sort::TempStorage sort;
    uint32_t part[kWarps][kMaxWords];
  } tmp;
  __shared__ uint32_t sorted[kBlock];

  const int32_t* block_idx = idx + static_cast<int64_t>(blockIdx.x) * kBlock;
  uint32_t keys[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {   // coalesced; the sort takes any order
    keys[i] = static_cast<uint32_t>(block_idx[i * kThreads + threadIdx.x]);
  }
  if (end_bit > begin_bit) Sort(tmp.sort).Sort(keys, begin_bit, end_bit);
#pragma unroll
  for (int i = 0; i < kItems; ++i) sorted[threadIdx.x * kItems + i] = keys[i];
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  U acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = splat<U>(MinI32::kIdent);
  for (int g = warp * kRows; g < kBlock; g += kWarps * kRows) {
    U v[kRows][kPer];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {   // every row in flight first
      const U* row = rows + static_cast<int64_t>(sorted[g + r]) * units;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = lane + j * kWarp;
        v[r][j] = c < units ? __ldg(row + c) : splat<U>(MinI32::kIdent);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = combine<MinI32>(acc[j], v[r][j]);
    }
  }

  // `part` shares the sort's storage, which every thread left before the
  // barrier above
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = lane + j * kWarp;
    if (c < units) Words<U>::put(&tmp.part[warp][c * Words<U>::kPerUnit], acc[j]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < words; c += kThreads) {
    uint32_t m = tmp.part[0][c];
    for (int w = 1; w < kWarps; ++w) m = MinI32::op(m, tmp.part[w][c]);
    out[static_cast<int64_t>(blockIdx.x) * words + c] = static_cast<int32_t>(m);
  }
}

}  // namespace

extern "C" {

// rows int32 [num_rows, words]; idx int32 [>= n_blocks * 2048], every
// entry in [0, num_rows); out int32 [n_blocks, words].

int dma_gather_block_min(const void* rows, const void* idx, void* out,
                         int64_t num_rows, int64_t n_blocks, int64_t words,
                         void* stream) {
  if (words < 1 || words > kMaxWords || num_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks > 0) {
    // the bits of the largest index, num_rows - 1; sort on the top kSortBits
    int end_bit = 0;
    while (end_bit < 31 && (int64_t{1} << end_bit) < num_rows) ++end_bit;
    const int begin_bit = end_bit > kSortBits ? end_bit - kSortBits : 0;
    const auto st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(n_blocks);
    auto* o = static_cast<int32_t*>(out);
    const auto* i = static_cast<const int32_t*>(idx);
    if (words % 4 == 0 && aligned16(rows)) {
      block_min_kernel<uint4, 1><<<grid, kThreads, 0, st>>>(
          static_cast<const uint4*>(rows), i, o, words / 4,
          static_cast<int>(words), begin_bit, end_bit);
    } else {
      block_min_kernel<uint32_t, kMaxWords / kWarp><<<grid, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(rows), i, o, words,
          static_cast<int>(words), begin_bit, end_bit);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
