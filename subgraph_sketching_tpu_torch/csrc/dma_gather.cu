// K4: the gather-rate study's kernel, for Hopper (sm_90a).
//
// Replaces the Pallas kernel studies/pallas_dma_gather_rate.py (dma_gather,
// body _kernel): per block of 2048 indices it gathers rows[idx[i]] with a
// pipeline of single-row DMAs issued by the scalar core and folds them into
// an elementwise min.  Its output block index is (0, 0) at every grid step,
// so each step overwrites the one output row and the result is the min over
// the LAST block's rows only.
//
// Hopper has no DMA engine for single rows: every warp issues its own
// loads.  Here one CTA owns one block of 2048 indices; its warps each take
// a share of the block, one row at a time, with the lanes across the row's
// 32-bit words (coalesced 128-byte segments) and four rows gathered before
// they are combined; the warps' partial mins meet in shared memory, and the
// CTA stores its block's min to row b of an [n_blocks, words] output.  The
// wrapper (studies/dma_gather_rate.py) returns the last row, the study's
// function; every block's gathers still land in the output, so none of
// them is dead work.
//
// Bound: HBM bytes: the distinct rows these indices touch, read once, plus
// the indices.  Each gathered row that is not distinct comes from L2 when
// the table fits there, or from HBM again when it does not.
//
// Plain C interface (ctypes): the entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 2048;          // indices per CTA, as the study's BLOCK
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxWordsPerLane = 4;   // rows of up to 128 int32 words
constexpr int kMaxWords = kWarp * kMaxWordsPerLane;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
block_min_kernel(const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ idx,
                 int32_t* __restrict__ out, int words) {
  __shared__ int32_t part[kWarps][kMaxWords];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int32_t* block_idx = idx + static_cast<int64_t>(blockIdx.x) * kBlock;

  int32_t acc[kMaxWordsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxWordsPerLane; ++k) acc[k] = INT_MAX;

  for (int base = warp * kWarp; base < kBlock; base += kThreads) {
    const int32_t mine = block_idx[base + lane];
    for (int j = 0; j < kWarp; j += 4) {
      const int32_t* r0 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j)) * words;
      const int32_t* r1 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j + 1)) * words;
      const int32_t* r2 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j + 2)) * words;
      const int32_t* r3 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j + 3)) * words;
#pragma unroll
      for (int k = 0; k < kMaxWordsPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c < words) {
          const int32_t a = __ldg(r0 + c), b = __ldg(r1 + c);
          const int32_t d = __ldg(r2 + c), f = __ldg(r3 + c);
          acc[k] = min(acc[k], min(min(a, b), min(d, f)));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxWordsPerLane; ++k) {
    const int c = lane + k * kWarp;
    if (c < words) part[warp][c] = acc[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < words; c += kThreads) {
    int32_t m = part[0][c];
    for (int w = 1; w < kWarps; ++w) m = min(m, part[w][c]);
    out[static_cast<int64_t>(blockIdx.x) * words + c] = m;
  }
}

}  // namespace

extern "C" {

// rows int32 [N, words]; idx int32 [>= n_blocks * 2048], every entry in
// [0, N); out int32 [n_blocks, words].

int dma_gather_block_min(const void* rows, const void* idx, void* out,
                         int64_t n_blocks, int64_t words, void* stream) {
  if (words < 1 || words > kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks > 0) {
    block_min_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(idx),
        static_cast<int32_t*>(out), static_cast<int>(words));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
