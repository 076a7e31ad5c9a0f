// K2: block-accumulator sketch propagation, for Hopper (sm_90a).
//
// Replaces the Pallas kernel studies/pallas_sketch_prop.py (_block_prop,
// body _block_prop_kernel).  That kernel partitions the destinations into
// blocks of NB = 4096 rows, keeps one block's running min/max in a 2 MB
// VMEM accumulator, and streams the block's edges (self-loops included,
// sorted by (dst block, src)) through a sequential grid, loading source
// rows in 512-row chunks with a prefetched second buffer and flushing the
// accumulator when the block changes.  4096 rows of 512 bytes do not fit
// the 227 KB of shared memory a Hopper block may use, and Hopper blocks run
// in parallel with nothing carried between them, so here one CTA owns one
// destination block of block_rows rows (studies/sketch_prop.py BLOCK_ROWS),
// with its accumulator tile in shared memory:
//
//   acc[d, :] = identity;  for each edge (s, d) of the block:
//       acc[d, :] = op(acc[d, :], rows[s, :]);   out[block rows] = acc
//
// with the edge range of each block given by blk_ptr and d the row within
// the block (dstl).  The block's edges are sorted by src, so the CTA's
// warps gather neighbouring source rows at the same time and reuse them
// through L2: what the TPU kernel's chunk streaming bought.  No double
// buffer: the warps' own loads in flight hide the latency.
//
// Updates are shared-memory atomics, since two warps may hold edges of the
// same destination row.  int32 min (biased MinHash) is the native atomicMin.
// There is no shared-memory int8 atomic max, so HLL rows stay int8 in shared
// memory, four registers per 32-bit word, updated by an atomicCAS loop on
// the word with the byte-SIMD __vmaxs4.  Widening to int32 in shared memory
// (as the TPU kernel widened in VMEM) would take four times the tile for
// the same block; the loop keeps the tile at the row's own 256 bytes and
// needs no atomic at all once a word already holds the max, which is the
// common case as sketches saturate.
//
// Bound: HBM bytes at best (rows read once, out written once, src, dstl and
// blk_ptr read once), but every edge gathers one whole row, (E + N)*W*b
// bytes from L2 or HBM, and does one shared-memory atomic per 32-bit word.
//
// Plain C interface (ctypes): each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;         // 16 warps share one destination block
constexpr int kMaxWordsPerLane = 4;   // rows of up to 128 32-bit words
constexpr unsigned kFull = 0xffffffffu;

struct MinI32 {   // uint32 min carried as biased int32
  using T = int32_t;
  static __device__ __forceinline__ T ident() { return INT_MAX; }
  static __device__ __forceinline__ void update(T* a, T v) { atomicMin(a, v); }
};

struct MaxI8x4 {  // four int8 registers per 32-bit word
  using T = uint32_t;
  static __device__ __forceinline__ T ident() { return 0x80808080u; }
  static __device__ __forceinline__ void update(T* a, T v) {
    T old = *reinterpret_cast<volatile T*>(a);
    while (true) {
      // registers only grow, so a word that already holds the max needs
      // no write even if the read was stale
      const T next = __vmaxs4(old, v);
      if (next == old) return;
      const T seen = atomicCAS(a, old, next);
      if (seen == old) return;
      old = seen;
    }
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
block_prop_kernel(const typename Op::T* __restrict__ rows,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dstl,
                  const int64_t* __restrict__ blk_ptr,
                  typename Op::T* __restrict__ out,
                  int64_t num_rows, int words, int block_rows) {
  using T = typename Op::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);
  const int tile = block_rows * words;
  for (int i = threadIdx.x; i < tile; i += kThreads) acc[i] = Op::ident();
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t e0 = blk_ptr[blockIdx.x];
  const int64_t e1 = blk_ptr[blockIdx.x + 1];
  // warp w takes edges [base, base + 32) with base = e0 + 32 w, then steps
  // over the other warps' chunks: together the warps walk the src-sorted
  // edges front to back
  for (int64_t base = e0 + warp * kWarp; base < e1; base += kThreads) {
    const int n = e1 - base < kWarp ? static_cast<int>(e1 - base) : kWarp;
    const int32_t my_src = lane < n ? src[base + lane] : 0;
    const int32_t my_dst = lane < n ? dstl[base + lane] : 0;
    for (int j = 0; j < n; ++j) {
      const T* r = rows + static_cast<int64_t>(__shfl_sync(kFull, my_src, j)) * words;
      T* a = acc + __shfl_sync(kFull, my_dst, j) * words;
      T v[kMaxWordsPerLane];
#pragma unroll
      for (int k = 0; k < kMaxWordsPerLane; ++k) {   // all loads first
        const int c = lane + k * kWarp;
        if (c < words) v[k] = __ldg(r + c);
      }
#pragma unroll
      for (int k = 0; k < kMaxWordsPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c < words) Op::update(a + c, v[k]);
      }
    }
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_rows;
  const int64_t left = num_rows - row0;
  const int rows_here = left < block_rows ? static_cast<int>(left) : block_rows;
  for (int i = threadIdx.x; i < rows_here * words; i += kThreads) {
    out[row0 * words + i] = acc[i];
  }
}

template <class Op>
int launch(const void* rows, const void* src, const void* dstl,
           const void* blk_ptr, void* out, int64_t num_rows, int64_t words,
           int64_t block_rows, void* stream) {
  using T = typename Op::T;
  if (words < 1 || words > kWarp * kMaxWordsPerLane || block_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows > 0) {
    const size_t tile_bytes = static_cast<size_t>(block_rows) * words * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        block_prop_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks =
        static_cast<unsigned>((num_rows + block_rows - 1) / block_rows);
    block_prop_kernel<Op>
        <<<blocks, kThreads, tile_bytes, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(rows), static_cast<const int32_t*>(src),
            static_cast<const int32_t*>(dstl),
            static_cast<const int64_t*>(blk_ptr), static_cast<T*>(out),
            num_rows, static_cast<int>(words), static_cast<int>(block_rows));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows/out [num_rows, words] 32-bit words (W for int32, W / 4 for int8);
// src/dstl int32 [E + N] sorted by (block, src); blk_ptr int64
// [ceil(num_rows / block_rows) + 1].

int block_prop_min_i32(const void* rows, const void* src, const void* dstl,
                       const void* blk_ptr, void* out, int64_t num_rows,
                       int64_t words, int64_t block_rows, void* stream) {
  return launch<MinI32>(rows, src, dstl, blk_ptr, out, num_rows, words,
                        block_rows, stream);
}

int block_prop_max_i8(const void* rows, const void* src, const void* dstl,
                      const void* blk_ptr, void* out, int64_t num_rows,
                      int64_t words, int64_t block_rows, void* stream) {
  return launch<MaxI8x4>(rows, src, dstl, blk_ptr, out, num_rows, words,
                         block_rows, stream);
}

}  // extern "C"
