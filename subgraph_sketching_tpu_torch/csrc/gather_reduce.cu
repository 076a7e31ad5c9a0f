// K3: fused row gather and segmented min/max over dst-sorted edges, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel studies/pallas_gather_reduce.py
// (gather_reduce, body _reduce_kernel).  That kernel walks the dst-sorted
// edge list in one sequential grid sweep, keeps a DMA_DEPTH-deep pipeline
// of single-row copies in flight and a one-row VMEM accumulator for the
// current destination, and writes into an output aliased to the input
// rows.  Hopper has no sequential grid and no scalar DMA engine, so here
// every destination row is reduced on its own from its edge range:
//
//   out[v, :] = op(rows[v, :], op_{e in [ptr[v], ptr[v+1])} rows[src[e], :])
//
// with ptr the per-destination edge pointer that the host derives from the
// dst-sorted edges (studies/gather_reduce.py prepare_csr_edges).  The
// output is a separate buffer: the gathers read neighbours' input rows
// while other warps write their own results.
//
// Bound: HBM bytes at best (rows read once, out written once, src and ptr
// read once), but every edge gathers one whole row, E*W*b bytes that come
// from L2 when the table fits there and from HBM when it does not.  Layout:
// one warp per destination row, lanes across the row's 32-bit words, so a
// gathered row is read as contiguous 128-byte segments; each lane fetches
// 32 edges' sources in one load and the warp broadcasts them with shuffles;
// four edges are gathered before they are combined, to keep loads in
// flight.  int8 rows are combined four lanes at a time with the byte-SIMD
// __vmaxs4 on 32-bit words.  A hub serialises on its one warp.
//
// Plain C interface (ctypes): each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;      // one warp per destination row
constexpr int kMaxWordsPerLane = 4;   // rows of up to 128 32-bit words
constexpr unsigned kFull = 0xffffffffu;

struct MinI32 {   // uint32 min carried as biased int32
  using T = int32_t;
  static __device__ __forceinline__ T ident() { return INT_MAX; }
  static __device__ __forceinline__ T combine(T a, T b) { return min(a, b); }
};

struct MaxI8x4 {  // four int8 lanes per 32-bit word
  using T = uint32_t;
  static __device__ __forceinline__ T ident() { return 0x80808080u; }
  static __device__ __forceinline__ T combine(T a, T b) {
    return __vmaxs4(a, b);
  }
};

template <class Op>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_reduce_kernel(const typename Op::T* __restrict__ rows,
                     const int32_t* __restrict__ src,
                     const int64_t* __restrict__ ptr,
                     typename Op::T* __restrict__ out,
                     int64_t num_rows, int words) {
  using T = typename Op::T;
  const int lane = threadIdx.x;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (row >= num_rows) return;   // uniform across the warp

  T acc[kMaxWordsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxWordsPerLane; ++k) {
    const int c = lane + k * kWarp;
    acc[k] = c < words ? rows[row * words + c] : Op::ident();
  }
  const int64_t e0 = ptr[row];
  const int64_t e1 = ptr[row + 1];
  for (int64_t base = e0; base < e1; base += kWarp) {
    const int n = e1 - base < kWarp ? static_cast<int>(e1 - base) : kWarp;
    const int32_t mine = lane < n ? src[base + lane] : 0;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      const T* r0 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j)) * words;
      const T* r1 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j + 1)) * words;
      const T* r2 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j + 2)) * words;
      const T* r3 = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j + 3)) * words;
#pragma unroll
      for (int k = 0; k < kMaxWordsPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c < words) {
          const T a = __ldg(r0 + c), b = __ldg(r1 + c);
          const T d = __ldg(r2 + c), f = __ldg(r3 + c);
          acc[k] = Op::combine(acc[k], Op::combine(Op::combine(a, b),
                                                   Op::combine(d, f)));
        }
      }
    }
    for (; j < n; ++j) {
      const T* r = rows + static_cast<int64_t>(__shfl_sync(kFull, mine, j)) * words;
#pragma unroll
      for (int k = 0; k < kMaxWordsPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c < words) acc[k] = Op::combine(acc[k], __ldg(r + c));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxWordsPerLane; ++k) {
    const int c = lane + k * kWarp;
    if (c < words) out[row * words + c] = acc[k];
  }
}

template <class Op>
int launch(const void* rows, const void* src, const void* ptr, void* out,
           int64_t num_rows, int64_t words, void* stream) {
  using T = typename Op::T;
  if (words < 1 || words > kWarp * kMaxWordsPerLane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows > 0) {
    const dim3 block(kWarp, kRowsPerBlock);
    const dim3 grid(
        static_cast<unsigned>((num_rows + kRowsPerBlock - 1) / kRowsPerBlock));
    gather_reduce_kernel<Op>
        <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(rows), static_cast<const int32_t*>(src),
            static_cast<const int64_t*>(ptr), static_cast<T*>(out), num_rows,
            static_cast<int>(words));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows/out [num_rows, words] 32-bit words (W for int32, W / 4 for int8),
// src int32 [E], ptr int64 [num_rows + 1].

int gather_reduce_min_i32(const void* rows, const void* src, const void* ptr,
                          void* out, int64_t num_rows, int64_t words,
                          void* stream) {
  return launch<MinI32>(rows, src, ptr, out, num_rows, words, stream);
}

int gather_reduce_max_i8(const void* rows, const void* src, const void* ptr,
                         void* out, int64_t num_rows, int64_t words,
                         void* stream) {
  return launch<MaxI8x4>(rows, src, ptr, out, num_rows, words, stream);
}

}  // extern "C"
