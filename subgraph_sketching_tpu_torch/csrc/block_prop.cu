// K2: block-accumulator sketch propagation, for Hopper (sm_90a).
//
// Replaces the Pallas kernel studies/pallas_sketch_prop.py (_block_prop,
// body _block_prop_kernel).  That kernel partitions the destinations into
// blocks of NB = 4096 rows, keeps one block's running min/max in a 2 MB
// VMEM accumulator, and streams the block's edges (self-loops included,
// sorted by (dst block, src)) through a sequential grid, loading source
// rows in 512-row chunks with a prefetched second buffer and flushing the
// accumulator when the block changes.  Here the function is the same:
//
//   out[v, :] = op over the edges (s, v), self-loops included, of rows[s, :]
//
// with the edges of destination block b given by the host layout
// (studies/sketch_prop.py prepare_block_edges: src, dstl = the row within
// the block, and the block pointer), and the block's rows accumulated in a
// shared-memory tile.  4096 rows do not fit the 227 KB a Hopper block may
// use, so a block is block_rows rows (studies/sketch_prop.py BLOCK_ROWS).
//
// What bounds it: every edge gathers one whole source row, (E + N)*W*b
// bytes from L2 or HBM (rows, out, src and dstl each touched once are the
// HBM bound), and updates one tile row in shared memory.  The first
// version (one CTA of 16 warps per block, one 4-byte word a lane per load)
// put a hub's whole block (50k edges at bench_hub) on one CTA while the
// grid waited, and kept one row in flight a warp.  The design:
//
// - Pieces.  Each block's edge range is cut into pieces of at most kSteps
//   edges (a table built once per graph on the host: studies/sketch_prop.py
//   block_pieces).  One CTA per piece.  A block of one piece writes its
//   tile straight to out; the pieces of a longer block write their tiles to
//   scratch, and a second short launch (fold_kernel) combines each such
//   block's tiles in piece order and writes the block: the carry pattern of
//   merge_path.cuh at tile granularity.  So a hub costs its bytes spread
//   over ~deg/kSteps CTAs.  Nothing crosses CTAs but those tiles.
// - Bytes in flight.  A team of T lanes (T = 32, or 16 for rows of at most
//   16 units) reads one source row as 16-byte units (uint4) where the row's
//   bytes are a multiple of 16, as 32-bit words otherwise; each team loads
//   the rows of kRows (8) edges before it updates the tile with any of
//   them: 4 KB a warp in flight at 512-byte rows, 32 KB a CTA, 4 CTAs an
//   SM.  The piece's src and dstl are staged in shared memory once, so no
//   gather waits on an index load.  Rows wider than T units take more grid
//   rows (blockIdx.y), each with its own column slice of the tile.
// - The tile.  Word k of lane l's unit of tile row r lies at word
//   r*T*kWords + k*T + l, so a team's update of one word touches T
//   consecutive words (no bank conflict); the two 16-lane teams of a warp
//   take a unit's words in opposite order, so they touch different banks.
//   Two teams may hold edges of one destination row, so updates are
//   shared-memory atomics: int32 min (biased MinHash) is a plain atomicMin,
//   issued for every word (its result is not waited for; reading the word
//   first to skip it cost more than it saved on the H100); int8 HLL
//   registers stay int8, four to a word, and each word is read, merged with
//   the byte-SIMD __vmaxs4 and written by an atomicCAS loop only where a
//   register grew (rare once a row has seen a few edges).  On the H100 the
//   time follows the shared-memory operations per edge, not their kind:
//   reading a unit's four words together before their CAS loops made the
//   HLL hop several times slower, and widening HLL registers to int32 for a
//   plain atomicMax each (four times the operations) was no faster.  A
//   variant with no atomics at all (each warp owning a column slice of
//   every row and walking every edge, lanes of one row merged by
//   __match_any_sync) was slower at both study shapes: its per-step
//   shuffles and the dependent load and store of each update cost more than
//   the atomics they replace.
// - Order.  Inside a block the edges stay sorted by src, and the teams of a
//   CTA take consecutive groups of kRows edges: the CTAs that run together
//   walk src upward together, so the rows they gather overlap in L2, which
//   is what the TPU kernel bought with chunk streaming.
//
// Plain C interface (ctypes): each entry point launches one kernel on the
// given stream, allocates nothing (the caller passes the scratch), and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

using merge_path::MaxI8x4;
using merge_path::MinI32;
using merge_path::RowLoad;
using merge_path::aligned16;
using merge_path::splat;

constexpr int kSteps = 2048;        // edges of one piece at most
constexpr int kThreads = 256;
constexpr int kRows = 8;            // edges whose rows a team loads at once
constexpr int kMaxWords = 128;      // the study's widest row
constexpr int kMaxBlockRows = 256;  // a tile of at most 128 KB

template <class U>
struct Unit;

template <>
struct Unit<uint32_t> {
  static constexpr int kWords = 1;
  static __device__ __forceinline__ uint32_t word(uint32_t u, int) { return u; }
  template <int T>
  static __device__ __forceinline__ uint32_t gather(const uint32_t* p) {
    return p[0];
  }
};

template <>
struct Unit<uint4> {
  static constexpr int kWords = 4;
  static __device__ __forceinline__ uint32_t word(const uint4& u, int k) {
    return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  }
  template <int T>
  static __device__ __forceinline__ uint4 gather(const uint32_t* p) {
    return make_uint4(p[0], p[T], p[2 * T], p[3 * T]);
  }
};

// op(tile, v) for one unit v whose word k lies at a[k * T], in the word
// order given by flip; other teams update the same words.
template <class Op, class U, int T>
struct Update;

template <class U, int T>
struct Update<MinI32, U, T> {
  static __device__ __forceinline__ void run(uint32_t* a, const U& v,
                                             int flip) {
#pragma unroll
    for (int w = 0; w < Unit<U>::kWords; ++w) {
      const int k = w ^ flip;
      atomicMin(reinterpret_cast<int*>(a + k * T),
                static_cast<int>(Unit<U>::word(v, k)));
    }
  }
};

template <class U, int T>
struct Update<MaxI8x4, U, T> {
  static __device__ __forceinline__ void run(uint32_t* a, const U& v,
                                             int flip) {
#pragma unroll
    for (int w = 0; w < Unit<U>::kWords; ++w) {
      const int k = w ^ flip;
      const uint32_t x = Unit<U>::word(v, k);
      uint32_t old = *reinterpret_cast<volatile uint32_t*>(a + k * T);
      while (true) {
        // registers only grow, so a word that already holds the max needs
        // no write even if the read was stale
        const uint32_t next = __vmaxs4(old, x);
        if (next == old) break;
        const uint32_t seen = atomicCAS(a + k * T, old, next);
        if (seen == old) break;
        old = seen;
      }
    }
  }
};

template <class U, int T>
size_t smem_bytes(int block_rows) {
  return 2 * kSteps * sizeof(int32_t) + static_cast<size_t>(block_rows) * T *
                                            Unit<U>::kWords * sizeof(uint32_t);
}

// One CTA per piece: its edges' rows op-ed into the block's tile, which
// goes to out (a block of one piece) or to the piece's scratch tile.
template <class Op, class U, int T>
__global__ void __launch_bounds__(kThreads, 4)
block_prop_kernel(const U* __restrict__ rows, const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dstl,
                  const int64_t* __restrict__ piece_ptr,
                  const int32_t* __restrict__ piece_blk,
                  const int32_t* __restrict__ piece_slot, U* __restrict__ out,
                  U* __restrict__ scratch, int64_t num_rows, int64_t units,
                  int block_rows) {
  constexpr int kW = Unit<U>::kWords;
  constexpr int kTeams = kThreads / T;
  constexpr int kRowWords = T * kW;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_src = reinterpret_cast<int32_t*>(smem);
  int32_t* s_dst = s_src + kSteps;
  uint32_t* tile = reinterpret_cast<uint32_t*>(s_dst + kSteps);

  const int64_t p = blockIdx.x;
  const int64_t e0 = piece_ptr[p];
  const int n = static_cast<int>(piece_ptr[p + 1] - e0);
  for (int i = threadIdx.x; i < block_rows * kRowWords; i += kThreads) {
    tile[i] = Op::kIdent;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_src[i] = __ldg(src + e0 + i);
    s_dst[i] = __ldg(dstl + e0 + i);
  }
  __syncthreads();

  const int lane = threadIdx.x % T;
  const int64_t c = static_cast<int64_t>(blockIdx.y) * T + lane;
  const bool active = c < units;
  const int64_t col = active ? c : 0;
  const int flip = T == 16 && kW > 1 ? (threadIdx.x >> 4) & 1 : 0;
  // team t takes edges [g, g + kRows) for g = kRows * t, then steps over
  // the other teams' groups: together they walk the src-sorted piece
  for (int g = threadIdx.x / T * kRows; g < n; g += kTeams * kRows) {
    U v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {   // every row in flight first
      v[k] = g + k < n
          ? __ldg(rows + static_cast<int64_t>(s_src[g + k]) * units + col)
          : splat<U>(Op::kIdent);
    }
    if (!active) continue;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (g + k >= n) break;
      Update<Op, U, T>::run(tile + s_dst[g + k] * kRowWords + lane, v[k],
                            flip);
    }
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(piece_blk[p]) * block_rows;
  const int64_t left = num_rows - row0;
  const int rows_here = left < block_rows ? static_cast<int>(left) : block_rows;
  const int32_t slot = piece_slot[p];
  U* dest = slot < 0 ? out + row0 * units
                     : scratch + static_cast<int64_t>(slot) * block_rows * units;
  for (int i = threadIdx.x; i < rows_here * T; i += kThreads) {
    const int r = i / T;
    const int l = i % T;
    const int64_t cc = static_cast<int64_t>(blockIdx.y) * T + l;
    if (cc < units) {
      dest[r * units + cc] =
          Unit<U>::template gather<T>(tile + r * kRowWords + l);
    }
  }
}

// The second launch: fold m combines the scratch tiles
// [fold_ptr[m], fold_ptr[m + 1]) of block fold_blk[m] in piece order, one
// thread per unit of the block, and writes the block's rows of out.
template <class Op, class U>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const U* __restrict__ scratch, const int32_t* __restrict__ fold_ptr,
            const int32_t* __restrict__ fold_blk, U* __restrict__ out,
            int64_t num_rows, int64_t units, int block_rows) {
  const int64_t m = blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(fold_blk[m]) * block_rows;
  const int64_t left = num_rows - row0;
  const int64_t rows_here = left < block_rows ? left : block_rows;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (i >= rows_here * units) return;
  const int64_t r = i / units;
  const int64_t c = i % units;
  // tile s's unit (r, c) is scratch[(s * block_rows + r) * units + c]
  out[(row0 + r) * units + c] = merge_path::fold<Op, U>(
      splat<U>(Op::kIdent), fold_ptr[m], fold_ptr[m + 1], c,
      RowLoad<U>{scratch + r * units, block_rows * units});
}

template <class Op, class U, int T>
cudaError_t run(const void* rows, const void* src, const void* dstl,
                const void* piece_ptr, const void* piece_blk,
                const void* piece_slot, void* out, void* scratch,
                int64_t num_rows, int64_t num_pieces, int64_t units,
                int block_rows, cudaStream_t stream) {
  const size_t smem = smem_bytes<U, T>(block_rows);
  const cudaError_t err = cudaFuncSetAttribute(
      block_prop_kernel<Op, U, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(num_pieces),
                  static_cast<unsigned>((units + T - 1) / T));
  block_prop_kernel<Op, U, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const U*>(rows), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(dstl),
      static_cast<const int64_t*>(piece_ptr),
      static_cast<const int32_t*>(piece_blk),
      static_cast<const int32_t*>(piece_slot), static_cast<U*>(out),
      static_cast<U*>(scratch), num_rows, units, block_rows);
  return cudaGetLastError();
}

template <class Op>
int launch(const void* rows, const void* src, const void* dstl,
           const void* piece_ptr, const void* piece_blk,
           const void* piece_slot, void* out, void* scratch, int64_t num_rows,
           int64_t num_pieces, int64_t words, int64_t block_rows,
           int64_t steps, void* stream) {
  if (words < 1 || words > kMaxWords || block_rows < 1 ||
      block_rows > kMaxBlockRows || steps != kSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows <= 0 || num_pieces <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int br = static_cast<int>(block_rows);
  const bool vec = words % 4 == 0 && aligned16(rows) && aligned16(out) &&
                   aligned16(scratch);
  const int64_t units = vec ? words / 4 : words;
  cudaError_t err;
  if (vec) {
    err = units <= 16
        ? run<Op, uint4, 16>(rows, src, dstl, piece_ptr, piece_blk, piece_slot,
                             out, scratch, num_rows, num_pieces, units, br, st)
        : run<Op, uint4, 32>(rows, src, dstl, piece_ptr, piece_blk, piece_slot,
                             out, scratch, num_rows, num_pieces, units, br, st);
  } else {
    err = units <= 16
        ? run<Op, uint32_t, 16>(rows, src, dstl, piece_ptr, piece_blk,
                                piece_slot, out, scratch, num_rows, num_pieces,
                                units, br, st)
        : run<Op, uint32_t, 32>(rows, src, dstl, piece_ptr, piece_blk,
                                piece_slot, out, scratch, num_rows, num_pieces,
                                units, br, st);
  }
  return static_cast<int>(err);
}

template <class Op, class U>
cudaError_t run_fold(const void* scratch, const void* fold_ptr,
                     const void* fold_blk, void* out, int64_t num_rows,
                     int64_t num_folds, int64_t units, int block_rows,
                     cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(num_folds),
                  static_cast<unsigned>((block_rows * units + kThreads - 1) /
                                        kThreads));
  fold_kernel<Op, U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(scratch), static_cast<const int32_t*>(fold_ptr),
      static_cast<const int32_t*>(fold_blk), static_cast<U*>(out), num_rows,
      units, block_rows);
  return cudaGetLastError();
}

template <class Op>
int launch_fold(const void* scratch, const void* fold_ptr,
                const void* fold_blk, void* out, int64_t num_rows,
                int64_t num_folds, int64_t words, int64_t block_rows,
                void* stream) {
  if (words < 1 || words > kMaxWords || block_rows < 1 ||
      block_rows > kMaxBlockRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rows <= 0 || num_folds <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int br = static_cast<int>(block_rows);
  const bool vec = words % 4 == 0 && aligned16(scratch) && aligned16(out);
  const cudaError_t err =
      vec ? run_fold<Op, uint4>(scratch, fold_ptr, fold_blk, out, num_rows,
                                num_folds, words / 4, br, st)
          : run_fold<Op, uint32_t>(scratch, fold_ptr, fold_blk, out, num_rows,
                                   num_folds, words, br, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The edges of one piece at most: the caller cuts the pieces with it
// (studies/sketch_prop.py block_pieces) and passes it back as `steps`.
int64_t block_prop_share_steps() { return kSteps; }

// rows/out [num_rows, words] 32-bit words (W for int32, W / 4 for int8);
// src/dstl int32 [E + N] sorted by (block, src); piece_ptr int64
// [num_pieces + 1], piece_blk and piece_slot int32 [num_pieces]; scratch
// [slots * block_rows, words].

int block_prop_min_i32(const void* rows, const void* src, const void* dstl,
                       const void* piece_ptr, const void* piece_blk,
                       const void* piece_slot, void* out, void* scratch,
                       int64_t num_rows, int64_t num_pieces, int64_t words,
                       int64_t block_rows, int64_t steps, void* stream) {
  return launch<MinI32>(rows, src, dstl, piece_ptr, piece_blk, piece_slot, out,
                        scratch, num_rows, num_pieces, words, block_rows, steps,
                        stream);
}

int block_prop_max_i8(const void* rows, const void* src, const void* dstl,
                      const void* piece_ptr, const void* piece_blk,
                      const void* piece_slot, void* out, void* scratch,
                      int64_t num_rows, int64_t num_pieces, int64_t words,
                      int64_t block_rows, int64_t steps, void* stream) {
  return launch<MaxI8x4>(rows, src, dstl, piece_ptr, piece_blk, piece_slot,
                         out, scratch, num_rows, num_pieces, words, block_rows,
                         steps, stream);
}

// scratch as above; fold_ptr int32 [num_folds + 1] (fold m's tiles),
// fold_blk int32 [num_folds].

int block_prop_fold_min_i32(const void* scratch, const void* fold_ptr,
                            const void* fold_blk, void* out, int64_t num_rows,
                            int64_t num_folds, int64_t words,
                            int64_t block_rows, void* stream) {
  return launch_fold<MinI32>(scratch, fold_ptr, fold_blk, out, num_rows,
                             num_folds, words, block_rows, stream);
}

int block_prop_fold_max_i8(const void* scratch, const void* fold_ptr,
                           const void* fold_blk, void* out, int64_t num_rows,
                           int64_t num_folds, int64_t words,
                           int64_t block_rows, void* stream) {
  return launch_fold<MaxI8x4>(scratch, fold_ptr, fold_blk, out, num_rows,
                              num_folds, words, block_rows, stream);
}

}  // extern "C"
