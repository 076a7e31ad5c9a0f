// K1: the sorted-segment merge of the padded-tree plan, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// subgraph_sketching_tpu/ops/pallas_segscan.py (_segscan_totals, with the
// glue segment_aggregates / sorted_segment_combine).  That kernel runs a
// forward segmented scan over the [S, W] sub-run results in one sequential
// grid sweep with a VMEM carry, writes an [S, W] totals array and gathers
// each run's last slot.  Here the plan's sub-run pointer (ptr = sub_starts,
// [N + 1]) gives each destination's range, and
//
//   min / max:  out[n, :] = op(x[n, :], op_{s in [ptr[n], ptr[n+1])} v[s, :])
//   add:        out[n, :] =              sum_{s in [ptr[n], ptr[n+1])} v[s, :]
//
// (an empty range leaves x[n] for min/max and 0 for add).
//
// Design (merge_path.cuh): the N row ends and the S sub-run rows form one
// merge path of N + S steps, cut into shares of kShareSteps; a team of 32
// lanes (16 for rows of at most 16 units, so int8 W=256 runs two teams a
// warp) walks one share, writes the rows that end in it, and leaves the
// open row's partial as a carry-out; a second launch folds each row's
// carry-outs into out in share order.  x is folded once, by the share
// that ends the row.  A share's v is one contiguous slab v[j0:j1], read as
// 16-byte units when rows are a multiple of 16 bytes (int32/float32
// W=128, int8 W=256) and as 32-bit words otherwise (int32 W=40, int8 W=8,
// W=1), by the same kernel.  The slab is read straight into registers,
// kUnroll rows of loads at a time, not through a TMA or cp.async ring: a
// share is short (64 steps: about 30 rows and 34 sub-runs on the main
// path's sketch plan), a row's sub-runs are loaded together while the
// next row's x is loaded ahead, and tens of resident teams per SM keep
// more bytes in flight than the memory system needs.  Of 32 to 256 steps
// a share, 64 was the fastest or near it on the H100 at every instance
// and shape (128 loses at int8, 256 at the main path).
//
// Bound: HBM bytes.  It reads v once (S*W*b), x once (N*W*b, min/max only)
// and the pointer (N+1 int64), and writes out once (N*W*b); one combine per
// element read.  The partition adds the search's few rounds of pointer
// loads per share and one carry-out row per share that ends inside a row
// (written and read once: ~1-3% of the bytes at 64 steps a share and
// 512-byte rows).  A hub's sub-runs are spread over ceil(its steps / 64) shares, so
// its time is its bytes at the card's rate plus the carry pass over its
// ~S_hub/64 carry-outs, no longer one warp walking the whole run.
//
// bfloat16 add (the bfloat16 compute dtype of training: the SpMMs and the
// row-gather backwards, JAX `--dtype bfloat16`; the TPU kernel took float32
// add only, so the JAX package sums bfloat16 by XLA).  It reads bfloat16
// and sums in float32: a share's rows and carry-outs are float32, and a
// row is rounded to bfloat16 once, on its store (__float2bfloat16_rn).  A
// row split across shares is finished by the carry pass: the share that
// ends it leaves its part as a float32 head, and the carry pass adds the
// head and the row's carry-outs (in share order) before the one rounding.
// So the result is sum-then-round, as the plain version computes it, and
// does not depend on where the shares cut a hub beyond float32 order.
// Rows of a multiple of 8 elements (16 bytes) are read as 16-byte units,
// eight float32 sums a lane; other widths (DGCNN's last layer, W = 1) as
// one 16-bit element a lane, so no width is refused and nothing is padded.
// Its scratch is float32: carry [2 shares, W] (carry-outs, then heads).
// Bound: HBM bytes, S*W*2 read + N*W*2 written + 8(N+1), plus the float32
// carry-outs and heads (two rows per share that a row crosses).
//
// Plain C interface (ctypes): each entry point launches both kernels on
// the given stream, allocates nothing (the caller passes carry [shares,
// words] and carry_row [shares]), and returns the first cudaError.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace merge_path {

// float64 add, for the float64 reference runs of training: a 16-byte unit
// holds two float64 lanes (low word first), so it is combined as a pair
// and never word by word.
struct AddF64 {
  static constexpr uint32_t kIdent = 0u;   // +0.0 in both words
};

template <>
__device__ __forceinline__ uint4 combine<AddF64>(uint4 a, uint4 b) {
  const double s0 = __hiloint2double(static_cast<int>(a.y),
                                     static_cast<int>(a.x)) +
                    __hiloint2double(static_cast<int>(b.y),
                                     static_cast<int>(b.x));
  const double s1 = __hiloint2double(static_cast<int>(a.w),
                                     static_cast<int>(a.z)) +
                    __hiloint2double(static_cast<int>(b.w),
                                     static_cast<int>(b.z));
  return make_uint4(static_cast<uint32_t>(__double2loint(s0)),
                    static_cast<uint32_t>(__double2hiint(s0)),
                    static_cast<uint32_t>(__double2loint(s1)),
                    static_cast<uint32_t>(__double2hiint(s1)));
}

// bfloat16 add, summed in float32.  Its units: uint4 (eight bfloat16,
// summed as an F8 of float32, merge_path.cuh) or uint16_t (one bfloat16,
// summed as a float).
struct AddBF16 {
  static constexpr uint32_t kIdent = 0u;   // +0.0f
};

__device__ __forceinline__ float bf16_to_float(uint32_t bits16) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(bits16)));
}

__device__ __forceinline__ uint32_t float_to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <>
struct Accum<AddBF16, uint4> {
  using A = F8;
  static constexpr bool kWide = true;
  static __device__ __forceinline__ F8 widen(uint4 u) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    F8 r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // element 2k in the low half
      r.v[2 * k] = bf16_to_float(w[k] & 0xffffu);
      r.v[2 * k + 1] = bf16_to_float(w[k] >> 16);
    }
    return r;
  }
  static __device__ __forceinline__ uint4 narrow(const F8& a) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = float_to_bf16(a.v[2 * k]) | (float_to_bf16(a.v[2 * k + 1]) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Accum<AddBF16, uint16_t> {
  using A = float;
  static constexpr bool kWide = true;
  static __device__ __forceinline__ float widen(uint16_t u) {
    return bf16_to_float(u);
  }
  static __device__ __forceinline__ uint16_t narrow(float a) {
    return static_cast<uint16_t>(float_to_bf16(a));
  }
};

}  // namespace merge_path

namespace {

using namespace merge_path;

// Ops whose lanes span two 32-bit words combine whole 16-byte units only.
template <class Op>
constexpr bool kUnitsOnly = false;
template <>
constexpr bool kUnitsOnly<AddF64> = true;

constexpr int kShareSteps = 64;   // merge-path steps (rows + items) a team

template <class Op, class U, int T, bool kFoldSelf>
__global__ void __launch_bounds__(kBlock)
segscan_kernel(const U* __restrict__ v, const U* __restrict__ x,
               const int64_t* __restrict__ ptr, U* __restrict__ out,
               typename Accum<Op, U>::A* __restrict__ carry,
               int64_t* __restrict__ carry_row, int64_t num_rows,
               int64_t num_items, int64_t units, int64_t shares) {
  const Team<T> t;
  if (t.id >= shares) return;   // uniform across the team
  const Share s = find_share<T, kShareSteps>(t, ptr, num_rows, num_items);
  walk_share<Op, U, T, kFoldSelf>(t, s, ptr, x, out, carry, carry_row,
                                  num_rows, units, shares,
                                  RowLoad<U>{v, units});
}

template <class Op, bool kFoldSelf, class U, int T>
cudaError_t run(const void* v, const void* x, const void* ptr, void* out,
                void* carry, void* carry_row, int64_t num_rows,
                int64_t num_items, int64_t units, int64_t shares,
                cudaStream_t stream) {
  using A = typename Accum<Op, U>::A;
  const dim3 grid = grid_for<T>(shares, units);
  segscan_kernel<Op, U, T, kFoldSelf><<<grid, kBlock, 0, stream>>>(
      static_cast<const U*>(v), static_cast<const U*>(x),
      static_cast<const int64_t*>(ptr), static_cast<U*>(out),
      static_cast<A*>(carry), static_cast<int64_t*>(carry_row), num_rows,
      num_items, units, shares);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<Op, U, T><<<grid, kBlock, 0, stream>>>(
      static_cast<const A*>(carry), static_cast<const int64_t*>(carry_row),
      static_cast<U*>(out), units, shares);
  return cudaGetLastError();
}

template <class Op, bool kFoldSelf>
int launch(const void* v, const void* x, const void* ptr, void* out,
           void* carry, void* carry_row, int64_t num_rows, int64_t num_items,
           int64_t words, int64_t shares, void* stream) {
  if (num_rows <= 0 || words <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (num_items < 0 || shares != num_shares(num_rows, num_items, kShareSteps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = words % 4 == 0 && aligned16(v) && aligned16(out) &&
                   aligned16(carry) && (!kFoldSelf || aligned16(x));
  const int64_t units = vec ? words / 4 : words;
  cudaError_t err;
  if (vec) {
    err = units <= 16
        ? run<Op, kFoldSelf, uint4, 16>(v, x, ptr, out, carry, carry_row,
                                        num_rows, num_items, units, shares, st)
        : run<Op, kFoldSelf, uint4, 32>(v, x, ptr, out, carry, carry_row,
                                        num_rows, num_items, units, shares, st);
  } else if constexpr (kUnitsOnly<Op>) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    err = units <= 16
        ? run<Op, kFoldSelf, uint32_t, 16>(v, x, ptr, out, carry, carry_row,
                                           num_rows, num_items, units, shares,
                                           st)
        : run<Op, kFoldSelf, uint32_t, 32>(v, x, ptr, out, carry, carry_row,
                                           num_rows, num_items, units, shares,
                                           st);
  }
  return static_cast<int>(err);
}

// The bfloat16 add: `width` bfloat16 elements a row; 16-byte units when
// the width is a multiple of 8 and v, out and carry are 16-byte aligned,
// else one element a lane.  carry is float32 [2 shares, width].
int launch_add_bf16(const void* v, const void* ptr, void* out, void* carry,
                    void* carry_row, int64_t num_rows, int64_t num_items,
                    int64_t width, int64_t shares, void* stream) {
  if (num_rows <= 0 || width <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (num_items < 0 || shares != num_shares(num_rows, num_items, kShareSteps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = width % 8 == 0 && aligned16(v) && aligned16(out) &&
                   aligned16(carry);
  const int64_t units = vec ? width / 8 : width;
  cudaError_t err;
  if (vec) {
    err = units <= 16
        ? run<AddBF16, false, uint4, 16>(v, nullptr, ptr, out, carry,
                                         carry_row, num_rows, num_items,
                                         units, shares, st)
        : run<AddBF16, false, uint4, 32>(v, nullptr, ptr, out, carry,
                                         carry_row, num_rows, num_items,
                                         units, shares, st);
  } else {
    err = units <= 16
        ? run<AddBF16, false, uint16_t, 16>(v, nullptr, ptr, out, carry,
                                            carry_row, num_rows, num_items,
                                            units, shares, st)
        : run<AddBF16, false, uint16_t, 32>(v, nullptr, ptr, out, carry,
                                            carry_row, num_rows, num_items,
                                            units, shares, st);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The merge-path steps of one share: the caller sizes the scratch as
// ceil((num_rows + num_items) / segscan_share_steps()) rows.
int64_t segscan_share_steps() { return kShareSteps; }

// v [num_items, words], x / out [num_rows, words] in 32-bit words (W for
// 4-byte types, W / 4 for int8), ptr int64 [num_rows + 1], carry [shares,
// words], carry_row int64 [shares].

int segscan_min_i32(const void* v, const void* x, const void* ptr, void* out,
                    void* carry, void* carry_row, int64_t num_rows,
                    int64_t num_items, int64_t words, int64_t shares,
                    void* stream) {
  return launch<MinI32, true>(v, x, ptr, out, carry, carry_row, num_rows,
                              num_items, words, shares, stream);
}

int segscan_max_i32(const void* v, const void* x, const void* ptr, void* out,
                    void* carry, void* carry_row, int64_t num_rows,
                    int64_t num_items, int64_t words, int64_t shares,
                    void* stream) {
  return launch<MaxI32, true>(v, x, ptr, out, carry, carry_row, num_rows,
                              num_items, words, shares, stream);
}

int segscan_max_i8(const void* v, const void* x, const void* ptr, void* out,
                   void* carry, void* carry_row, int64_t num_rows,
                   int64_t num_items, int64_t words, int64_t shares,
                   void* stream) {
  return launch<MaxI8x4, true>(v, x, ptr, out, carry, carry_row, num_rows,
                               num_items, words, shares, stream);
}

int segscan_add_f32(const void* v, const void* x, const void* ptr, void* out,
                    void* carry, void* carry_row, int64_t num_rows,
                    int64_t num_items, int64_t words, int64_t shares,
                    void* stream) {
  (void)x;
  return launch<AddF32, false>(v, nullptr, ptr, out, carry, carry_row,
                               num_rows, num_items, words, shares, stream);
}

// float64 add: words = 2 W, and rows must be whole 16-byte units (W even,
// 16-byte aligned), else cudaErrorInvalidValue.
int segscan_add_f64(const void* v, const void* x, const void* ptr, void* out,
                    void* carry, void* carry_row, int64_t num_rows,
                    int64_t num_items, int64_t words, int64_t shares,
                    void* stream) {
  (void)x;
  return launch<AddF64, false>(v, nullptr, ptr, out, carry, carry_row,
                               num_rows, num_items, words, shares, stream);
}

// bfloat16 add, summed in float32: `words` is the row's width W in
// bfloat16 elements (any W), and carry is float32 [2 shares, W].
int segscan_add_bf16(const void* v, const void* x, const void* ptr, void* out,
                     void* carry, void* carry_row, int64_t num_rows,
                     int64_t num_items, int64_t words, int64_t shares,
                     void* stream) {
  (void)x;
  return launch_add_bf16(v, ptr, out, carry, carry_row, num_rows, num_items,
                         words, shares, stream);
}

}  // extern "C"
