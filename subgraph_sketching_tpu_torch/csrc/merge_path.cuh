// Merge-path partition of a sorted segment reduction, shared by K1
// (segscan.cu) and K3 (gather_reduce.cu), for Hopper (sm_90a).
//
// Both kernels reduce rows of a CSR-like layout: row r owns the items
// [ptr[r], ptr[r + 1]) (K1: sub-run rows of v; K3: dst-sorted edges, each
// a gathered row), and the result is
//
//   out[r] = op(self[r], op over its items)     (min / max; self = x or rows)
//   out[r] = sum over its items, 0 when empty   (add)
//
// The merge path of Merrill & Garland ("Merge-based Parallel Sparse
// Matrix-Vector Multiplication", SC16) walks the row ends ptr[1..N] and the
// item indices 0..S-1 in one sorted order: N + S steps.  A team of T lanes
// (T = 32 or 16, so one warp or half of one) takes a share of kShareSteps
// consecutive steps, whatever the rows' lengths, so a hub costs its bytes
// and no longer holds one warp for its whole run.  A team finds its share's
// two ends by a search of ptr on the device (each half-team runs a
// (T/2)-way search of one end; about five rounds of loads at 200k rows): no
// host table per call, no host sync.  It then walks its share row by row:
// every row whose end lies in the share is reduced whole and written
// (self folded in exactly once, here, for min/max); the items of the row
// still open at the share's end are reduced into a carry-out, one row of
// scratch per share, with that row's id (or -1 when the share holds none
// of its items).  A second short launch combines each run of carry-outs
// of one row in share order and folds the result into out: no atomics on
// values, so min/max are bit-equal to any order and the float32 add is the
// same bit for bit from run to run (its order depends only on ptr and the
// grid).  The carry-out plays the part of the TPU kernel's VMEM carry.
//
// Row layout: a row is `units` units; a unit is 16 bytes (uint4) when the
// row's bytes are a multiple of 16 and every row pointer is 16-byte
// aligned, else one 32-bit word.  Lane l of a team holds unit
// blockIdx.y * T + l, so one warp instruction reads 512 contiguous bytes of
// a row (a whole int32/float32 W=128 row, or two int8 W=256 rows for the
// two 16-lane teams of a warp).  Wider rows take more grid rows
// (blockIdx.y), each walking the same shares over its own columns.  int8
// rows are combined four bytes at a time with the byte-SIMD __vmaxs4.
// Lanes past the row's end load column 0 and store nothing.
//
// Loads in flight: each lane issues kUnroll independent loads of one unit
// before it combines them (a tree, in a fixed order), the next row's own
// row (self) is loaded one row ahead, and a team's row ends come from one
// load per lane per T rows, shuffled: a row then waits on its data, not on
// its pointer.  Registers and occupancy (tens of teams per
// SM) keep tens of KB per SM in flight, above the ~17 KB that Little's law
// asks at 3.35 TB/s and ~0.7 us across 132 SMs, without a shared-memory
// ring.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace merge_path {

constexpr int kBlock = 256;   // threads per CTA
constexpr int kWarp = 32;
constexpr int kUnroll = 8;    // independent unit loads per lane before a combine

// ---- the combines, on the 32-bit words of a row ----------------------------

struct MinI32 {   // uint32 min carried as biased int32
  static constexpr uint32_t kIdent = 0x7fffffffu;
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(min(static_cast<int32_t>(a),
                                     static_cast<int32_t>(b)));
  }
};

struct MaxI32 {
  static constexpr uint32_t kIdent = 0x80000000u;
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(max(static_cast<int32_t>(a),
                                     static_cast<int32_t>(b)));
  }
};

struct MaxI8x4 {  // four int8 lanes per 32-bit word
  static constexpr uint32_t kIdent = 0x80808080u;
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return __vmaxs4(a, b);
  }
};

struct AddF32 {
  static constexpr uint32_t kIdent = 0u;   // +0.0f
  static __device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
};

template <class Op>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return Op::op(a, b);
}

template <class Op>
__device__ __forceinline__ uint4 combine(uint4 a, uint4 b) {
  return make_uint4(Op::op(a.x, b.x), Op::op(a.y, b.y), Op::op(a.z, b.z),
                    Op::op(a.w, b.w));
}

// Float32 accumulators of an add that stores a narrower type (K1's
// bfloat16 add, segscan.cu, via Accum below): one float a lane, or an F8,
// the eight sums of a 16-byte unit of eight bfloat16.
struct __align__(16) F8 {
  float v[8];
};

template <class Op>
__device__ __forceinline__ float combine(float a, float b) {
  return a + b;
}

template <class Op>
__device__ __forceinline__ F8 combine(F8 a, F8 b) {
  F8 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = a.v[k] + b.v[k];
  return r;
}

template <class U>
__device__ __forceinline__ U splat(uint32_t w);

template <>
__device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t w) { return w; }

template <>
__device__ __forceinline__ uint4 splat<uint4>(uint32_t w) {
  return make_uint4(w, w, w, w);
}

template <>
__device__ __forceinline__ float splat<float>(uint32_t w) {
  return __uint_as_float(w);
}

template <>
__device__ __forceinline__ F8 splat<F8>(uint32_t w) {
  F8 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = __uint_as_float(w);
  return r;
}

// ---- accumulators -----------------------------------------------------------

// How an op sums the units it loads: by default in the unit itself.  An op
// that reads narrower data than it sums (segscan.cu's bfloat16 add, which
// sums in float32) specialises it: A is the accumulator, widen converts a
// loaded unit, narrow rounds a finished row once for its store, and kWide
// says that a row split across shares is finished in A: the share that
// ends it leaves its part as a "head" (scratch rows [shares, 2 shares) of
// carry) instead of storing it, and the carry pass combines the head with
// the row's carry-outs before the one rounding.
template <class Op, class U>
struct Accum {
  using A = U;
  static constexpr bool kWide = false;
  static __device__ __forceinline__ A widen(U u) { return u; }
  static __device__ __forceinline__ U narrow(A a) { return a; }
};

// ---- teams and shares -------------------------------------------------------

template <int T>
struct Team {
  static_assert(T == 16 || T == 32, "a team is a warp or half of one");
  static constexpr int kPerBlock = kBlock / T;
  int lane;       // 0 .. T-1
  int slot;       // the team's index in its CTA
  int64_t id;     // the team's index in the grid = its share
  unsigned mask;  // the team's lanes in its warp

  __device__ __forceinline__ Team()
      : lane(static_cast<int>(threadIdx.x) % T),
        slot(static_cast<int>(threadIdx.x) / T),
        id(static_cast<int64_t>(blockIdx.x) * kPerBlock +
           static_cast<int>(threadIdx.x) / T),
        mask(T == kWarp ? 0xffffffffu : 0xffffu << (threadIdx.x & 16)) {}

  // the team's bits of a ballot, lane 0 first
  __device__ __forceinline__ unsigned own(unsigned ballot) const {
    return (ballot & mask) >> (threadIdx.x & (kWarp - T));
  }
};

inline int64_t num_shares(int64_t num_rows, int64_t num_items, int steps) {
  return (num_rows + num_items + steps - 1) / steps;
}

// Rows whose end the merge path has passed after d steps (the split of
// diagonal d): the first i in [max(0, d - S), min(d, N)] with
// ptr[i + 1] > d - i - 1, i.e. row i's end comes after item d - i - 1.
// Run by the H lanes of `hmask` together: each round they test H pivots
// spread over [lo, hi) and keep the gap where the test turns false.
template <int H>
__device__ __forceinline__ int64_t search(const int64_t* __restrict__ ptr,
                                          int64_t num_rows, int64_t num_items,
                                          int64_t d, unsigned hmask, int hl) {
  int64_t lo = d > num_items ? d - num_items : 0;
  int64_t hi = d < num_rows ? d : num_rows;
  while (lo < hi) {
    const int64_t span = hi - lo;
    const int64_t p = lo + span * (hl + 1) / (H + 1);
    const unsigned below = __ballot_sync(hmask, ptr[p + 1] <= d - p - 1);
    const int cnt = __popc(below & hmask);
    const int64_t next_lo = cnt > 0 ? lo + span * cnt / (H + 1) + 1 : lo;
    hi = cnt < H ? lo + span * (cnt + 1) / (H + 1) : hi;
    lo = next_lo;
  }
  return lo;
}

struct Share {
  int64_t i0, j0;   // rows passed, items passed at the share's start
  int64_t i1, j1;   // ... at its end
};

template <int T, int kSteps>
__device__ __forceinline__ Share find_share(const Team<T>& t,
                                            const int64_t* __restrict__ ptr,
                                            int64_t num_rows,
                                            int64_t num_items) {
  constexpr int H = T / 2;
  const int64_t total = num_rows + num_items;
  const int64_t d0 = t.id * kSteps;
  const int64_t d1 = d0 + kSteps < total ? d0 + kSteps : total;
  const unsigned hmask = ((1u << H) - 1) << (threadIdx.x & (kWarp - H));
  const int64_t i = search<H>(ptr, num_rows, num_items,
                              t.lane < H ? d0 : d1, hmask, t.lane % H);
  Share s;
  s.i0 = __shfl_sync(t.mask, i, 0, T);
  s.i1 = __shfl_sync(t.mask, i, H, T);
  s.j0 = d0 - s.i0;
  s.j1 = d1 - s.i1;
  return s;
}

// ---- the walk ---------------------------------------------------------------

// Unit `col` of row `item` of a row-major [*, units] array.
template <class U>
struct RowLoad {
  const U* base;
  int64_t units;
  __device__ __forceinline__ U operator()(int64_t item, int64_t col) const {
    return __ldg(base + item * units + col);
  }
};

// An F8 unit of a float32 row (K1's bfloat16 carry scratch), as two
// 16-byte loads.
template <>
struct RowLoad<F8> {
  const F8* base;
  int64_t units;
  __device__ __forceinline__ F8 operator()(int64_t item, int64_t col) const {
    const float4* p =
        reinterpret_cast<const float4*>(base + item * units + col);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    F8 r;
    r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
    r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
    return r;
  }
};

// acc combined with the items [a, b), kUnroll loads in flight at a time
// (load returns the accumulator type A).
template <class Op, class A, class Load>
__device__ __forceinline__ A fold(A acc, int64_t a, int64_t b, int64_t col,
                                  const Load& load) {
  for (; a + kUnroll <= b; a += kUnroll) {
    A t[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) t[k] = load(a + k, col);
#pragma unroll
    for (int w = 1; w < kUnroll; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < kUnroll; k += 2 * w) {
        t[k] = combine<Op>(t[k], t[k + w]);
      }
    }
    acc = combine<Op>(acc, t[0]);
  }
  for (; a < b; ++a) acc = combine<Op>(acc, load(a, col));
  return acc;
}

// Reduce and write the share's whole rows [i0, i1); write the carry-out of
// row i1 (its items in [j, j1)) and its id, or -1.  carry holds `shares`
// rows of carry-outs, and for a kWide op `shares` more of heads.
template <class Op, class U, int T, bool kFoldSelf, class Load>
__device__ __forceinline__ void walk_share(
    const Team<T>& t, const Share& s, const int64_t* __restrict__ ptr,
    const U* __restrict__ self, U* __restrict__ out,
    typename Accum<Op, U>::A* __restrict__ carry,
    int64_t* __restrict__ carry_row, int64_t num_rows, int64_t units,
    int64_t shares, const Load& load) {
  using Acc = Accum<Op, U>;
  using A = typename Acc::A;
  const int64_t c = static_cast<int64_t>(blockIdx.y) * T + t.lane;
  const bool active = c < units;
  const int64_t col = active ? c : 0;
  const auto wide_load = [&load](int64_t item, int64_t cl) {
    return Acc::widen(load(item, cl));
  };
  // a kWide op's first row, begun in an earlier share, is left as a head
  const bool head = Acc::kWide && s.i0 < s.i1 && ptr[s.i0] < s.j0;
  int64_t j = s.j0;
  int64_t base = s.i0 - T;   // row ends ptr[base + 1 + lane], T rows a load
  int64_t ends = 0;
  // the next row's own row is loaded one row ahead
  A next = kFoldSelf && s.i0 < s.i1
      ? Acc::widen(__ldg(self + s.i0 * units + col)) : splat<A>(Op::kIdent);
  for (int64_t r = s.i0; r < s.i1; ++r) {
    if (r - base == T) {
      base = r;
      const int64_t q = r + 1 + t.lane;
      ends = q <= num_rows ? ptr[q] : 0;
    }
    const int64_t e = __shfl_sync(t.mask, ends, static_cast<int>(r - base), T);
    A acc = next;
    if (kFoldSelf && r + 1 < s.i1) {
      next = Acc::widen(__ldg(self + (r + 1) * units + col));
    }
    acc = fold<Op, A>(acc, j, e, col, wide_load);
    if (active) {
      if (head && r == s.i0) {
        carry[(shares + t.id) * units + c] = acc;
      } else {
        out[r * units + c] = Acc::narrow(acc);
      }
    }
    j = e;
  }
  int64_t row = -1;
  if (s.i1 < num_rows && j < s.j1) {
    const A acc = fold<Op, A>(splat<A>(Op::kIdent), j, s.j1, col, wide_load);
    if (active) carry[t.id * units + c] = acc;
    row = s.i1;
  }
  if (t.lane == 0 && blockIdx.y == 0) carry_row[t.id] = row;
}

// The second launch: the first share of each run of carry-outs of one row
// combines the run in share order and folds it into that row of out (for
// a kWide op: into the head that the row's ending share, the run's next,
// left, then rounds once).
template <class Op, class U, int T>
__global__ void __launch_bounds__(kBlock)
carry_kernel(const typename Accum<Op, U>::A* __restrict__ carry,
             const int64_t* __restrict__ carry_row, U* __restrict__ out,
             int64_t units, int64_t shares) {
  using Acc = Accum<Op, U>;
  using A = typename Acc::A;
  const Team<T> t;
  if (t.id >= shares) return;   // uniform across the team
  const int64_t row = carry_row[t.id];
  if (row < 0 || (t.id > 0 && carry_row[t.id - 1] == row)) return;
  int64_t end = t.id + 1;   // one past the run: T shares tested a round
  for (;;) {
    const int64_t q = end + t.lane;
    const unsigned other =
        t.own(__ballot_sync(t.mask, q >= shares || carry_row[q] != row));
    if (other != 0) {
      end += __ffs(other) - 1;
      break;
    }
    end += T;
  }
  const int64_t c = static_cast<int64_t>(blockIdx.y) * T + t.lane;
  const A acc = fold<Op, A>(splat<A>(Op::kIdent), t.id, end, c < units ? c : 0,
                            RowLoad<A>{carry, units});
  if (c >= units) return;
  if constexpr (Acc::kWide) {
    out[row * units + c] =
        Acc::narrow(combine<Op>(carry[(shares + end) * units + c], acc));
  } else {
    out[row * units + c] = combine<Op>(out[row * units + c], acc);
  }
}

// The grid of both launches: kPerBlock teams a CTA along x, one grid row
// of T units per y.
template <int T>
inline dim3 grid_for(int64_t shares, int64_t units) {
  return dim3(static_cast<unsigned>((shares + Team<T>::kPerBlock - 1) /
                                    Team<T>::kPerBlock),
              static_cast<unsigned>((units + T - 1) / T));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace merge_path
