// Training-mode BatchNorm over the link batch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its BatchNorms to XLA.  It
// was added because PyTorch's CUDA BatchNorm bounds BUDDY's training step:
// an input that is not contiguous with channel stride 1 (SIGN's per-endpoint
// views h[:, 0] and h[:, 1] of the [B, 2, C] hop block) takes PyTorch's
// batch_norm_*_cuda_template, one block per channel over a spatial size of
// 1, so a few threads of each block walk all B rows with uncoalesced loads.
//
// It works on a row-major block x [B, P, C] (P = 2: a SIGN hop block's two
// endpoints in one launch; P = 1: every other BatchNorm over the batch).
// Each of the K = P * C columns takes its own statistics; the affine
// weight and bias [C] are shared across p.
//
//   forward:  mean, var (biased) over the B rows of each column;
//             invstd = 1 / sqrt(var + eps);
//             y = (x - mean) * (invstd * weight) + bias;
//             running_mean/var[c] <- (1 - momentum) r + momentum (mean, var),
//             p = 0, 1, ... in order, as P calls on x[:, p] update them.
//   backward: per column sdy = sum dy, dot = sum dy (x - mean);
//             dweight[c] = sum_p dot * invstd, dbias[c] = sum_p sdy;
//             dx = weight invstd (dy - sdy / B - (x - mean) invstd^2 dot / B).
//
// Design.  The rows are cut into chunks (the wrapper's layout(): enough
// chunk blocks to fill the card, at least 8 row steps a thread); a chunk
// block of tx * ty <= 256 threads lays tx threads along the contiguous
// columns of a row, each on `vec` adjacent columns (one 16-byte load where
// the row's bytes allow, else one element), and ty rows side by side, so a
// warp reads whole rows: narrow rows (C = 8, C = 1) put many rows in a
// warp.  Each thread keeps its columns' statistics over its rows (Welford:
// count, mean, M2; for the backward, plain sums), kUnroll rows of loads
// issued together; the ty rows of a block merge in a fixed tree in shared
// memory and the block writes one partial a column.  A merge kernel (one
// thread per channel c, kMergeY lanes over the chunks, a fixed tree over
// the lanes) combines the chunks' partials in a fixed order (Chan's merge
// of counts, means and M2), writes mean and invstd, and updates the
// running statistics; in the backward it writes the column sums and the
// parameter gradients.  A third kernel streams the rows once more for y or
// dx.  No value is combined with atomics, so two calls give the same bits.
//
// Bound: HBM bytes.  Forward: x read twice (statistics, normalise), y
// written once; backward: x and dy read twice (sums, dx), dx written once.
// The partials ([2, chunks, K]) and the column vectors are a few MB at
// most, next to 268 MB a pass for a citation2 SIGN block (B = 261,424,
// P = 2, C = 128, float32).
//
// Plain C interface (ctypes): each entry point launches its three kernels
// on the given stream, allocates nothing (the caller passes the partials
// [2, chunks, K] and the column vectors) and returns the first cudaError.
// float64 instances serve the float64 reference runs of training.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // most threads of a chunk block (tx * ty)
constexpr int kUnroll = 4;      // rows a thread loads before it combines
constexpr int kMergeX = 32;     // channels of a merge block
constexpr int kMergeY = 16;     // chunk lanes of a merge block

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

// Chan's merge of (mean b, M2 b, count b) into (mean a, M2 a, count a).
template <typename T>
__device__ __forceinline__ void chan(T& ma, T& m2a, long long& na, T mb,
                                     T m2b, long long nb) {
  if (nb == 0) return;
  if (na == 0) {
    ma = mb;
    m2a = m2b;
    na = nb;
    return;
  }
  const long long n = na + nb;
  const T wb = static_cast<T>(nb) / static_cast<T>(n);
  const T d = mb - ma;
  ma += d * wb;
  m2a += m2b + d * d * static_cast<T>(na) * wb;
  na = n;
}

// The first row and one past the last row of chunk `j`.
__device__ __forceinline__ void chunk_rows(long long j, long long rows,
                                           long long per, long long& r0,
                                           long long& r1) {
  r0 = j * per;
  r1 = min(rows, r0 + per);
}

// ---------------------------------------------------------------- forward

// Per chunk and column: mean and M2 of the chunk's rows, into
// part[0][chunk][k] and part[1][chunk][k].
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, long long rows, long long cols,
                 long long per, T* __restrict__ part) {
  __shared__ T s_mean[kThreads * N];
  __shared__ T s_m2[kThreads * N];
  __shared__ long long s_n[kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int slot = ty * nx + tx;
  const long long k0 = (static_cast<long long>(blockIdx.y) * nx + tx) * N;
  const bool live = k0 < cols;
  long long r0, r1;
  chunk_rows(blockIdx.x, rows, per, r0, r1);

  T mean[N], m2[N];
#pragma unroll
  for (int j = 0; j < N; ++j) mean[j] = m2[j] = T(0);
  long long n = 0;
  if (live) {
    long long r = r0 + ty;
    for (; r + (kUnroll - 1) * ny < r1; r += kUnroll * ny) {
      Pack<T, N> p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        p[u] = load<T, N>(x + (r + u * ny) * cols + k0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T inv = T(1) / static_cast<T>(++n);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const T d = p[u].v[j] - mean[j];
          mean[j] += d * inv;
          m2[j] += d * (p[u].v[j] - mean[j]);
        }
      }
    }
    for (; r < r1; r += ny) {
      const Pack<T, N> p = load<T, N>(x + r * cols + k0);
      const T inv = T(1) / static_cast<T>(++n);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T d = p.v[j] - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (p.v[j] - mean[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s_mean[slot * N + j] = mean[j];
    s_m2[slot * N + j] = m2[j];
  }
  s_n[slot] = n;
  __syncthreads();
  int top = 1;
  while (top < ny) top <<= 1;
  for (int s = top >> 1; s > 0; s >>= 1) {
    if (ty < s && ty + s < ny) {
      const int other = (ty + s) * nx + tx;
      const long long nb = s_n[other];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        long long na = n;
        chan(mean[j], m2[j], na, s_mean[other * N + j], s_m2[other * N + j],
             nb);
        s_mean[slot * N + j] = mean[j];
        s_m2[slot * N + j] = m2[j];
      }
      n += nb;
      s_n[slot] = n;
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const long long at = static_cast<long long>(blockIdx.x) * cols + k0;
    const long long plane = static_cast<long long>(gridDim.x) * cols;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      part[at + j] = mean[j];
      part[plane + at + j] = m2[j];
    }
  }
}

// One thread per channel c (threadIdx.x) and kMergeY lanes over the
// chunks: for p = 0 .. planes - 1 in order, the chunks' partials of column
// k = p * C + c merged in a fixed order, then mean[k], invstd[k] and the
// running statistics of c.
template <typename T>
__global__ void __launch_bounds__(kMergeX* kMergeY)
    stats_merge_kernel(const T* __restrict__ part, long long chunks,
                       long long rows, long long per, long long planes,
                       long long channels, T* __restrict__ mean_out,
                       T* __restrict__ invstd_out, T* __restrict__ run_mean,
                       T* __restrict__ run_var, T keep, T momentum, T eps) {
  __shared__ T s_mean[kMergeY][kMergeX];
  __shared__ T s_m2[kMergeY][kMergeX];
  __shared__ long long s_n[kMergeY][kMergeX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c = static_cast<long long>(blockIdx.x) * kMergeX + tx;
  const bool live = c < channels;
  const long long cols = planes * channels;
  const long long plane = chunks * cols;
  for (long long p = 0; p < planes; ++p) {
    const long long k = p * channels + c;
    T m = T(0), m2 = T(0);
    long long n = 0;
    if (live) {
      long long j = ty;
      for (; j + (kUnroll - 1) * kMergeY < chunks; j += kUnroll * kMergeY) {
        T a[kUnroll], b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          a[u] = part[(j + u * kMergeY) * cols + k];
          b[u] = part[plane + (j + u * kMergeY) * cols + k];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          long long r0, r1;
          chunk_rows(j + u * kMergeY, rows, per, r0, r1);
          chan(m, m2, n, a[u], b[u], r1 - r0);
        }
      }
      for (; j < chunks; j += kMergeY) {
        long long r0, r1;
        chunk_rows(j, rows, per, r0, r1);
        chan(m, m2, n, part[j * cols + k], part[plane + j * cols + k],
             r1 - r0);
      }
    }
    s_mean[ty][tx] = m;
    s_m2[ty][tx] = m2;
    s_n[ty][tx] = n;
    __syncthreads();
    for (int s = kMergeY / 2; s > 0; s >>= 1) {
      if (ty < s) {
        chan(m, m2, n, s_mean[ty + s][tx], s_m2[ty + s][tx],
             s_n[ty + s][tx]);
        s_mean[ty][tx] = m;
        s_m2[ty][tx] = m2;
        s_n[ty][tx] = n;
      }
      __syncthreads();
    }
    if (ty == 0 && live) {
      const T var = m2 / static_cast<T>(rows);
      mean_out[k] = m;
      invstd_out[k] = T(1) / sqrt(var + eps);
      run_mean[c] = run_mean[c] * keep + momentum * m;
      run_var[c] = run_var[c] * keep + momentum * var;
    }
    __syncthreads();   // the next plane reuses the shared arrays
  }
}

// y = (x - mean) * (invstd * weight) + bias over the chunk's rows.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    normalise_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                     const T* __restrict__ bias, const T* __restrict__ mean,
                     const T* __restrict__ invstd, long long rows,
                     long long cols, long long channels, long long per,
                     T* __restrict__ y) {
  const int nx = blockDim.x, ny = blockDim.y;
  const long long k0 =
      (static_cast<long long>(blockIdx.y) * nx + threadIdx.x) * N;
  if (k0 >= cols) return;
  long long r0, r1;
  chunk_rows(blockIdx.x, rows, per, r0, r1);
  T mu[N], scale[N], shift[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const long long c = (k0 + j) % channels;
    mu[j] = mean[k0 + j];
    scale[j] = invstd[k0 + j] * weight[c];
    shift[j] = bias[c];
  }
  long long r = r0 + threadIdx.y;
  for (; r + (kUnroll - 1) * ny < r1; r += kUnroll * ny) {
    Pack<T, N> p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      p[u] = load<T, N>(x + (r + u * ny) * cols + k0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        p[u].v[j] = (p[u].v[j] - mu[j]) * scale[j] + shift[j];
      store<T, N>(y + (r + u * ny) * cols + k0, p[u]);
    }
  }
  for (; r < r1; r += ny) {
    Pack<T, N> p = load<T, N>(x + r * cols + k0);
#pragma unroll
    for (int j = 0; j < N; ++j)
      p.v[j] = (p.v[j] - mu[j]) * scale[j] + shift[j];
    store<T, N>(y + r * cols + k0, p);
  }
}

// --------------------------------------------------------------- backward

// Per chunk and column: sum dy and sum dy (x - mean) of the chunk's rows,
// into part[0][chunk][k] and part[1][chunk][k].
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    grad_sums_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const T* __restrict__ mean, long long rows,
                     long long cols, long long per, T* __restrict__ part) {
  __shared__ T s_dy[kThreads * N];
  __shared__ T s_dot[kThreads * N];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int slot = ty * nx + tx;
  const long long k0 = (static_cast<long long>(blockIdx.y) * nx + tx) * N;
  const bool live = k0 < cols;
  long long r0, r1;
  chunk_rows(blockIdx.x, rows, per, r0, r1);

  T sdy[N], dot[N], mu[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    sdy[j] = dot[j] = T(0);
    mu[j] = live ? mean[k0 + j] : T(0);
  }
  if (live) {
    long long r = r0 + ty;
    for (; r + (kUnroll - 1) * ny < r1; r += kUnroll * ny) {
      Pack<T, N> g[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        g[u] = load<T, N>(dy + (r + u * ny) * cols + k0);
        v[u] = load<T, N>(x + (r + u * ny) * cols + k0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          sdy[j] += g[u].v[j];
          dot[j] += g[u].v[j] * (v[u].v[j] - mu[j]);
        }
      }
    }
    for (; r < r1; r += ny) {
      const Pack<T, N> g = load<T, N>(dy + r * cols + k0);
      const Pack<T, N> v = load<T, N>(x + r * cols + k0);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sdy[j] += g.v[j];
        dot[j] += g.v[j] * (v.v[j] - mu[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s_dy[slot * N + j] = sdy[j];
    s_dot[slot * N + j] = dot[j];
  }
  __syncthreads();
  int top = 1;
  while (top < ny) top <<= 1;
  for (int s = top >> 1; s > 0; s >>= 1) {
    if (ty < s && ty + s < ny) {
      const int other = (ty + s) * nx + tx;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sdy[j] += s_dy[other * N + j];
        dot[j] += s_dot[other * N + j];
        s_dy[slot * N + j] = sdy[j];
        s_dot[slot * N + j] = dot[j];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const long long at = static_cast<long long>(blockIdx.x) * cols + k0;
    const long long plane = static_cast<long long>(gridDim.x) * cols;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      part[at + j] = sdy[j];
      part[plane + at + j] = dot[j];
    }
  }
}

// The chunks' sums of column k = p * C + c in a fixed order, into
// sums[0][k] (sum dy) and sums[1][k] (sum dy (x - mean)); dweight[c] and
// dbias[c] summed over p in order.
template <typename T>
__global__ void __launch_bounds__(kMergeX* kMergeY)
    grad_merge_kernel(const T* __restrict__ part, long long chunks,
                      long long planes, long long channels,
                      const T* __restrict__ invstd, T* __restrict__ sums,
                      T* __restrict__ dweight, T* __restrict__ dbias) {
  __shared__ T s_dy[kMergeY][kMergeX];
  __shared__ T s_dot[kMergeY][kMergeX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c = static_cast<long long>(blockIdx.x) * kMergeX + tx;
  const bool live = c < channels;
  const long long cols = planes * channels;
  const long long plane = chunks * cols;
  T gw = T(0), gb = T(0);
  for (long long p = 0; p < planes; ++p) {
    const long long k = p * channels + c;
    T sdy = T(0), dot = T(0);
    if (live) {
      long long j = ty;
      for (; j + (kUnroll - 1) * kMergeY < chunks; j += kUnroll * kMergeY) {
        T a[kUnroll], b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          a[u] = part[(j + u * kMergeY) * cols + k];
          b[u] = part[plane + (j + u * kMergeY) * cols + k];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          sdy += a[u];
          dot += b[u];
        }
      }
      for (; j < chunks; j += kMergeY) {
        sdy += part[j * cols + k];
        dot += part[plane + j * cols + k];
      }
    }
    s_dy[ty][tx] = sdy;
    s_dot[ty][tx] = dot;
    __syncthreads();
    for (int s = kMergeY / 2; s > 0; s >>= 1) {
      if (ty < s) {
        sdy += s_dy[ty + s][tx];
        dot += s_dot[ty + s][tx];
        s_dy[ty][tx] = sdy;
        s_dot[ty][tx] = dot;
      }
      __syncthreads();
    }
    if (ty == 0 && live) {
      sums[k] = sdy;
      sums[cols + k] = dot;
      gb += sdy;
      gw += dot * invstd[k];
    }
    __syncthreads();   // the next plane reuses the shared arrays
  }
  if (ty == 0 && live) {
    dweight[c] = gw;
    dbias[c] = gb;
  }
}

// dx = weight invstd (dy - sum dy / B - (x - mean) invstd^2 dot / B).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    grad_input_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const T* __restrict__ weight,
                      const T* __restrict__ mean,
                      const T* __restrict__ invstd,
                      const T* __restrict__ sums, long long rows,
                      long long cols, long long channels, long long per,
                      T* __restrict__ dx) {
  const int nx = blockDim.x, ny = blockDim.y;
  const long long k0 =
      (static_cast<long long>(blockIdx.y) * nx + threadIdx.x) * N;
  if (k0 >= cols) return;
  long long r0, r1;
  chunk_rows(blockIdx.x, rows, per, r0, r1);
  const T inv_rows = T(1) / static_cast<T>(rows);
  T mu[N], scale[N], mdy[N], proj[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const long long k = k0 + j;
    const T is = invstd[k];
    mu[j] = mean[k];
    scale[j] = weight[k % channels] * is;
    mdy[j] = sums[k] * inv_rows;
    proj[j] = sums[cols + k] * inv_rows * is * is;
  }
  long long r = r0 + threadIdx.y;
  for (; r + (kUnroll - 1) * ny < r1; r += kUnroll * ny) {
    Pack<T, N> g[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g[u] = load<T, N>(dy + (r + u * ny) * cols + k0);
      v[u] = load<T, N>(x + (r + u * ny) * cols + k0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        g[u].v[j] =
            scale[j] * (g[u].v[j] - mdy[j] - (v[u].v[j] - mu[j]) * proj[j]);
      store<T, N>(dx + (r + u * ny) * cols + k0, g[u]);
    }
  }
  for (; r < r1; r += ny) {
    Pack<T, N> g = load<T, N>(dy + r * cols + k0);
    const Pack<T, N> v = load<T, N>(x + r * cols + k0);
#pragma unroll
    for (int j = 0; j < N; ++j)
      g.v[j] = scale[j] * (g.v[j] - mdy[j] - (v.v[j] - mu[j]) * proj[j]);
    store<T, N>(dx + r * cols + k0, g);
  }
}

// ------------------------------------------------------------------ host

// The chunk blocks' grid and shape, or false for a layout no kernel takes
// (the wrapper computes it: vec, tx, ty, rows a chunk, chunks).
bool chunk_grid(long long rows, long long cols, long long vec, long long tx,
                long long ty, long long per, long long chunks, int unit,
                dim3& grid, dim3& block) {
  if (rows < 1 || cols < 1 || tx < 1 || ty < 1 || tx * ty > kThreads ||
      (vec != 1 && vec != unit) || cols % vec || per < 1 || chunks < 1 ||
      (chunks - 1) * per >= rows || chunks * per < rows)
    return false;
  const long long gx = (cols / vec + tx - 1) / tx;
  if (gx > 65535 || chunks > 2147483647LL) return false;
  grid = dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(gx));
  block = dim3(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  return true;
}

template <typename T, int U>
int forward(const void* x, const void* weight, const void* bias, void* y,
            void* mean, void* invstd, void* run_mean, void* run_var,
            void* part, long long rows, long long planes, long long channels,
            long long vec, long long tx, long long ty, long long per,
            long long chunks, double momentum, double eps, void* stream) {
  const long long cols = planes * channels;
  dim3 grid, block;
  if (planes < 1 || channels < 1 ||
      !chunk_grid(rows, cols, vec, tx, ty, per, chunks, U, grid, block))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* xs = static_cast<const T*>(x);
  T* ps = static_cast<T*>(part);
  if (vec == U)
    stats_kernel<T, U><<<grid, block, 0, st>>>(xs, rows, cols, per, ps);
  else
    stats_kernel<T, 1><<<grid, block, 0, st>>>(xs, rows, cols, per, ps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 mgrid(static_cast<unsigned>((channels + kMergeX - 1) / kMergeX));
  stats_merge_kernel<T><<<mgrid, dim3(kMergeX, kMergeY), 0, st>>>(
      ps, chunks, rows, per, planes, channels, static_cast<T*>(mean),
      static_cast<T*>(invstd), static_cast<T*>(run_mean),
      static_cast<T*>(run_var), static_cast<T>(1.0 - momentum),
      static_cast<T>(momentum), static_cast<T>(eps));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* w = static_cast<const T*>(weight);
  const T* b = static_cast<const T*>(bias);
  const T* mu = static_cast<const T*>(mean);
  const T* is = static_cast<const T*>(invstd);
  T* ys = static_cast<T*>(y);
  if (vec == U)
    normalise_kernel<T, U><<<grid, block, 0, st>>>(xs, w, b, mu, is, rows,
                                                   cols, channels, per, ys);
  else
    normalise_kernel<T, 1><<<grid, block, 0, st>>>(xs, w, b, mu, is, rows,
                                                   cols, channels, per, ys);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int U>
int backward(const void* dy, const void* x, const void* weight,
             const void* mean, const void* invstd, void* part, void* sums,
             void* dx, void* dweight, void* dbias, long long rows,
             long long planes, long long channels, long long vec,
             long long tx, long long ty, long long per, long long chunks,
             void* stream) {
  const long long cols = planes * channels;
  dim3 grid, block;
  if (planes < 1 || channels < 1 ||
      !chunk_grid(rows, cols, vec, tx, ty, per, chunks, U, grid, block))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(dy);
  const T* xs = static_cast<const T*>(x);
  const T* mu = static_cast<const T*>(mean);
  const T* is = static_cast<const T*>(invstd);
  T* ps = static_cast<T*>(part);
  T* ss = static_cast<T*>(sums);
  if (vec == U)
    grad_sums_kernel<T, U><<<grid, block, 0, st>>>(g, xs, mu, rows, cols,
                                                   per, ps);
  else
    grad_sums_kernel<T, 1><<<grid, block, 0, st>>>(g, xs, mu, rows, cols,
                                                   per, ps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 mgrid(static_cast<unsigned>((channels + kMergeX - 1) / kMergeX));
  grad_merge_kernel<T><<<mgrid, dim3(kMergeX, kMergeY), 0, st>>>(
      ps, chunks, planes, channels, is, ss, static_cast<T*>(dweight),
      static_cast<T*>(dbias));
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  const T* w = static_cast<const T*>(weight);
  T* out = static_cast<T*>(dx);
  if (vec == U)
    grad_input_kernel<T, U><<<grid, block, 0, st>>>(
        g, xs, w, mu, is, ss, rows, cols, channels, per, out);
  else
    grad_input_kernel<T, 1><<<grid, block, 0, st>>>(
        g, xs, w, mu, is, ss, rows, cols, channels, per, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x / y [rows, planes, channels] row-major; weight, bias, run_mean,
// run_var [channels]; mean, invstd [planes * channels]; part [2, chunks,
// planes * channels].  vec: columns a thread loads at once (1, or the
// elements of 16 bytes: 4 float32, 2 float64; then x and y 16-byte
// aligned and the row's columns a multiple of vec).  The running
// statistics are updated in place, plane 0 first.
int batch_norm_forward_f32(const void* x, const void* weight,
                           const void* bias, void* y, void* mean,
                           void* invstd, void* run_mean, void* run_var,
                           void* part, int64_t rows, int64_t planes,
                           int64_t channels, int64_t vec, int64_t tx,
                           int64_t ty, int64_t per, int64_t chunks,
                           double momentum, double eps, void* stream) {
  return forward<float, 4>(x, weight, bias, y, mean, invstd, run_mean,
                           run_var, part, rows, planes, channels, vec, tx,
                           ty, per, chunks, momentum, eps, stream);
}

int batch_norm_forward_f64(const void* x, const void* weight,
                           const void* bias, void* y, void* mean,
                           void* invstd, void* run_mean, void* run_var,
                           void* part, int64_t rows, int64_t planes,
                           int64_t channels, int64_t vec, int64_t tx,
                           int64_t ty, int64_t per, int64_t chunks,
                           double momentum, double eps, void* stream) {
  return forward<double, 2>(x, weight, bias, y, mean, invstd, run_mean,
                            run_var, part, rows, planes, channels, vec, tx,
                            ty, per, chunks, momentum, eps, stream);
}

// dy, x, dx [rows, planes, channels]; weight, dweight, dbias [channels];
// mean, invstd [planes * channels] (the forward's); part [2, chunks,
// planes * channels]; sums [2, planes * channels].  dx may be null: the
// input needs no gradient, and only the parameters' are written.
int batch_norm_backward_f32(const void* dy, const void* x,
                            const void* weight, const void* mean,
                            const void* invstd, void* part, void* sums,
                            void* dx, void* dweight, void* dbias,
                            int64_t rows, int64_t planes, int64_t channels,
                            int64_t vec, int64_t tx, int64_t ty, int64_t per,
                            int64_t chunks, void* stream) {
  return backward<float, 4>(dy, x, weight, mean, invstd, part, sums, dx,
                            dweight, dbias, rows, planes, channels, vec, tx,
                            ty, per, chunks, stream);
}

int batch_norm_backward_f64(const void* dy, const void* x,
                            const void* weight, const void* mean,
                            const void* invstd, void* part, void* sums,
                            void* dx, void* dweight, void* dbias,
                            int64_t rows, int64_t planes, int64_t channels,
                            int64_t vec, int64_t tx, int64_t ty, int64_t per,
                            int64_t chunks, void* stream) {
  return backward<double, 2>(dy, x, weight, mean, invstd, part, sums, dx,
                             dweight, dbias, rows, planes, channels, vec, tx,
                             ty, per, chunks, stream);
}

}  // extern "C"
