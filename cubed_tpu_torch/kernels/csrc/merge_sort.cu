// K4: merge_sort -- the sort network's block kernels: a stable sort of each
// lane of a block, a stable argsort, and the merge-split of two sorted blocks.
//
// The JAX package sorts with jnp.sort / jnp.lexsort outside any Pallas kernel
// (cubed_tpu/array_api/_block_sort.py:177-309, sorting_functions.py:94-160).
// torch.sort on the card materializes int64 indices and, for a lane longer
// than 4096 elements, sorts a non-innermost axis through a transposed copy
// with CUB's scratch, which puts a task past the memory the plan projects
// for it. These kernels need no scratch:
//
//   merge_pass  -- one pass of a bottom-up merge sort along an axis: each pair
//                  of neighbouring sorted runs of `width` elements becomes one
//                  sorted run of 2 * width. A block sorts in ceil(log2 n)
//                  passes between two buffers. Values alone, values with
//                  carried int64 indices, or indirect (argsort): the runs
//                  hold int64 positions and compare by the values they name,
//                  so an argsort keeps only index buffers beside its input.
//   merge_split -- the network's compare-exchange: the two sorted blocks of a
//                  pair merged, and the low or the high half kept, by a flag
//                  per lane group; values alone or with carried indices.
//
// Every output element is one thread. It finds its rank's place on the merge
// path of its two runs by binary search (ceil(log2 width) probes), then
// writes one element; no thread waits on another and no atomic is used, so
// a result is the same from run to run. The order is numpy's and XLA's:
// ascending, NaN after every number (all NaNs equal), -0.0 equal to 0.0;
// equal values keep their order (the earlier run first), and with indices
// the pair (value, index) is the key, as the reference's lexsort orders it.
//
// Layout: a contiguous (outer, n, inner) tensor sorted along n; element
// (o, k, l) at (o * n + k) * inner + l. Threads run over elements in that
// order, so a warp's stores coalesce along inner.
//
// Bound on the H100: each pass reads and writes every element once
// (3.35 TB/s); the probes read within one lane's runs.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ bool is_nan(T) {
  return false;
}
template <>
__device__ __forceinline__ bool is_nan<float>(float v) {
  return v != v;
}
template <>
__device__ __forceinline__ bool is_nan<double>(double v) {
  return v != v;
}

// a sorts before b: ascending, NaN last
template <typename T>
__device__ __forceinline__ bool less(T a, T b) {
  return a < b || (!is_nan(a) && is_nan(b));
}

// an element of X goes before an element of Y: by value (by (value, index)
// with indices), X first on equal keys
template <typename T, bool kIdx>
__device__ __forceinline__ bool x_first(T xv, long long xi, T yv, long long yi) {
  if (less(yv, xv)) return false;
  if (!kIdx || less(xv, yv)) return true;
  return xi <= yi;
}

// a run read along a lane: values, and carried indices when kIdx
template <typename T, bool kIdx>
struct Direct {
  const T* __restrict__ v;
  const long long* __restrict__ i;
  long long stride;
  __device__ __forceinline__ T val(long long j) const { return v[j * stride]; }
  __device__ __forceinline__ long long idx(long long j) const { return kIdx ? i[j * stride] : 0; }
};

// a run of positions along a lane, ordered by the values they name; with no
// index buffer the run is the identity (a first pass)
template <typename T>
struct Indirect {
  const T* __restrict__ data;
  const long long* __restrict__ i;
  long long stride;
  long long first;
  __device__ __forceinline__ long long idx(long long j) const { return i ? i[j * stride] : first + j; }
  __device__ __forceinline__ T val(long long j) const { return data[idx(j) * stride]; }
};

// the element of rank r in the stable merge of X (nx) and Y (ny)
template <typename T, bool kIdx, typename Run>
__device__ __forceinline__ void select_rank(const Run& X, long long nx, const Run& Y, long long ny, long long r,
                                            T& v, long long& vi) {
  long long lo = r > ny ? r - ny : 0;
  long long hi = r < nx ? r : nx;
  while (lo < hi) {
    const long long m = (lo + hi) >> 1;
    // X[m] is among the first r when it goes before Y[r - 1 - m]
    if (x_first<T, kIdx>(X.val(m), X.idx(m), Y.val(r - 1 - m), Y.idx(r - 1 - m))) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  const long long i = lo, j = r - lo;
  const bool take_x = j >= ny || (i < nx && x_first<T, kIdx>(X.val(i), X.idx(i), Y.val(j), Y.idx(j)));
  if (take_x) {
    v = X.val(i);
    vi = X.idx(i);
  } else {
    v = Y.val(j);
    vi = Y.idx(j);
  }
}

// kMode 0: values; 1: values with carried indices; 2: indirect (argsort)
template <typename T, int kMode>
__global__ void __launch_bounds__(256) merge_pass_kernel(const T* __restrict__ src, const long long* __restrict__ srci,
                                                         T* __restrict__ dst, long long* __restrict__ dsti,
                                                         long long outer, long long n, long long inner,
                                                         long long width) {
  const long long total = outer * n * inner;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long l = t % inner;
    const long long ok = t / inner;
    const long long k = ok % n;
    const long long lane = (ok - k) * inner + l;  // element (o, 0, l)
    const long long start = k / (2 * width) * (2 * width);
    const long long mid = min(start + width, n);
    const long long end = min(start + 2 * width, n);
    T v;
    long long vi;
    if constexpr (kMode == 2) {
      const Indirect<T> X{src + lane, srci ? srci + lane + start * inner : nullptr, inner, start};
      const Indirect<T> Y{src + lane, srci ? srci + lane + mid * inner : nullptr, inner, mid};
      select_rank<T, true>(X, mid - start, Y, end - mid, k - start, v, vi);
      dsti[t] = vi;
    } else {
      constexpr bool kIdx = kMode == 1;
      const Direct<T, kIdx> X{src + lane + start * inner, kIdx ? srci + lane + start * inner : nullptr, inner};
      const Direct<T, kIdx> Y{src + lane + mid * inner, kIdx ? srci + lane + mid * inner : nullptr, inner};
      select_rank<T, kIdx>(X, mid - start, Y, end - mid, k - start, v, vi);
      dst[t] = v;
      if constexpr (kIdx) dsti[t] = vi;
    }
  }
}

// the low (flag 1) or high (flag 0) n of the merge of x's and y's lanes;
// lane group o (the elements (o, *, *)) reads flag[o]
template <typename T, bool kIdx>
__global__ void __launch_bounds__(256) merge_split_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                                          const long long* __restrict__ xi,
                                                          const long long* __restrict__ yi,
                                                          const unsigned char* __restrict__ take_low,
                                                          T* __restrict__ out, long long* __restrict__ outi,
                                                          long long outer, long long n, long long inner) {
  const long long total = outer * n * inner;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long l = t % inner;
    const long long ok = t / inner;
    const long long k = ok % n;
    const long long o = ok / n;
    const long long lane = o * n * inner + l;
    const Direct<T, kIdx> X{x + lane, kIdx ? xi + lane : nullptr, inner};
    const Direct<T, kIdx> Y{y + lane, kIdx ? yi + lane : nullptr, inner};
    T v;
    long long vi;
    select_rank<T, kIdx>(X, n, Y, n, take_low[o] ? k : n + k, v, vi);
    out[t] = v;
    if (kIdx) outi[t] = vi;
  }
}

template <typename T>
int launch_pass(int mode, const void* src, const void* srci, void* dst, void* dsti, long long outer, long long n,
                long long inner, long long width, int grid, cudaStream_t s) {
  const T* a = static_cast<const T*>(src);
  const long long* ai = static_cast<const long long*>(srci);
  T* b = static_cast<T*>(dst);
  long long* bi = static_cast<long long*>(dsti);
  if (mode == 0) {
    merge_pass_kernel<T, 0><<<grid, 256, 0, s>>>(a, ai, b, bi, outer, n, inner, width);
  } else if (mode == 1) {
    merge_pass_kernel<T, 1><<<grid, 256, 0, s>>>(a, ai, b, bi, outer, n, inner, width);
  } else {
    merge_pass_kernel<T, 2><<<grid, 256, 0, s>>>(a, ai, b, bi, outer, n, inner, width);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split(int with_idx, const void* x, const void* y, const void* xi, const void* yi,
                 const unsigned char* take_low, void* out, void* outi, long long outer, long long n, long long inner,
                 int grid, cudaStream_t s) {
  if (with_idx) {
    merge_split_kernel<T, true><<<grid, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const long long*>(xi),
        static_cast<const long long*>(yi), take_low, static_cast<T*>(out), static_cast<long long*>(outi), outer, n,
        inner);
  } else {
    merge_split_kernel<T, false><<<grid, 256, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(y), nullptr,
                                                      nullptr, take_low, static_cast<T*>(out), nullptr, outer, n,
                                                      inner);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 int64, 3 int32, 4 int16, 5 int8, 6 uint8
extern "C" int merge_pass(int dtype, int mode, const void* src, const void* srci, void* dst, void* dsti,
                          long long outer, long long n, long long inner, long long width, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_pass<double>(mode, src, srci, dst, dsti, outer, n, inner, width, grid, s);
    case 1: return launch_pass<float>(mode, src, srci, dst, dsti, outer, n, inner, width, grid, s);
    case 2: return launch_pass<long long>(mode, src, srci, dst, dsti, outer, n, inner, width, grid, s);
    case 3: return launch_pass<int>(mode, src, srci, dst, dsti, outer, n, inner, width, grid, s);
    case 4: return launch_pass<short>(mode, src, srci, dst, dsti, outer, n, inner, width, grid, s);
    case 5: return launch_pass<signed char>(mode, src, srci, dst, dsti, outer, n, inner, width, grid, s);
    case 6: return launch_pass<unsigned char>(mode, src, srci, dst, dsti, outer, n, inner, width, grid, s);
    default: return -1;
  }
}

extern "C" int merge_split(int dtype, int with_idx, const void* x, const void* y, const void* xi, const void* yi,
                           const void* take_low, void* out, void* outi, long long outer, long long n, long long inner,
                           int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* f = static_cast<const unsigned char*>(take_low);
  switch (dtype) {
    case 0: return launch_split<double>(with_idx, x, y, xi, yi, f, out, outi, outer, n, inner, grid, s);
    case 1: return launch_split<float>(with_idx, x, y, xi, yi, f, out, outi, outer, n, inner, grid, s);
    case 2: return launch_split<long long>(with_idx, x, y, xi, yi, f, out, outi, outer, n, inner, grid, s);
    case 3: return launch_split<int>(with_idx, x, y, xi, yi, f, out, outi, outer, n, inner, grid, s);
    case 4: return launch_split<short>(with_idx, x, y, xi, yi, f, out, outi, outer, n, inner, grid, s);
    case 5: return launch_split<signed char>(with_idx, x, y, xi, yi, f, out, outi, outer, n, inner, grid, s);
    case 6: return launch_split<unsigned char>(with_idx, x, y, xi, yi, f, out, outi, outer, n, inner, grid, s);
    default: return -1;
  }
}
