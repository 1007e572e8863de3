// K2: region_sum -- keepdims sum over an axis set, for float64, float32 and int64.
//
// Replaces the JAX package's Pallas kernels region_sum (_col_sum_kernel) and
// block_sum (_sum_tiles_kernel), cubed_tpu/kernels/reductions.py:140-240 and
// :68-125 at commit 0cd9f84^: the tree reduction's sums (_mean_func,
// _mean_combine, _sum_with_dtype).
//
// Bound on the H100: the input bytes, read once at 3.35 TB/s. The input is
// read in place through its strides, axes merged where contiguous
// (kernels/_geometry.py), never copied. One launch, in one of two layouts:
//   rows    -- the innermost merged axis is reduced. CTA (m, s) sums split s
//              of output m's reduced positions, its threads packed across
//              short rows, each keeping kUnroll loads in flight; 16-byte
//              loads when the rows allow them. The main path's sums over
//              every axis are this layout with one output.
//   columns -- the innermost merged axis is kept: the TPU's _col_sum_kernel
//              thought through again. Each thread owns V neighbouring outputs
//              along the innermost axis, so a warp's loads coalesce, and walks
//              the reduced positions of its split; CTAs split the reduced
//              extent.
// Both layouts come in two index widths: four merged axes of a role, or
// eight for the grid views of blocks that the device executor's batched
// route hands over (grid axes kept beside kept in-block axes).
// With one split a CTA writes its outputs itself: small inputs (the tree
// reduction's combines) take one CTA and no partials. With more, the CTA
// that draws an output's last ticket sums its partials in split order
// (reduce_common.cuh): no second launch, no atomics on values, so a result
// is bitwise the same from run to run. float32 accumulates in float64, int64
// in 64-bit unsigned arithmetic (wrapping as torch does).
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include "reduce_common.cuh"

namespace {

using reduce::kUnroll;
template <int kD>
using Geometry = reduce::Geometry<1, kD>;

template <typename T>
struct Acc {
  using type = double;
};
template <>
struct Acc<long long> {
  using type = unsigned long long;
};

template <typename T, int V, int kD>
__global__ void __launch_bounds__(256, 2)
    region_sum_rows(const T* __restrict__ x, T* __restrict__ out,
                    typename Acc<T>::type* __restrict__ partials, unsigned* __restrict__ counters,
                    Geometry<kD> g) {
  using A = typename Acc<T>::type;
  const int m = blockIdx.x / g.splits;
  const int s = blockIdx.x - m * g.splits;
  int c[kD];
  reduce::coords(g.kept, m, c);
  const T* __restrict__ xm = x + reduce::dot(c, g.kstride[0]);
  const int begin = s * g.per_split;
  const int end = min(begin + g.per_split, g.red_units);
  const int step = blockDim.x * kUnroll;
  A acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = A(0);
  for (int i = begin + threadIdx.x; i < end; i += step) {
    T v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * blockDim.x;
      if (j < end) {
        int r[kD];
        reduce::coords(g.red, j, r);
        reduce::load<T, V>(xm + reduce::dot(r, g.rstride[0]), v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * (int)blockDim.x < end) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[u] += (A)v[u][e];
      }
    }
  }
  const A total = reduce::block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (g.splits == 1) {
    if (threadIdx.x == 0) out[m] = (T)total;
    return;
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
  if (!reduce::last_to_arrive(counters + m, g.splits)) return;
  A t = A(0);
  for (int k = threadIdx.x; k < g.splits; k += blockDim.x)
    t += reduce::load_partial(partials + (long long)m * g.splits + k);
  t = reduce::block_sum(t);
  if (threadIdx.x == 0) out[m] = (T)t;
}

template <typename T, int V, int kD>
__global__ void __launch_bounds__(256, 2)
    region_sum_columns(const T* __restrict__ x, T* __restrict__ out,
                       typename Acc<T>::type* __restrict__ partials,
                       unsigned* __restrict__ counters, Geometry<kD> g) {
  using A = typename Acc<T>::type;
  const int tile = blockIdx.x / g.splits;
  const int s = blockIdx.x - tile * g.splits;
  const int o = tile * blockDim.x + threadIdx.x;  // this thread's output unit
  const bool live = o < g.out_units;
  int c[kD];
  reduce::coords(g.kept, live ? o : 0, c);
  const T* __restrict__ xo = x + reduce::dot(c, g.kstride[0]);
  const int begin = s * g.per_split;
  const int end = min(begin + g.per_split, g.red_units);
  A acc[kUnroll][V];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[u][e] = A(0);
  if (live) {
    for (int l = begin; l < end; l += kUnroll) {
      T v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (l + u < end) {
          int r[kD];
          reduce::coords(g.red, l + u, r);
          reduce::load<T, V>(xo + reduce::dot(r, g.rstride[0]), v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (l + u < end) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[u][e] += (A)v[u][e];
        }
      }
    }
  }
  A sum[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sum[e] = (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
  const long long first = (long long)o * V;  // this thread's first output element
  if (g.splits == 1) {
    if (live) {
#pragma unroll
      for (int e = 0; e < V; ++e) out[first + e] = (T)sum[e];
    }
    return;
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < V; ++e) partials[(long long)s * g.outputs + first + e] = sum[e];
  }
  if (!reduce::last_to_arrive(counters + tile, g.splits)) return;
  if (live) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      A t = A(0);
      for (int k = 0; k < g.splits; ++k)
        t += reduce::load_partial(partials + (long long)k * g.outputs + first + e);
      out[first + e] = (T)t;
    }
  }
}

template <typename T, int V, int kD>
int launch_dims(int layout, const void* x, void* out, void* partials, void* counters,
                const long long* params, int grid, int threads, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const Geometry<kD> g = reduce::unpack<1, kD>(params);
  if (layout == 0)
    region_sum_rows<T, V, kD><<<grid, threads, 0, stream>>>((const T*)x, (T*)out, (A*)partials,
                                                            (unsigned*)counters, g);
  else
    region_sum_columns<T, V, kD><<<grid, threads, 0, stream>>>((const T*)x, (T*)out, (A*)partials,
                                                               (unsigned*)counters, g);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(int dims, int layout, const void* x, void* out, void* partials, void* counters,
           const long long* params, int grid, int threads, cudaStream_t stream) {
  if (dims == reduce::kDims)
    return launch_dims<T, V, reduce::kDims>(layout, x, out, partials, counters, params, grid, threads, stream);
  if (dims == reduce::kWideDims)
    return launch_dims<T, V, reduce::kWideDims>(layout, x, out, partials, counters, params, grid, threads, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float64, 1 = float32, 2 = int64; dims: the index width (4 or
// 8); layout: 0 = rows, 1 = columns; vector: elements per load (1, or 16
// bytes' worth). params: the geometry as _geometry.Plan.params lays it out
// for one input. partials holds outputs * splits values of the accumulator
// type (float64 for the floats, int64 for int64) and counters one zeroed
// unsigned per output (rows) or per tile (columns), owned by the launching
// stream; both are unused with one split.
extern "C" int region_sum(int dtype, int dims, int layout, int vector, const void* x, void* out,
                          void* partials, void* counters, const long long* params, int grid,
                          int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vector == 1) return launch<double, 1>(dims, layout, x, out, partials, counters, params, grid, threads, s);
  if (dtype == 0 && vector == 2) return launch<double, 2>(dims, layout, x, out, partials, counters, params, grid, threads, s);
  if (dtype == 1 && vector == 1) return launch<float, 1>(dims, layout, x, out, partials, counters, params, grid, threads, s);
  if (dtype == 1 && vector == 4) return launch<float, 4>(dims, layout, x, out, partials, counters, params, grid, threads, s);
  if (dtype == 2 && vector == 1) return launch<long long, 1>(dims, layout, x, out, partials, counters, params, grid, threads, s);
  if (dtype == 2 && vector == 2) return launch<long long, 2>(dims, layout, x, out, partials, counters, params, grid, threads, s);
  return (int)cudaErrorInvalidValue;
}
