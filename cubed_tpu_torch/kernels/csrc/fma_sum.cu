// K3: fma_sum -- sum(a*x + b*y) over every element of four equal-shaped
// tensors, accumulated in float64, for float64 and float32 inputs.
//
// Replaces the JAX package's Pallas kernel fused_fma_mean (_fma_mean_kernel),
// cubed_tpu/kernels/reductions.py:241-330 at commit 0cd9f84^: the initial
// reduction of pangeo-vorticity's mean(a[1:]*x[1:] + b[1:]*y[1:]), with the
// products and their sum never written to device memory.
//
// Bound on the H100: the four inputs, read once at 3.35 TB/s (a (100, 100,
// 100) float64 block: 32 MB, 0.00955 ms); the 3 flops per element are far
// below the float64 rate. The design keeps enough bytes in flight and spends
// few instructions per byte:
//   - one launch of persistent CTAs (two per SM), each taking a contiguous
//     range of the flattened input; the main path's block views (strides
//     (180000, 400, 1)) are 10,000 rows of 100, and a CTA's threads are
//     packed across rows, so no lane idles at a row's end;
//   - 16-byte loads (double2, float4) when the rows allow them (the "vector"
//     path), else one element a load (the "scalar" path, any strides);
//   - each thread keeps kUnroll independent loads per input in flight, each
//     into its own accumulator;
//   - positions split into coordinates by 32-bit fast division, not 64-bit
//     division (reduce_common.cuh);
//   - the CTA that draws the last ticket sums the per-CTA partials in index
//     order, so no second launch and no atomics on values.
// An input of at most two full CTA steps is taken by one CTA, which writes
// the result itself. Geometry: kernels/_geometry.py.
//
// The products and their sum are rounded as the plain PyTorch version rounds
// them (__dmul_rn/__dadd_rn, or __fmul_rn/__fadd_rn then a widening for
// float32), which nvcc would otherwise contract into an FMA; the kernel and
// the plain version then differ only in summation order.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include "reduce_common.cuh"

namespace {

using reduce::kDims;
using reduce::kUnroll;
using Geometry = reduce::Geometry<4>;

__device__ __forceinline__ double term(double a, double x, double b, double y) {
  return __dadd_rn(__dmul_rn(a, x), __dmul_rn(b, y));
}

__device__ __forceinline__ double term(float a, float x, float b, float y) {
  return (double)__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

template <typename T, int V>
__global__ void __launch_bounds__(256, 2)
    fma_sum_kernel(const T* __restrict__ a, const T* __restrict__ x, const T* __restrict__ b,
                   const T* __restrict__ y, double* __restrict__ out,
                   double* __restrict__ partials, unsigned* __restrict__ counter, Geometry g) {
  const int begin = blockIdx.x * g.per_split;
  const int end = min(begin + g.per_split, g.red_units);
  const int step = blockDim.x * kUnroll;
  double acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = 0.0;
  for (int i = begin + threadIdx.x; i < end; i += step) {
    T va[kUnroll][V], vx[kUnroll][V], vb[kUnroll][V], vy[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * blockDim.x;
      if (j < end) {
        int c[kDims];
        reduce::coords(g.red, j, c);
        reduce::load<T, V>(a + reduce::dot(c, g.rstride[0]), va[u]);
        reduce::load<T, V>(x + reduce::dot(c, g.rstride[1]), vx[u]);
        reduce::load<T, V>(b + reduce::dot(c, g.rstride[2]), vb[u]);
        reduce::load<T, V>(y + reduce::dot(c, g.rstride[3]), vy[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * (int)blockDim.x < end) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[u] += term(va[u][e], vx[u][e], vb[u][e], vy[u][e]);
      }
    }
  }
  const double total = reduce::block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) out[0] = total;
    return;
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
  if (!reduce::last_to_arrive(counter, gridDim.x)) return;
  double s = 0.0;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) s += reduce::load_partial(partials + k);
  s = reduce::block_sum(s);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T, int V>
int launch(const void* a, const void* x, const void* b, const void* y, void* out,
           void* partials, void* counter, const Geometry& g, int grid, int threads,
           cudaStream_t stream) {
  fma_sum_kernel<T, V><<<grid, threads, 0, stream>>>(
      (const T*)a, (const T*)x, (const T*)b, (const T*)y, (double*)out, (double*)partials,
      (unsigned*)counter, g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float64, 1 = float32; vector: elements per load (1, or 2 for
// float64 / 4 for float32 on the vector path). params: the geometry as
// _geometry.Plan.params lays it out for four inputs (a, x, b, y). out is one
// float64; partials holds grid float64s and counter one zeroed unsigned
// owned by the launching stream (both unused when grid == 1).
extern "C" int fma_sum(int dtype, int vector, const void* a, const void* x, const void* b,
                       const void* y, void* out, void* partials, void* counter,
                       const long long* params, int grid, int threads, void* stream) {
  const Geometry g = reduce::unpack<4>(params);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vector == 1) return launch<double, 1>(a, x, b, y, out, partials, counter, g, grid, threads, s);
  if (dtype == 0 && vector == 2) return launch<double, 2>(a, x, b, y, out, partials, counter, g, grid, threads, s);
  if (dtype == 1 && vector == 1) return launch<float, 1>(a, x, b, y, out, partials, counter, g, grid, threads, s);
  if (dtype == 1 && vector == 4) return launch<float, 4>(a, x, b, y, out, partials, counter, g, grid, threads, s);
  return (int)cudaErrorInvalidValue;
}
