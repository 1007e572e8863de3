// K3: fma_sum_blocks -- sum(a*x + b*y) of every block of a blocked grid of
// four equal-shaped tensors, in one launch, accumulated in float64, for
// float64 and float32 inputs.
//
// Replaces the JAX package's Pallas kernel fused_fma_mean (_fma_mean_kernel),
// cubed_tpu/kernels/reductions.py:241-330 at commit 0cd9f84^: the initial
// reduction of pangeo-vorticity's mean(a[1:]*x[1:] + b[1:]*y[1:]), with the
// products and their sum never written to device memory. The device
// executor's fusion rule sends it every block of the op at once (the main
// path: 100 blocks at (500, 450, 400) / 100) and, when the inputs are not all
// resident, each block as a grid of one block.
//
// Work items are (block, tile): CTA i sums tile i % per_block of block
// i / per_block (blocks in C order of the grid), reading the four inputs in
// place through their strides (the [1:] views of resident arrays), 16-byte
// loads (double2, float4) where every block's rows allow them, else one
// element a load; each thread keeps kUnroll independent loads per input in
// flight, each into its own accumulator. A grid of few blocks takes smaller
// tiles, so that a launch still fills the card. Each block's extent along
// an axis is the full chunk or, for the last block there, the edge;
// positions split into coordinates by 32-bit fast division. With more than
// one tile a block, each CTA writes a partial and takes a ticket from its
// block's counter; the CTA that draws the block's last ticket sums the
// block's partials in tile order and writes the block's total in place into
// the (nb0, nb1, ...) output. The order of every sum follows from the shape
// alone and no atomic touches a value, so results are bitwise reproducible.
//
// The products and their sum are rounded as the plain PyTorch version rounds
// them (__dmul_rn/__dadd_rn, or __fmul_rn/__fadd_rn then a widening for
// float32), which nvcc would otherwise contract into an FMA; the kernel and
// the plain version then differ only in summation order.
//
// Bound on the H100: the four inputs, read once at 3.35 TB/s (main path:
// 4 x 718.56 MB, 0.858 ms); the 3 flops per element are far below the
// float64 rate. Geometry: kernels/_geometry.py (fma_blocks_plan).
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include "reduce_common.cuh"

namespace {

using reduce::kDims;
using reduce::kUnroll;

__device__ __forceinline__ double term(double a, double x, double b, double y) {
  return __dadd_rn(__dmul_rn(a, x), __dmul_rn(b, y));
}

__device__ __forceinline__ double term(float a, float x, float b, float y) {
  return (double)__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

struct Div {
  int d;
  unsigned mul;
  int shr;
};

struct BlocksGeometry {
  Div chunk[kDims];  // a full block's extent per axis (innermost in units)
  Div edge[kDims];   // the last block's extent per axis
  Div nb[kDims];     // blocks per axis
  int stride[4][kDims];  // per input (innermost in units of V elements)
  Div per_block;     // work items a block
  int tile;          // units a work item sums
  int items;
};

BlocksGeometry unpack_blocks(const long long* p) {
  BlocksGeometry g;
  Div* divs[3] = {g.chunk, g.edge, g.nb};
  for (int which = 0; which < 3; ++which)
    for (int d = 0; d < kDims; ++d) {
      divs[which][d].d = (int)*p++;
      divs[which][d].mul = (unsigned)*p++;
      divs[which][d].shr = (int)*p++;
    }
  for (int k = 0; k < 4; ++k)
    for (int d = 0; d < kDims; ++d) g.stride[k][d] = (int)*p++;
  g.per_block.d = (int)*p++;
  g.per_block.mul = (unsigned)*p++;
  g.per_block.shr = (int)*p++;
  g.tile = (int)*p++;
  g.items = (int)*p++;
  return g;
}

__device__ __forceinline__ int quot(int i, const Div& v) { return reduce::quot(i, v.mul, v.shr); }

template <typename T, int V>
__global__ void __launch_bounds__(256, 2)
    fma_blocks_kernel(const T* __restrict__ a, const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ y, double* __restrict__ out,
                      double* __restrict__ partials, unsigned* __restrict__ counters,
                      BlocksGeometry g) {
  const int item = blockIdx.x;
  const int blk = quot(item, g.per_block);
  const int tile = item - blk * g.per_block.d;
  // the block's coordinates, extents and base offsets
  Div ext[kDims];
  int base[4] = {0, 0, 0, 0};
  int units = 1;
  int rest = blk;
#pragma unroll
  for (int d = kDims - 1; d >= 0; --d) {
    int c = rest;
    if (d > 0) {
      const int q = quot(rest, g.nb[d]);
      c = rest - q * g.nb[d].d;
      rest = q;
    }
    ext[d] = c == g.nb[d].d - 1 ? g.edge[d] : g.chunk[d];
    units *= ext[d].d;
#pragma unroll
    for (int k = 0; k < 4; ++k) base[k] += c * g.chunk[d].d * g.stride[k][d];
  }
  const int begin = tile * g.tile;
  const int end = min(begin + g.tile, units);
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
        int r = j;
#pragma unroll
        for (int d = kDims - 1; d > 0; --d) {
          const int q = quot(r, ext[d]);
          c[d] = r - q * ext[d].d;
          r = q;
        }
        c[0] = r;
        reduce::load<T, V>(a + base[0] + reduce::dot(c, g.stride[0]), va[u]);
        reduce::load<T, V>(x + base[1] + reduce::dot(c, g.stride[1]), vx[u]);
        reduce::load<T, V>(b + base[2] + reduce::dot(c, g.stride[2]), vb[u]);
        reduce::load<T, V>(y + base[3] + reduce::dot(c, g.stride[3]), vy[u]);
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
  if (g.per_block.d == 1) {
    if (threadIdx.x == 0) out[blk] = total;
    return;
  }
  if (threadIdx.x == 0) partials[item] = total;
  if (!reduce::last_to_arrive(counters + blk, g.per_block.d)) return;
  double s = 0.0;
  for (int k = threadIdx.x; k < g.per_block.d; k += blockDim.x)
    s += reduce::load_partial(partials + (long long)blk * g.per_block.d + k);
  s = reduce::block_sum(s);
  if (threadIdx.x == 0) out[blk] = s;
}

template <typename T, int V>
int launch_blocks(const void* a, const void* x, const void* b, const void* y, void* out,
                  void* partials, void* counters, const BlocksGeometry& g, cudaStream_t stream) {
  fma_blocks_kernel<T, V><<<g.items, 256, 0, stream>>>(
      (const T*)a, (const T*)x, (const T*)b, (const T*)y, (double*)out, (double*)partials,
      (unsigned*)counters, g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float64, 1 = float32; vector: elements per load (1, or 2 for
// float64 / 4 for float32). params: the geometry as
// _geometry.FmaBlocksPlan.params lays it out. out holds one float64 per
// block (C order of the grid); partials one float64 per work item and
// counters one zeroed unsigned per block, owned by the launching stream
// (both unused with one work item a block). One CTA of 256 threads a work
// item.
extern "C" int fma_sum_blocks(int dtype, int vector, const void* a, const void* x, const void* b,
                              const void* y, void* out, void* partials, void* counters,
                              const long long* params, void* stream) {
  const BlocksGeometry g = unpack_blocks(params);
  cudaStream_t s = (cudaStream_t)stream;
  if (g.items <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vector == 1) return launch_blocks<double, 1>(a, x, b, y, out, partials, counters, g, s);
  if (dtype == 0 && vector == 2) return launch_blocks<double, 2>(a, x, b, y, out, partials, counters, g, s);
  if (dtype == 1 && vector == 1) return launch_blocks<float, 1>(a, x, b, y, out, partials, counters, g, s);
  if (dtype == 1 && vector == 4) return launch_blocks<float, 4>(a, x, b, y, out, partials, counters, g, s);
  return (int)cudaErrorInvalidValue;
}
