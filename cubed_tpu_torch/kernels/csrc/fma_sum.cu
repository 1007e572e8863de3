// K3: fma_sum -- sum(a*x + b*y) over every element of four equal-shaped
// tensors, accumulated in float64, for float64 and float32 inputs.
//
// Replaces the JAX package's Pallas kernel fused_fma_mean (_fma_mean_kernel),
// cubed_tpu/kernels/reductions.py:241-330 at commit 0cd9f84^: the initial
// reduction of pangeo-vorticity's mean(a[1:]*x[1:] + b[1:]*y[1:]), with the
// products and their sum never written to device memory.
//
// The Pallas kernel carried one (8, 128) float32 accumulator across a grid the
// TPU runs in order (the TPU has no float64). On Hopper the CTAs run in
// parallel and in no order, so:
//   pass 1: the work is cut into tasks of one row segment each (a row is the
//           innermost axis; a segment is up to SEG elements of it). Each warp
//           walks tasks in a grid-stride loop, its lanes reading neighbouring
//           elements, and each CTA writes one float64 partial;
//   pass 2: one CTA sums the partials in a fixed order.
// No atomics: the grid and every reduction order follow from the shape alone,
// so a result is bitwise the same from run to run.
//
// Each input has its own element strides (up to four axes), so a block view
// of a resident array -- strides (180000, 400, 1) on the main path -- is read
// in place, never copied. The products and their sum are rounded as the plain
// PyTorch version rounds them (__dmul_rn/__dadd_rn, or __fmul_rn/__fadd_rn
// then a widening for float32), which nvcc would otherwise contract into an
// FMA; the kernel and the plain version then differ only in summation order.
//
// Bound on the H100: the four inputs, read once at 3.35 TB/s (a (100, 100,
// 100) float64 block: 32 MB, 0.00955 ms); the 3 flops per element are far
// below the float64 rate.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 256;  // elements of a row one warp takes per task
constexpr int kLanes = 32;

struct Geometry {
  long long shape[4];       // axes padded to four in front with size 1
  long long stride[4][4];   // element strides of a, x, b, y per axis
  long long rows;           // shape[0] * shape[1] * shape[2]
  long long segs;           // ceil(shape[3] / kSeg)
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the CTA (blockDim.x a multiple of 32); valid in thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_totals[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_totals[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    v = lane < nwarps ? warp_totals[lane] : 0.0;
    v = warp_sum(v);
  }
  return v;
}

__device__ __forceinline__ double term(double a, double x, double b, double y) {
  return __dadd_rn(__dmul_rn(a, x), __dmul_rn(b, y));
}

__device__ __forceinline__ double term(float a, float x, float b, float y) {
  return (double)__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

template <typename T>
__global__ void fma_sum_partials(const T* __restrict__ a, const T* __restrict__ x,
                                 const T* __restrict__ b, const T* __restrict__ y,
                                 double* __restrict__ partials, Geometry g) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_cta = blockDim.x >> 5;
  const long long gwarp = (long long)blockIdx.x * warps_per_cta + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * warps_per_cta;
  const long long inner = g.shape[3];
  const long long tasks = g.rows * g.segs;
  double acc = 0.0;
  for (long long task = gwarp; task < tasks; task += nwarps) {
    const long long row = task / g.segs;
    const long long seg0 = (task - row * g.segs) * kSeg;
    const long long i2 = row % g.shape[2];
    const long long t = row / g.shape[2];
    const long long i1 = t % g.shape[1];
    const long long i0 = t / g.shape[1];
    const T* pa = a + i0 * g.stride[0][0] + i1 * g.stride[0][1] + i2 * g.stride[0][2];
    const T* px = x + i0 * g.stride[1][0] + i1 * g.stride[1][1] + i2 * g.stride[1][2];
    const T* pb = b + i0 * g.stride[2][0] + i1 * g.stride[2][1] + i2 * g.stride[2][2];
    const T* py = y + i0 * g.stride[3][0] + i1 * g.stride[3][1] + i2 * g.stride[3][2];
    const long long sa = g.stride[0][3], sx = g.stride[1][3];
    const long long sb = g.stride[2][3], sy = g.stride[3][3];
#pragma unroll
    for (int k = 0; k < kSeg / kLanes; ++k) {
      const long long j = seg0 + k * kLanes + lane;
      if (j < inner) acc += term(pa[j * sa], px[j * sx], pb[j * sb], py[j * sy]);
    }
  }
  const double total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void fma_sum_combine(const double* __restrict__ partials, double* __restrict__ out,
                                int P) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < P; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

template <typename T>
int launch(const void* a, const void* x, const void* b, const void* y, void* out,
           void* partials, const Geometry& g, int P, int threads, cudaStream_t stream) {
  fma_sum_partials<T><<<P, threads, 0, stream>>>((const T*)a, (const T*)x, (const T*)b,
                                                 (const T*)y, (double*)partials, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int combine_threads = P >= 1024 ? 1024 : ((P + 31) / 32) * 32;
  fma_sum_combine<<<1, combine_threads, 0, stream>>>((const double*)partials, (double*)out, P);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float64, 1 = float32. shape holds four sizes (leading axes of
// size 1 pad a lower rank); strides holds 16 element strides, four per input
// in the order a, x, b, y. out is one float64; partials holds P float64s.
extern "C" int fma_sum(int dtype, const void* a, const void* x, const void* b, const void* y,
                       void* out, void* partials, const long long* shape,
                       const long long* strides, int P, int threads, void* stream) {
  Geometry g;
  for (int d = 0; d < 4; ++d) {
    g.shape[d] = shape[d];
    for (int k = 0; k < 4; ++k) g.stride[k][d] = strides[4 * k + d];
  }
  g.rows = shape[0] * shape[1] * shape[2];
  g.segs = (shape[3] + kSeg - 1) / kSeg;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<double>(a, x, b, y, out, partials, g, P, threads, s);
    case 1:
      return launch<float>(a, x, b, y, out, partials, g, P, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
