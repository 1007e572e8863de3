// K1: philox_uniform -- numpy's Philox4x64-10 uniform float64 stream, on the card,
// as float64 or rounded to float32.
//
// Replaces the host-side block generation of the JAX package's
// random.py:_random_block (:217) / _philox_block (:137), which draw
// np.random.Generator(np.random.Philox(seed=s)).random(shape). The stream
// and its rounds are in philox.cuh; both entry points run them.
//
// Bound on the H100: integer issue on the FMA pipe. The card has no 64-bit
// multiplier: each of a counter's twenty 64x64->128 products becomes
// IMAD.WIDE instructions (two issue slots each), 164-178 FMA-pipe slots a
// counter against 91-108 on the ALU pipe, by build (SASS, sm_90a). At 64
// lanes per clock per SM that is a little above the 8 bytes written per
// element at 3.35 TB/s (4 bytes in float32: the integer floor bounds it still).
//
// Both kernels are templates on the output type. A float32 element is the
// float64 element rounded to the nearest float32 (__double2float_rn): the
// JAX package's float32 block under compute_dtype="float32", which casts its
// float64 draw. Where the float64 path stores a counter's four words as two
// 16-byte stores, the float32 path stores them as one (float4).
//
// Two kernels, each with an entry point per output type (_f64, _f32):
//   - philox_uniform_f64/_f32: one block, one counter per thread (the sequential
//     executor's tasks and fused random ops call it block by block);
//   - philox_uniform_blocks_f64/_f32: every block of a random op in one launch,
//     written in place into the assembled output. A persistent grid (as many
//     CTAs as fit, from the occupancy that the register count allows) strides
//     over work items (block, tile of kThreads * kCounters counters); each
//     thread takes kCounters counters, whose rounds the compiler interleaves,
//     so no wave of one-counter threads leaves ramp and tail exposed. A
//     counter's block-local elements are unravelled by the block's shape
//     (32-bit fast division; a ragged edge block's extent is
//     min(chunk, dim - origin)) and placed through the output's strides;
//     where a block's rows allow it (last extent a multiple of 4, 16-byte
//     aligned) a counter's four words go out as 16-byte stores. Geometry
//     and the vector-or-scalar choice: kernels/_geometry.py:blocks_plan.
//     Three CTAs of 256 fit an SM (at most 80 registers a thread, no spills
//     at four counters); the rounds keep the FMA pipe busy, and the stores
//     of one item overlap the next item's rounds.
//
// Plain C interface for ctypes: the launches return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using philox::philox4x64_10;
using philox::unit;

constexpr int kDims = 4;
constexpr int kThreads = 256;  // _geometry.PHILOX_THREADS
constexpr int kCounters = 4;   // counters a thread takes per work item (_geometry.PHILOX_COUNTERS)

// A uniform of word u in the output type: the double, or it rounded to the
// nearest float.
template <typename T>
__device__ __forceinline__ T value(unsigned long long u);

template <>
__device__ __forceinline__ double value<double>(unsigned long long u) {
  return unit(u);
}

template <>
__device__ __forceinline__ float value<float>(unsigned long long u) {
  return __double2float_rn(unit(u));
}

// A counter's four values at o, 16-byte aligned: two double2 or one float4.
__device__ __forceinline__ void store4(double* o, double v0, double v1, double v2, double v3) {
  reinterpret_cast<double2*>(o)[0] = make_double2(v0, v1);
  reinterpret_cast<double2*>(o)[1] = make_double2(v2, v3);
}

__device__ __forceinline__ void store4(float* o, float v0, float v1, float v2, float v3) {
  *reinterpret_cast<float4*>(o) = make_float4(v0, v1, v2, v3);
}

template <typename T>
__global__ void philox_uniform_kernel(T* __restrict__ out, long long n,
                                      unsigned long long key0,
                                      unsigned long long key1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long base = 4 * i;
  if (base >= n) return;
  unsigned long long w[4];
  philox4x64_10((unsigned long long)i + 1ULL, key0, key1, w);
  const T v0 = value<T>(w[0]), v1 = value<T>(w[1]), v2 = value<T>(w[2]), v3 = value<T>(w[3]);
  if (base + 3 < n) {
    if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      // 16-byte stores: base is a multiple of 4 elements
      store4(out + base, v0, v1, v2, v3);
    } else {
      out[base] = v0;
      out[base + 1] = v1;
      out[base + 2] = v2;
      out[base + 3] = v3;
    }
  } else {
    out[base] = v0;
    if (base + 1 < n) out[base + 1] = v1;
    if (base + 2 < n) out[base + 2] = v2;
  }
}

// ---------------------------------------------------------------------------
// every block of a random op in one launch
// ---------------------------------------------------------------------------

// A divisor with its fast-division multiplier (CUTLASS's FastDivmod):
// i / d == umulhi(i, mul) >> shr for 0 <= i < 2^31; mul == 0 stands for d == 1.
struct Div {
  int d;
  unsigned mul;
  int shr;
};

__device__ __forceinline__ int quot(const Div& v, int i) {
  return v.mul ? (int)(__umulhi((unsigned)i, v.mul) >> v.shr) : i;
}

// The params array as _geometry.BlocksPlan.params lays it out. Axes are
// padded in front to kDims with size 1 and stride 0.
struct Blocks {
  int stride[kDims];  // output strides, in elements
  Div chunk[kDims];   // a full block's extent per axis
  Div edge[kDims];    // the last block's extent per axis
  Div nb[kDims];      // blocks per axis
  Div per_block;      // work items per block
  int items;          // work items in all: blocks * per_block
  int vector_full;    // blocks not last along the last axis take 16-byte stores
  int vector_edge;    // the last block along the last axis does
};

Blocks unpack(const long long* p) {
  Blocks g;
  for (int d = 0; d < kDims; ++d) g.stride[d] = (int)*p++;
  Div* divs[3] = {g.chunk, g.edge, g.nb};
  for (int k = 0; k < 3; ++k) {
    for (int d = 0; d < kDims; ++d) {
      divs[k][d].d = (int)*p++;
      divs[k][d].mul = (unsigned)*p++;
      divs[k][d].shr = (int)*p++;
    }
  }
  g.per_block.d = (int)*p++;
  g.per_block.mul = (unsigned)*p++;
  g.per_block.shr = (int)*p++;
  g.items = (int)*p++;
  g.vector_full = (int)*p++;
  g.vector_edge = (int)*p++;
  return g;
}

// Element offset, from the block's origin, of block-local element e.
__device__ __forceinline__ int local_offset(const Div (&ext)[kDims], const int (&stride)[kDims], int e) {
  int off = 0;
#pragma unroll
  for (int d = kDims - 1; d > 0; --d) {
    const int q = quot(ext[d], e);
    off += (e - q * ext[d].d) * stride[d];
    e = q;
  }
  return off + e * stride[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    philox_blocks_kernel(T* __restrict__ out, const ulonglong2* __restrict__ keys, const Blocks g) {
  constexpr int kTile = kThreads * kCounters;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const int b = quot(g.per_block, item);
    const int first = (item - b * g.per_block.d) * kTile;
    // the block's grid coordinates (innermost first), extent and origin
    Div ext[kDims];
    int rest = b, n = 1, base = 0;
    bool last_inner = false;
#pragma unroll
    for (int d = kDims - 1; d >= 0; --d) {
      const int q = d ? quot(g.nb[d], rest) : 0;
      const int coord = d ? rest - q * g.nb[d].d : rest;
      rest = q;
      const bool last = coord == g.nb[d].d - 1;
      if (d == kDims - 1) last_inner = last;
      ext[d] = last ? g.edge[d] : g.chunk[d];
      n *= ext[d].d;
      base += coord * g.chunk[d].d * g.stride[d];
    }
    const int counters = (n + 3) >> 2;
    if (first >= counters) continue;  // the same for the whole CTA
    const ulonglong2 key = keys[b];
    const bool vector = last_inner ? g.vector_edge : g.vector_full;
    unsigned long long w[kCounters][4];
#pragma unroll
    for (int k = 0; k < kCounters; ++k) {
      philox4x64_10((unsigned long long)(first + k * kThreads + threadIdx.x) + 1ULL, key.x, key.y, w[k]);
    }
#pragma unroll
    for (int k = 0; k < kCounters; ++k) {
      const int c = first + k * kThreads + threadIdx.x;
      if (c >= counters) break;
      if (vector) {
        // the four words lie in one row, 16-byte aligned
        store4(out + base + local_offset(ext, g.stride, 4 * c), value<T>(w[k][0]), value<T>(w[k][1]),
               value<T>(w[k][2]), value<T>(w[k][3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * c + j;
          if (e < n) out[base + local_offset(ext, g.stride, e)] = value<T>(w[k][j]);
        }
      }
    }
  }
}

template <typename T>
int launch_block(void* out, long long n, unsigned long long key0, unsigned long long key1, int threads,
                 void* stream) {
  const long long counters = (n + 3) / 4;
  const long long blocks = (counters + threads - 1) / threads;
  philox_uniform_kernel<T><<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>((T*)out, n, key0, key1);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy() {
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, philox_blocks_kernel<T>, kThreads, 0) != cudaSuccess) {
    return -1;
  }
  return ctas;
}

template <typename T>
int launch_blocks(void* out, const long long* params, const void* keys, int grid, void* stream) {
  const Blocks g = unpack(params);
  philox_blocks_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>((T*)out, (const ulonglong2*)keys, g);
  return (int)cudaGetLastError();
}

}  // namespace

// out: a contiguous block of n elements; one counter per thread.
extern "C" int philox_uniform_f64(void* out, long long n, unsigned long long key0, unsigned long long key1,
                                  int threads, void* stream) {
  return launch_block<double>(out, n, key0, key1, threads, stream);
}

extern "C" int philox_uniform_f32(void* out, long long n, unsigned long long key0, unsigned long long key1,
                                  int threads, void* stream) {
  return launch_block<float>(out, n, key0, key1, threads, stream);
}

// CTAs of philox_blocks_kernel that fit on one SM at once (its registers
// decide), or -1 on an error.
extern "C" int philox_uniform_blocks_occupancy_f64() { return occupancy<double>(); }

extern "C" int philox_uniform_blocks_occupancy_f32() { return occupancy<float>(); }

// out: the assembled output; params: _geometry.BlocksPlan.params (for the
// output's element size); keys: the op's block keys on the card, two uint64
// a block in C order of the block grid (16-byte aligned); grid: persistent
// CTAs of kThreads threads.
extern "C" int philox_uniform_blocks_f64(void* out, const long long* params, const void* keys, int grid,
                                         void* stream) {
  return launch_blocks<double>(out, params, keys, grid, stream);
}

extern "C" int philox_uniform_blocks_f32(void* out, const long long* params, const void* keys, int grid,
                                         void* stream) {
  return launch_blocks<float>(out, params, keys, grid, stream);
}
