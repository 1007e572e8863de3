// Shared pieces of the reduction kernels (fma_sum.cu, region_sum.cu): the
// geometry the wrapper plans (kernels/_geometry.py), index decomposition by
// 32-bit fast division, 16-byte loads, CTA sums and the last-CTA combine.
//
// Geometry. An index space is up to four merged axes (eight in the wide
// instantiation, for grid views of blocks), innermost last, padded in front
// with size-1 axes. A position i splits into coordinates by
// dividing with a precomputed multiplier (CUTLASS's FastDivmod:
// q = umulhi(i, mul) >> shr, exact for 0 <= i < 2^31; mul == 0 stands for
// size 1); each input's element offset is the dot product of the
// coordinates with its strides. The wrapper checks that every offset and
// count fits an int with room for one step, so all index arithmetic is
// 32-bit.
//
// Tickets. With more than one split, every CTA of an output writes a partial
// and takes a ticket from that output's counter (an acquire-release atomic); the CTA that draws
// the last ticket sums the partials in index order, writes the output and
// sets the counter back to 0. No atomic touches a value, so a result is
// bitwise the same from run to run. A counter belongs to one stream: the
// wrapper keeps one buffer of counters per (device, stream), all 0 between
// launches, and launches on two streams never share one.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reduce {

constexpr int kDims = 4;  // the narrow index (Plan.dims 4)
constexpr int kWideDims = 8;  // the wide index (Plan.dims 8): grid views of blocks
constexpr int kUnroll = 4;  // units a thread loads per input per step (UNROLL)

template <int kD>
struct Index {
  int size[kD];
  unsigned mul[kD];
  int shr[kD];
};

// The layout of the params array the C entry points take (see
// _geometry.Plan.params): for the kept then the reduced index, sizes,
// multipliers, shifts, then kInputs x kD strides; then five counts.
template <int kInputs, int kD = kDims>
struct Geometry {
  Index<kD> kept;
  int kstride[kInputs][kD];
  Index<kD> red;
  int rstride[kInputs][kD];
  int out_units;  // rows: outputs; columns: outputs / V
  int red_units;  // rows: reduced elements / V; columns: reduced elements
  int splits;
  int per_split;  // reduced units one CTA takes
  int outputs;    // output elements
};

template <int kInputs, int kD = kDims>
inline Geometry<kInputs, kD> unpack(const long long* p) {
  Geometry<kInputs, kD> g;
  Index<kD>* idx[2] = {&g.kept, &g.red};
  int(*st[2])[kD] = {g.kstride, g.rstride};
  for (int which = 0; which < 2; ++which) {
    for (int d = 0; d < kD; ++d) idx[which]->size[d] = (int)*p++;
    for (int d = 0; d < kD; ++d) idx[which]->mul[d] = (unsigned)*p++;
    for (int d = 0; d < kD; ++d) idx[which]->shr[d] = (int)*p++;
    for (int k = 0; k < kInputs; ++k)
      for (int d = 0; d < kD; ++d) st[which][k][d] = (int)*p++;
  }
  g.out_units = (int)*p++;
  g.red_units = (int)*p++;
  g.splits = (int)*p++;
  g.per_split = (int)*p++;
  g.outputs = (int)*p++;
  return g;
}

// i / d by the precomputed multiplier (mul == 0 stands for d == 1).
__device__ __forceinline__ int quot(int i, unsigned mul, int shr) {
  return mul ? (int)(__umulhi((unsigned)i, mul) >> shr) : i;
}

// Coordinates of position i of idx, outermost first.
template <int kD>
__device__ __forceinline__ void coords(const Index<kD>& idx, int i, int (&c)[kD]) {
#pragma unroll
  for (int d = kD - 1; d > 0; --d) {
    const int q = quot(i, idx.mul[d], idx.shr[d]);
    c[d] = i - q * idx.size[d];
    i = q;
  }
  c[0] = i;
}

template <int kD>
__device__ __forceinline__ int dot(const int (&c)[kD], const int (&s)[kD]) {
  int r = 0;
#pragma unroll
  for (int d = 0; d < kD; ++d) r += c[d] * s[d];
  return r;
}

// V elements from p: one 16-byte load when V > 1 (p 16-byte aligned), else
// one element. Read-only path: every byte is read once.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, T (&v)[V]);

template <>
__device__ __forceinline__ void load<double, 1>(const double* p, double (&v)[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load<float, 1>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load<long long, 1>(const long long* p, long long (&v)[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load<double, 2>(const double* p, double (&v)[2]) {
  const double2 w = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = w.x;
  v[1] = w.y;
}
template <>
__device__ __forceinline__ void load<float, 4>(const float* p, float (&v)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
template <>
__device__ __forceinline__ void load<long long, 2>(const long long* p, long long (&v)[2]) {
  const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(p));
  v[0] = w.x;
  v[1] = w.y;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the CTA (blockDim.x a multiple of 32, at most 1024), in a fixed
// order; valid in thread 0. Ends with every warp past its shared-memory use
// only after the next __syncthreads.
template <typename A>
__device__ __forceinline__ A block_sum(A v) {
  __shared__ A warp_totals[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_totals[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    v = lane < nwarps ? warp_totals[lane] : A(0);
    v = warp_sum(v);
  }
  return v;
}

// After this CTA's partials are stored: take a ticket from *counter; true in
// every thread of the CTA that drew the last of `arrivals`, which then resets
// the counter. The barrier orders the CTA's partial stores before thread 0's
// ticket; the ticket is an acquire-release atomic at device scope, so it
// publishes this CTA's partials and, for the last CTA, makes every other
// CTA's visible (the fence each CTA would otherwise run, folded into the
// atomic).
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, unsigned arrivals) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(*counter);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == arrivals - 1;
    if (last) ticket.store(0u, cuda::memory_order_relaxed);  // no other CTA of this launch touches it
  }
  __syncthreads();
  return last;
}

// A partial written by another CTA of this launch: read from L2, past L1.
__device__ __forceinline__ double load_partial(const double* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned long long load_partial(const unsigned long long* p) {
  return __ldcg(p);
}

}  // namespace reduce
