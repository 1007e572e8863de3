// Philox's rounds alone, for chip_smoke.py: what the integer pipes cost
// without the stores. Not part of cubed_tpu_torch.
//
// The launch covers the same work items as philox_uniform_blocks_f64 (item
// i is tile i % per_block of block i / per_block, a tile being kThreads *
// kCounters counters), runs the same rounds (philox.cuh of the package's
// kernels), and stores nothing unless a counter's four words XOR to one
// 64-bit value, so the compiler keeps every round. Its SASS, divided by
// kCounters, is the fewest integer issue slots a counter takes in any build
// of the rounds; its time beside that count's issue floor says whether
// IMAD.WIDE takes two FMA-pipe slots.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC -I cubed_tpu_torch/kernels/csrc -o <lib> philox_rounds.cu

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;  // as philox_uniform.cu
constexpr int kCounters = 4;

// counters: each block's counter count; d: work items per block, with
// i / d == umulhi(i, mul) >> shr (d > 1, so mul is not 0; one division
// sequence, and the item loop is not unrolled, so the SASS holds one copy
// of a work item's code)
__global__ void __launch_bounds__(kThreads, 3)
    philox_rounds_kernel(double* __restrict__ out, const ulonglong2* __restrict__ keys,
                         const int* __restrict__ counters, int d, unsigned mul, int shr, int items) {
  constexpr int kTile = kThreads * kCounters;
#pragma unroll 1
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = (int)(__umulhi((unsigned)item, mul) >> shr);
    const int first = (item - b * d) * kTile;
    if (first >= counters[b]) continue;
    const ulonglong2 key = keys[b];
    unsigned long long w[kCounters][4];
#pragma unroll
    for (int k = 0; k < kCounters; ++k) {
      philox::philox4x64_10((unsigned long long)(first + k * kThreads + threadIdx.x) + 1ULL, key.x, key.y, w[k]);
    }
#pragma unroll
    for (int k = 0; k < kCounters; ++k) {
      if ((w[k][0] ^ w[k][1] ^ w[k][2] ^ w[k][3]) == 0x0123456789ABCDEFULL) out[first] = 1.0;
    }
  }
}

}  // namespace

extern "C" int philox_rounds_f64(void* out, const void* keys, const void* counters, int d, unsigned mul,
                                 int shr, int items, int grid, void* stream) {
  philox_rounds_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (double*)out, (const ulonglong2*)keys, (const int*)counters, d, mul, shr, items);
  return (int)cudaGetLastError();
}
