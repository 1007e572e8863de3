// numpy's Philox4x64-10 on the card: the rounds and the uniform double.
//
// Element j of a block, in the block's own C order, is word j % 4 of
// philox4x64_10(counter=(j/4 + 1, 0, 0, 0), key): numpy increments the
// counter before its first use. The double is (u >> 11) * 2^-53, as numpy's
// next_double.
//
// The card has no 64-bit multiplier: each of a counter's twenty 64x64->128
// products becomes IMAD.WIDE instructions (two FMA-pipe issue slots each),
// so integer issue on the FMA pipe, not the 8 bytes written per element,
// bounds a kernel built on these rounds (SASS, sm_90a).

#pragma once

namespace philox {

constexpr unsigned long long kM0 = 0xD2E7470EE14C6C93ULL;
constexpr unsigned long long kM1 = 0xCA5A826395121157ULL;
constexpr unsigned long long kW0 = 0x9E3779B97F4A7C15ULL;
constexpr unsigned long long kW1 = 0xBB67AE8584CAA73BULL;

// The four words of philox4x64_10(counter=(ctr, 0, 0, 0), key=(k0, k1)).
__device__ __forceinline__ void philox4x64_10(unsigned long long ctr, unsigned long long k0,
                                              unsigned long long k1, unsigned long long (&w)[4]) {
  unsigned long long c0 = ctr, c1 = 0ULL, c2 = 0ULL, c3 = 0ULL;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const unsigned long long hi0 = __umul64hi(kM0, c0);
    const unsigned long long lo0 = kM0 * c0;
    const unsigned long long hi1 = __umul64hi(kM1, c2);
    const unsigned long long lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  w[0] = c0;
  w[1] = c1;
  w[2] = c2;
  w[3] = c3;
}

__device__ __forceinline__ double unit(unsigned long long u) {
  return (double)(u >> 11) * (1.0 / 9007199254740992.0);  // 2^-53
}

}  // namespace philox
