// flash_block -- one step of ring attention's online softmax: the scores of a
// block of queries against one block of keys, folded into the running
// maximum m, denominator l and unnormalized output o, in place.
//
// Replaces the per-device body of the JAX package's ring attention,
// cubed_tpu/parallel/ring_attention.py:_ring_attention_local (:51-118; its
// loop body :75-108): at ring step s, device i holds the K/V block of device
// (i - s) % n and updates (o, l, m) with
//   scores = (q . k^T) * scale, -inf where the causal mask hides a key
//            (q_pos >= k_pos, positions global: q_pos = q_offset + row,
//            k_pos = k_offset + column);
//   m_new  = max(m, rowmax(scores)); safe = (m_new == -inf) ? 0 : m_new;
//   p      = exp(scores - safe), 0 where masked;
//   corr   = (m == -inf) ? 0 : exp(m - safe);
//   l      = l * corr + rowsum(p); o = o * corr + p . v.
// The JAX body computes that over the whole block at once and returns new
// arrays; this kernel walks the block's keys a tile at a time with the same
// recurrence (the same result up to rounding) and overwrites o, l and m.
// The final o / l (l == 0 -> 1) is not part of a step: the ring's epilogue
// does it in torch (parallel/ring_attention.py).
//
// Layout: q (B, S_q, H, D) and k, v (B, S_k, H, D) read in place through
// their batch, sequence and head strides (the head dimension contiguous),
// in float32, float16 or bfloat16, widened to float32; o (B, H, S_q, D),
// l and m (B, H, S_q), float32, contiguous.
//
// One CTA of 256 threads per (batch, head, 64-query tile). The query tile
// sits in shared memory for the CTA's life; the CTA loops over 64-key tiles
// of the block, staging K and V in shared memory. A thread owns 4 query rows
// (ty + 16 i) and, of the scores, 4 key columns (tx + 16 j): 16 scores from
// 16-byte loads of Q and K rows; a row's max and sum are reduced over the 16
// lanes that share it by warp shuffles. Its 4 rows of o stay in registers
// (columns 4 tx + 64 j' + t), scaled by corr each tile, and gain P . V with P
// written over the K tile's shared memory. The head dimension is padded to
// DP = 64, 128 or 256 (zeros: no score changes); a larger one is refused.
// Key tiles that the causal mask hides entirely are skipped (their p is 0 and
// corr 1, so the result is the same), and a CTA whose every key is hidden
// writes nothing.
//
// Arithmetic is FP32 on the CUDA cores, the exponentials expf, so results
// match the plain torch step (kernels/flash_block.py) to float32 rounding.
// Bound on the H100: 4 S_q S_k D operations a (batch, head) (two products)
// at the FP32 rate, 67 TFLOP/s, far above the bytes' time (main path: 137
// GFLOP a slot-step at S_q = S_k = 4096, H = 16, D = 128, 2.05 ms). A later
// redesign would run both products on the tensor cores (wgmma, with TMA
// loads of the K/V tiles), at TF32 or bf16 against that bound.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 64;      // queries and keys a tile
constexpr int kThreads = 256;  // 16 x 16: ty (rows), tx (columns)
constexpr int kPStride = kTile + 4;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Geometry {
  long long B, H, Sq, Sk, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long q_off, k_off;
  float scale;
  int causal;
};

// rows of a 64-row tile of a (B, S, H, D) tensor into shared memory, row
// stride `stride` floats, zeros past the sequence's end and past D
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src, long long sb, long long ss,
                                      long long sh, long long b, long long h, long long s0, long long S,
                                      long long D) {
  const T* base = src + b * sb + h * sh;
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP;
    const int d = idx % DP;
    const long long s = s0 + r;
    dst[r * stride + d] = (s < S && d < D) ? widen(base[s * ss + d]) : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                               const T* __restrict__ v, float* __restrict__ o,
                                                               float* __restrict__ l, float* __restrict__ m,
                                                               Geometry g) {
  constexpr int QS = DP + 4;  // row stride of the Q and K tiles: 16-byte rows, banks spread
  constexpr int J = DP / 64;  // groups of 4 output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [kTile][QS]
  float* Ks = Qs + kTile * QS;  // [kTile][QS], then P [kTile][kPStride]
  float* Vs = Ks + kTile * QS;  // [kTile][DP]

  const long long tiles_q = (g.Sq + kTile - 1) / kTile;
  const long long qt = blockIdx.x % tiles_q;
  const long long bh = blockIdx.x / tiles_q;
  const long long h = bh % g.H;
  const long long b = bh / g.H;
  const long long q0 = qt * kTile;
  const long long q_last = (q0 + kTile < g.Sq ? q0 + kTile : g.Sq) - 1;

  long long tiles_k = (g.Sk + kTile - 1) / kTile;
  if (g.causal) {
    // key tiles past the tile's last query are hidden entirely
    const long long reach = g.q_off + q_last - g.k_off;  // the last visible key
    tiles_k = reach < 0 ? 0 : (reach / kTile + 1 < tiles_k ? reach / kTile + 1 : tiles_k);
  }
  if (tiles_k == 0) return;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  stage<T, DP>(Qs, QS, q, g.q_sb, g.q_ss, g.q_sh, b, h, q0, g.Sq, g.D);

  const long long row_base = bh * g.Sq;
  float m_r[4], l_r[4], acc[4][J][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty + 16 * i;
    const bool in = row < g.Sq;
    m_r[i] = in ? m[row_base + row] : -CUDART_INF_F;
    l_r[i] = in ? l[row_base + row] : 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long c = 4 * tx + 64 * j + t;
        acc[i][j][t] = (in && c < g.D) ? o[(row_base + row) * g.D + c] : 0.0f;
      }
  }

  for (long long kt = 0; kt < tiles_k; ++kt) {
    const long long k0 = kt * kTile;
    __syncthreads();  // the previous tile's P and V are consumed
    stage<T, DP>(Ks, QS, k, g.k_sb, g.k_ss, g.k_sh, b, h, k0, g.Sk, g.D);
    stage<T, DP>(Vs, DP, v, g.v_sb, g.v_ss, g.v_sh, b, h, k0, g.Sk, g.D);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long q_pos = g.q_off + q0 + ty + 16 * i;
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long col = k0 + tx + 16 * j;
        const bool visible = col < g.Sk && (!g.causal || q_pos >= g.k_off + col);
        s[i][j] = visible ? s[i][j] * g.scale : -CUDART_INF_F;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m_r[i], rmax);
      const float safe = m_new == -CUDART_INF_F ? 0.0f : m_new;
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = s[i][j] == -CUDART_INF_F ? 0.0f : expf(s[i][j] - safe);
        rsum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = m_r[i] == -CUDART_INF_F ? 0.0f : expf(m_r[i] - safe);
      l_r[i] = l_r[i] * corr + rsum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][j][t] *= corr;
    }

    __syncthreads();  // every score is read out of the K tile
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p[i][j];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kPStride + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[(kk + u) * DP + 4 * tx + 64 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
            acc[i][j][0] = fmaf(pu, vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pu, vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pu, vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pu, vv.w, acc[i][j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty + 16 * i;
    if (row >= g.Sq) continue;
    if (tx == 0) {
      m[row_base + row] = m_r[i];
      l[row_base + row] = l_r[i];
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long c = 4 * tx + 64 * j + t;
        if (c < g.D) o[(row_base + row) * g.D + c] = acc[i][j][t];
      }
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kTile * (DP + 4) + kTile * DP);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* l, void* m, const Geometry& g,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_block_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = g.B * g.H * ((g.Sq + kTile - 1) / kTile);
  if (ctas <= 0) return 0;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_block_kernel<T, DP><<<(unsigned)ctas, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<float*>(o),
      static_cast<float*>(l), static_cast<float*>(m), g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dp(int dp, const void* q, const void* k, const void* v, void* o, void* l, void* m, const Geometry& g,
              cudaStream_t s) {
  if (dp == 64) return launch<T, 64>(q, k, v, o, l, m, g, s);
  if (dp == 128) return launch<T, 128>(q, k, v, o, l, m, g, s);
  if (dp == 256) return launch<T, 256>(q, k, v, o, l, m, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// params: B, H, S_q, S_k, D, q's batch/sequence/head strides, k's, v's (in
// elements), q_offset, k_offset. dtype: 0 float32, 1 float16, 2 bfloat16.
extern "C" int flash_block(int dtype, int dp, const void* q, const void* k, const void* v, void* o, void* l,
                           void* m, const long long* params, float scale, int causal, void* stream) {
  Geometry g;
  g.B = params[0];
  g.H = params[1];
  g.Sq = params[2];
  g.Sk = params[3];
  g.D = params[4];
  g.q_sb = params[5];
  g.q_ss = params[6];
  g.q_sh = params[7];
  g.k_sb = params[8];
  g.k_ss = params[9];
  g.k_sh = params[10];
  g.v_sb = params[11];
  g.v_ss = params[12];
  g.v_sh = params[13];
  g.q_off = params[14];
  g.k_off = params[15];
  g.scale = scale;
  g.causal = causal;
  if (g.D <= 0 || g.D > dp) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dp<float>(dp, q, k, v, o, l, m, g, s);
  if (dtype == 1) return launch_dp<__half>(dp, q, k, v, o, l, m, g, s);
  if (dtype == 2) return launch_dp<__nv_bfloat16>(dp, q, k, v, o, l, m, g, s);
  return (int)cudaErrorInvalidValue;
}
