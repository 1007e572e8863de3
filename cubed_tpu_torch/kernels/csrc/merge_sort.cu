// K4: merge_sort -- the order statistics' block kernels: a stable sort of
// each lane of a block (values, or values with carried int64 indices), a
// stable argsort, and the sort network's merge-split of two sorted blocks.
//
// What each replaces (none of them is a Pallas kernel: the JAX package sorts
// with jnp calls that XLA lowers):
//   sort_tiles + sort_merge, values  -- cubed_tpu/array_api/_block_sort.py:210,
//       jnp.sort of the network's local round (and the single-chunk sort);
//       with indices, _pair_order's lexsort of the same round.
//   sort_tiles + sort_merge, argsort -- cubed_tpu/array_api/sorting_functions.py:249,
//       jnp.argsort in _stable_argsort_kernel (top-k's per-block order, the
//       single-chunk argsort).
//   merge_split                      -- _block_sort.py:220, jnp.sort of a
//       concatenated pair of blocks, the low or the high half kept.
//
// Why no library sort: torch.sort on the card takes int64 indices beside
// its values and, for a lane past 4096 elements, CUB's segmented sort with a
// transposed copy and scratch, which puts a task past the memory its plan
// projects (1.50 of it along 16384 steps, against these kernels' 0.50).
// These kernels hold, beside their input: a lane of at most `tile`
// elements, its output alone; a longer lane, two buffers (values, and with
// indices two of each; argsort two int64 position buffers).
//
// The order is numpy's and XLA's: ascending, NaN after every number (all
// NaNs equal), -0.0 equal to 0.0; equal keys keep their first order, and
// with indices the pair (value, index) is the key. Compares go through an
// order-preserving unsigned key (the float bit transform with -0.0 folded to
// 0.0 and every NaN to the largest key; the sign bit flipped for signed
// integers); the original bits are written out, so -0.0 and NaN payloads
// come out as they went in. No thread waits on another but at a CTA's
// barriers and no atomic is used: a result is the same from run to run.
//
// Layout: a contiguous (outer, n, inner) tensor sorted along n; element
// (o, k, l) at (o * n + k) * inner + l. The work split is pure Python
// (kernels/_geometry.py: sort_plan, replayed by sort_walk on the CPU).
//
// sort_tiles -- a CTA owns a tile: `tile` consecutive positions of `lanes`
//     neighbouring lanes along inner (a power of two of each). Each row of
//     the tile is `lanes` contiguous elements, so loads and stores coalesce
//     (16 float64 lanes: 128-byte rows); a contiguous lane (inner == 1) is
//     loaded with 16-byte vectors, kBatch loads in flight a thread. The
//     values go to shared memory once; the CTA then sorts uint16 tile
//     positions by (key, [index,] position), a total order, so the sort is
//     stable: each warp sorts runs of 256 positions of a lane in registers
//     (8 a thread, a bitonic network: no thread waits on another's data,
//     distances past 8 exchanged by shuffles), then log2(tile / 256)
//     merge-path merges in shared memory (each thread finds its 8 outputs'
//     place on the path of its two runs by binary search and merges them).
//     A lane of at most `tile` elements is then written where it was read:
//     one launch, the block read once and written once. A longer lane's
//     tiles go out as sorted runs of `tile` to a buffer whose lanes are
//     contiguous.
// sort_merge -- one pass merging neighbouring runs of `width`: a CTA owns
//     `tile` outputs of `lanes` lanes of one pair of runs. One merge-path
//     search per lane and per end of the CTA's range (not one per element)
//     splits the two runs; both segments load into shared memory with
//     contiguous reads, merge there, and go out in rows: lanes contiguous,
//     or (the last pass) the (outer, n, inner) layout. ceil(log2(ceil(n /
//     tile))) passes follow the tile sort. Argsort's passes stay indirect:
//     each position's value is gathered once a pass, not once a probe.
// merge_split -- one pass over a pair of sorted blocks, keeping the low
//     or the high half of each lane's stable merge (a flag a lane group): a
//     CTA owns `tile` consecutive outputs of the kept half of `lanes`
//     neighbouring lanes, the merged positions [d0, d0 + tn). Its threads
//     find each lane's split of X and Y at both ends by merge path over the
//     (outer, n, inner) layout, all the CTA's threads over the ends not
//     known (16 threads a search for 16 lanes and one end, each round
//     probing 16 places: 2-3 rounds of loads for a lane of 512, not 9),
//     then load each lane's two segments into shared memory, a group of
//     lanes that one 32-byte sector holds at a time over the union of
//     their segments' rows (the over-read bounded by the spread of the
//     splits within a sector; 4- and 8-byte elements by cp.async, all of a
//     thread's copies in flight at once), and merge in shared memory like
//     sort_merge, each thread's outputs stored as it merges them
//     (neighbouring threads on neighbouring lanes: each store a row of the
//     (outer, n, inner) layout). One launch a call; the output is the only buffer. No stage
//     streams: the searches and the loads wait on device memory, the merge
//     on the SM, so the tile is sized for four CTAs an SM (256 x 16
//     float64, 33 KB), each overlapping the others' stages.
//
// Bound on the H100: bytes, the block read once and its output written once
// a launch (3.35 TB/s); for merge_split one block of the pair read (the
// kept half is x[0:i] ++ y[0:n-i], or the other end) and one written, the
// split searches O(log n) a lane. A sort tile of 512 x 16 float64 holds 64 KB of values
// and 32 KB of positions: two CTAs an SM. What holds sort_tiles from it is
// the compares, not the bytes: the tile's load and store alone take about a
// fifth of a launch on the H100 (PERF.md, Findings). The shared-memory
// layout is the plan's (Regions); the kernels take its offsets. Dynamic
// shared memory past 48 KB is allowed once for every kernel when
// the library loads (merge_sort_init), never inside a CUDA-graph capture.
//
// Plain C interface for ctypes: each entry point returns cudaGetLastError()
// after its launch.

#include <climits>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// sort_tiles / sort_merge
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kItems = 8;  // outputs a thread merges at a time (unit_shift below: tile_shift - 3)
static_assert(kItems == 8, "the kernels count units of kItems by shifts of 3");
constexpr int kSmemLimit = 232448;
constexpr int kBatch = 8;  // global loads a thread has in flight
constexpr int kMaxGroups = 4;  // merge_split's sector groups a CTA (the plan's lanes / sector)

// order-preserving unsigned keys: a < b in the sort's order iff key(a) <
// key(b); -0.0 and 0.0 share a key, and every NaN takes the largest
template <typename T>
struct Order;
template <>
struct Order<double> {
  using K = unsigned long long;
  static __device__ __forceinline__ K key(double v) {
    if (v != v) return ~0ull;
    const K u = v == 0.0 ? 0ull : static_cast<K>(__double_as_longlong(v));
    return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
  }
};
template <>
struct Order<float> {
  using K = unsigned int;
  static __device__ __forceinline__ K key(float v) {
    if (v != v) return ~0u;
    const K u = v == 0.0f ? 0u : __float_as_uint(v);
    return (u >> 31) ? ~u : (u | 0x80000000u);
  }
};
template <>
struct Order<long long> {
  using K = unsigned long long;
  static __device__ __forceinline__ K key(long long v) { return static_cast<K>(v) ^ 0x8000000000000000ull; }
};
template <>
struct Order<int> {
  using K = unsigned int;
  static __device__ __forceinline__ K key(int v) { return static_cast<K>(v) ^ 0x80000000u; }
};
template <>
struct Order<short> {
  using K = unsigned int;
  static __device__ __forceinline__ K key(short v) { return static_cast<K>(static_cast<int>(v) + 32768); }
};
template <>
struct Order<signed char> {
  using K = unsigned int;
  static __device__ __forceinline__ K key(signed char v) { return static_cast<K>(static_cast<int>(v) + 128); }
};
template <>
struct Order<unsigned char> {
  using K = unsigned int;
  static __device__ __forceinline__ K key(unsigned char v) { return v; }
};

// the run a warp sorts in registers: kWarpItems elements a thread
constexpr int kWarpItems = 8;
constexpr int kRun = 32 * kWarpItems;
constexpr int kRunShift = 8;
static_assert(kRun == 1 << kRunShift, "kRun is 2 ** kRunShift");

// an element under compare: its key, its carried index (kIdx) and its
// position (in the tile, or in a merge pass's segments)
template <typename K, bool kIdx>
struct Elem {
  K k;
  long long i;
  int p;
};

// the total order (key, [index,] position)
template <typename K, bool kIdx>
__device__ __forceinline__ bool before(const Elem<K, kIdx>& a, const Elem<K, kIdx>& b) {
  if (a.k != b.k) return a.k < b.k;
  if (kIdx && a.i != b.i) return a.i < b.i;
  return a.p < b.p;
}

template <typename K, bool kIdx>
__device__ __forceinline__ Elem<K, kIdx> shfl_xor(const Elem<K, kIdx>& e, int mask) {
  Elem<K, kIdx> o;
  o.k = __shfl_xor_sync(0xffffffffu, e.k, mask);
  o.i = kIdx ? __shfl_xor_sync(0xffffffffu, e.i, mask) : 0;
  o.p = __shfl_xor_sync(0xffffffffu, e.p, mask);
  return o;
}

// a warp's kRun elements sorted by the total order: a bitonic network over
// ranks me * kWarpItems + i (thread me, register i); distances below
// kWarpItems compare registers of a thread, longer ones exchange registers
// with the thread me ^ (distance / kWarpItems). The network is the same
// whatever the data, and a total order makes it stable.
template <typename E>
__device__ __forceinline__ void warp_sort(E (&e)[kWarpItems], int me) {
#pragma unroll
  for (int k = 2; k <= kRun; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < kWarpItems) {
#pragma unroll
        for (int i = 0; i < kWarpItems; ++i) {
          const int q = i ^ j;
          if (q > i) {
            const bool up = ((me * kWarpItems + i) & k) == 0;
            if (before(e[q], e[i]) == up) {
              const E t = e[i];
              e[i] = e[q];
              e[q] = t;
            }
          }
        }
      } else {
        const int m = j / kWarpItems;
        const bool low = (me & m) == 0;
        const bool up = ((me * kWarpItems) & k) == 0;
#pragma unroll
        for (int i = 0; i < kWarpItems; ++i) {
          const E o = shfl_xor(e[i], m);
          if (before(o, e[i]) == (low == up)) e[i] = o;
        }
      }
    }
  }
}

// outputs [d, d + count) of the merge of X = at(xs .. xs + nx) and Y =
// at(ys .. ys + ny), both sorted: the place on the merge path by binary
// search, then a sequential merge; emit(t, element) for output d + t
template <typename E, typename At, typename Emit>
__device__ __forceinline__ void merge_range(const At& at, int xs, int nx, int ys, int ny, int d, int count,
                                            const Emit& emit) {
  int lo = d > ny ? d - ny : 0;
  int hi = d < nx ? d : nx;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (before(at(xs + m), at(ys + d - 1 - m))) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  int i = lo, j = d - lo;
  E x{}, y{};
  if (i < nx) x = at(xs + i);
  if (j < ny) y = at(ys + j);
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    if (t < count) {
      if (j >= ny || (i < nx && before(x, y))) {
        emit(t, x);
        if (++i < nx) x = at(xs + i);
      } else {
        emit(t, y);
        if (++j < ny) y = at(ys + j);
      }
    }
  }
}

// for each e in [threadIdx.x, total) a CTA step apart, put(e, get(e)) where
// live(e): kBatch gets in flight a thread before their puts
template <typename V, typename Live, typename Get, typename Put>
__device__ __forceinline__ void batched(int total, const Live& live, const Get& get, const Put& put) {
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kBatch) {
    V v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < total && live(e)) v[j] = get(e);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < total && live(e)) put(e, v[j]);
    }
  }
}

// byte offsets of a CTA's shared-memory regions, laid out by the Python plan
// (kernels/_geometry.py: sort_layout; the carried indices at 0): the values,
// argsort's positions (a merge pass), the order buffers (one for a merge
// pass) and each lane's splits (a merge pass)
struct Regions {
  int vals, pos, ord0, ord1, splits;
};

// kMode 0: values; 1: values with carried indices; 2: argsort (positions)
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    sort_tiles_kernel(const T* __restrict__ src, const long long* __restrict__ srci, T* __restrict__ out,
                      long long* __restrict__ outi, long long n, long long inner, int tile_shift, int lane_shift,
                      int vector, long long tiles_n, long long lane_groups, long long tiles, Regions R,
                      int runs_out) {
  using K = typename Order<T>::K;
  constexpr bool kIdx = kMode == 1;
  using E = Elem<K, kIdx>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = 1 << tile_shift, lanes = 1 << lane_shift;
  const int vstride = tile + 1, ostride = tile + 2;
  long long* sidx = reinterpret_cast<long long*>(smem);
  T* svals = reinterpret_cast<T*>(smem + R.vals);
  unsigned short* ord0 = reinterpret_cast<unsigned short*>(smem + R.ord0);
  unsigned short* ord1 = reinterpret_cast<unsigned short*>(smem + R.ord1);
  const int unit_shift = tile_shift - 3;  // log2 of the units (of kItems) a lane
  const int units = 1 << (unit_shift + lane_shift);

  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const long long kt = b % tiles_n, rest = b / tiles_n;
    const long long lg = rest % lane_groups, o = rest / lane_groups;
    const long long k0 = kt << tile_shift, l0 = lg << lane_shift;
    const int tn = (int)min((long long)tile, n - k0);
    const int cn = (int)min((long long)lanes, inner - l0);
    const long long base = (o * n + k0) * inner + l0;  // element (o, k0, l0)

    // the tile into shared memory, rows of `lanes` contiguous elements
    const int total = tile << lane_shift;
    auto row_live = [&](int e) { return (e >> lane_shift) < tn && (e & (lanes - 1)) < cn; };
    auto row_at = [&](int e) { return base + (e >> lane_shift) * inner + (e & (lanes - 1)); };
    auto lane_at = [&](int e) { return (e & (lanes - 1)) * vstride + (e >> lane_shift); };
    if (vector > 1) {  // one contiguous lane, 16-byte aligned
      const int vecs = tn / vector;
      const uint4* v = reinterpret_cast<const uint4*>(src + base);
      batched<uint4>(vecs, [](int) { return true; }, [&](int u) { return v[u]; },
                     [&](int u, const uint4& w) { reinterpret_cast<uint4*>(svals)[u] = w; });
      for (int k = vecs * vector + threadIdx.x; k < tn; k += kThreads) svals[k] = src[base + k];
    } else {
      batched<T>(total, row_live, [&](int e) { return src[row_at(e)]; },
                 [&](int e, const T& w) { svals[lane_at(e)] = w; });
    }
    if constexpr (kIdx) {
      batched<long long>(total, row_live, [&](int e) { return srci[row_at(e)]; },
                         [&](int e, const long long& w) { sidx[lane_at(e)] = w; });
    }
    __syncthreads();

    // runs of kRun sorted in registers, one a warp; positions past tn
    // (none past a lane's end but the tile's) sort last, after every NaN
    const int warp = threadIdx.x >> 5, me = threadIdx.x & 31;
    const int run_shift = tile_shift > kRunShift ? tile_shift - kRunShift : 0;  // log2 of the runs a lane
    const int run_len = min(tile, kRun);
    for (int r = warp; r < (lanes << run_shift); r += kThreads / 32) {
      const int c = r >> run_shift, j0 = (r & ((1 << run_shift) - 1)) << kRunShift;
      if (c >= cn) continue;
      unsigned short* dst = ord0 + c * ostride + j0;
      if (j0 >= tn) {
        for (int t = me; t < run_len; t += 32) dst[t] = (unsigned short)(j0 + t);
        continue;
      }
      E e[kWarpItems];
#pragma unroll
      for (int i = 0; i < kWarpItems; ++i) {
        const int p = j0 + i * 32 + me;
        e[i].p = p;
        if (p < tn) {
          e[i].k = Order<T>::key(svals[c * vstride + p]);
          e[i].i = kIdx ? sidx[c * vstride + p] : 0;
        } else {
          e[i].k = ~K(0);
          e[i].i = LLONG_MAX;
        }
      }
      warp_sort(e, me);
#pragma unroll
      for (int i = 0; i < kWarpItems; ++i) {
        if (me * kWarpItems + i < run_len) dst[me * kWarpItems + i] = (unsigned short)e[i].p;
      }
    }
    __syncthreads();

    // merge-path merges of runs of w, w = kRun .. tile / 2; a pair's
    // outputs past its elements of the tile are its padding positions, in
    // order (as the warps' sorts left them)
    unsigned short* from = ord0;
    unsigned short* to = ord1;
    for (int w = kRun; w < tile; w *= 2) {
      for (int u = threadIdx.x; u < units; u += kThreads) {
        const int c = u >> unit_shift, j0 = (u & ((1 << unit_shift) - 1)) * kItems;
        if (c >= cn) continue;
        const int s = j0 & ~(2 * w - 1);
        const int nx = max(0, min(w, tn - s)), ny = max(0, min(w, tn - s - w));
        unsigned short* dst = to + c * ostride + j0;
        const int d = j0 - s;
        if (d >= nx + ny) {
#pragma unroll
          for (int t = 0; t < kItems; ++t) dst[t] = (unsigned short)(j0 + t);
          continue;
        }
        const unsigned short* run = from + c * ostride;
        const T* lv = svals + c * vstride;
        const long long* li = sidx + c * vstride;
        auto at = [&](int q) {
          E e;
          e.p = run[q];
          e.k = Order<T>::key(lv[e.p]);
          e.i = kIdx ? li[e.p] : 0;
          return e;
        };
        merge_range<E>(at, s, nx, s + w, ny, d, min(kItems, nx + ny - d),
                       [&](int t, const E& e) { dst[t] = (unsigned short)e.p; });
        for (int t = nx + ny - d; t < kItems; ++t) dst[t] = (unsigned short)(j0 + t);
      }
      __syncthreads();
      unsigned short* tmp = from;
      from = to;
      to = tmp;
    }

    // out: in place of the tile, or as a run of a lane-contiguous buffer
    if (!runs_out) {
#pragma unroll 4
      for (int e = threadIdx.x; e < total; e += kThreads) {
        const int c = e & (lanes - 1), k = e >> lane_shift;
        if (k < tn && c < cn) {
          const int p = from[c * ostride + k];
          const long long g = base + k * inner + c;
          if constexpr (kMode == 2) {
            outi[g] = k0 + p;
          } else {
            out[g] = svals[c * vstride + p];
            if constexpr (kIdx) outi[g] = sidx[c * vstride + p];
          }
        }
      }
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < total; e += kThreads) {
        const int k = e & (tile - 1), c = e >> tile_shift;
        if (k < tn && c < cn) {
          const int p = from[c * ostride + k];
          const long long g = ((o * inner + l0 + c) * n) + k0 + k;
          if constexpr (kMode == 2) {
            outi[g] = k0 + p;
          } else {
            out[g] = svals[c * vstride + p];
            if constexpr (kIdx) outi[g] = sidx[c * vstride + p];
          }
        }
      }
    }
    __syncthreads();  // the next tile's loads overwrite shared memory
  }
}

// one merge pass over sorted runs of `width` in a lane-contiguous buffer
// (src, srci: lane (o * inner + l) at its index times n); argsort's runs
// hold positions whose values it gathers from x, (outer, n, inner)
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    sort_merge_kernel(const T* __restrict__ x, const T* __restrict__ src, const long long* __restrict__ srci,
                      T* __restrict__ out, long long* __restrict__ outi, long long n, long long inner,
                      int tile_shift, int lane_shift, long long tiles_n, long long lane_groups, long long tiles,
                      long long width, Regions R, int final_out) {
  using K = typename Order<T>::K;
  constexpr bool kIdx = kMode == 1;
  using E = Elem<K, kIdx>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = 1 << tile_shift, lanes = 1 << lane_shift;
  const int vstride = tile + 1, ostride = tile + 2;
  long long* sidx = reinterpret_cast<long long*>(smem);
  T* svals = reinterpret_cast<T*>(smem + R.vals);
  int* spos = reinterpret_cast<int*>(smem + R.pos);
  unsigned short* ord = reinterpret_cast<unsigned short*>(smem + R.ord0);
  long long* splits = reinterpret_cast<long long*>(smem + R.splits);
  const int unit_shift = tile_shift - 3;
  const int units = 1 << (unit_shift + lane_shift);

  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const long long kt = b % tiles_n, rest = b / tiles_n;
    const long long lg = rest % lane_groups, o = rest / lane_groups;
    const long long k0 = kt << tile_shift, l0 = lg << lane_shift;
    const int tn = (int)min((long long)tile, n - k0);
    const int cn = (int)min((long long)lanes, inner - l0);
    const long long s = k0 / (2 * width) * (2 * width);  // the pair of runs: X at s, Y at s + width
    const long long nx = min(width, n - s), ny = max(0LL, min(2 * width, n - s) - width);

    // X's elements before each end of the CTA's range, per lane: the stable
    // merge takes X first on equal keys
    if ((int)threadIdx.x < 2 * lanes) {
      const int c = threadIdx.x & (lanes - 1), which = threadIdx.x >> lane_shift;
      if (c < cn) {
        const long long l = l0 + c;
        const long long run = (o * inner + l) * n + s;
        auto key = [&](long long q, K& k, long long& i) {
          if constexpr (kMode == 2) {
            k = Order<T>::key(x[(o * n + srci[run + q]) * inner + l]);
            i = 0;
          } else {
            k = Order<T>::key(src[run + q]);
            i = kIdx ? srci[run + q] : 0;
          }
        };
        const long long d = k0 - s + (which ? tn : 0);
        long long lo = d > ny ? d - ny : 0, hi = d < nx ? d : nx;
        while (lo < hi) {
          const long long m = (lo + hi) >> 1;
          K xk, yk;
          long long xi, yi;
          key(m, xk, xi);
          key(width + d - 1 - m, yk, yi);
          // X[m] is among the first d unless Y[d - 1 - m] goes strictly before it
          if (!(yk < xk || (kIdx && yk == xk && yi < xi))) {
            lo = m + 1;
          } else {
            hi = m;
          }
        }
        splits[which * lanes + c] = lo;
      }
    }
    __syncthreads();

    // both segments into shared memory, X's then Y's, contiguous reads
    const int total = tile << lane_shift;
    auto seg_live = [&](int e) { return (e & (tile - 1)) < tn && (e >> tile_shift) < cn; };
    auto seg_at = [&](int e) {
      const int j = e & (tile - 1), c = e >> tile_shift;
      const long long xa = splits[c];
      const int nxs = (int)(splits[lanes + c] - xa);
      const long long q = j < nxs ? xa + j : width + (k0 - s - xa) + (j - nxs);
      return (o * inner + l0 + c) * n + s + q;
    };
    auto seg_put = [&](int e) { return (e >> tile_shift) * vstride + (e & (tile - 1)); };
    if constexpr (kMode == 2) {
      // the positions, then the values they name (a gather a position)
      batched<long long>(total, seg_live, [&](int e) { return srci[seg_at(e)]; },
                         [&](int e, const long long& p) { spos[(e >> tile_shift) * tile + (e & (tile - 1))] = (int)p; });
      __syncthreads();
      batched<T>(
          total, seg_live,
          [&](int e) {
            const int c = e >> tile_shift;
            return x[(o * n + spos[c * tile + (e & (tile - 1))]) * inner + l0 + c];
          },
          [&](int e, const T& w) { svals[seg_put(e)] = w; });
    } else {
      batched<T>(total, seg_live, [&](int e) { return src[seg_at(e)]; },
                 [&](int e, const T& w) { svals[seg_put(e)] = w; });
      if constexpr (kIdx) {
        batched<long long>(total, seg_live, [&](int e) { return srci[seg_at(e)]; },
                           [&](int e, const long long& w) { sidx[seg_put(e)] = w; });
      }
    }
    __syncthreads();

    // the merge in shared memory: X's segment [0, nxs), Y's [nxs, tn),
    // ordered by (key, [index,] place), so X first on equal keys
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int c = u >> unit_shift, j0 = (u & ((1 << unit_shift) - 1)) * kItems;
      if (c >= cn || j0 >= tn) continue;
      const int nxs = (int)(splits[lanes + c] - splits[c]);
      const T* lv = svals + c * vstride;
      const long long* li = sidx + c * vstride;
      auto at = [&](int q) {
        E e;
        e.p = q;
        e.k = Order<T>::key(lv[q]);
        e.i = kIdx ? li[q] : 0;
        return e;
      };
      unsigned short* dst = ord + c * ostride + j0;
      merge_range<E>(at, 0, nxs, nxs, tn - nxs, j0, min(kItems, tn - j0),
                     [&](int t, const E& e) { dst[t] = (unsigned short)e.p; });
    }
    __syncthreads();

    // out: lanes contiguous, or (the last pass) the (outer, n, inner) layout
#pragma unroll 4
    for (int e = threadIdx.x; e < total; e += kThreads) {
      int k, c;
      if (final_out) {
        c = e & (lanes - 1);
        k = e >> lane_shift;
      } else {
        k = e & (tile - 1);
        c = e >> tile_shift;
      }
      if (k < tn && c < cn) {
        const int q = ord[c * ostride + k];
        const long long g = final_out ? (o * n + k0 + k) * inner + l0 + c : (o * inner + l0 + c) * n + k0 + k;
        if constexpr (kMode == 2) {
          outi[g] = spos[c * tile + q];
        } else {
          out[g] = svals[c * vstride + q];
          if constexpr (kIdx) outi[g] = sidx[c * vstride + q];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_tiles(int mode, const void* src, const void* srci, void* out, void* outi, long long n, long long inner,
                 int tile_shift, int lane_shift, int vector, long long tiles_n, long long lane_groups,
                 long long tiles, int grid, const Regions& R, int smem, int runs_out, cudaStream_t s) {
  const T* a = static_cast<const T*>(src);
  const long long* ai = static_cast<const long long*>(srci);
  T* b = static_cast<T*>(out);
  long long* bi = static_cast<long long*>(outi);
  if (mode == 0) {
    sort_tiles_kernel<T, 0><<<grid, kThreads, smem, s>>>(a, ai, b, bi, n, inner, tile_shift, lane_shift, vector,
                                                         tiles_n, lane_groups, tiles, R, runs_out);
  } else if (mode == 1) {
    sort_tiles_kernel<T, 1><<<grid, kThreads, smem, s>>>(a, ai, b, bi, n, inner, tile_shift, lane_shift, vector,
                                                         tiles_n, lane_groups, tiles, R, runs_out);
  } else {
    sort_tiles_kernel<T, 2><<<grid, kThreads, smem, s>>>(a, ai, b, bi, n, inner, tile_shift, lane_shift, vector,
                                                         tiles_n, lane_groups, tiles, R, runs_out);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(int mode, const void* x, const void* src, const void* srci, void* out, void* outi, long long n,
                 long long inner, int tile_shift, int lane_shift, long long tiles_n, long long lane_groups,
                 long long tiles, long long width, int grid, const Regions& R, int smem, int final_out,
                 cudaStream_t s) {
  const T* xv = static_cast<const T*>(x);
  const T* a = static_cast<const T*>(src);
  const long long* ai = static_cast<const long long*>(srci);
  T* b = static_cast<T*>(out);
  long long* bi = static_cast<long long*>(outi);
  if (mode == 0) {
    sort_merge_kernel<T, 0><<<grid, kThreads, smem, s>>>(xv, a, ai, b, bi, n, inner, tile_shift, lane_shift, tiles_n,
                                                         lane_groups, tiles, width, R, final_out);
  } else if (mode == 1) {
    sort_merge_kernel<T, 1><<<grid, kThreads, smem, s>>>(xv, a, ai, b, bi, n, inner, tile_shift, lane_shift, tiles_n,
                                                         lane_groups, tiles, width, R, final_out);
  } else {
    sort_merge_kernel<T, 2><<<grid, kThreads, smem, s>>>(xv, a, ai, b, bi, n, inner, tile_shift, lane_shift, tiles_n,
                                                         lane_groups, tiles, width, R, final_out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// merge_split
// ---------------------------------------------------------------------------

// one element copied from device to shared memory without a register
// (cp.async; 4 or 8 bytes, both addresses aligned to them)
template <typename V>
__device__ __forceinline__ void copy_async(V* to, const V* from) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8, "cp.async copies 4, 8 or 16 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(from), "n"(sizeof(V)));
}

// the low (flag 1) or high (flag 0) n of the stable merge of x's and y's
// lanes, lane group o (the elements (o, *, *)) reading take_low[o *
// flag_stride] (a bool or uint8, read in place: stride 0 for one flag): a CTA
// owns `tile` consecutive outputs of `lanes` neighbouring lanes, the merged
// positions [d0, d0 + tn) of each (kMode 0 values; 1 with carried indices)
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 3)
    merge_split_kernel(const T* __restrict__ x, const T* __restrict__ y, const long long* __restrict__ xi,
                       const long long* __restrict__ yi, const unsigned char* __restrict__ take_low,
                       long long flag_stride, T* __restrict__ out, long long* __restrict__ outi, long long n,
                       long long inner, int tile_shift, int lane_shift, int sector_shift, long long tiles_n,
                       long long lane_groups, long long tiles, Regions R) {
  using K = typename Order<T>::K;
  constexpr bool kIdx = kMode == 1;
  constexpr int kLoads = kIdx ? kBatch / 2 : kBatch;  // register loads in flight a thread: 64 bytes
  using E = Elem<K, kIdx>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = 1 << tile_shift, lanes = 1 << lane_shift, sector = 1 << sector_shift;
  const int groups = lanes >> sector_shift;
  const int vstride = tile + 1;
  long long* sidx = reinterpret_cast<long long*>(smem);
  T* svals = reinterpret_cast<T*>(smem + R.vals);
  long long* splits = reinterpret_cast<long long*>(smem + R.splits);  // [end][lane]
  // [group]: first X row, X rows, first Y row, its first load; then the loads
  int* rows = reinterpret_cast<int*>(splits + 2 * lanes);
  const int unit_shift = tile_shift - 3;
  const int units = 1 << (unit_shift + lane_shift);

  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const long long kt = b % tiles_n, rest = b / tiles_n;
    const long long lg = rest % lane_groups, o = rest / lane_groups;
    const long long k0 = kt << tile_shift, l0 = lg << lane_shift;
    const int tn = (int)min((long long)tile, n - k0);
    const int cn = (int)min((long long)lanes, inner - l0);
    const long long d0 = (take_low[o * flag_stride] ? 0 : n) + k0;
    const long long base = o * n * inner + l0;  // element (o, 0, l0)

    // X's elements among the first d of each lane's stable merge (X first
    // on equal keys), d = d0 and d0 + tn: 0 at d = 0 and n at d = 2n, else
    // found by `probes` threads a search (a power of two within a warp: the
    // CTA's threads over the ends to search), each round probing `probes`
    // evenly spaced places of the interval left
    {
      const int skip = d0 == 0, ends = 2 - skip - (d0 + tn == 2 * n);
      const int probes = min(32, kThreads >> (lane_shift + ends - 1));
      const int me = threadIdx.x & (probes - 1), search = threadIdx.x / probes;
      const int c = search & (lanes - 1), which = skip + (search >> lane_shift);
      const bool live = search < ends * lanes && c < cn;
      if ((int)threadIdx.x < lanes) {
        if (skip) splits[threadIdx.x] = 0;
        if (skip + ends < 2) splits[lanes + threadIdx.x] = n;
      }
      const long long d = d0 + (which ? tn : 0);
      long long lo = live ? max(0LL, d - n) : 0, hi = live ? min(d, n) : 0;
      while (__any_sync(0xffffffffu, lo < hi)) {
        const long long span = hi - lo;
        bool first = false;
        if (lo < hi) {
          const long long m = lo + span * (me + 1) / (probes + 1);
          const long long px = base + m * inner + c, py = base + (d - 1 - m) * inner + c;
          const K xk = Order<T>::key(x[px]), yk = Order<T>::key(y[py]);
          // X[m] is among the first d unless Y[d - 1 - m] goes strictly before it
          first = !(yk < xk || (kIdx && yk == xk && yi[py] < xi[px]));
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, first);
        const unsigned mine =
            probes == 32 ? ballot : (ballot >> (threadIdx.x & 31 & ~(probes - 1))) & ((1u << probes) - 1);
        const int t = __popc(mine);  // the probes before the split: a prefix
        if (lo < hi) {
          const long long nlo = t > 0 ? lo + span * t / (probes + 1) + 1 : lo;
          hi = t < probes ? lo + span * (t + 1) / (probes + 1) : hi;
          lo = nlo;
        }
      }
      if (me == 0 && search < ends * lanes) splits[which * lanes + c] = live ? lo : 0;
    }
    __syncthreads();

    // each sector group's rows: the union of its lanes' segments of X
    // ([i0, i1)) and of Y ([d0 - i0, d0 + tn - i1)), and where its
    // elements start in the CTA's order of loads (a scan over the groups)
    if (threadIdx.x < 32) {
      const int g = threadIdx.x;
      long long min0 = LLONG_MAX, max0 = LLONG_MIN, min1 = LLONG_MAX, max1 = LLONG_MIN;
      for (int c = g << sector_shift; g < groups && c < min(cn, (g + 1) << sector_shift); ++c) {
        min0 = min(min0, splits[c]);
        max0 = max(max0, splits[c]);
        min1 = min(min1, splits[lanes + c]);
        max1 = max(max1, splits[lanes + c]);
      }
      const bool any = g < groups && (g << sector_shift) < cn;  // else no row at all
      const int nrx = any ? (int)(max1 - min0) : 0, nry = any ? (int)(tn + max0 - min1) : 0;
      int first = (nrx + nry) << sector_shift;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, first, k);
        if (g >= k) first += v;
      }
      first -= (nrx + nry) << sector_shift;  // exclusive
      if (g < groups) {
        rows[4 * g] = any ? (int)min0 : 0;
        rows[4 * g + 1] = nrx;
        rows[4 * g + 2] = any ? (int)(d0 - max0) : 0;
        rows[4 * g + 3] = first;
      }
      if (g == groups - 1) rows[4 * kMaxGroups] = first + ((nrx + nry) << sector_shift);
    }
    __syncthreads();

    // both segments of each lane into shared memory (X's at [0, nx), Y's at
    // [nx, tn)): a group's rows of `sector` neighbouring lanes, each row one
    // sector of device memory; a lane takes the rows of its own segments.
    // Load e's source (1 X, 2 Y, 0 none: outside its lane's segment or a
    // lane past the edge), its offset and its shared-memory slot:
    auto locate = [&](int e, long long& gi, int& slot) -> int {
      int g = 0;
#pragma unroll
      for (int k = 1; k < kMaxGroups; ++k) g += k < groups && e >= rows[4 * k + 3];
      int r = e - rows[4 * g + 3];
      const int c = (g << sector_shift) + (r & (sector - 1));
      r >>= sector_shift;
      const int nrx = rows[4 * g + 1];
      if (c >= cn) return 0;
      const int i0 = (int)splits[c], i1 = (int)splits[lanes + c];
      const bool in_x = r < nrx;
      const int q = in_x ? rows[4 * g] + r : rows[4 * g + 2] + (r - nrx);  // the row along n
      const int s0 = in_x ? i0 : (int)(d0 - i0), s1 = in_x ? i1 : (int)(d0 + tn - i1);
      if (q < s0 || q >= s1) return 0;
      gi = base + (long long)q * inner + c;
      slot = c * vstride + (q - s0) + (in_x ? 0 : i1 - i0);
      return in_x ? 1 : 2;
    };
    const int total = rows[4 * kMaxGroups];
    if constexpr (sizeof(T) >= 4) {
      // copies straight into shared memory (cp.async: 4 or 8 bytes), every
      // one of a thread's in flight at once, no register held for them
      for (int e = threadIdx.x; e < total; e += kThreads) {
        long long gi;
        int slot;
        const int from = locate(e, gi, slot);
        if (from) {
          copy_async(svals + slot, (from == 1 ? x : y) + gi);
          if constexpr (kIdx) copy_async(sidx + slot, (from == 1 ? xi : yi) + gi);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      // 1- and 2-byte elements through registers, kLoads in flight a thread
      for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kLoads) {
        T v[kLoads];
        long long vi[kLoads];
        int slot[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int e = e0 + j * kThreads;
          long long gi = 0;
          const int from = e < total ? locate(e, gi, slot[j]) : 0;
          if (!from) slot[j] = -1;
          if (from) {
            v[j] = from == 1 ? x[gi] : y[gi];
            if constexpr (kIdx) vi[j] = from == 1 ? xi[gi] : yi[gi];
          }
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          if (slot[j] >= 0) {
            svals[slot[j]] = v[j];
            if constexpr (kIdx) sidx[slot[j]] = vi[j];
          }
        }
      }
    }
    __syncthreads();

    // the merge in shared memory, ordered by (key, [index,] place): X first
    // on equal keys; a thread's kItems outputs of one lane straight out,
    // neighbouring threads on neighbouring lanes (each store a row)
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int c = u & (lanes - 1), j0 = (u >> lane_shift) * kItems;
      if (c >= cn || j0 >= tn) continue;
      const int nxs = (int)(splits[lanes + c] - splits[c]);
      const T* lv = svals + c * vstride;
      const long long* li = sidx + c * vstride;
      auto at = [&](int q) {
        E e;
        e.p = q;
        e.k = Order<T>::key(lv[q]);
        e.i = kIdx ? li[q] : 0;
        return e;
      };
      const long long g0 = base + (k0 + j0) * inner + c;
      merge_range<E>(at, 0, nxs, nxs, tn - nxs, j0, min(kItems, tn - j0), [&](int t, const E& e) {
        out[g0 + t * inner] = lv[e.p];
        if constexpr (kIdx) outi[g0 + t * inner] = li[e.p];
      });
    }
    __syncthreads();  // the next item's splits and loads overwrite shared memory
  }
}

template <typename T>
int launch_split(int mode, const void* x, const void* y, const void* xi, const void* yi, const unsigned char* f,
                 long long fs, void* out, void* outi, long long n, long long inner, int tile_shift, int lane_shift,
                 int sector_shift, long long tiles_n, long long lane_groups, long long tiles, int grid,
                 const Regions& R, int smem, cudaStream_t s) {
  const T* a = static_cast<const T*>(x);
  const T* b = static_cast<const T*>(y);
  const long long* ai = static_cast<const long long*>(xi);
  const long long* bi = static_cast<const long long*>(yi);
  T* o = static_cast<T*>(out);
  long long* oi = static_cast<long long*>(outi);
  if (mode == 0) {
    merge_split_kernel<T, 0><<<grid, kThreads, smem, s>>>(a, b, ai, bi, f, fs, o, oi, n, inner, tile_shift,
                                                          lane_shift, sector_shift, tiles_n, lane_groups, tiles, R);
  } else {
    merge_split_kernel<T, 1><<<grid, kThreads, smem, s>>>(a, b, ai, bi, f, fs, o, oi, n, inner, tile_shift,
                                                          lane_shift, sector_shift, tiles_n, lane_groups, tiles, R);
  }
  return (int)cudaGetLastError();
}

// the plan's region offsets (vals, pos, ord0, ord1, splits) as Regions:
// false unless each is 16-byte aligned within the CTA's smem bytes and smem
// within kSmemLimit
bool regions_from(const int* r, int smem, Regions& R) {
  if (smem < 0 || smem > kSmemLimit) return false;
  for (int k = 0; k < 5; ++k) {
    if (r[k] < 0 || r[k] % 16 != 0 || r[k] > smem) return false;
  }
  R = Regions{r[0], r[1], r[2], r[3], r[4]};
  return true;
}

template <typename T>
void allow_smem() {
  cudaFuncSetAttribute(sort_tiles_kernel<T, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  cudaFuncSetAttribute(sort_tiles_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  cudaFuncSetAttribute(sort_tiles_kernel<T, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  cudaFuncSetAttribute(sort_merge_kernel<T, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  cudaFuncSetAttribute(sort_merge_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  cudaFuncSetAttribute(sort_merge_kernel<T, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  cudaFuncSetAttribute(merge_split_kernel<T, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  cudaFuncSetAttribute(merge_split_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
}

}  // namespace

// every sort kernel may take up to kSmemLimit bytes of dynamic shared memory
// on the current device; called once a device when the library loads
extern "C" int merge_sort_init() {
  allow_smem<double>();
  allow_smem<float>();
  allow_smem<long long>();
  allow_smem<int>();
  allow_smem<short>();
  allow_smem<signed char>();
  allow_smem<unsigned char>();
  return (int)cudaGetLastError();
}

// the tile sort of one sort_block / argsort_block call (mode 0 values, 1
// pairs, 2 argsort); regions: the CTA's five region offsets (Regions);
// runs_out: write lanes contiguous (merge passes follow)
extern "C" int sort_tiles(int dtype, int mode, const void* src, const void* srci, void* out, void* outi, long long n,
                          long long inner, int tile_shift, int lane_shift, int vector, long long tiles_n,
                          long long lane_groups, long long tiles, int grid, const int* regions, int smem, int runs_out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Regions R;
  if (!regions_from(regions, smem, R)) return (int)cudaErrorInvalidValue;
#define MS_TILES(T)                                                                                               \
  launch_tiles<T>(mode, src, srci, out, outi, n, inner, tile_shift, lane_shift, vector, tiles_n, lane_groups, tiles, \
                  grid, R, smem, runs_out, s)
  switch (dtype) {
    case 0: return MS_TILES(double);
    case 1: return MS_TILES(float);
    case 2: return MS_TILES(long long);
    case 3: return MS_TILES(int);
    case 4: return MS_TILES(short);
    case 5: return MS_TILES(signed char);
    case 6: return MS_TILES(unsigned char);
    default: return -1;
  }
#undef MS_TILES
}

// one merge pass of runs of `width`; regions as sort_tiles'; final_out:
// write the (outer, n, inner) layout (the last pass)
extern "C" int sort_merge(int dtype, int mode, const void* x, const void* src, const void* srci, void* out,
                          void* outi, long long n, long long inner, int tile_shift, int lane_shift, long long tiles_n,
                          long long lane_groups, long long tiles, long long width, int grid, const int* regions,
                          int smem, int final_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Regions R;
  if (!regions_from(regions, smem, R)) return (int)cudaErrorInvalidValue;
#define MS_MERGE(T)                                                                                                 \
  launch_merge<T>(mode, x, src, srci, out, outi, n, inner, tile_shift, lane_shift, tiles_n, lane_groups, tiles, width, \
                  grid, R, smem, final_out, s)
  switch (dtype) {
    case 0: return MS_MERGE(double);
    case 1: return MS_MERGE(float);
    case 2: return MS_MERGE(long long);
    case 3: return MS_MERGE(int);
    case 4: return MS_MERGE(short);
    case 5: return MS_MERGE(signed char);
    case 6: return MS_MERGE(unsigned char);
    default: return -1;
  }
#undef MS_MERGE
}

// the merge-split of one merge_split call (mode 0 values, 1 with carried
// indices); regions as sort_merge's, the sector groups' rows after the
// splits; take_low: a bool or uint8 flag a lane group, flag_stride apart
extern "C" int merge_split(int dtype, int mode, const void* x, const void* y, const void* xi, const void* yi,
                           const void* take_low, long long flag_stride, void* out, void* outi, long long n,
                           long long inner,
                           int tile_shift, int lane_shift, int sector_shift, long long tiles_n,
                           long long lane_groups, long long tiles, int grid, const int* regions, int smem,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Regions R;
  if (!regions_from(regions, smem, R) || tile_shift < 3 || sector_shift > lane_shift ||
      (1 << (lane_shift - sector_shift)) > kMaxGroups ||
      R.splits + 2LL * (1 << lane_shift) * 8 + (4 * kMaxGroups + 1) * 4 > smem) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned char* f = static_cast<const unsigned char*>(take_low);
#define MS_SPLIT(T)                                                                                                  \
  launch_split<T>(mode, x, y, xi, yi, f, flag_stride, out, outi, n, inner, tile_shift, lane_shift, sector_shift,     \
                  tiles_n, lane_groups, tiles, grid, R, smem, s)
  switch (dtype) {
    case 0: return MS_SPLIT(double);
    case 1: return MS_SPLIT(float);
    case 2: return MS_SPLIT(long long);
    case 3: return MS_SPLIT(int);
    case 4: return MS_SPLIT(short);
    case 5: return MS_SPLIT(signed char);
    case 6: return MS_SPLIT(unsigned char);
    default: return -1;
  }
#undef MS_SPLIT
}
