// Machinery shared by the cluster cascade kernels (congestion_cascade.cu,
// qos_cascade.cu).  A row of the batch belongs to one thread-block cluster
// of k CTAs; CTA r owns the slice [lo, hi) of the row's live events (those
// before the pads) and walks it in tiles of kTile events, kItems consecutive
// events per thread.  The CTAs exchange a stage's per-segment counts, maxima
// and sums through distributed shared memory, with cluster.sync() between
// the steps.  ref.py's *_partitioned mirrors compute the same steps.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace cascade {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kItems = 8;  // consecutive events per thread and tile
constexpr int kTile = kThreads * kItems;  // ref.KERNEL_TILE
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 8;  // CTAs per row: the portable cluster size
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPad = FLT_MAX / 4.0f;  // the stager's pad time (ref._big)
constexpr int kMergeNone = 0, kMergeRan = 1, kMergeSkipped = 2;  // ref.MERGE_*

struct Add {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Block-wide exclusive scans of the first n of V values per thread at once
// (one pair of barriers for all of them); total[j] gets value j's reduction
// over the block.  ws holds (kWarps + 1) * V values.  n is block-uniform and
// every thread of the block calls it.
template <typename T, int V, typename Op>
__device__ __forceinline__ void block_scan(const T (&v)[V], int n, T id, Op op, T (&excl)[V],
                                           T (&total)[V], T* ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    inc[j] = v[j];
    if (j < n) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(kFull, inc[j], o);
        if (lane >= o) inc[j] = op(inc[j], y);
      }
      if (lane == 31) ws[warp * V + j] = inc[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < n) {
        const T w = lane < kWarps ? ws[lane * V + j] : id;
        T winc = w;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const T y = __shfl_up_sync(kFull, winc, o);
          if (lane >= o) winc = op(winc, y);
        }
        T wex = __shfl_up_sync(kFull, winc, 1);
        if (lane == 0) wex = id;
        if (lane < kWarps) ws[lane * V + j] = wex;
        if (lane == kWarps - 1) ws[kWarps * V + j] = winc;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      T tex = __shfl_up_sync(kFull, inc[j], 1);
      if (lane == 0) tex = id;
      excl[j] = op(ws[warp * V + j], tex);
      total[j] = ws[kWarps * V + j];
    } else {
      excl[j] = id;
      total[j] = id;
    }
  }
  __syncthreads();  // the workspace is reused by the next call
}

// Block-wide sums of the first n of V ints per thread.
template <int V>
__device__ __forceinline__ void block_sums(int (&v)[V], int n, int* ws) {
  int excl[V], total[V];
  block_scan(v, n, 0, Add(), excl, total, ws);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = total[j];
}

// Block-wide sum of one double per thread in a fixed order, returned to
// every thread.
__device__ __forceinline__ double block_sum(double v, double* ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < kWarps ? ws[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(kFull, w, o);
    if (lane == 0) ws[kWarps] = w;
  }
  __syncthreads();
  const double total = ws[kWarps];
  __syncthreads();
  return total;
}

// Delay sums by slot (host, or host and class).  Up to kPrivSlots slots,
// each thread owns a column of doubles in shared memory, slot-major (the
// lanes of a warp on distinct banks): an add is a plain read-modify-write.
// Beyond that, each warp owns a row and its lanes sum in lane order first
// (warp_slot_add).  Either way the order of every sum is fixed.
constexpr int kPrivSlots = 16;

// Fold the threads' columns of slots [0, n_slots) (n_slots <= kPrivSlots)
// into out (a shared array the cluster reads), in a fixed order: each warp
// by shuffles, then the warps in order; resets the columns.  ws holds
// kWarps * kPrivSlots doubles.  Every thread of the block calls it, after a
// barrier that follows the last add.
__device__ __forceinline__ void fold_columns(double* cols, int n_slots, double* out, double* ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < n_slots; ++j) {
    double v = cols[j * kThreads + threadIdx.x];
    cols[j * kThreads + threadIdx.x] = 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) ws[warp * kPrivSlots + j] = v;
  }
  __syncthreads();
  if (threadIdx.x < n_slots) {
    double acc = 0.0;
    for (int w = 0; w < kWarps; ++w) acc += ws[w * kPrivSlots + threadIdx.x];
    out[threadIdx.x] = acc;
  }
}

// Add v to slot `slot` of this warp's row of delay sums: the lanes that
// share a slot are summed in lane order first, and the lowest of them adds
// the sum (each warp owns its row, so no atomics and a fixed order).  Every
// lane of the warp calls it.
__device__ __forceinline__ void warp_slot_add(double* wrow, bool active, int slot, double v) {
  const unsigned act = __ballot_sync(kFull, active);
  if (!active) return;
  const unsigned peers = __match_any_sync(act, slot);
  double sum = 0.0;
  for (unsigned p = peers; p; p &= p - 1) sum += __shfl_sync(peers, v, __ffs(p) - 1);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) wrow[slot] += sum;
}

// Fold the warps' rows of slots [0, n_slots) in warp order into out (a
// shared array the cluster reads) and reset them.  Call after a barrier
// that follows the last warp_slot_add; the next block scan orders the reset
// before new adds.
__device__ __forceinline__ void fold_slots(double* wrows, int n_slots, double* out) {
  for (int j = threadIdx.x; j < n_slots; j += kThreads) {
    double acc = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      acc += wrows[w * n_slots + j];
      wrows[w * n_slots + j] = 0.0;
    }
    out[j] = acc;
  }
}

// Order-preserving int32 image of an f32 value (ref._f32_sort_key).
__device__ __forceinline__ int f32_key(float v) {
  const int x = __float_as_int(v);
  return x >= 0 ? x : x ^ 0x7fffffff;
}

__device__ __forceinline__ void cluster_sync(cg::cluster_group& cl) {
  __threadfence();  // global writes of this CTA before the peers' reads
  cl.sync();
}

template <typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cl, T* p, int rank) {
  return cl.map_shared_rank(p, static_cast<unsigned>(rank));
}

// First index of the sorted row t[0:n) whose time is >= kPad.
__device__ __forceinline__ long long pad_start(const float* t, long long n) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (t[mid] < kPad) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// CTA r of k owns [lo, hi) of n (ref._segments): slices of ceil(n / k)
// rounded up to whole kItems groups, so that a thread's group starts on a
// 32-byte boundary of an aligned row.
__device__ __forceinline__ void segment(long long n, int k, int r, long long& lo, long long& hi) {
  const long long step = ((n + k - 1) / k + kItems - 1) / kItems * kItems;
  lo = min(static_cast<long long>(r) * step, n);
  hi = min(lo + step, n);
}

// v[j] at a runtime index, from registers (the unrolled compare keeps the
// array out of local memory).
template <typename T, int V>
__device__ __forceinline__ T pick(const T (&v)[V], int j) {
  T out = v[0];
#pragma unroll
  for (int k = 1; k < V; ++k) {
    if (k == j) out = v[k];
  }
  return out;
}

__device__ __forceinline__ float from_bits(unsigned u, float) { return __uint_as_float(u); }
__device__ __forceinline__ int from_bits(unsigned u, int) { return static_cast<int>(u); }
__device__ __forceinline__ unsigned to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned to_bits(int v) { return static_cast<unsigned>(v); }

// A thread's kItems consecutive values p[0:n) (n <= kItems; the rest get
// fill): two 16-byte loads when all are live and p is 16-byte aligned (vec),
// so that a warp's load covers whole cache lines.
template <typename T>
__device__ __forceinline__ void load_items(const T* p, int n, bool vec, T fill, T (&v)[kItems]) {
  static_assert(sizeof(T) == 4 && kItems == 8, "two 16-byte vectors a thread");
  if (vec && n == kItems) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    const unsigned u[kItems] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = from_bits(u[j], fill);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = j < n ? p[j] : fill;
  }
}

// Store a thread's kItems consecutive values where keep[j]: two 16-byte
// stores of all of them when all are live and aligned (the kept values and
// the unchanged rest), else one store per kept value.
template <typename T>
__device__ __forceinline__ void store_items(T* p, int n, bool vec, const T (&v)[kItems],
                                            const bool (&keep)[kItems]) {
  if (vec && n == kItems) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(to_bits(v[0]), to_bits(v[1]), to_bits(v[2]),
                                                to_bits(v[3]));
    reinterpret_cast<uint4*>(p)[1] = make_uint4(to_bits(v[4]), to_bits(v[5]), to_bits(v[6]),
                                                to_bits(v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j < n && keep[j]) p[j] = v[j];
    }
  }
}

// Copy the input row's [from, to) into the working row (times, route words,
// slot indices = positions), a tile of loads in flight per thread before its
// stores; seen(t, route word) sees every event copied.
template <class Row, class Seen>
__device__ __forceinline__ void copy_rows(const float* t0, const int* b0, const Row& cur,
                                          long long from, long long to, Seen seen) {
  for (long long tb = from; tb < to; tb += kTile) {
    float tv[kItems];
    int bv[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = tb + threadIdx.x + q * kThreads;
      if (i < to) {
        tv[q] = t0[i];
        bv[q] = b0[i];
      }
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = tb + threadIdx.x + q * kThreads;
      if (i < to) {
        cur.t[i] = tv[q];
        cur.b[i] = bv[q];
        cur.i[i] = static_cast<int>(i);
        seen(tv[q], bv[q]);
      }
    }
  }
}

// The row state a merge reads or writes: times, route words, slot indices
// and (QoS folds) the events' positions before the fold.
struct Arrays {
  float* t;
  int* b;
  int* i;
  int* p;  // nullptr where the merge keys on time alone
};

__device__ __forceinline__ Arrays offset(const Arrays& a, long long off) {
  return Arrays{a.t + off, a.b + off, a.i + off, a.p ? a.p + off : nullptr};
}

// A merge tile's arrays skip one word in 32, so that the threads of a warp,
// kItems apart, fall on distinct banks.
constexpr int kPadTile = kTile + kTile / 32;
__device__ __forceinline__ int pad(int x) { return x + (x >> 5); }

// Shared memory of one merge tile (kPadTile words an array): both input
// slices, then the merged tile.
struct MergeSmem {
  float* t;
  int* b;
  int* i;
  int* p;
  long long* split;  // kThreads + 1 tile boundaries' splits
};

// Merge path: the number of elements of run a among the first d of the
// merge of a[0:na) and b[0:nb), where before(a, b) says the a element goes
// first (a total order, ties included).  One bisection.
template <bool kPos, class Before>
__device__ __forceinline__ long long merge_split(const Arrays& a, long long na, const Arrays& b,
                                                 long long nb, long long d, Before before) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long j = d - 1 - mid;
    if (before(a.t[mid], kPos ? a.p[mid] : 0, b.t[j], kPos ? b.p[j] : 0)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge the sorted runs a[0:na) and b[0:nb) into out over this CTA's output
// range [o_lo, o_hi), by merge path: the range is cut into tiles of kTile;
// the split of every tile boundary is found by one bisection each (all of a
// chunk's boundaries at once, one per thread); each tile's two input slices
// are staged in shared memory with coalesced reads, each thread finds its
// own split of the tile by a bisection in shared memory and merges its
// kItems outputs, and the merged tile goes back out coalesced through
// shared memory.  observe(route word, slot index) sees every element written.
template <bool kPos, class Before, class Observe>
__device__ void merge_runs(const Arrays& a, long long na, const Arrays& b, long long nb,
                           const Arrays& out, long long o_lo, long long o_hi, Before before,
                           const MergeSmem& ms, Observe& observe) {
  const long long n_tiles = (o_hi - o_lo + kTile - 1) / kTile;
  for (long long c0 = 0; c0 < n_tiles; c0 += kThreads) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kThreads), n_tiles - c0));
    for (int j = threadIdx.x; j <= cnt; j += kThreads) {
      const long long d = min(o_lo + (c0 + j) * kTile, o_hi);
      ms.split[j] = merge_split<kPos>(a, na, b, nb, d, before);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const long long d0 = o_lo + (c0 + j) * kTile;
      const long long d1 = min(d0 + kTile, o_hi);
      const long long a0 = ms.split[j], a1 = ms.split[j + 1];
      const long long b0 = d0 - a0;
      const int nat = static_cast<int>(a1 - a0);
      const int len = static_cast<int>(d1 - d0);
      const int nbt = len - nat;
      {  // every load of the tile in flight before any store
        float lt[kItems];
        int lb[kItems], li[kItems], lp[kItems];
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          const int x = threadIdx.x + q * kThreads;
          if (x < len) {
            const bool in_a = x < nat;
            const long long src = in_a ? a0 + x : b0 + (x - nat);
            const Arrays& from = in_a ? a : b;
            lt[q] = from.t[src];
            lb[q] = from.b[src];
            li[q] = from.i[src];
            lp[q] = kPos ? from.p[src] : 0;
          }
        }
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          const int x = threadIdx.x + q * kThreads;
          if (x < len) {
            ms.t[pad(x)] = lt[q];
            ms.b[pad(x)] = lb[q];
            ms.i[pad(x)] = li[q];
            if (kPos) ms.p[pad(x)] = lp[q];
          }
        }
      }
      __syncthreads();
      float rt[kItems];
      int rb[kItems], ri[kItems], rp[kItems];
      const int q0 = threadIdx.x * kItems;
      if (q0 < len) {
        int lo = q0 > nbt ? q0 - nbt : 0;
        int hi = q0 < nat ? q0 : nat;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const int jb = nat + q0 - 1 - mid;
          if (before(ms.t[pad(mid)], kPos ? ms.p[pad(mid)] : 0, ms.t[pad(jb)], kPos ? ms.p[pad(jb)] : 0)) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        int ia = lo, ib = q0 - lo;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (q0 + k < len) {
            const bool take_a =
                ia < nat && (ib >= nbt || before(ms.t[pad(ia)], kPos ? ms.p[pad(ia)] : 0, ms.t[pad(nat + ib)],
                                                 kPos ? ms.p[pad(nat + ib)] : 0));
            const int x = take_a ? ia++ : nat + ib++;
            rt[k] = ms.t[pad(x)];
            rb[k] = ms.b[pad(x)];
            ri[k] = ms.i[pad(x)];
            rp[k] = kPos ? ms.p[pad(x)] : 0;
          }
        }
      }
      __syncthreads();
      if (q0 < len) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (q0 + k < len) {
            ms.t[pad(q0 + k)] = rt[k];
            ms.b[pad(q0 + k)] = rb[k];
            ms.i[pad(q0 + k)] = ri[k];
            if (kPos) ms.p[pad(q0 + k)] = rp[k];
          }
        }
      }
      __syncthreads();
      {  // all of the tile's stores, then the observer (whose loads then run together)
        int ob[kItems], oi[kItems];
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          const int x = threadIdx.x + q * kThreads;
          if (x < len) {
            const long long o = d0 + x;
            ob[q] = ms.b[pad(x)];
            oi[q] = ms.i[pad(x)];
            out.t[o] = ms.t[pad(x)];
            out.b[o] = ob[q];
            out.i[o] = oi[q];
            if (kPos && out.p) out.p[o] = ms.p[pad(x)];
          }
        }
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          if (threadIdx.x + q * kThreads < len) observe(ob[q], oi[q]);
        }
      }
      __syncthreads();
    }
  }
}

// Adjacent-pair check of a tile's new times for the identity test of the
// next merge: bad(x_t, x_a, y_t, y_a) says the pair (x, y) would move.  The
// thread checks its own items, then (through shared memory, one barrier)
// its last item against the next thread's first, and thread 0 its first
// against the previous tile's last (tail[], by tile parity).  Returns false
// when a pair of this tile would move.  first/last receive the CTA's first
// and last live events' (time, flag).
struct PairSmem {
  float t[kThreads];
  int a[kThreads];  // flag, or -1 for a thread with no live item
  float tail_t[2];
  int tail_a[2];
};

template <class Bad>
__device__ __forceinline__ bool tile_pairs(const float (&nt)[kItems], const bool (&na)[kItems],
                                           int n_valid, bool first_tile, int parity,
                                           PairSmem& ps, Bad bad) {
  bool ok = true;
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    if (k < n_valid && bad(nt[k - 1], na[k - 1], nt[k], na[k])) ok = false;
  }
  ps.t[threadIdx.x] = nt[0];
  ps.a[threadIdx.x] = n_valid > 0 ? static_cast<int>(na[0]) : -1;
  __syncthreads();
  if (threadIdx.x + 1 < kThreads && ps.a[threadIdx.x + 1] >= 0) {
    // the next thread has a live item, so all of this thread's are live
    if (bad(nt[kItems - 1], na[kItems - 1], ps.t[threadIdx.x + 1], ps.a[threadIdx.x + 1] != 0)) {
      ok = false;
    }
  }
  if (threadIdx.x == 0 && !first_tile && n_valid > 0) {
    if (bad(ps.tail_t[parity ^ 1], ps.tail_a[parity ^ 1] != 0, nt[0], na[0])) ok = false;
  }
  if (threadIdx.x == kThreads - 1 && n_valid == kItems) {
    ps.tail_t[parity] = nt[kItems - 1];
    ps.tail_a[parity] = na[kItems - 1];
  }
  return ok;
}

}  // namespace cascade
