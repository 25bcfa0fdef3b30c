// Fused S-stage FIFO serial-queue congestion cascade for Hopper (sm_90a),
// single-host and host-segmented.
//
// Replaces the TPU kernels repro/kernels/congestion.py:congestion_cascade and
// congestion_cascade_hosts (one shared body, _cascade_body, with a static
// has_hosts switch; here a template on kHosts).  Semantics are those of the
// plain version, repro_torch/kernels/ref.py:serial_queue_cascade with
// merge_plan=None (the conservative schedule, which the TPU kernels also
// run): for every epoch row and every stage s, in stage order,
//
//   merge   (s > 0, only while the row's cumulative delay is > 0) the events
//           of stage s-1 (a sorted run: a FIFO queue never reorders) back
//           into the untouched ones (the other sorted run), ties placing the
//           stage s-1 events first;
//   scan    rank = cumsum(mask) - 1 (int32), f = cummax(t - stt*rank),
//           start = f + stt*rank over the events whose route word has bit s;
//           per_stage_delay[row, s] = sum(start - t), or with kHosts
//           per_stage_delay[row, s, h] = the sum over the events of host h,
//           the host of the event in slot i being hosts[row, slot_idx[i]].
//
// Outputs: t_final[row, k] is the post-congestion time of the event that sat
// at sorted position slot_idx[row, k] of the input row; merge_flags[row, s]
// says what became of the merge before stage s (ref.MERGE_*).
//
// What bounds it: memory.  The least traffic is reading t and the route bits
// (and the host ids) and writing t_final and slot_idx once: 16 B per event,
// 20 B with hosts, about 0.2 ms for fabric8's [32, 1048576] batch at
// 3.35 TB/s.  The arithmetic (a handful of f32 ops per event and stage) is
// far below the f32 peak.  A row of the fabric batch (12 MB of state) does
// not fit on chip, so every stage streams it from HBM: each pass over the
// row costs bytes, and the design counts passes.
//
// What this design does about it (cluster_cascade.cuh):
// - Several CTAs per row: a thread-block cluster of k CTAs (the wrapper's
//   ctas_per_row: B*k fills the 132 SMs, k <= 8, a portable cluster), each
//   owning a slice of the row.  A cluster, not decoupled look-back: its CTAs
//   are co-resident by construction, so the per-stage barriers cannot
//   deadlock, and the per-segment carries travel through distributed shared
//   memory.
// - Exact carries in any partition: a stage's scan is count, then max, then
//   write.  Each CTA knows its segment's masked count before the stage (the
//   previous pass over the same events counted it), so it has its global
//   rank base before it forms t - stt*rank; it takes the max of its segment
//   (exact in any order), the cluster exchanges the maxima, and the write
//   pass starts from the max over the earlier segments.  So any split gives
//   the serial scan bitwise.  The write pass moves no event, so it also
//   takes the next stage's segment maxima over the new times: the max pass
//   runs only after a merge, and most stages cost one pass over the row.
// - Merges by merge path, not a binary search per element into HBM: the run
//   of stage s-1 and the rest are compacted (count-then-place across the
//   cluster, each tile grouped by run in shared memory so that both slices
//   go out coalesced), each CTA merges its own output range tile by tile,
//   with one bisection per tile boundary, both input slices staged in
//   shared memory and coalesced reads and writes.
// - Merges that would do nothing are skipped, exactly: the write pass of
//   stage s also checks every adjacent pair of the row (across tiles, and
//   across CTAs from the published ends).  When no event is earlier than the
//   one before it and no tie has an untouched event directly before a
//   queued one, the merge is the identity and does not run.  On the pooled
//   fabrics every per-host RC stage moves nothing, so 7 of the 8 merges of
//   a fabric8 row are skipped.
// - Pads (time finfo.max/4, no route: the stager's padding of short rows)
//   never queue and sort last, so every pass stops at the row's first pad
//   (one bisection), once a pass over the tail has checked that every event
//   there is such a pad (else the whole row is live).
// - Per-host sums without atomics: up to 16 hosts, each thread adds into
//   its own column of doubles in shared memory (slot-major, no bank
//   conflicts), folded by warp shuffles and then in warp order; beyond 16,
//   the lanes of a warp that share a host are summed in lane order
//   (__match_any_sync) and the lowest adds the sum to its warp's row.  Then
//   across the cluster in rank order.
//
// Numerics: the f32 products and sums are rounded one by one (__fmul_rn,
// __fsub_rn, __fadd_rn) so no fused multiply-add changes a rounding against
// the plain version; the rank is an int32 count, converted once; delay sums
// accumulate in double, in a fixed order, and are rounded to f32 at the end.
// The merge guard is the row's cumulative delay from that fixed-order fold,
// so t_final, slot_idx and the flags do not vary between runs.

#include "cluster_cascade.cuh"

namespace {

using namespace cascade;

constexpr int kMaxHosts = 32;  // per-host delay slots (the route word allows 31 stages)

// What a CTA publishes to its cluster.
struct Pub {
  // By the parity of the stage they describe: a stage reads its own, and its
  // write pass fills the next stage's, which no peer reads any more.
  int cnt[2];  // the stage's events in this CTA's segment
  int cnt2[2];  // the next stage's events in the segment, in the stage's order
  float seg_max[2];  // the stage's max of t - stt*rank over the segment
  int tail_ok;
  int ok;  // no adjacent pair of the segment would move in the next merge
  int first_a, last_a;
  float first_t, last_t;
  double dsum;
  double host[kMaxHosts];
};

// The FIFO merge's order: the run of the previous stage first on ties.
struct FifoBefore {
  __device__ __forceinline__ bool operator()(float ta, int, float tb, int) const { return ta <= tb; }
};

// A pair (x, y) the FIFO merge would reorder.
struct FifoBad {
  __device__ __forceinline__ bool operator()(float xt, bool xa, float yt, bool ya) const {
    return yt < xt || (yt == xt && !xa && ya);
  }
};

// Counts the events with route bits `bit` and `bit` + 1 among those a merge
// writes.
struct CountBits {
  int bit;
  int count[2];
  __device__ __forceinline__ void operator()(int b, int) {
    count[0] += (b >> bit) & 1;
    count[1] += (b >> (bit + 1)) & 1;
  }
};

template <bool kHosts>
__global__ void __launch_bounds__(kThreads, 1)
cascade_kernel(const float* __restrict__ t_in, const int* __restrict__ bits_in,
               const int* __restrict__ hosts_in, const float* __restrict__ stts,
               int n_stages, long long n, int n_hosts, float* t_out, int* idx_out,
               int* scratch, float* psd, signed char* flags) {
  cg::cluster_group cl = cg::this_cluster();
  const int k = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const long long row = blockIdx.x / k;
  const long long off = row * n;
  const long long plane = static_cast<long long>(gridDim.x / k) * n;

  __shared__ Pub pub;
  __shared__ PairSmem ps;
  __shared__ int ws_i[(kWarps + 1) * 2];
  __shared__ float ws_f[(kWarps + 1)];
  __shared__ double ws_d[kWarps + 1];
  __shared__ double ws_cols[kHosts ? kWarps * kPrivSlots : 1];
  __shared__ long long s_live;
  extern __shared__ __align__(16) unsigned char dyn[];
  MergeSmem ms{reinterpret_cast<float*>(dyn), reinterpret_cast<int*>(dyn) + kPadTile,
               reinterpret_cast<int*>(dyn) + 2 * kPadTile, nullptr,
               reinterpret_cast<long long*>(dyn + 3 * kPadTile * sizeof(int))};
  double* wrows = reinterpret_cast<double*>(dyn + 3 * kPadTile * sizeof(int) +
                                            (kThreads + 1) * sizeof(long long));

  // the row's state: current times (t_out), route words, slot indices, and
  // the merge's compacted runs
  Arrays cur{t_out + off, scratch + off, idx_out + off, nullptr};
  Arrays cmp{reinterpret_cast<float*>(scratch + plane) + off, scratch + 2 * plane + off,
             scratch + 3 * plane + off, nullptr};
  const float* t0 = t_in + off;
  const int* b0 = bits_in + off;
  const int* h0 = kHosts ? hosts_in + off : nullptr;

  const bool cols = n_hosts <= kPrivSlots;  // per-thread columns of host sums, else per-warp rows
  if constexpr (kHosts) {
    for (int j = threadIdx.x; j < (cols ? kThreads : kWarps) * n_hosts; j += kThreads) wrows[j] = 0.0;
  }
  if (threadIdx.x == 0) s_live = pad_start(t0, n);
  __syncthreads();
  long long live = s_live;
  {  // copy the tail and check that it is all pads
    long long lo, hi;
    segment(n - live, k, rank, lo, hi);
    int ok = 1;
    copy_rows(t0, b0, cur, live + lo, live + hi, [&](float x, int b) {
      ok &= (b == 0) & (x >= kPad);
    });
    ok = __syncthreads_and(ok);
    if (threadIdx.x == 0) pub.tail_ok = ok;
  }
  cluster_sync(cl);
  for (int q = 0; q < k; ++q) {
    if (!peer(cl, &pub, q)->tail_ok) live = n;
  }
  long long lo, hi;  // this CTA's segment of the live events
  segment(live, k, rank, lo, hi);
  const bool vec = ((off + lo) & 3) == 0;  // the segment's groups are 16-byte aligned
  {  // copy the segment and count stage 0's and stage 1's events in it
    int c[2] = {0, 0};
    copy_rows(t0, b0, cur, lo, hi, [&](float, int b) {
      c[0] += b & 1;
      c[1] += (b >> 1) & 1;
    });
    block_sums(c, 2, ws_i);
    if (threadIdx.x == 0) {
      pub.cnt[0] = c[0];
      pub.cnt2[0] = c[1];
    }
  }
  cluster_sync(cl);

  double dirty = 0.0;  // the row's cumulative delay: 0 => nothing moved
  bool fused = false;  // the last write pass took this stage's segment maxima
  for (int s = 0; s < n_stages; ++s) {
    const int par = s & 1;
    const bool has_next = s + 1 < n_stages;
    int base = 0, total = 0;  // stage-s events before this segment, and in the row
    int base2 = 0;  // stage s+1's events before this segment
    for (int q = 0; q < k; ++q) {
      const Pub* pq = peer(cl, &pub, q);
      base += q < rank ? pq->cnt[par] : 0;
      base2 += q < rank ? pq->cnt2[par] : 0;
      total += pq->cnt[par];
    }
    const float stt = stts[s];
    const float stt2 = has_next ? stts[s + 1] : 0.0f;

    // count-then-max: the max of t - stt*rank over the segment, unless the
    // last write pass took it (no merge came between)
    if (!fused) {
      float run = -INFINITY;
      int carry_c = base;
      for (long long tb = lo; tb < hi; tb += kTile) {
        const long long i0 = tb + static_cast<long long>(threadIdx.x) * kItems;
        const int n_valid = static_cast<int>(max(0LL, min(static_cast<long long>(kItems), hi - i0)));
        float tv[kItems];
        int bv[kItems];
        bool m[kItems];
        int c[1] = {0};
        load_items(cur.t + i0, n_valid, vec, 0.0f, tv);
        load_items(cur.b + i0, n_valid, vec, 0, bv);
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          m[j] = (bv[j] >> s) & 1;
          c[0] += m[j];
        }
        int ex[1], tot[1];
        block_scan(c, 1, 0, Add(), ex, tot, ws_i);
        int r = carry_c + ex[0];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (m[j]) {
            run = fmaxf(run, __fsub_rn(tv[j], __fmul_rn(stt, __int2float_rn(r))));
            ++r;
          }
        }
        carry_c += tot[0];
      }
      float v[1] = {run}, ex[1], tot[1];
      block_scan(v, 1, -INFINITY, Max(), ex, tot, ws_f);
      if (threadIdx.x == 0) pub.seg_max[par] = tot[0];
    }
    // also keeps the write pass below from overwriting what a peer may still
    // read of the last stage
    cluster_sync(cl);
    float carry_f = -INFINITY;  // the max over the earlier segments
    for (int q = 0; q < rank; ++q) carry_f = fmaxf(carry_f, peer(cl, &pub, q)->seg_max[par]);

    // write pass: starts, delays, the pair check, and for the next stage its
    // segment max over the new times (its ranks are known: this pass moves
    // no event) and the counts of the stage after it
    {
      int carry_c = base, carry_c2 = base2;
      double dsum = 0.0;
      int next = 0, next2 = 0;
      float run2 = -INFINITY;
      bool ok = true;
      double* wrow = kHosts ? wrows + (threadIdx.x >> 5) * n_hosts : nullptr;
      int parity = 0;
      for (long long tb = lo; tb < hi; tb += kTile, parity ^= 1) {
        const long long i0 = tb + static_cast<long long>(threadIdx.x) * kItems;
        const int n_valid = static_cast<int>(max(0LL, min(static_cast<long long>(kItems), hi - i0)));
        float tv[kItems], p[kItems], lm[kItems], nt[kItems];
        bool m[kItems], m2[kItems];
        int bv[kItems], hv[kItems];  // route words, the host of each queued event
        int c[2] = {0, 0};
        load_items(cur.t + i0, n_valid, vec, 0.0f, tv);
        load_items(cur.b + i0, n_valid, vec, 0, bv);
        if constexpr (kHosts) load_items(cur.i + i0, n_valid, vec, 0, hv);
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int b = bv[j];
          m[j] = (b >> s) & 1;
          if constexpr (kHosts) hv[j] = m[j] ? h0[hv[j]] : 0;
          m2[j] = has_next && ((b >> (s + 1)) & 1);
          next2 += s + 2 < n_stages ? (b >> (s + 2)) & 1 : 0;
          c[0] += m[j];
          c[1] += m2[j];
        }
        int ex[2], tot[2];
        block_scan(c, 2, 0, Add(), ex, tot, ws_i);
        int r = carry_c + ex[0];
        float lrun = -INFINITY;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          p[j] = 0.0f;
          if (m[j]) {
            p[j] = __fmul_rn(stt, __int2float_rn(r));
            lrun = fmaxf(lrun, __fsub_rn(tv[j], p[j]));
            ++r;
          }
          lm[j] = lrun;
        }
        float v[1] = {lrun}, fex[1], ftot[1];
        block_scan(v, 1, -INFINITY, Max(), fex, ftot, ws_f);
        const float pre = fmaxf(carry_f, fex[0]);
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          nt[j] = m[j] ? __fadd_rn(fmaxf(pre, lm[j]), p[j]) : tv[j];
          double d = 0.0;
          if (m[j]) {
            d = static_cast<double>(__fsub_rn(nt[j], tv[j]));
            dsum += d;
          }
          if constexpr (kHosts) {
            const bool add = m[j] && static_cast<unsigned>(hv[j]) < static_cast<unsigned>(n_hosts);
            if (cols) {
              if (add) wrows[hv[j] * kThreads + threadIdx.x] += d;
            } else {
              warp_slot_add(wrow, add, hv[j], d);
            }
          }
        }
        int r2 = carry_c2 + ex[1];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (m2[j]) {
            run2 = fmaxf(run2, __fsub_rn(nt[j], __fmul_rn(stt2, __int2float_rn(r2))));
            ++r2;
          }
        }
        store_items(cur.t + i0, n_valid, vec, nt, m);
        if (!tile_pairs(nt, m, n_valid, tb == lo, parity, ps, FifoBad())) ok = false;
        if (threadIdx.x == 0 && tb == lo) {
          pub.first_t = nt[0];
          pub.first_a = m[0];
        }
        if (n_valid > 0 && i0 + n_valid == hi) {
          pub.last_t = nt[n_valid - 1];
          pub.last_a = m[n_valid - 1];
        }
        carry_c += tot[0];
        carry_c2 += tot[1];
        next += tot[1];
        carry_f = fmaxf(carry_f, ftot[0]);
      }
      const double seg_delay = block_sum(dsum, ws_d);
      int cnt[1] = {next2};
      block_sums(cnt, 1, ws_i);
      float v2[1] = {run2}, ex2[1], max2[1];
      block_scan(v2, 1, -INFINITY, Max(), ex2, max2, ws_f);
      ok = __syncthreads_and(ok);
      if (threadIdx.x == 0) {
        pub.dsum = seg_delay;
        pub.ok = ok;
        pub.cnt[par ^ 1] = next;
        pub.cnt2[par ^ 1] = cnt[0];
        pub.seg_max[par ^ 1] = max2[0];
      }
      if constexpr (kHosts) {
        if (cols) fold_columns(wrows, n_hosts, pub.host, ws_cols);
        else fold_slots(wrows, n_hosts, pub.host);
      }
    }
    cluster_sync(cl);

    double stage = 0.0;  // folded in rank order: every CTA gets the same sum
    bool identity = true;
    for (int q = 0; q < k; ++q) {
      const Pub* pq = peer(cl, &pub, q);
      stage += pq->dsum;
      identity = identity && pq->ok;
      if (q + 1 < k) {
        long long qlo, qhi, nlo, nhi;
        segment(live, k, q, qlo, qhi);
        segment(live, k, q + 1, nlo, nhi);
        if (qhi > qlo && nhi > nlo) {
          const Pub* pn = peer(cl, &pub, q + 1);
          if (FifoBad()(pq->last_t, pq->last_a, pn->first_t, pn->first_a)) identity = false;
        }
      }
    }
    if (rank == 0) {
      if constexpr (kHosts) {
        for (int h = threadIdx.x; h < n_hosts; h += kThreads) {
          double acc = 0.0;
          for (int q = 0; q < k; ++q) acc += peer(cl, &pub, q)->host[h];
          psd[(row * n_stages + s) * n_hosts + h] = static_cast<float>(acc);
        }
      } else {
        if (threadIdx.x == 0) psd[row * n_stages + s] = static_cast<float>(stage);
      }
    }
    dirty += stage;
    if (s + 1 == n_stages) break;

    int flag = kMergeNone;
    if (dirty > 0.0) {
      flag = identity ? kMergeSkipped : kMergeRan;
    }
    if (flag == kMergeRan) {
      // compact: stage s's events to cmp[0, total), the rest after them
      int ca = base;  // stage-s events before the current tile
      for (long long tb = lo; tb < hi; tb += kTile) {
        const long long i0 = tb + static_cast<long long>(threadIdx.x) * kItems;
        const int n_valid = static_cast<int>(max(0LL, min(static_cast<long long>(kItems), hi - i0)));
        float tv[kItems];
        int bv[kItems], iv[kItems];
        int c[1] = {0};
        load_items(cur.t + i0, n_valid, vec, 0.0f, tv);
        load_items(cur.b + i0, n_valid, vec, 0, bv);
        load_items(cur.i + i0, n_valid, vec, 0, iv);
#pragma unroll
        for (int j = 0; j < kItems; ++j) c[0] += (bv[j] >> s) & 1;
        int ex[1], tot[1];
        block_scan(c, 1, 0, Add(), ex, tot, ws_i);
        // stage the tile in shared memory, its stage-s events first, so that
        // both runs' slices go out as contiguous, coalesced writes
        int xa = ex[0], xb = tot[0] + static_cast<int>(threadIdx.x) * kItems - ex[0];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (j < n_valid) {
            const int x = (bv[j] >> s) & 1 ? xa++ : xb++;
            ms.t[pad(x)] = tv[j];
            ms.b[pad(x)] = bv[j];
            ms.i[pad(x)] = iv[j];
          }
        }
        __syncthreads();
        const int len = static_cast<int>(min(static_cast<long long>(kTile), hi - tb));
        const long long b_at = total + (tb - ca);  // the tile's first untouched event's place
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          const int x = threadIdx.x + q * kThreads;
          if (x < len) {
            const long long dst = x < tot[0] ? ca + x : b_at + (x - tot[0]);
            cmp.t[dst] = ms.t[pad(x)];
            cmp.b[dst] = ms.b[pad(x)];
            cmp.i[dst] = ms.i[pad(x)];
          }
        }
        __syncthreads();
        ca += tot[0];
      }
      cluster_sync(cl);
      CountBits counter{s + 1, {0, 0}};
      merge_runs<false>(cmp, total, offset(cmp, total), live - total, cur, lo, hi,
                        FifoBefore(), ms, counter);
      block_sums(counter.count, 2, ws_i);
      if (threadIdx.x == 0) {
        pub.cnt[par ^ 1] = counter.count[0];
        pub.cnt2[par ^ 1] = counter.count[1];
      }
      cluster_sync(cl);
    }
    fused = flag != kMergeRan;
    if (rank == 0 && threadIdx.x == 0) flags[row * n_stages + s + 1] = static_cast<signed char>(flag);
  }
  if (rank == 0 && threadIdx.x == 0 && n_stages > 0) flags[row * n_stages] = kMergeNone;
  cl.sync();  // no CTA leaves while a peer may still read its shared memory
}

template <bool kHosts>
int launch(const void* t, const void* bits, const void* hosts, const void* stts, void* t_out,
           void* idx_out, void* scratch, void* psd, void* flags, long long n_rows, long long n,
           int n_stages, int n_hosts, int ctas, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (ctas < 1 || ctas > kMaxCtas || n_hosts < 1 || n_hosts > kMaxHosts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 3 * kPadTile * sizeof(int) + (kThreads + 1) * sizeof(long long) +
                      (kHosts ? (n_hosts <= kPrivSlots ? kThreads : kWarps) * n_hosts *
                                    sizeof(double)
                              : 0);
  auto kernel = cascade_kernel<kHosts>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_rows * ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(t),
                         static_cast<const int*>(bits), static_cast<const int*>(hosts),
                         static_cast<const float*>(stts), n_stages, n, n_hosts,
                         static_cast<float*>(t_out), static_cast<int*>(idx_out),
                         static_cast<int*>(scratch), static_cast<float*>(psd),
                         static_cast<signed char*>(flags));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: [4, n_rows, n] 32-bit words (route words, then the merge's
// compacted times, route words and slot indices).
extern "C" int congestion_cascade_launch(
    const void* t, const void* bits, const void* stts, void* t_out, void* idx_out,
    void* scratch, void* psd, void* flags, long long n_rows, long long n, int n_stages,
    int ctas, void* stream) {
  return launch<false>(t, bits, nullptr, stts, t_out, idx_out, scratch, psd, flags, n_rows, n,
                       n_stages, 1, ctas, stream);
}

extern "C" int congestion_cascade_hosts_launch(
    const void* t, const void* bits, const void* hosts, const void* stts, void* t_out,
    void* idx_out, void* scratch, void* psd, void* flags, long long n_rows, long long n,
    int n_stages, int n_hosts, int ctas, void* stream) {
  return launch<true>(t, bits, hosts, stts, t_out, idx_out, scratch, psd, flags, n_rows, n,
                      n_stages, n_hosts, ctas, stream);
}

extern "C" const char* congestion_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
