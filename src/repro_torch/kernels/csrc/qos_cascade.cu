// QoS-arbitrated S-stage congestion cascade for Hopper (sm_90a), single-host
// and host-segmented.
//
// Replaces the TPU kernel repro/kernels/congestion.py:qos_congestion_cascade
// (body _qos_cascade_body), and takes the host-segmented form the reference
// computes with its plain ref.qos_cascade_dyn(hosts=).  Semantics are those
// of the plain version, repro_torch/kernels/ref.py:qos_cascade_dyn, step for
// step: for every epoch row and every stage s, in stage order,
//
//   skip    if stts[s] == 0 the stage is an identity (delays 0);
//   scans   otherwise C masked closed-form FIFO scans over the events whose
//           route word has bit s: class c's queue holds the events with
//           q_eff <= c under priority and q_eff == c under WFQ and FIFO
//           (q_eff = the event's class, 0 at a FIFO stage, so FIFO runs one
//           scan), with service time stt_table[s, c] (stt*W/w_c under WFQ,
//           from the wrapper's ref.qos_service_table); an event starts where
//           its own class's scan puts it.  The event in slot i has class
//           qos[slot_idx[i]] (and host hosts[slot_idx[i]]): no class or host
//           row moves through the folds;
//   sums    per_stage_delay[row, s, h, c] = the delay of the events of host h
//           and *actual* class c;
//   fold    if s < S-1, the row's cumulative delay is > 0, and neither the
//           next stage is WFQ over the same events of the row nor is it the
//           last stage with zero service, the C + 1 sorted runs (the stage's
//           events keyed by q_eff, then the untouched ones) are merged back
//           into time order by a STABLE merge: ties keep array order (the
//           DES heap's push order).
//
// Outputs: t_final[row, k] is the post-congestion time of the event that sat
// at sorted position slot_idx[row, k] of the input row; merge_flags[row, s]
// says what became of the fold before stage s (ref.MERGE_*).
//
// What bounds it: memory.  The least traffic is reading t, the route bits and
// the classes (and the host ids) and writing t_final and slot_idx once: 20 B
// per event, 24 B with hosts, about 0.24 ms for qos-fabric's [32, 1048576]
// batch at 3.35 TB/s.  The C scans per stage are a few f32 operations per
// event and class, far below the f32 peak.  A fabric row does not fit on
// chip, so each pass over it streams from HBM, and the design counts passes.
//
// What this design does about it: the FIFO cascade's design
// (congestion_cascade.cu, cluster_cascade.cuh), class by class:
// - a thread-block cluster of k CTAs per row (the wrapper's ctas_per_row),
//   the per-segment carries exchanged through distributed shared memory;
// - count, then max, then write for each stage, all C classes' scans in the
//   same two passes (one block scan of C counters and one of C maxima per
//   tile, not two per class): exact in any split;
// - the fold as a chain of two-way merges by merge path: the C + 1 runs
//   are compacted (count-then-place across the cluster, each tile grouped
//   by run in shared memory, the positions kept beside them), then the
//   non-empty runs are merged one after another,
//   smallest first, keyed by (the f32 sort key, array position), a total
//   order in which every run is sorted, so the chain is the stable fold;
// - a fold skipped exactly when the row is already in key order (checked on
//   every adjacent pair by the pass that writes the stage's starts): the
//   stable fold would be the identity;
// - pads cut off as in the FIFO cascade, and per-(host, class) sums as its
//   per-host sums: per-thread columns up to 16 slots, per-warp rows beyond.
// The kernel is instantiated for at most 2 and at most 8 classes, so the
// usual two-class topologies keep their per-class arrays in registers.  It
// does not take the next stage's maxima in the write pass as the FIFO
// kernel does: with C classes of state that pass spilled more registers
// and, on the card, ran slower than the separate max pass.
//
// Numerics: f32 products and sums rounded one by one (__fmul_rn, __fsub_rn,
// __fadd_rn) as in the plain version; the rank is an int32 count; delay sums
// accumulate in double in a fixed order; the fold guard is the row's
// cumulative delay from that fixed-order fold, so t_final, slot_idx and the
// flags do not vary between runs.

#include "cluster_cascade.cuh"

namespace {

using namespace cascade;

constexpr int kMaxClasses = 8;  // QoS classes (every topology of the repository has <= 3)
constexpr int kMaxHosts = 32;  // per-host delay slots (the route word allows 31 stages)
constexpr int kMaxSlots = kMaxHosts * kMaxClasses;
constexpr int kDiscFifo = 0;  // ref.DISC_FIFO
constexpr int kDiscPriority = 1;  // ref.DISC_PRIORITY
constexpr int kDiscWfq = 2;  // ref.DISC_WFQ

// What a CTA publishes to its cluster.
struct Pub {
  int cnt[kMaxClasses];  // the next scanned stage's per-class counts in this segment
  float seg_max[kMaxClasses];  // the stage's per-class max of t - stt*rank
  int runs[kMaxClasses + 1];  // the fold's run sizes in this segment
  int tail_ok;
  int ok;  // the segment is in key order, its ends included
  int same;  // every event crosses stage s exactly when it crosses s + 1
  float first_t, last_t;
  double dsum;
  double slot[kMaxSlots];
};

__device__ __forceinline__ int clamp_class(int q, int n_classes) {
  return q < 0 ? 0 : (q >= n_classes ? n_classes - 1 : q);
}

// Whether an event of effective class qe joins class c's queue.
__device__ __forceinline__ bool joins(int disc, int qe, int c) {
  return disc == kDiscPriority ? qe <= c : qe == c;
}

// The stable fold's order: (f32 sort key, array position).
struct QosBefore {
  __device__ __forceinline__ bool operator()(float ta, int pa, float tb, int pb) const {
    const int ka = f32_key(ta), kb = f32_key(tb);
    return ka < kb || (ka == kb && pa < pb);
  }
};

// A pair the stable fold would reorder.
struct QosBad {
  __device__ __forceinline__ bool operator()(float xt, bool, float yt, bool) const {
    return f32_key(yt) < f32_key(xt);
  }
};

// The stage a pass counts for: its bit, discipline and number of scans.
struct Stage {
  int bit;
  int disc;
  int n_scans;
};

template <int kC>
__device__ __forceinline__ void count_joins(const Stage& st, int b, int q, int (&cnt)[kC]) {
  if ((b >> st.bit) & 1) {
    const int qe = st.disc == kDiscFifo ? 0 : q;
#pragma unroll
    for (int c = 0; c < kC; ++c) cnt[c] += c < st.n_scans && joins(st.disc, qe, c);
  }
}

// Counts a stage's per-class queue sizes among the events a merge writes.
template <int kC>
struct CountJoins {
  Stage st;
  const int* qos;
  int n_classes;
  int cnt[kC];
  __device__ __forceinline__ void operator()(int b, int i) {
    if ((b >> st.bit) & 1) count_joins(st, b, clamp_class(qos[i], n_classes), cnt);
  }
};

struct NoObserve {
  __device__ __forceinline__ void operator()(int, int) {}
};

template <bool kHosts, int kC>
__global__ void __launch_bounds__(kThreads, 1)
qos_cascade_kernel(const float* __restrict__ t_in, const int* __restrict__ bits_in,
                   const int* __restrict__ qos_in, const int* __restrict__ hosts_in,
                   const float* __restrict__ stts, const float* __restrict__ stt_table,
                   const int* __restrict__ disc, int n_stages, int n_classes, long long n,
                   int n_hosts, float* t_out, int* idx_out, int* scratch, float* psd,
                   signed char* flags) {
  constexpr int kR = kC + 1;  // the fold's runs: classes, then the untouched events
  cg::cluster_group cl = cg::this_cluster();
  const int k = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const long long row = blockIdx.x / k;
  const long long off = row * n;
  const long long plane = static_cast<long long>(gridDim.x / k) * n;
  const int n_slots = n_hosts * n_classes;

  __shared__ Pub pub;
  __shared__ PairSmem ps;
  __shared__ int ws_i[(kWarps + 1) * kR];
  __shared__ float ws_f[(kWarps + 1) * kC];
  __shared__ double ws_d[kWarps + 1];
  __shared__ double ws_cols[kWarps * kPrivSlots];
  __shared__ long long s_live;
  extern __shared__ __align__(16) unsigned char dyn[];
  MergeSmem ms{reinterpret_cast<float*>(dyn), reinterpret_cast<int*>(dyn) + kPadTile,
               reinterpret_cast<int*>(dyn) + 2 * kPadTile,
               reinterpret_cast<int*>(dyn) + 3 * kPadTile,
               reinterpret_cast<long long*>(dyn + 4 * kPadTile * sizeof(int))};
  double* wrows = reinterpret_cast<double*>(dyn + 4 * kPadTile * sizeof(int) +
                                            (kThreads + 1) * sizeof(long long));

  // the row's state (current times in t_out, route words, slot indices, and
  // positions for an intermediate merge), the fold's compacted runs, and the
  // other buffer of its chain of merges
  Arrays cur{t_out + off, scratch + off, idx_out + off, scratch + plane + off};
  Arrays cmp{reinterpret_cast<float*>(scratch + 2 * plane) + off, scratch + 3 * plane + off,
             scratch + 4 * plane + off, scratch + 5 * plane + off};
  Arrays aux{reinterpret_cast<float*>(scratch + 6 * plane) + off, scratch + 7 * plane + off,
             scratch + 8 * plane + off, scratch + 9 * plane + off};
  const float* t0 = t_in + off;
  const int* b0 = bits_in + off;
  const int* q0 = qos_in + off;
  const int* h0 = kHosts ? hosts_in + off : nullptr;
  float* row_psd = psd + row * n_stages * n_slots;

  const bool cols = n_slots <= kPrivSlots;  // per-thread columns of slot sums, else per-warp rows
  for (int j = threadIdx.x; j < (cols ? kThreads : kWarps) * n_slots; j += kThreads) wrows[j] = 0.0;
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

  auto stage_of = [&](int s) {
    const int d = disc[s];
    return Stage{s, d, d == kDiscFifo ? 1 : n_classes};
  };
  // one pass over the segment that counts stage s_cnt's queues and, for
  // s_run >= 0, stage s_run's fold runs and whether every event crosses
  // s_run exactly when it crosses s_run + 1; publishes them.  It starts with
  // a cluster barrier: the peers may still be reading the last published
  // values.
  auto stats_pass = [&](int s_cnt, int s_run) {
    cluster_sync(cl);
    const Stage st_cnt = stage_of(s_cnt);
    int cnt[kC], runs[kR];
#pragma unroll
    for (int c = 0; c < kC; ++c) cnt[c] = 0;
#pragma unroll
    for (int j = 0; j < kR; ++j) runs[j] = 0;
    int same = 1;
    const Stage st_run = s_run >= 0 ? stage_of(s_run) : Stage{0, kDiscFifo, 1};
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int b = cur.b[i];
      const bool m_cnt = (b >> s_cnt) & 1;
      const bool m_run = s_run >= 0 && ((b >> s_run) & 1);
      const int q = m_cnt || m_run ? clamp_class(q0[cur.i[i]], n_classes) : 0;
      if (m_cnt) count_joins(st_cnt, b, q, cnt);
      if (s_run >= 0) {
        const int r = m_run ? (st_run.disc == kDiscFifo ? 0 : q) : n_classes;
#pragma unroll
        for (int j = 0; j < kR; ++j) runs[j] += r == j;
        same &= (((b >> s_run) ^ (b >> (s_run + 1))) & 1) == 0;
      }
    }
    block_sums(cnt, kC, ws_i);
    block_sums(runs, kR, ws_i);
    same = __syncthreads_and(same);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < kC; ++c) pub.cnt[c] = cnt[c];
#pragma unroll
      for (int j = 0; j < kR; ++j) pub.runs[j] = runs[j];
      pub.same = same;
    }
  };

  copy_rows(t0, b0, cur, lo, hi, [](float, int) {});
  __syncthreads();
  int counts_for = -1;  // the stage whose queue sizes pub.cnt holds
  if (n_stages > 0) {
    stats_pass(0, -1);
    counts_for = 0;
  }
  cluster_sync(cl);

  double dirty = 0.0;  // the row's cumulative delay: 0 => nothing moved
  bool ordered = true;  // the row is in key order
  for (int s = 0; s < n_stages; ++s) {
    const Stage st = stage_of(s);
    const bool served = stts[s] > 0.0f;
    const bool has_next = s + 1 < n_stages;
    const Stage st_next = has_next ? stage_of(s + 1) : Stage{-1, kDiscFifo, 1};
    bool same = false;
    int run_tot[kR], run_base[kR];  // the fold's run sizes, and this segment's offsets
    if (served) {
      if (counts_for != s) {
        stats_pass(s, -1);
        cluster_sync(cl);
      }
      int base[kC];  // per-class queue sizes of the earlier segments
#pragma unroll
      for (int c = 0; c < kC; ++c) base[c] = 0;
      for (int q = 0; q < rank; ++q) {
        const Pub* pq = peer(cl, &pub, q);
#pragma unroll
        for (int c = 0; c < kC; ++c) base[c] += pq->cnt[c];
      }
      float stt_c[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) stt_c[c] = c < st.n_scans ? stt_table[s * n_classes + c] : 0.0f;

      // count-then-max: each class's max of t - stt*rank over the segment
      {
        int carry_c[kC];
        float run[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          carry_c[c] = base[c];
          run[c] = -INFINITY;
        }
        for (long long tb = lo; tb < hi; tb += kTile) {
          const long long i0 = tb + static_cast<long long>(threadIdx.x) * kItems;
          const int n_valid =
              static_cast<int>(max(0LL, min(static_cast<long long>(kItems), hi - i0)));
          float tv[kItems];
          int bv[kItems];
          int qe[kItems];  // slot indices, then the effective class (-1: not in the stage)
          int cnt[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) cnt[c] = 0;
          load_items(cur.t + i0, n_valid, vec, 0.0f, tv);
          load_items(cur.b + i0, n_valid, vec, 0, bv);
          if (st.disc != kDiscFifo) load_items(cur.i + i0, n_valid, vec, 0, qe);
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            if ((bv[j] >> s) & 1) {
              qe[j] = st.disc == kDiscFifo ? 0 : clamp_class(q0[qe[j]], n_classes);
#pragma unroll
              for (int c = 0; c < kC; ++c) cnt[c] += c < st.n_scans && joins(st.disc, qe[j], c);
            } else {
              qe[j] = -1;
            }
          }
          int ex[kC], tot[kC];
          block_scan(cnt, st.n_scans, 0, Add(), ex, tot, ws_i);
#pragma unroll
          for (int c = 0; c < kC; ++c) ex[c] += carry_c[c];
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            if (qe[j] >= 0) {
#pragma unroll
              for (int c = 0; c < kC; ++c) {
                if (c < st.n_scans && joins(st.disc, qe[j], c)) {
                  run[c] = fmaxf(run[c], __fsub_rn(tv[j], __fmul_rn(stt_c[c], __int2float_rn(ex[c]))));
                  ++ex[c];
                }
              }
            }
          }
#pragma unroll
          for (int c = 0; c < kC; ++c) carry_c[c] += tot[c];
        }
        float ex[kC], tot[kC];
        block_scan(run, st.n_scans, -INFINITY, Max(), ex, tot, ws_f);
        if (threadIdx.x == 0) {
#pragma unroll
          for (int c = 0; c < kC; ++c) pub.seg_max[c] = tot[c];
        }
      }
      cluster_sync(cl);

      // write pass: starts, delays, the next stage's queue sizes, this
      // stage's fold runs, the same-mask test and the key-order check
      {
        int carry_c[kC];
        float carry_f[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          carry_c[c] = base[c];
          carry_f[c] = -INFINITY;
        }
        for (int q = 0; q < rank; ++q) {
          const Pub* pq = peer(cl, &pub, q);
#pragma unroll
          for (int c = 0; c < kC; ++c) carry_f[c] = fmaxf(carry_f[c], pq->seg_max[c]);
        }
        int next[kC], runs[kR];
#pragma unroll
        for (int c = 0; c < kC; ++c) next[c] = 0;
#pragma unroll
        for (int j = 0; j < kR; ++j) runs[j] = 0;
        double dsum = 0.0;
        bool ok = true;
        int same_i = 1;
        double* wrow = wrows + (threadIdx.x >> 5) * n_slots;
        int parity = 0;
        for (long long tb = lo; tb < hi; tb += kTile, parity ^= 1) {
          const long long i0 = tb + static_cast<long long>(threadIdx.x) * kItems;
          const int n_valid =
              static_cast<int>(max(0LL, min(static_cast<long long>(kItems), hi - i0)));
          float tv[kItems], lm[kItems], pk[kItems], nt[kItems];
          int qe[kItems], slot[kItems];
          bool m[kItems];
          int cnt[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) cnt[c] = 0;
          int bv[kItems];
          load_items(cur.t + i0, n_valid, vec, 0.0f, tv);
          load_items(cur.b + i0, n_valid, vec, 0, bv);
          load_items(cur.i + i0, n_valid, vec, 0, slot);  // slot indices first
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            const bool ok_j = j < n_valid;
            const int b = bv[j];
            m[j] = (b >> s) & 1;
            const bool m_next = has_next && ((b >> (s + 1)) & 1);
            int q = 0;
            const int idx = slot[j];
            slot[j] = -1;
            if (m[j] || m_next) {
              q = clamp_class(q0[idx], n_classes);
              const int h = kHosts ? h0[idx] : 0;
              if (static_cast<unsigned>(h) < static_cast<unsigned>(n_hosts)) slot[j] = h * n_classes + q;
            }
            qe[j] = m[j] ? (st.disc == kDiscFifo ? 0 : q) : -1;
            if (m[j]) {
#pragma unroll
              for (int c = 0; c < kC; ++c) cnt[c] += c < st.n_scans && joins(st.disc, qe[j], c);
            }
            if (m_next) count_joins(st_next, b, q, next);
            if (ok_j) {
              const int r = m[j] ? qe[j] : n_classes;
#pragma unroll
              for (int jr = 0; jr < kR; ++jr) runs[jr] += r == jr;
              if (has_next) same_i &= (((b >> s) ^ (b >> (s + 1))) & 1) == 0;
            }
          }
          int ex[kC], tot[kC];
          block_scan(cnt, st.n_scans, 0, Add(), ex, tot, ws_i);
#pragma unroll
          for (int c = 0; c < kC; ++c) ex[c] += carry_c[c];
          float lrun[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) lrun[c] = -INFINITY;
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            lm[j] = -INFINITY;
            pk[j] = 0.0f;
            if (m[j]) {
#pragma unroll
              for (int c = 0; c < kC; ++c) {
                if (c < st.n_scans && joins(st.disc, qe[j], c)) {
                  const float p = __fmul_rn(stt_c[c], __int2float_rn(ex[c]));
                  lrun[c] = fmaxf(lrun[c], __fsub_rn(tv[j], p));
                  ++ex[c];
                  if (c == qe[j]) {
                    lm[j] = lrun[c];
                    pk[j] = p;
                  }
                }
              }
            }
          }
          float fex[kC], ftot[kC];
          block_scan(lrun, st.n_scans, -INFINITY, Max(), fex, ftot, ws_f);
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            nt[j] = tv[j];
            double d = 0.0;
            if (m[j]) {
              const int c = qe[j];
              const float pre = fmaxf(pick(carry_f, c), pick(fex, c));
              nt[j] = __fadd_rn(fmaxf(pre, lm[j]), pk[j]);
              d = static_cast<double>(__fsub_rn(nt[j], tv[j]));
              dsum += d;
            }
            if (cols) {
              if (m[j] && slot[j] >= 0) wrows[slot[j] * kThreads + threadIdx.x] += d;
            } else {
              warp_slot_add(wrow, m[j] && slot[j] >= 0, slot[j], d);
            }
          }
          store_items(cur.t + i0, n_valid, vec, nt, m);
          if (!tile_pairs(nt, m, n_valid, tb == lo, parity, ps, QosBad())) ok = false;
          if (threadIdx.x == 0 && tb == lo) pub.first_t = nt[0];
          if (n_valid > 0 && i0 + n_valid == hi) pub.last_t = nt[n_valid - 1];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            carry_c[c] += tot[c];
            carry_f[c] = fmaxf(carry_f[c], ftot[c]);
          }
        }
        const double seg_delay = block_sum(dsum, ws_d);
        block_sums(next, kC, ws_i);
        block_sums(runs, kR, ws_i);
        ok = __syncthreads_and(ok);
        same_i = __syncthreads_and(same_i);
        if (threadIdx.x == 0) {
          pub.dsum = seg_delay;
          pub.ok = ok;
          pub.same = same_i;
#pragma unroll
          for (int c = 0; c < kC; ++c) pub.cnt[c] = next[c];
#pragma unroll
          for (int j = 0; j < kR; ++j) pub.runs[j] = runs[j];
        }
        if (cols) fold_columns(wrows, n_slots, pub.slot, ws_cols);
        else fold_slots(wrows, n_slots, pub.slot);
      }
      cluster_sync(cl);

      double stage = 0.0;  // folded in rank order: every CTA gets the same sum
      ordered = true;
      same = true;
      for (int q = 0; q < k; ++q) {
        const Pub* pq = peer(cl, &pub, q);
        stage += pq->dsum;
        ordered = ordered && pq->ok;
        same = same && pq->same;
        if (q + 1 < k) {
          long long qlo, qhi, nlo, nhi;
          segment(live, k, q, qlo, qhi);
          segment(live, k, q + 1, nlo, nhi);
          if (qhi > qlo && nhi > nlo &&
              QosBad()(pq->last_t, false, peer(cl, &pub, q + 1)->first_t, false)) {
            ordered = false;
          }
        }
      }
      if (rank == 0) {
        for (int j = threadIdx.x; j < n_slots; j += kThreads) {
          double acc = 0.0;
          for (int q = 0; q < k; ++q) acc += peer(cl, &pub, q)->slot[j];
          row_psd[s * n_slots + j] = static_cast<float>(acc);
        }
      }
      dirty += stage;
      counts_for = s + 1;
    } else if (rank == 0) {
      for (int j = threadIdx.x; j < n_slots; j += kThreads) row_psd[s * n_slots + j] = 0.0f;
    }
    if (!has_next) break;

    int flag = kMergeNone;
    if (dirty > 0.0) {
      bool elide = s + 1 == n_stages - 1 && !(stts[s + 1] > 0.0f);
      const bool need_same = !elide && st_next.disc == kDiscWfq;
      if (!served && (need_same || (!elide && !ordered))) {
        // nothing was scanned here: one pass for the runs and masks
        stats_pass(s + 1, s);
        cluster_sync(cl);
        same = true;
        for (int q = 0; q < k; ++q) same = same && peer(cl, &pub, q)->same;
        counts_for = s + 1;
      }
      if (need_same && same) elide = true;
      if (!elide) flag = ordered ? kMergeSkipped : kMergeRan;
    }
    if (flag == kMergeRan) {
      int acc = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        run_tot[j] = 0;
        run_base[j] = 0;
        for (int q = 0; q < k; ++q) {
          const int c = peer(cl, &pub, q)->runs[j];
          run_tot[j] += c;
          run_base[j] += q < rank ? c : 0;
        }
      }
      int seg_off[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        seg_off[j] = acc;
        run_base[j] += acc;
        acc += run_tot[j];
      }
      // compact each run into its own segment of cmp, in array order
      for (long long tb = lo; tb < hi; tb += kTile) {
        const long long i0 = tb + static_cast<long long>(threadIdx.x) * kItems;
        const int n_valid =
            static_cast<int>(max(0LL, min(static_cast<long long>(kItems), hi - i0)));
        int rid[kItems], bv[kItems], iv[kItems];
        float tv[kItems];
        int cnt[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) cnt[j] = 0;
        load_items(cur.t + i0, n_valid, vec, 0.0f, tv);
        load_items(cur.b + i0, n_valid, vec, 0, bv);
        load_items(cur.i + i0, n_valid, vec, 0, iv);
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          rid[j] = kR;
          if (j < n_valid) {
            rid[j] = n_classes;
            if ((bv[j] >> s) & 1) {
              rid[j] = st.disc == kDiscFifo ? 0 : clamp_class(q0[iv[j]], n_classes);
            }
#pragma unroll
            for (int jr = 0; jr < kR; ++jr) cnt[jr] += rid[j] == jr;
          }
        }
        int ex[kR], tot[kR];
        block_scan(cnt, n_classes + 1, 0, Add(), ex, tot, ws_i);
        // stage the tile in shared memory grouped by run, so that each run's
        // slice goes out as contiguous, coalesced writes
        int toff[kR];  // the runs' offsets in the tile
        {
          int acc = 0;
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            toff[j] = acc;
            acc += tot[j];
          }
        }
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (rid[j] < kR) {
            const int r = rid[j];
            const int x = pick(toff, r) + pick(ex, r);
#pragma unroll
            for (int jr = 0; jr < kR; ++jr) ex[jr] += r == jr;
            ms.t[pad(x)] = tv[j];
            ms.b[pad(x)] = bv[j];
            ms.i[pad(x)] = iv[j];
            ms.p[pad(x)] = static_cast<int>(i0 + j);
          }
        }
        __syncthreads();
        const int len = static_cast<int>(min(static_cast<long long>(kTile), hi - tb));
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
          const int x = threadIdx.x + q * kThreads;
          if (x < len) {
            int r = 0;
#pragma unroll
            for (int jr = 1; jr < kR; ++jr) {
              if (x >= toff[jr] && tot[jr] > 0) r = jr;
            }
            const long long dst = pick(run_base, r) + (x - pick(toff, r));
            cmp.t[dst] = ms.t[pad(x)];
            cmp.b[dst] = ms.b[pad(x)];
            cmp.i[dst] = ms.i[pad(x)];
            cmp.p[dst] = ms.p[pad(x)];
          }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kR; ++j) run_base[j] += tot[j];
      }
      cluster_sync(cl);
      // merge the non-empty runs one after another, smallest first (any
      // order gives the stable fold: the key is a total order); the last
      // merge writes the row, the earlier ones alternate between aux and the
      // row (with its position plane)
      int order[kR], runs_left = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        if (run_tot[j] == 0) continue;
        int at = runs_left++;
        while (at > 0 && pick(run_tot, order[at - 1]) > run_tot[j]) {
          order[at] = order[at - 1];
          --at;
        }
        order[at] = j;
      }
      Arrays x = offset(cmp, pick(seg_off, order[0]));
      long long nx = pick(run_tot, order[0]);
#pragma unroll 1
      for (int q = 1; q < runs_left; ++q) {
        const int j = order[q];
        const long long ny = pick(run_tot, j);
        const Arrays y = offset(cmp, pick(seg_off, j));
        const int merges_left = runs_left - 1 - q;
        long long olo, ohi;
        segment(nx + ny, k, rank, olo, ohi);
        if (merges_left == 0) {
          const Arrays out{cur.t, cur.b, cur.i, nullptr};
          CountJoins<kC> counter{st_next, q0, n_classes, {}};
          merge_runs<true>(x, nx, y, ny, out, olo, ohi, QosBefore(), ms, counter);
          block_sums(counter.cnt, kC, ws_i);
          if (threadIdx.x == 0) {
#pragma unroll
            for (int c = 0; c < kC; ++c) pub.cnt[c] = counter.cnt[c];
          }
        } else {
          const Arrays out = (merges_left & 1) == 0 ? cur : aux;
          NoObserve none;
          merge_runs<true>(x, nx, y, ny, out, olo, ohi, QosBefore(), ms, none);
          x = out;
        }
        cluster_sync(cl);
        nx += ny;
      }
      ordered = true;
      counts_for = s + 1;
    }
    if (rank == 0 && threadIdx.x == 0) flags[row * n_stages + s + 1] = static_cast<signed char>(flag);
  }
  if (rank == 0 && threadIdx.x == 0 && n_stages > 0) flags[row * n_stages] = kMergeNone;
  cl.sync();  // no CTA leaves while a peer may still read its shared memory
}

template <bool kHosts, int kC>
size_t smem_bytes(int n_slots) {
  return 4 * kPadTile * sizeof(int) + (kThreads + 1) * sizeof(long long) +
         (n_slots <= kPrivSlots ? kThreads : kWarps) * n_slots * sizeof(double);
}

template <bool kHosts, int kC>
int launch_with(const void* t, const void* bits, const void* qos, const void* hosts,
                const void* stts, const void* stt_table, const void* disc, void* t_out,
                void* idx_out, void* scratch, void* psd, void* flags, long long n_rows,
                long long n, int n_stages, int n_classes, int n_hosts, int ctas,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<kHosts, kC>(n_hosts * n_classes);
  auto kernel = qos_cascade_kernel<kHosts, kC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_rows * ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(t),
                         static_cast<const int*>(bits), static_cast<const int*>(qos),
                         static_cast<const int*>(hosts), static_cast<const float*>(stts),
                         static_cast<const float*>(stt_table), static_cast<const int*>(disc),
                         n_stages, n_classes, n, n_hosts, static_cast<float*>(t_out),
                         static_cast<int*>(idx_out), static_cast<int*>(scratch),
                         static_cast<float*>(psd), static_cast<signed char*>(flags));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHosts>
int launch(const void* t, const void* bits, const void* qos, const void* hosts,
           const void* stts, const void* stt_table, const void* disc, void* t_out,
           void* idx_out, void* scratch, void* psd, void* flags, long long n_rows, long long n,
           int n_stages, int n_classes, int n_hosts, int ctas, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (n_classes < 1 || n_classes > kMaxClasses || n_hosts < 1 || n_hosts > kMaxHosts ||
      ctas < 1 || ctas > kMaxCtas) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_classes <= 2) {
    return launch_with<kHosts, 2>(t, bits, qos, hosts, stts, stt_table, disc, t_out, idx_out,
                                  scratch, psd, flags, n_rows, n, n_stages, n_classes, n_hosts,
                                  ctas, s);
  }
  return launch_with<kHosts, kMaxClasses>(t, bits, qos, hosts, stts, stt_table, disc, t_out,
                                          idx_out, scratch, psd, flags, n_rows, n, n_stages,
                                          n_classes, n_hosts, ctas, s);
}

}  // namespace

// scratch: [10, n_rows, n] 32-bit words (route words and positions of the
// row, then the fold's compacted runs and the other buffer of its chain of
// merges, each as times, route words, slot indices and positions).
extern "C" int qos_cascade_launch(
    const void* t, const void* bits, const void* qos, const void* stts, const void* stt_table,
    const void* disc, void* t_out, void* idx_out, void* scratch, void* psd, void* flags,
    long long n_rows, long long n, int n_stages, int n_classes, int ctas, void* stream) {
  return launch<false>(t, bits, qos, nullptr, stts, stt_table, disc, t_out, idx_out, scratch,
                       psd, flags, n_rows, n, n_stages, n_classes, 1, ctas, stream);
}

extern "C" int qos_cascade_hosts_launch(
    const void* t, const void* bits, const void* qos, const void* hosts, const void* stts,
    const void* stt_table, const void* disc, void* t_out, void* idx_out, void* scratch,
    void* psd, void* flags, long long n_rows, long long n, int n_stages, int n_classes,
    int n_hosts, int ctas, void* stream) {
  return launch<true>(t, bits, qos, hosts, stts, stt_table, disc, t_out, idx_out, scratch, psd,
                      flags, n_rows, n, n_stages, n_classes, n_hosts, ctas, stream);
}

extern "C" const char* qos_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
