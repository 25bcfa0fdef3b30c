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
//           and *actual* class c (per-warp shared-memory doubles);
//   fold    if s < S-1, the row's cumulative delay is > 0, and neither the
//           next stage is WFQ over the same events of the row nor is it the
//           last stage with zero service, the C + 1 sorted runs (the stage's
//           events keyed by q_eff, then the untouched ones) are merged back
//           into time order by a STABLE rank merge: ties keep array order
//           (the DES heap's push order).
//
// Outputs: t_final[row, k] is the post-congestion time of the event that sat
// at sorted position slot_idx[row, k] of the input row.
//
// What bounds it: memory.  The least traffic is reading t, the route bits and
// the classes (and the host ids) and writing t_final and slot_idx once: 20 B
// per event, 24 B with hosts, about 25 us for a [32, 131072] batch at
// 3.35 TB/s.  The C scans per stage are a few f32 operations per event and
// class, far below the f32 peak.
//
// What this design does about it: nothing yet; it is the simple, right first
// version, built from the FIFO cascade's machinery (block_scan.cuh).  One CTA
// per epoch row walks the row in tiles; the row's times, route bits and slot
// indices stay in global memory (L2).  Each stage costs two block-wide scans
// per tile and class, with each class's (int32 rank, f32 cummax) carry pair
// in registers.  Each fold costs three passes: label and count the runs,
// compact each run into its own segment in array order, then place every
// element at its own-run rank plus, for every other run j,
// clamp(pc_j, lower_bound_j(key), upper_bound_j(key)) with pc_j the run-j
// elements at earlier array positions (a block scan of R counters); the
// bounds are read around pc_j in run j's segment (two reads when the element
// did not pass a run-j element, a galloping search when it did), so a fold
// reads O(N R) from L2 plus O(log distance) per displaced element.
// Keys compare as the int32 image of the f32 time (ref._f32_sort_key).  One
// CTA per row fills only B of the 132 SMs.
//
// Numerics: f32 products and sums rounded one by one (__fmul_rn, __fsub_rn,
// __fadd_rn) as in the plain version; the rank is an int32 count; delay sums
// accumulate in double.  The per-(host, class) sums take atomic adds in a
// run-dependent order, so they vary in their last double bits; the fold guard
// is the row's cumulative delay from a deterministic block reduction, so
// t_final and slot_idx do not vary.

#include "block_scan.cuh"

namespace {

using namespace congestion;

constexpr int kMaxClasses = 8;  // QoS classes (every topology of the repository has <= 3)
constexpr int kMaxRuns = kMaxClasses + 1;  // the fold's runs: classes + untouched
constexpr int kMaxHosts = 32;  // per-host delay slots (the route word allows 31 stages)
constexpr int kDiscFifo = 0;  // ref.DISC_FIFO
constexpr int kDiscPriority = 1;  // ref.DISC_PRIORITY
constexpr int kDiscWfq = 2;  // ref.DISC_WFQ

struct FoldSmem {
  int c[kWarps][kMaxRuns];  // per-warp partials of the R-counter scan
  int tot[kMaxRuns];
  int seg[kMaxRuns + 1];  // run j occupies [seg[j], seg[j+1]) of the compacted row
};

__device__ __forceinline__ int clamp_class(int q, int n_classes) {
  return q < 0 ? 0 : (q >= n_classes ? n_classes - 1 : q);
}

// Order-preserving int32 image of an f32 value (ref._f32_sort_key).
__device__ __forceinline__ int f32_key(float v) {
  const int x = __float_as_int(v);
  return x >= 0 ? x : x ^ 0x7fffffff;
}

// Number of elements of the key-sorted run a[0:len) whose key is < key
// (strict) or <= key (!strict).
__device__ __forceinline__ int count_below(const float* a, int len, int key, bool strict) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int k = f32_key(a[mid]);
    if (strict ? k < key : k <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Run j's contribution to the merged rank of an element of another run with
// key `key`: clamp(pc, lower_bound(key), upper_bound(key)) over the key-sorted
// run a[0:len), pc being the run-j elements at earlier array positions.  The
// runs were sorted before the stage moved some of them, so the answer is
// usually pc itself (two reads); otherwise a galloping search from pc finds
// it in O(log distance) reads.
__device__ __forceinline__ int stable_count(const float* a, int len, int pc, int key) {
  if (pc > 0 && f32_key(a[pc - 1]) > key) {
    // upper_bound < pc: the first element > key lies in [0, pc - 1]
    int b = pc - 1, step = 1;
    while (b - step >= 0 && f32_key(a[b - step]) > key) {
      b -= step;
      step <<= 1;
    }
    const int l = b - step + 1 > 0 ? b - step + 1 : 0;
    return l + count_below(a + l, b - l, key, false);
  }
  if (pc < len && f32_key(a[pc]) < key) {
    // lower_bound > pc: the first element >= key lies in [pc + 1, len]
    int b = pc, step = 1;
    while (b + step < len && f32_key(a[b + step]) < key) {
      b += step;
      step <<= 1;
    }
    const int r = b + step < len ? b + step : len;
    return b + 1 + count_below(a + b + 1, r - b - 1, key, true);
  }
  return pc;  // lower_bound <= pc <= upper_bound
}

// v[j] at a runtime index, from registers (the unrolled compare keeps the
// array out of local memory).
__device__ __forceinline__ int pick(const int (&v)[kMaxRuns], int j) {
  int out = 0;
#pragma unroll
  for (int k = 0; k < kMaxRuns; ++k) {
    if (k == j) out = v[k];
  }
  return out;
}

// Block-wide exclusive prefix sums of the first n_runs of kMaxRuns counters
// per thread at once; total[j] gets counter j's sum over the block.  Every
// thread of the block must call it (n_runs is block-uniform).
__device__ __forceinline__ void block_exclusive_sum_runs(const int (&v)[kMaxRuns], int n_runs,
                                                         int (&excl)[kMaxRuns],
                                                         int (&total)[kMaxRuns], FoldSmem& fs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc[kMaxRuns];
#pragma unroll
  for (int j = 0; j < kMaxRuns; ++j) {
    inc[j] = v[j];
    if (j < n_runs) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, inc[j], o);
        if (lane >= o) inc[j] += y;
      }
      if (lane == 31) fs.c[warp][j] = inc[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kMaxRuns; ++j) {
      if (j < n_runs) {
        const int w = fs.c[lane][j];
        int winc = w;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, winc, o);
          if (lane >= o) winc += y;
        }
        fs.c[lane][j] = winc - w;
        if (lane == 31) fs.tot[j] = winc;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxRuns; ++j) {
    excl[j] = j < n_runs ? fs.c[warp][j] + (inc[j] - v[j]) : 0;
    total[j] = j < n_runs ? fs.tot[j] : 0;
  }
  __syncthreads();  // the workspace is reused by the next call
}

// True when every event of the row crosses stage s exactly when it crosses
// stage s + 1 (a block-wide AND).
__device__ bool same_masks(const int* bits, long long n, int s) {
  int eq = 1;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const int b = bits[i];
    eq &= ((b >> s) ^ (b >> (s + 1))) & 1 ? 0 : 1;
  }
  return __syncthreads_and(eq) != 0;
}

// The run counts of one tile of kItems consecutive events per thread: r[k]
// gets each event's run (kMaxRuns past the row's end), before[j] the run-j
// events at earlier positions of the row, carry[j] advances by the tile.
__device__ __forceinline__ void tile_runs(const unsigned char* rid, long long n, long long i0,
                                          int n_runs, int (&carry)[kMaxRuns], int (&r)[kItems],
                                          int (&before)[kMaxRuns], FoldSmem& fs) {
  int local[kMaxRuns];
#pragma unroll
  for (int j = 0; j < kMaxRuns; ++j) local[j] = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    r[k] = i0 + k < n ? static_cast<int>(rid[i0 + k]) : kMaxRuns;
#pragma unroll
    for (int j = 0; j < kMaxRuns; ++j) local[j] += r[k] == j;
  }
  int tile_tot[kMaxRuns];
  block_exclusive_sum_runs(local, n_runs, before, tile_tot, fs);
#pragma unroll
  for (int j = 0; j < kMaxRuns; ++j) {
    before[j] += carry[j];
    carry[j] += tile_tot[j];
  }
}

// The stable multi-run fold of stage s (ref._qos_rank_fold): run j < C holds
// the stage's events with q_eff == j, run C the untouched events.
__device__ void qos_fold(float* t, int* bits, int* idx, float* ct, int* cb, int* ci,
                         unsigned char* rid, const int* qos, long long n, int s, bool fifo,
                         int n_classes, FoldSmem& fs) {
  const int n_runs = n_classes + 1;
  // pass 0: label every element's run and count the runs
  int cnt[kMaxRuns];
#pragma unroll
  for (int j = 0; j < kMaxRuns; ++j) cnt[j] = 0;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    int r = n_classes;
    if ((bits[i] >> s) & 1) r = fifo ? 0 : clamp_class(qos[idx[i]], n_classes);
    rid[i] = static_cast<unsigned char>(r);
#pragma unroll
    for (int j = 0; j < kMaxRuns; ++j) cnt[j] += r == j;
  }
  int excl[kMaxRuns], total[kMaxRuns];
  block_exclusive_sum_runs(cnt, n_runs, excl, total, fs);
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int j = 0; j < n_runs; ++j) {
      fs.seg[j] = acc;
      acc += total[j];
    }
    fs.seg[n_runs] = acc;
  }
  __syncthreads();

  // pass 1: compact each run into its own segment, in array order
  int carry[kMaxRuns], r[kItems], before[kMaxRuns];
#pragma unroll
  for (int j = 0; j < kMaxRuns; ++j) carry[j] = 0;
  for (long long base = 0; base < n; base += kTile) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
    tile_runs(rid, n, i0, n_runs, carry, r, before, fs);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (r[k] < n_runs) {
        const long long i = i0 + k;
        const int pos = fs.seg[r[k]] + pick(before, r[k]);
        ct[pos] = t[i];
        cb[pos] = bits[i];
        ci[pos] = idx[i];
#pragma unroll
        for (int j = 0; j < kMaxRuns; ++j) before[j] += r[k] == j;
      }
    }
  }
  __syncthreads();

  // pass 2: place every element by its stable merged rank
#pragma unroll
  for (int j = 0; j < kMaxRuns; ++j) carry[j] = 0;
  for (long long base = 0; base < n; base += kTile) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
    tile_runs(rid, n, i0, n_runs, carry, r, before, fs);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int rk = r[k];
      if (rk < n_runs) {
        const int own = pick(before, rk);
        const int src = fs.seg[rk] + own;
        const float x = ct[src];
        const int key = f32_key(x);
        int pos = own;
#pragma unroll
        for (int j = 0; j < kMaxRuns; ++j) {
          if (j < n_runs && j != rk) {
            pos += stable_count(ct + fs.seg[j], fs.seg[j + 1] - fs.seg[j], before[j], key);
          }
        }
        t[pos] = x;
        bits[pos] = cb[src];
        idx[pos] = ci[src];
#pragma unroll
        for (int j = 0; j < kMaxRuns; ++j) before[j] += rk == j;
      }
    }
  }
  __syncthreads();
}

template <bool kHosts>
__global__ void __launch_bounds__(kThreads)
qos_cascade_kernel(const float* __restrict__ t_in, const int* __restrict__ bits_in,
                   const int* __restrict__ qos_in, const int* __restrict__ hosts_in,
                   const float* __restrict__ stts, const float* __restrict__ stt_table,
                   const int* __restrict__ disc, int n_stages, int n_classes, long long n,
                   int n_hosts, float* t_out, int* idx_out, int* bits_work, float* comp_t,
                   int* comp_bits, int* comp_idx, unsigned char* run_id, float* psd) {
  __shared__ Smem sm;
  __shared__ FoldSmem fs;
  extern __shared__ double hsum[];  // [kWarps][n_hosts * n_classes] per-warp delay sums
  const int n_slots = n_hosts * n_classes;
  const long long off = static_cast<long long>(blockIdx.x) * n;
  const float* t0 = t_in + off;
  const int* b0 = bits_in + off;
  const int* q0 = qos_in + off;
  float* t = t_out + off;  // working row: current times
  int* idx = idx_out + off;
  int* bits = bits_work + off;
  float* row_psd = psd + static_cast<long long>(blockIdx.x) * n_stages * n_slots;

  for (long long i = threadIdx.x; i < n; i += kThreads) {
    t[i] = t0[i];
    bits[i] = b0[i];
    idx[i] = static_cast<int>(i);
  }
  for (int j = threadIdx.x; j < kWarps * n_slots; j += kThreads) hsum[j] = 0.0;
  __syncthreads();

  double dirty = 0.0;  // the row's cumulative delay: 0 => nothing moved
  for (int s = 0; s < n_stages; ++s) {
    const int disc_s = disc[s];
    const bool fifo = disc_s == kDiscFifo;
    const bool prio = disc_s == kDiscPriority;
    if (stts[s] > 0.0f) {
      const int n_scans = fifo ? 1 : n_classes;
      const float* stt_c = stt_table + static_cast<long long>(s) * n_classes;
      int carry_c[kMaxClasses];
      float carry_f[kMaxClasses];
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        carry_c[c] = 0;
        carry_f[c] = -INFINITY;
      }
      double dsum = 0.0;
      double* my_sums = hsum + (threadIdx.x >> 5) * n_slots;
      for (long long base = 0; base < n; base += kTile) {
        const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
        float tv[kItems], st[kItems];
        bool m[kItems];
        int qe[kItems];
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const long long i = i0 + k;
          const bool ok = i < n;
          tv[k] = ok ? t[i] : 0.0f;
          m[k] = ok && ((bits[i] >> s) & 1);
          qe[k] = m[k] && !fifo ? clamp_class(q0[idx[i]], n_classes) : 0;
          st[k] = tv[k];
        }
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c) {
          if (c < n_scans) {
            bool mc[kItems];
            float sc[kItems];
#pragma unroll
            for (int k = 0; k < kItems; ++k) mc[k] = m[k] && (prio ? qe[k] <= c : qe[k] == c);
            scan_tile(tv, mc, stt_c[c], carry_c[c], carry_f[c], sc, sm);
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
              if (m[k] && qe[k] == c) st[k] = sc[k];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (m[k]) {
            const long long i = i0 + k;
            t[i] = st[k];
            const float d = __fsub_rn(st[k], tv[k]);
            dsum += static_cast<double>(d);
            const int slot = idx[i];
            const int q = clamp_class(q0[slot], n_classes);
            unsigned h = 0;
            if constexpr (kHosts) h = static_cast<unsigned>(hosts_in[off + slot]);
            if (h < static_cast<unsigned>(n_hosts)) {
              atomicAdd(&my_sums[h * n_classes + q], static_cast<double>(d));
            }
          }
        }
      }
      dirty += block_sum(dsum, sm);  // also orders the per-warp adds before the fold below
      // thread j owns slot j: fold the warps' rows in order and reset them;
      // the next stage's first block scan orders the reset before new adds
      for (int j = threadIdx.x; j < n_slots; j += kThreads) {
        double acc = 0.0;
        for (int w = 0; w < kWarps; ++w) {
          acc += hsum[w * n_slots + j];
          hsum[w * n_slots + j] = 0.0;
        }
        row_psd[s * n_slots + j] = static_cast<float>(acc);
      }
    } else {
      for (int j = threadIdx.x; j < n_slots; j += kThreads) row_psd[s * n_slots + j] = 0.0f;
    }
    if (s == n_stages - 1 || !(dirty > 0.0)) continue;
    // elision: the last stage serving in zero time never needs its input
    // sorted; a WFQ stage over the same events reads only each class's own
    // subsequence, which this stage left sorted
    bool skip = s + 1 == n_stages - 1 && !(stts[s + 1] > 0.0f);
    if (!skip && disc[s + 1] == kDiscWfq) skip = same_masks(bits, n, s);
    if (!skip) {
      qos_fold(t, bits, idx, comp_t + off, comp_bits + off, comp_idx + off, run_id + off,
               q0, n, s, fifo, n_classes, fs);
    }
  }
}

template <bool kHosts>
int launch(const void* t, const void* bits, const void* qos, const void* hosts,
           const void* stts, const void* stt_table, const void* disc, void* t_out,
           void* idx_out, void* bits_work, void* comp_t, void* comp_bits, void* comp_idx,
           void* run_id, void* psd, long long n_rows, long long n, int n_stages,
           int n_classes, int n_hosts, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (n_classes < 1 || n_classes > kMaxClasses || n_hosts < 1 || n_hosts > kMaxHosts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(double)) * kWarps * n_hosts * n_classes;
  if (smem > 48 * 1024) {  // above the default dynamic limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        qos_cascade_kernel<kHosts>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  qos_cascade_kernel<kHosts><<<static_cast<unsigned>(n_rows), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const int*>(bits),
      static_cast<const int*>(qos), static_cast<const int*>(hosts),
      static_cast<const float*>(stts), static_cast<const float*>(stt_table),
      static_cast<const int*>(disc), n_stages, n_classes, n, n_hosts,
      static_cast<float*>(t_out), static_cast<int*>(idx_out), static_cast<int*>(bits_work),
      static_cast<float*>(comp_t), static_cast<int*>(comp_bits), static_cast<int*>(comp_idx),
      static_cast<unsigned char*>(run_id), static_cast<float*>(psd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qos_cascade_launch(
    const void* t, const void* bits, const void* qos, const void* stts, const void* stt_table,
    const void* disc, void* t_out, void* idx_out, void* bits_work, void* comp_t,
    void* comp_bits, void* comp_idx, void* run_id, void* psd, long long n_rows, long long n,
    int n_stages, int n_classes, void* stream) {
  return launch<false>(t, bits, qos, nullptr, stts, stt_table, disc, t_out, idx_out,
                       bits_work, comp_t, comp_bits, comp_idx, run_id, psd, n_rows, n,
                       n_stages, n_classes, 1, stream);
}

extern "C" int qos_cascade_hosts_launch(
    const void* t, const void* bits, const void* qos, const void* hosts, const void* stts,
    const void* stt_table, const void* disc, void* t_out, void* idx_out, void* bits_work,
    void* comp_t, void* comp_bits, void* comp_idx, void* run_id, void* psd, long long n_rows,
    long long n, int n_stages, int n_classes, int n_hosts, void* stream) {
  return launch<true>(t, bits, qos, hosts, stts, stt_table, disc, t_out, idx_out, bits_work,
                      comp_t, comp_bits, comp_idx, run_id, psd, n_rows, n, n_stages,
                      n_classes, n_hosts, stream);
}

extern "C" const char* qos_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
