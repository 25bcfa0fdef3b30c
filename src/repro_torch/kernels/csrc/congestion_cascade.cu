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
// at sorted position slot_idx[row, k] of the input row.
//
// What bounds it: memory.  The least traffic is reading t and the route bits
// (and the host ids) and writing t_final and slot_idx once: 16 B per event,
// 20 B with hosts, about 20 us for a [32, 131072] batch at 3.35 TB/s.  The
// arithmetic (a handful of f32 ops per event and stage) is far below the
// f32 peak.
//
// What this design does about it: nothing yet; it is the simple, right first
// version.  One CTA per epoch row walks the row in tiles (a loop inside the
// block takes the place of the TPU's sequential grid).  The row's times,
// route bits and slot indices stay in global memory (L2): a 131072-event row
// is 1.5 MB, far over the 227 KB of shared memory a block can use.  Each
// stage costs two block-wide scans per tile (an int32 count, then an f32 max)
// with the carries in registers, and each merge costs a compaction pass plus
// a binary search per event, O(N log N) reads from L2.  One CTA per row fills
// only B of the 132 SMs.  The host ids are not permuted through the merges:
// the slot index already carried gives each queued event's host with one
// gather.  Per-host sums go into a per-warp row of shared-memory doubles by
// atomicAdd (contention only between the lanes of one warp), and the block
// folds the 32 rows in a fixed order at the end of the stage.  Making it fast
// (a thread-block cluster with distributed shared memory, decoupled
// look-back, merge-path partitioning) is later work.
//
// Numerics: the f32 products and sums are rounded one by one (__fmul_rn,
// __fsub_rn, __fadd_rn) so no fused multiply-add changes a rounding against
// the plain version; the rank is an int32 count, converted once; per-stage
// delay sums accumulate in double and are rounded to f32 at the end.  The
// order of the per-host atomic adds varies from run to run, so per-host sums
// vary in their last double bits; the merge guard uses the per-stage total,
// which does not.

#include "block_scan.cuh"

namespace {

using namespace congestion;

constexpr int kMaxHosts = 32;  // per-host delay slots (the route word allows 31 stages)

// Number of elements of the sorted run a[0:len) that are < x.
__device__ __forceinline__ long long lower_bound(const float* a, long long len, float x) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Number of elements of the sorted run a[0:len) that are <= x.
__device__ __forceinline__ long long upper_bound(const float* a, long long len, float x) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge the row's two sorted runs: the events with route bit `bit` (n_a of
// them) and the rest.  Pass 1 compacts run a into comp[0:n_a) and run b into
// comp[n_a:n); pass 2 places every element at its rank in its own run plus
// its count in the other run (lower bound for a in b, upper bound for b in a:
// ties put run a first) and scatters it back into the working row.
__device__ void merge_runs(float* t, int* bits, int* idx, float* ct, int* cb, int* ci,
                           long long n, int bit, long long n_a, Smem& sm) {
  long long carry = 0;
  for (long long base = 0; base < n; base += kTile) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = i0 + k;
      if (i < n) cnt += (bits[i] >> bit) & 1;
    }
    int tile_a;
    const int excl = block_exclusive_sum(cnt, &tile_a, sm);
    long long ra = carry + excl;  // run-a events before i
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = i0 + k;
      if (i < n) {
        const int b = bits[i];
        const bool in_a = (b >> bit) & 1;
        const long long pos = in_a ? ra : n_a + (i - ra);
        ct[pos] = t[i];
        cb[pos] = b;
        ci[pos] = idx[i];
        ra += in_a;
      }
    }
    carry += tile_a;
  }
  __syncthreads();
  for (long long j = threadIdx.x; j < n; j += kThreads) {
    const float x = ct[j];
    const long long pos = j < n_a ? j + lower_bound(ct + n_a, n - n_a, x)
                                  : (j - n_a) + upper_bound(ct, n_a, x);
    t[pos] = x;
    bits[pos] = cb[j];
    idx[pos] = ci[j];
  }
  __syncthreads();
}

template <bool kHosts>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const float* __restrict__ t_in, const int* __restrict__ bits_in,
               const int* __restrict__ hosts_in, const float* __restrict__ stts,
               int n_stages, long long n, int n_hosts,
               float* t_out, int* idx_out, int* bits_work,
               float* comp_t, int* comp_bits, int* comp_idx, float* psd) {
  __shared__ Smem sm;
  // per-warp per-host delay sums of the current stage (hosts variant only)
  __shared__ double hsum[kHosts ? kWarps : 1][kHosts ? kMaxHosts : 1];
  const long long off = static_cast<long long>(blockIdx.x) * n;
  const float* t0 = t_in + off;
  const int* b0 = bits_in + off;
  float* t = t_out + off;  // working row: current times, kept sorted
  int* idx = idx_out + off;
  int* bits = bits_work + off;
  float* ct = comp_t + off;
  int* cb = comp_bits + off;
  int* ci = comp_idx + off;

  for (long long i = threadIdx.x; i < n; i += kThreads) {
    t[i] = t0[i];
    bits[i] = b0[i];
    idx[i] = static_cast<int>(i);
  }
  if constexpr (kHosts) {
    for (int j = threadIdx.x; j < kWarps * kMaxHosts; j += kThreads) {
      hsum[j / kMaxHosts][j % kMaxHosts] = 0.0;
    }
  }
  __syncthreads();

  double dirty = 0.0;  // the row's cumulative delay: 0 => nothing moved
  long long prev_count = 0;  // events of the previous stage
  for (int s = 0; s < n_stages; ++s) {
    if (s > 0 && dirty > 0.0) {
      merge_runs(t, bits, idx, ct, cb, ci, n, s - 1, prev_count, sm);
    }
    const float stt = stts[s];
    long long carry_c = 0;
    float carry_f = -INFINITY;
    double dsum = 0.0;
    for (long long base = 0; base < n; base += kTile) {
      const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
      float tv[kItems], start[kItems];
      bool m[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const long long i = i0 + k;
        const bool ok = i < n;
        tv[k] = ok ? t[i] : 0.0f;
        m[k] = ok && ((bits[i] >> s) & 1);
      }
      scan_tile(tv, m, stt, carry_c, carry_f, start, sm);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (m[k]) {
          t[i0 + k] = start[k];
          const float d = __fsub_rn(start[k], tv[k]);
          dsum += static_cast<double>(d);
          if constexpr (kHosts) {
            const unsigned h = static_cast<unsigned>(hosts_in[off + idx[i0 + k]]);
            if (h < static_cast<unsigned>(n_hosts)) {
              atomicAdd(&hsum[threadIdx.x >> 5][h], static_cast<double>(d));
            }
          }
        }
      }
    }
    const double stage_delay = block_sum(dsum, sm);  // also orders the writes
    if constexpr (kHosts) {
      // thread h owns column h: fold the warps' rows in order and reset it;
      // the next stage's first block scan orders the reset before new adds
      if (threadIdx.x < n_hosts) {
        double acc = 0.0;
        for (int w = 0; w < kWarps; ++w) {
          acc += hsum[w][threadIdx.x];
          hsum[w][threadIdx.x] = 0.0;
        }
        psd[(static_cast<long long>(blockIdx.x) * n_stages + s) * n_hosts + threadIdx.x] =
            static_cast<float>(acc);
      }
    } else {
      if (threadIdx.x == 0) psd[static_cast<long long>(blockIdx.x) * n_stages + s] = static_cast<float>(stage_delay);
    }
    dirty += stage_delay;
    prev_count = carry_c;
  }
}

}  // namespace

extern "C" int congestion_cascade_launch(
    const void* t, const void* bits, const void* stts, void* t_out, void* idx_out,
    void* bits_work, void* comp_t, void* comp_bits, void* comp_idx, void* psd,
    long long n_rows, long long n, int n_stages, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cascade_kernel<false><<<static_cast<unsigned>(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const int*>(bits), nullptr,
      static_cast<const float*>(stts), n_stages, n, 1, static_cast<float*>(t_out),
      static_cast<int*>(idx_out), static_cast<int*>(bits_work), static_cast<float*>(comp_t),
      static_cast<int*>(comp_bits), static_cast<int*>(comp_idx), static_cast<float*>(psd));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int congestion_cascade_hosts_launch(
    const void* t, const void* bits, const void* hosts, const void* stts, void* t_out,
    void* idx_out, void* bits_work, void* comp_t, void* comp_bits, void* comp_idx, void* psd,
    long long n_rows, long long n, int n_stages, int n_hosts, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (n_hosts < 1 || n_hosts > kMaxHosts) return static_cast<int>(cudaErrorInvalidValue);
  cascade_kernel<true><<<static_cast<unsigned>(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const int*>(bits), static_cast<const int*>(hosts),
      static_cast<const float*>(stts), n_stages, n, n_hosts, static_cast<float*>(t_out),
      static_cast<int*>(idx_out), static_cast<int*>(bits_work), static_cast<float*>(comp_t),
      static_cast<int*>(comp_bits), static_cast<int*>(comp_idx), static_cast<float*>(psd));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* congestion_cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
