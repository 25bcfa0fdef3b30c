// One switch's masked FIFO serial-queue scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/congestion.py:congestion_scan
// (_kernel).  Semantics are those of the plain version,
// repro_torch/kernels/ref.py:congestion_scan: for every row of a [B, N]
// batch of time-sorted events and the events whose mask is set,
//
//   rank = cumsum(mask) - 1 (int32), f = cummax(t - stt*rank),
//   start = f + stt*rank,  delay = start - t;
//
// unmasked events pass through (start = t, delay = 0).  The TPU kernel keeps
// an f32 rank; this one keeps an int32 count, as the plain version does:
// the two agree below 2^24 masked events per row.
//
// What bounds it: memory.  The least traffic is reading t (4 B) and the mask
// (1 B) and writing start and delay (8 B): 13 B per event, about 16 us for a
// [32, 65536] batch at 3.35 TB/s.  The arithmetic is a handful of f32 ops per
// masked event.
//
// What this design does about it: nothing yet; it is the simple, right first
// version.  One CTA per row walks the row in 4096-event tiles (the loop takes
// the place of the TPU's sequential grid), with the masked-event count and
// the running max carried between tiles in registers; each tile costs two
// block-wide scans (block_scan.cuh).  One CTA per row fills only B of the 132
// SMs.
//
// Numerics: as the cascade's scan: every f32 product and sum rounded by
// itself (__fmul_rn, __fsub_rn, __fadd_rn), the int32 rank converted once.

#include "block_scan.cuh"

namespace {

using namespace congestion;

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ t_in, const unsigned char* __restrict__ mask_in,
            float stt, long long n, float* __restrict__ start_out,
            float* __restrict__ delay_out) {
  __shared__ Smem sm;
  const long long off = static_cast<long long>(blockIdx.x) * n;
  const float* t = t_in + off;
  const unsigned char* mask = mask_in + off;
  float* out = start_out + off;
  float* delay = delay_out + off;
  long long carry_c = 0;
  float carry_f = -INFINITY;
  for (long long base = 0; base < n; base += kTile) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * kItems;
    float tv[kItems], start[kItems];
    bool m[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = i0 + k;
      const bool ok = i < n;
      tv[k] = ok ? t[i] : 0.0f;
      m[k] = ok && mask[i] != 0;
    }
    scan_tile(tv, m, stt, carry_c, carry_f, start, sm);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = i0 + k;
      if (i < n) {
        out[i] = start[k];
        delay[i] = m[k] ? __fsub_rn(start[k], tv[k]) : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" int congestion_scan_launch(const void* t, const void* mask, float stt,
                                      void* start, void* delay, long long n_rows,
                                      long long n, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  scan_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const unsigned char*>(mask), stt, n,
      static_cast<float*>(start), static_cast<float*>(delay));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* congestion_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
