// Block-wide scans shared by the congestion kernels (congestion_cascade.cu,
// congestion_scan.cu): one block of kThreads threads walks an epoch row in
// tiles of kTile events, kItems consecutive events per thread, and carries
// the running count and max between tiles in registers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace congestion {

constexpr int kThreads = 1024;
constexpr int kItems = 4;  // consecutive events per thread and tile
constexpr long long kTile = static_cast<long long>(kThreads) * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == 32, "the second scan level is one warp wide");

struct Smem {
  int c[kWarps];
  float g[kWarps];
  double d[kWarps];
  int tot_c;
  float tot_g;
};

// Block-wide exclusive prefix sum of one int per thread; *total gets the sum
// over the block.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sm.c[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = sm.c[lane];
    int winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, winc, o);
      if (lane >= o) winc += y;
    }
    sm.c[lane] = winc - w;
    if (lane == 31) sm.tot_c = winc;
  }
  __syncthreads();
  const int excl = sm.c[warp] + (inc - v);
  *total = sm.tot_c;
  __syncthreads();  // the workspace is reused by the next call
  return excl;
}

// Block-wide exclusive prefix max of one float per thread (-inf for thread
// 0); *total gets the max over the block.
__device__ __forceinline__ float block_exclusive_max(float v, float* total, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = fmaxf(inc, y);
  }
  float wexcl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) wexcl = -INFINITY;
  if (lane == 31) sm.g[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const float w = sm.g[lane];
    float winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, winc, o);
      if (lane >= o) winc = fmaxf(winc, y);
    }
    float wex = __shfl_up_sync(kFull, winc, 1);
    if (lane == 0) wex = -INFINITY;
    sm.g[lane] = wex;
    if (lane == 31) sm.tot_g = winc;
  }
  __syncthreads();
  const float excl = fmaxf(sm.g[warp], wexcl);
  *total = sm.tot_g;
  __syncthreads();
  return excl;
}

// Block-wide sum of one double per thread, returned to every thread.
__device__ __forceinline__ double block_sum(double v, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) sm.d[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = sm.d[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(kFull, w, o);
    if (lane == 0) sm.d[0] = w;
  }
  __syncthreads();
  const double total = sm.d[0];
  __syncthreads();
  return total;
}

// One tile of the masked FIFO scan, shared by the cascade's stages and the
// single-switch kernel.  On entry m[k] and tv[k] hold the thread's kItems
// events (mask, current time); carry_c / carry_f are the masked-event count
// and the running max of t - stt*rank over earlier tiles.  On return m[k]
// events have start[k] = max(carry, cummax(t - stt*rank)) + stt*rank, every
// product and sum rounded by itself (no fused multiply-add), and the carries
// include this tile.  Every thread of the block must call it.
__device__ __forceinline__ void scan_tile(const float (&tv)[kItems], const bool (&m)[kItems],
                                          float stt, long long& carry_c, float& carry_f,
                                          float (&start)[kItems], Smem& sm) {
  float p[kItems], lm[kItems];
  int rl[kItems];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    rl[k] = cnt;
    cnt += m[k];
  }
  int tile_c;
  const int excl_c = block_exclusive_sum(cnt, &tile_c, sm);
  float run = -INFINITY;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long rank = carry_c + excl_c + rl[k];
    p[k] = __fmul_rn(stt, __ll2float_rn(rank));
    const float g = m[k] ? __fsub_rn(tv[k], p[k]) : -INFINITY;
    run = fmaxf(run, g);
    lm[k] = run;
  }
  float tile_g;
  const float excl_g = block_exclusive_max(run, &tile_g, sm);
  const float pre = fmaxf(carry_f, excl_g);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    start[k] = m[k] ? __fadd_rn(fmaxf(pre, lm[k]), p[k]) : tv[k];
  }
  carry_c += tile_c;
  carry_f = fmaxf(carry_f, tile_g);
}

}  // namespace congestion
