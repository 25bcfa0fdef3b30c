// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan (_kernel).
// Semantics are those of the plain version,
// repro_torch/kernels/ref.py:ssd_chunked: for every batch row b and head h
// of x[B, L, H, P] (f32 or bf16), dt[B, L, H], A[H] (negative), and one
// B/C group shared by all heads, Bm, Cm[B, L, N] (all f32), the recurrence
//
//   h_t = exp(A·dt_t)·h_{t-1} + dt_t·B_t ⊗ x_t  (h in [N, P], f32),  y_t = C_t·h_t
//
// computed chunk by chunk (chunk c, L % c == 0): with acum the inclusive
// cumsum of A·dt within the chunk and G = C·Bᵀ the chunk's [c, c] Gram
// matrix,
//
//   y_t = sum_{s<=t} G[t, s]·exp(acum_t - acum_s)·dt_s·x_s + (exp(acum_t)·C_t)·h
//   h   = exp(acum_last)·h + sum_s (dt_s·exp(acum_last - acum_s)·B_s) ⊗ x_s
//
// y is written in x's dtype, everything else is f32.
//
// What bounds it: operations.  G is the same for every head (B and C are
// one group), so it is c(c+1)·N FLOPs per (b, chunk); per (b, h, chunk)
// there remain c(c+1)·P (W·x on and below the diagonal), 2cNP (C·h) and
// 2cNP (the state update).  At mamba2-2.7b's prefill shape (B = 8, L =
// 4096, H = 80, P = 64, N = 128, c = 128) that is 108 GFLOP a call: 1.6 ms
// at the f32 rate outside the tensor cores (67 TFLOP/s), 0.66 ms as 3xTF32
// on the tensor cores (three TF32 products at 495 TFLOP/s), against 0.72
// GB of x (bf16), y, dt, B and C moved once (0.21 ms at 3.35 TB/s).  The
// bound is the 3xTF32 time: that route meets the f32 bar, as this kernel
// shows, so the card can do the work at that rate.
//
// What this design does about it:
// - Two kernels.  ssd_gram_kernel computes G once per (b, chunk) into
//   scratch the wrapper allocates ([B, L/c, c, c] f32, 16.8 MB at the
//   prefill shape, which stays in the 50 MB L2 while the heads of a batch
//   row read it); ssd_scan_kernel runs the heads.
// - Every product runs on the tensor cores as mma.sync m16n8k8 TF32 in
//   3xTF32: an f32 operand a is split into a_hi = tf32(a) and a_lo =
//   tf32(a - a_hi), and a·b is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, f32
//   accumulation, the lo·lo term dropped (about 2^-22 of a·b).  One TF32
//   pass (10 mantissa bits) puts an error of 2^-11 of each product into
//   y, 18-35x the f32 bar of 2e-5 of max|y| on the reference's cases
//   (tests/test_torch_ssd.py emulates both).  A bf16 x is exact in TF32,
//   so the two products with x as operand (W·x and the state update) need
//   only a_lo·x + a_hi·x there.
// - One CTA of 8 warps per (b, h) loops over the chunks in order, with
//   the state h[N, P] in shared memory (the loop takes the place of the
//   TPU's sequential grid axis and its VMEM scratch), so the state never
//   goes to device memory.  The chunk-parallel alternative (chunk states,
//   an inter-chunk scan, then the outputs) would fill the card with
//   B·H·L/c CTAs, but moves 671 MB of f32 chunk states per pass at the
//   prefill shape; 640 CTAs at two per SM already fill 132 SMs.
// - x (in its own dtype) and dt of the next chunk are copied with
//   cp.async into a second buffer while the CTA works on this one.  Per
//   chunk one warp scans acum; then each warp owns 16 rows t of y: it
//   accumulates (exp(acum_t)·C)·h over N and W·x over s <= t, skipping
//   the k-steps above its last row.  The A operands are read from L2 into
//   registers one k-step ahead (deeper prefetch measured slower): C, and W
//   built from G as G·2^((acum_t - acum_s)·log2 e)·dt_s, the exponential
//   evaluated only on and below the diagonal, where acum_t - acum_s <= 0
//   (above it the exponent is positive and could overflow, and 0·inf is
//   NaN).  x and h are the B operands in shared memory, rows padded to 8
//   mod 32 words so fragment loads hit 32 banks.  The W·x steps rise from
//   2 to 16 across the m-tiles of a 128-row chunk, and every warp waits
//   for the slowest at the barrier that follows; so at c = 128 with bf16
//   x, warp w < 4 also runs the last steps of m-tile 7 - w and hands that
//   partial sum over in shared memory, and each pair of warps does the
//   same work.  After the barrier each warp updates 16 rows n of h:
//   exp(acum_last)·h + (B·f)ᵀ·x with f_s = dt_s·exp(acum_last - acum_s).
// - Small shapes (chunk 32/64, N = 8/16, P = 8/16 of the reference's
//   tests) pad the tiles: out-of-range A elements are 0, x and h carry
//   zero rows and columns up to the tile edges, and only in-range y is
//   written; rows of x whose bytes are not a multiple of 16 are loaded
//   element by element instead of by cp.async.  At c = N = 128, P = 64 a
//   CTA holds 90 KB of shared memory with bf16 x (110 KB with f32 x, which
//   leaves no room for the handover): two CTAs (16 warps) per SM, capped
//   at 128 registers a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// y[p], y[p + 1] (the second only when p + 1 < P)
__device__ __forceinline__ void store_pair(float* y, int p, int P, float a, float b) {
  if (p + 1 < P && (P & 1) == 0) {
    *reinterpret_cast<float2*>(y) = make_float2(a, b);
  } else {
    if (p < P) y[0] = a;
    if (p + 1 < P) y[1] = b;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* y, int p, int P, float a, float b) {
  if (p + 1 < P && (P & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
  } else {
    if (p < P) y[0] = __float2bfloat16_rn(a);
    if (p + 1 < P) y[1] = __float2bfloat16_rn(b);
  }
}

// ---- 3xTF32 products on mma.sync m16n8k8 ---------------------------------- //
// Fragments (g = lane / 4, q = lane % 4): A (16 x 8, row) a0 (g, q), a1
// (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); B (8 x 8, col) b0 (q, g),
// b1 (q + 4, g); C (16 x 8) c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q),
// c3 (g + 8, 2q + 1).

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

struct Split {  // an f32 operand as hi + lo, both TF32
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4], float b0, float b1) {
  const Split x = split(b0), y = split(b1);
  mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, x.hi, y.hi);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, x.lo, y.lo);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, x.hi, y.hi);
}

// c += a·x for x in x's dtype: f32 x in 3xTF32; a bf16 x is exact in TF32
// (8 mantissa bits), so x_lo = 0 and a_lo·x + a_hi·x is the whole product
__device__ __forceinline__ void mma_x(float (&c)[4], const Split (&a)[4], float b0, float b1) {
  mma3(c, a, b0, b1);
}
__device__ __forceinline__ void mma_x(float (&c)[4], const Split (&a)[4], __nv_bfloat16 b0,
                                      __nv_bfloat16 b1) {
  const uint32_t x0 = __float_as_uint(__bfloat162float(b0));
  const uint32_t x1 = __float_as_uint(__bfloat162float(b1));
  mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, x0, x1);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, x0, x1);
}

__device__ __forceinline__ void split4(Split (&s)[4], const float (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = split(a[i]);
}

// for ks in [0, n): step(ks, a), where a holds the A-operand elements
// load(ks, a) read one k-step earlier, so their L2 latency hides behind the
// products in between (reading further ahead measured slower)
template <typename Load, typename Step>
__device__ __forceinline__ void read_ahead(int n, Load load, Step step) {
  float nxt[4];
  if (n > 0) load(0, nxt);
  for (int ks = 0; ks < n; ++ks) {
    const float cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
    if (ks + 1 < n) load(ks + 1, nxt);
    step(ks, cur);
  }
}

// the rows t of an m-tile that a thread's fragments hold: ta = 16·mt + g, tb = ta + 8
struct Rows {
  int ta, tb;
  bool va, vb;  // rows inside the chunk
  float aca, acb, ea, eb;  // acum of each row and its exp
};

// ---- shared-memory layout -------------------------------------------------- //

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// n-tiles (8 columns each) of a column block of y or h: 8 at P > 32
__host__ __device__ inline int col_tiles(int P) { return P > 32 ? 8 : P > 16 ? 4 : P > 8 ? 2 : 1; }
// row stride of x and h in floats: the column blocks' reach, padded to 8 mod 32
__host__ __device__ inline int row_stride(int P) { return round_up(P, 8 * col_tiles(P)) + 8; }

// h, acum, f and two dt buffers (f32), then two x buffers in x's dtype, then
// with bf16 x the warp pairs' partial sums, [kWarps / 2][n-tiles][4][32] f32
__host__ __device__ inline long long smem_bytes(int P, int N, int chunk, int x_bytes) {
  const long long c16 = round_up(chunk, 16);
  return 4LL * (round_up(N, 16) * static_cast<long long>(row_stride(P)) + 4 * c16) +
         2LL * x_bytes * c16 * row_stride(P) +
         (x_bytes == 2 ? 4LL * (kWarps / 2) * col_tiles(P) * 4 * 32 : 0);
}

// ---- kernel 1: G = C·Bᵀ per (b, chunk), on and below the diagonal --------- //

__global__ void __launch_bounds__(kThreads)
ssd_gram_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ G, int N, int chunk) {
  constexpr int NT = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const long long l0 = static_cast<long long>(blockIdx.x) * chunk;  // the chunk's first row
  const float* Cc = Cm + l0 * N;
  const float* Bc = Bm + l0 * N;
  float* Gc = G + static_cast<long long>(blockIdx.x) * chunk * chunk;
  for (int mt = warp; mt * 16 < chunk; mt += kWarps) {
    const int ta = mt * 16 + g, tb = ta + 8;
    const int s_end = min(chunk, mt * 16 + 16);  // columns s <= the tile's last row
    for (int s0 = 0; s0 < s_end; s0 += 8 * NT) {
      float acc[NT][4] = {};
      for (int n0 = 0; n0 < N; n0 += 8) {
        const int na = n0 + q, nb = na + 4;
        float a[4];
        a[0] = ta < chunk && na < N ? Cc[ta * N + na] : 0.f;
        a[1] = tb < chunk && na < N ? Cc[tb * N + na] : 0.f;
        a[2] = ta < chunk && nb < N ? Cc[ta * N + nb] : 0.f;
        a[3] = tb < chunk && nb < N ? Cc[tb * N + nb] : 0.f;
        Split as[4];
        split4(as, a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int s = s0 + 8 * j + g;  // B operand (k = n, col = s): Bᵀ[n][s] = B[s][n]
          if (s0 + 8 * j >= s_end) break;
          const float b0 = s < chunk && na < N ? Bc[s * N + na] : 0.f;
          const float b1 = s < chunk && nb < N ? Bc[s * N + nb] : 0.f;
          mma3(acc[j], as, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int s = s0 + 8 * j + 2 * q;
        if (s0 + 8 * j >= s_end) break;
        if (ta < chunk) {
          if (s < chunk) Gc[ta * chunk + s] = acc[j][0];
          if (s + 1 < chunk) Gc[ta * chunk + s + 1] = acc[j][1];
        }
        if (tb < chunk) {
          if (s < chunk) Gc[tb * chunk + s] = acc[j][2];
          if (s + 1 < chunk) Gc[tb * chunk + s + 1] = acc[j][3];
        }
      }
    }
  }
}

// ---- kernel 2: the heads, chunk by chunk ----------------------------------- //

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ G, T* __restrict__ y,
                int L, int H, int P, int N, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(P);
  const int n16 = round_up(N, 16), c16 = round_up(chunk, 16);
  float* hs = smem;  // [n16][ld] the carried state
  float* acum = hs + n16 * ld;  // [c16]
  float* fs = acum + c16;  // [c16] dt_s·exp(acum_last - acum_s)
  float* dtb = fs + c16;  // [2][c16] dt of this chunk and the next
  T* xb = reinterpret_cast<T*>(dtb + 2 * c16);  // [2][c16][ld] x of this chunk and the next
  // bf16 x leaves room for [kWarps / 2][NT][4][32] partial sums handed from warp to warp
  float* scratch = reinterpret_cast<float*>(xb + 2 * c16 * ld);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int h = static_cast<int>(blockIdx.x % H);
  const long long b = blockIdx.x / H;
  const int n_chunks = L / chunk;
  constexpr int CW = 8 * NT;  // columns of a block
  // the causal W·x steps of the m-tiles rise from 1 to 16 at c = 128: with
  // one m-tile per warp and one column block, warp pairs share the work
  const bool balanced = sizeof(T) == 2 && (chunk + 15) / 16 == kWarps && P <= CW;

  // h = 0; the padding rows and columns of both x buffers stay 0 for the whole run
  for (int e = tid; e < n16 * ld; e += kThreads) hs[e] = 0.f;
  for (int e = tid; e < 2 * c16 * ld; e += kThreads) xb[e] = T(0.f);
  const float a_h = A[h];
  const long long pos_stride = static_cast<long long>(H) * P;  // x / y, one position
  const long long head_off = static_cast<long long>(h) * P;
  // x rows as 16-byte pieces copied by cp.async when they are aligned, else element loads
  const bool vec = (P * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int row_pieces = static_cast<int>(P * sizeof(T) / 16);
  auto prefetch = [&](int ci) {  // chunk ci's dt and x into buffer ci % 2
    const long long l0 = b * L + static_cast<long long>(ci) * chunk;
    float* dts = dtb + (ci & 1) * c16;
    T* xs = xb + (ci & 1) * c16 * ld;
    for (int s = tid; s < chunk; s += kThreads) cp_async4(dts + s, dt + (l0 + s) * H + h);
    if (vec) {
      for (int e = tid; e < chunk * row_pieces; e += kThreads) {
        const int s = e / row_pieces, k = e - s * row_pieces;
        cp_async16(reinterpret_cast<char*>(xs + s * ld) + 16 * k,
                   reinterpret_cast<const char*>(x + (l0 + s) * pos_stride + head_off) + 16 * k);
      }
    } else {
      for (int e = tid; e < chunk * P; e += kThreads) {
        const int s = e / P, p = e - s * P;
        xs[s * ld + p] = x[(l0 + s) * pos_stride + head_off + p];
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // the zeros are written before the first copies land
  prefetch(0);

  for (int ci = 0; ci < n_chunks; ++ci) {
    const long long l0 = b * L + static_cast<long long>(ci) * chunk;  // the chunk's first row
    const float* dts = dtb + (ci & 1) * c16;
    const T* xs = xb + (ci & 1) * c16 * ld;
    cp_async_wait_all();
    __syncthreads();  // chunk ci's x and dt have landed; chunk ci - 1 is done with everything
    if (ci + 1 < n_chunks) prefetch(ci + 1);  // into the buffers chunk ci - 1 used
    if (warp == 0) {  // acum = inclusive cumsum of A·dt over the chunk, then f
      const int per = (chunk + 31) / 32;
      const int s0 = lane * per;
      const int s1 = min(s0 + per, chunk);
      float run = 0.0f;
      for (int s = s0; s < s1; ++s) {
        run += a_h * dts[s];
        acum[s] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      for (int s = s0; s < s1; ++s) acum[s] += excl;
      __syncwarp();
      const float last = acum[chunk - 1];
      for (int s = lane; s < chunk; s += 32) fs[s] = dts[s] * expf(last - acum[s]);
    }
    __syncthreads();
    const float* Cc = Cm + l0 * N;
    const float* Bc = Bm + l0 * N;
    const float* Gc = G + (b * n_chunks + ci) * static_cast<long long>(chunk) * chunk;

    // ---- y_t = (exp(acum_t)·C_t)·h + sum_{s<=t} W[t, s]·x_s, 16 rows t an m-tile
    auto rows_of = [&](int mt) {
      Rows r;
      r.ta = mt * 16 + g;
      r.tb = r.ta + 8;
      r.va = r.ta < chunk;
      r.vb = r.tb < chunk;
      r.aca = r.va ? acum[r.ta] : 0.f;
      r.acb = r.vb ? acum[r.tb] : 0.f;
      r.ea = r.va ? expf(r.aca) : 0.f;
      r.eb = r.vb ? expf(r.acb) : 0.f;
      return r;
    };
    // acc += (exp(acum_t)·C)·h over n
    auto c_h = [&](float (&acc)[NT][4], const Rows& r, int p0) {
      read_ahead((N + 7) / 8, [&](int ks, float (&a)[4]) {
        const int na = ks * 8 + q, nb = na + 4;
        a[0] = r.va && na < N ? Cc[r.ta * N + na] : 0.f;
        a[1] = r.vb && na < N ? Cc[r.tb * N + na] : 0.f;
        a[2] = r.va && nb < N ? Cc[r.ta * N + nb] : 0.f;
        a[3] = r.vb && nb < N ? Cc[r.tb * N + nb] : 0.f;
      }, [&](int ks, const float (&c)[4]) {
        const float cur[4] = {c[0] * r.ea, c[1] * r.eb, c[2] * r.ea, c[3] * r.eb};
        Split as[4];
        split4(as, cur);
        const float* h0 = hs + (ks * 8 + q) * ld + p0 + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) mma3(acc[j], as, h0[8 * j], h0[4 * ld + 8 * j]);
      });
    };
    // acc += W·x over the s-steps [k0, k1), W[t, s] = G[t, s]·exp(acum_t - acum_s)·dt_s
    // for s <= t
    auto w_x = [&](float (&acc)[NT][4], const Rows& r, int p0, int k0, int k1) {
      read_ahead(k1 - k0, [&](int i, float (&a)[4]) {
        const int sa = (k0 + i) * 8 + q, sb = sa + 4;
        a[0] = r.va && sa <= r.ta ? Gc[r.ta * chunk + sa] : 0.f;
        a[1] = r.vb && sa <= r.tb ? Gc[r.tb * chunk + sa] : 0.f;
        a[2] = r.va && sb <= r.ta ? Gc[r.ta * chunk + sb] : 0.f;
        a[3] = r.vb && sb <= r.tb ? Gc[r.tb * chunk + sb] : 0.f;
      }, [&](int i, const float (&gr)[4]) {
        const int sa = (k0 + i) * 8 + q, sb = sa + 4;
        float cur[4];
        cur[0] = r.va && sa <= r.ta ? gr[0] * exp2f((r.aca - acum[sa]) * kLog2e) * dts[sa] : 0.f;
        cur[1] = r.vb && sa <= r.tb ? gr[1] * exp2f((r.acb - acum[sa]) * kLog2e) * dts[sa] : 0.f;
        cur[2] = r.va && sb <= r.ta ? gr[2] * exp2f((r.aca - acum[sb]) * kLog2e) * dts[sb] : 0.f;
        cur[3] = r.vb && sb <= r.tb ? gr[3] * exp2f((r.acb - acum[sb]) * kLog2e) * dts[sb] : 0.f;
        Split as[4];
        split4(as, cur);
        const T* x0 = xs + sa * ld + p0 + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_x(acc[j], as, x0[8 * j], x0[4 * ld + 8 * j]);
      });
    };
    auto store_y = [&](const float (&acc)[NT][4], const Rows& r, int p0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = p0 + 8 * j + 2 * q;
        if (r.va) store_pair(y + (l0 + r.ta) * pos_stride + head_off + p, p, P, acc[j][0], acc[j][1]);
        if (r.vb) store_pair(y + (l0 + r.tb) * pos_stride + head_off + p, p, P, acc[j][2], acc[j][3]);
      }
    };
    // s-steps of m-tile mt: those up to its last row
    auto w_steps = [&](int mt) { return (min(chunk, mt * 16 + 16) + 7) / 8; };

    if (balanced) {
      // one m-tile per warp, one column block: warp w < kWarps / 2 also
      // takes the last s-steps of m-tile kWarps - 1 - w, so that both warps
      // of the pair do the same number, and hands its partial sum over
      const int pair = min(warp, kWarps - 1 - warp);
      const int light = pair, heavy = kWarps - 1 - pair;
      const int split = w_steps(heavy) - (w_steps(heavy) - w_steps(light)) / 2;
      float* part = scratch + pair * (NT * 4 * 32) + lane;  // [NT][4][32] a pair
      const Rows r = rows_of(warp);
      float acc[NT][4] = {};
      c_h(acc, r, 0);
      w_x(acc, r, 0, 0, warp == heavy ? split : w_steps(warp));
      if (warp == light) {
        store_y(acc, r, 0);
        float pacc[NT][4] = {};
        w_x(pacc, rows_of(heavy), 0, split, w_steps(heavy));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) part[(j * 4 + i) * 32] = pacc[j][i];
        }
      }
      __syncthreads();  // the partial sums are written; every warp is done reading h
      if (warp == heavy) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += part[(j * 4 + i) * 32];
        }
        store_y(acc, r, 0);
      }
    } else {
      for (int mt = warp; mt * 16 < chunk; mt += kWarps) {
        const Rows r = rows_of(mt);
        for (int p0 = 0; p0 < P; p0 += CW) {
          float acc[NT][4] = {};
          c_h(acc, r, p0);
          w_x(acc, r, p0, 0, w_steps(mt));
          store_y(acc, r, p0);
        }
      }
      __syncthreads();  // every warp is done reading h
    }

    // ---- h = exp(acum_last)·h + sum_s (B_s·f_s) ⊗ x_s, 16 rows n a warp
    const float gl = expf(acum[chunk - 1]);
    const int s_ks = (chunk + 7) / 8;
    for (int mt = warp; mt * 16 < N; mt += kWarps) {
      const int na = mt * 16 + g, nb = na + 8;
      const bool va = na < N, vb = nb < N;
      for (int p0 = 0; p0 < P; p0 += CW) {
        float acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = p0 + 8 * j + 2 * q;
          acc[j][0] = gl * hs[na * ld + c];
          acc[j][1] = gl * hs[na * ld + c + 1];
          acc[j][2] = gl * hs[nb * ld + c];
          acc[j][3] = gl * hs[nb * ld + c + 1];
        }
        auto load_b = [&](int ks, float (&a)[4]) {  // A[n][s] = B[s][n]
          const int sa = ks * 8 + q, sb = sa + 4;
          a[0] = va && sa < chunk ? Bc[sa * N + na] : 0.f;
          a[1] = vb && sa < chunk ? Bc[sa * N + nb] : 0.f;
          a[2] = va && sb < chunk ? Bc[sb * N + na] : 0.f;
          a[3] = vb && sb < chunk ? Bc[sb * N + nb] : 0.f;
        };
        read_ahead(s_ks, load_b, [&](int ks, const float (&bt)[4]) {
          const int sa = ks * 8 + q, sb = sa + 4;
          const float fa = sa < chunk ? fs[sa] : 0.f, fb = sb < chunk ? fs[sb] : 0.f;
          const float cur[4] = {bt[0] * fa, bt[1] * fa, bt[2] * fb, bt[3] * fb};
          Split as[4];
          split4(as, cur);
          const T* x0 = xs + sa * ld + p0 + g;
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_x(acc[j], as, x0[8 * j], x0[4 * ld + 8 * j]);
        });
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = p0 + 8 * j + 2 * q;
          hs[na * ld + c] = acc[j][0];
          hs[na * ld + c + 1] = acc[j][1];
          hs[nb * ld + c] = acc[j][2];
          hs[nb * ld + c + 1] = acc[j][3];
        }
      }
    }
  }
}

template <typename T, int NT>
int launch_heads(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 const void* G, void* y, long long batch, long long L, int H, int P, int N,
                 int chunk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_bytes(P, N, chunk, sizeof(T)));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, NT><<<static_cast<unsigned>(batch * H), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<const float*>(G),
      static_cast<T*>(y), static_cast<int>(L), H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* G, long long batch, long long L, int H, int P, int N, int chunk,
           cudaStream_t stream) {
  ssd_gram_kernel<<<static_cast<unsigned>(batch * (L / chunk)), kThreads, 0, stream>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(G), N,
      chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (col_tiles(P)) {
    case 1: return launch_heads<T, 1>(x, dt, A, Bm, Cm, G, y, batch, L, H, P, N, chunk, stream);
    case 2: return launch_heads<T, 2>(x, dt, A, Bm, Cm, G, y, batch, L, H, P, N, chunk, stream);
    case 4: return launch_heads<T, 4>(x, dt, A, Bm, Cm, G, y, batch, L, H, P, N, chunk, stream);
    default: return launch_heads<T, 8>(x, dt, A, Bm, Cm, G, y, batch, L, H, P, N, chunk, stream);
  }
}

}  // namespace

// shared memory of one CTA of the heads kernel; x_bytes: 4 for f32 x, 2 for bf16
extern "C" long long ssd_scan_smem_bytes(int P, int N, int chunk, int x_bytes) {
  return smem_bytes(P, N, chunk, x_bytes);
}

// G: scratch of batch·L·chunk floats (the [B, L/chunk, chunk, chunk] Gram matrices)
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* G, long long batch, long long L,
                               int H, int P, int N, int chunk, int x_is_bf16, void* stream) {
  if (batch <= 0 || H <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  if (chunk <= 0 || L % chunk != 0 || P <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, G, batch, L, H, P, N, chunk, s);
  return launch<float>(x, dt, A, Bm, Cm, y, G, batch, L, H, P, N, chunk, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
