// Flash attention (forward; GQA, causal or not) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel).  Semantics are those of the plain version,
// repro_torch/kernels/ref.py:mha_attention: for q[B, H, Sq, D] and
// k, v[B, Hk, Sk, D] (all f32 or all bf16), query head h reads KV head
// h / (H / Hk), and
//
//   o[b, h, i] = softmax_j(scale · q[b, h, i]·k[b, hk, j]) · v[b, hk, j]
//
// over the keys j < Sk, and with `causal` only j <= q_offset + i (absolute
// positions: a decode step is Sq = 1 with q_offset = the cache length over
// a padded cache, whose padding causality hides).  Scores, the softmax and
// the accumulator are f32; o is written in q's dtype.  Masked scores are
// -1e30, never -inf (-inf - -inf is NaN), and a masked key adds exactly 0
// to the row's sum, so a row with no visible key returns 0, as the TPU
// kernel's `l > 0` guard does.
//
// Three kernels, chosen by the wrapper (repro_torch/kernels/flash_attention.py:
// variant) from the dtype and the shapes:
//
// 1. bf16 prefill (flash_wgmma_kernel), D = 32, 64, 128.  What bounds it:
//    operations.  The work is 4·D FLOPs per (query, visible key) pair and
//    head: at qwen3-0.6b's prefill shape (B = 8, H = 16, Hk = 8, Sq = Sk =
//    4096, D = 128, causal) 5.5e11 FLOPs, 0.56 ms on bf16 tensor cores
//    (989 TFLOP/s), against 0.40 GB of q, k, v and o moved once (0.12 ms at
//    3.35 TB/s).  The design: one CTA of three warpgroups takes one (b, h,
//    128-row q tile), heaviest causal tiles first.  Warpgroup 0 is the
//    producer: after `setmaxnreg` gives its registers away, one thread
//    loads the q tile once and then K and V tiles of 128 keys with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle; 64-byte at D = 32) into a
//    2-stage ring, each stage with a K-full, a V-full and an empty
//    mbarrier.  Warpgroups 1 and 2 each own 64 query rows: S = Q·Kᵀ is one
//    wgmma m64n128k16 per 16 of D (both operands from shared memory, f32
//    accumulators), the online softmax (m, l) stays in f32 registers, and
//    O += P·V is a wgmma m64nDk16 with P from registers and V read
//    transposed from shared memory.  P goes in as P_hi + P_lo, two bf16
//    parts (P_hi = bf16(P), P_lo = bf16(P - P_hi)), two wgmmas per 16 keys:
//    a single bf16 P puts an error of 2^-9 of the largest weights into
//    every output, which exceeds one bf16 rounding of the result where an
//    output is near zero (the bar of chip_smoke.py's attn_bar at the served
//    shapes), while the split leaves P's error at 2^-17.  Tiles above the
//    causal diagonal are never loaded; only tiles that reach past the
//    diagonal or past Sk are masked.  K and V are described to TMA as 3-D
//    [B·Hk, Sk, D] (q as [B·H, Sq, D]), so a tile at a ragged Sk reads
//    zeros, never the next head's keys, and the kpos < Sk mask still
//    holds.  The consumers take their tiles in step and release a stage
//    when both have read it; two consumer warpgroups on one SM overlap one
//    another's softmax with their products.
//
// 2. decode (flash_decode_kernel + flash_combine_kernel), f32 or bf16, when
//    Sq · H/Hk is at most the wrapper's DECODE_MAX_ROWS.  What bounds it:
//    bytes.  Each visible key is read once (2·D elements of K and V) for
//    only Sq · H/Hk query rows, about 2 FLOPs a byte, far below the CUDA
//    cores' 20 FLOPs a byte: at the served decode shape 134 MB, 0.040 ms.
//    The design: the grid splits the visible keys (those up to q_offset +
//    Sq - 1) into splits of whole 128-key tiles, one CTA per (split, hk,
//    b), so that B·Hk·splits CTAs fill the card; each CTA serves every
//    query row of all H/Hk query heads of its KV head, so each K and V byte
//    is read once.  Its 8 warps walk their split 8 keys at a time, each
//    lane holding D/32 elements of a key row (a warp reads a row as one
//    coalesced line); scores are summed by warp shuffles, the online
//    softmax runs per warp, and the CTA merges its warps in shared memory
//    and writes the split's partial (m, l, acc) to scratch the wrapper
//    allocates.  A second kernel merges the splits of each row, rescaling
//    by exp(m_split - m).  CUDA cores, not mma.sync: with at most 4 query
//    rows a tile is mostly padding for a tensor-core fragment, and the
//    kernel waits on memory either way.  A split past a row's visible keys
//    keeps m = -1e30 and l = 0 and adds nothing; a row with none returns 0.
//
// 3. f32 prefill (flash_f32_kernel), D = 32, 64, 128: f32 is no served
//    path, and TF32 tensor cores would round q and k to 10 mantissa bits,
//    far outside the f32 bar of 2e-5, so it keeps the CUDA-core kernel of
//    the port's first version.  One CTA of 256 threads takes one (b, h,
//    64-row q tile) and loops over 64-key tiles up to the causal diagonal,
//    staged in shared memory as f32; thread (ty, tx) of a 16 x 16 grid owns
//    4 rows x 4 scores and 4 rows x D/16 output columns in registers, and
//    a row's 16 threads reduce its max and sum by shuffles.  At D = 128 it
//    holds 117 KB of shared memory; its loops are bound by shared-memory
//    loads (8 per 16 FMAs in Q·Kᵀ), about 26 ms at the prefill shape.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// --------------------------------------------------------------------------- //
// 3. the f32 prefill kernel (CUDA cores)
// --------------------------------------------------------------------------- //

namespace f32k {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16 (rows), tx = tid % 16 (columns)
constexpr int kBQ = 64;  // query rows of a CTA
constexpr int kBK = 64;  // keys of a KV tile
constexpr int kTM = kBQ / 16;  // rows of a thread: 4ty .. 4ty + 3
constexpr int kSC = kBK / 16;  // score columns of a thread: tx + 16j

template <int D>
struct Layout {
  static constexpr int q_ld = D + 4;  // rows 4 apart (two ty of a warp) in other banks
  static constexpr int k_ld = D + 1;  // 16 key rows read together: 16 banks
  static constexpr int v_ld = D;
  static constexpr int p_ld = kBK + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + kBQ * q_ld;
  static constexpr int v_off = k_off + kBK * k_ld;
  static constexpr int p_off = v_off + kBK * v_ld;
  static constexpr int floats = p_off + kBQ * p_ld;
};

// sum (max) over the 16 lanes of a half warp: the threads of one row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int H, int Hk, int Sq,
                       int Sk, int q_offset, int causal, float scale) {
  using L = Layout<D>;
  constexpr int kOC = D / 16;  // output columns of a thread: tx + 16c
  extern __shared__ float smem[];
  float* qs = smem + L::q_off;
  float* ks = smem + L::k_off;
  float* vs = smem + L::v_off;
  float* ps = smem + L::p_off;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the causally heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * Sq * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hk + hk) * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qs[r * L::q_ld + c] = q0 + r < Sq ? to_f32(q[q_base + static_cast<size_t>(q0 + r) * D + c]) : 0.f;
  }

  // keys this tile can see: all Sk, or those at or below its last query
  int k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + min(q0 + kBQ, Sq));
  const int n_kt = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  float m[kTM], l[kTM], acc[kTM][kOC];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's K, V and P are read (and Q is staged)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Sk) {
        const size_t off = kv_base + static_cast<size_t>(k0 + r) * D + c;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[r * L::k_ld + c] = kv;
      vs[r * L::v_ld + c] = vv;
    }
    __syncthreads();

    float s[kTM][kSC];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kSC; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kTM], kk[kSC];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = qs[(ty * kTM + i) * L::q_ld + d];
#pragma unroll
      for (int j = 0; j < kSC; ++j) kk[j] = ks[(tx + 16 * j) * L::k_ld + d];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kSC; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }
    }

    // online softmax of this tile's scores, row by row
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int qpos = q_offset + q0 + ty * kTM + i;
      bool ok[kSC];
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * kTM + i) * L::p_ld + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[kTM], vv[kOC];
#pragma unroll
      for (int i = 0; i < kTM; ++i) p[i] = ps[(ty * kTM + i) * L::p_ld + j];
#pragma unroll
      for (int c = 0; c < kOC; ++c) vv[c] = vs[j * L::v_ld + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int c = 0; c < kOC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty * kTM + i;
    if (row >= Sq) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;  // a row with no visible key: 0
    float* out = o + q_base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < kOC; ++c) store(out + tx + 16 * c, acc[i][c] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int Sq,
           int Sk, int q_offset, int causal, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout<D>::floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Hk, Sq, Sk, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32k

// --------------------------------------------------------------------------- //
// 1. the bf16 prefill kernel: TMA ring, wgmma, warp-specialised
// --------------------------------------------------------------------------- //

namespace wg {

constexpr int kBM = 128;  // query rows of a CTA: 64 per consumer warpgroup
constexpr int kBN = 128;  // keys of a KV tile (the wrapper's BLOCK_K)
constexpr int kStages = 2;  // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the phase of `parity` to complete; a wait of over about 10 s
// (a deadlock) traps, which fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// one TMA load of a [1][rows][cols] box at (c0, c1, c2) into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads of wgmma accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128-byte, 2: 64-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(mode) << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0:64] (+)= A·B, m64n128k16, A and B from shared-memory descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:16] += A·B, m64n32k16, A from registers (bf16 pairs), B from a
// shared-memory descriptor read transposed (MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:32] += A·B, m64n64k16, A from registers (bf16 pairs), B from a
// shared-memory descriptor read transposed (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:64] += A·B, m64n128k16, A from registers (bf16 pairs), B from a
// shared-memory descriptor read transposed (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// Shared-memory layout of one CTA.  A tile of R rows x D bf16 is stored as
// D / PW panels of R rows x PW elements, each row PW·2 bytes, swizzled by
// TMA (128-byte swizzle at PW = 64, 64-byte at PW = 32), which is the
// K-major layout wgmma reads for Q and K, and the MN-major layout it reads
// (transposed) for V.
template <int D>
struct Tiles {
  static constexpr int PW = D >= 64 ? 64 : 32;  // panel width, elements
  static constexpr int RB = PW * 2;  // bytes of a panel row
  static constexpr int NP = D / PW;  // panels
  static constexpr uint32_t MODE = RB == 128 ? 1 : 2;
  static constexpr int Q_PANEL = kBM * RB;
  static constexpr int KV_PANEL = kBN * RB;
  static constexpr int Q_BYTES = kBM * D * 2;
  static constexpr int KV_BYTES = kBN * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;  // q_full, k_full[], v_full[], empty[]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * kStages);
  static constexpr int ALLOC = BYTES + 1024;  // the base is aligned up to 1024 bytes in the kernel
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                   int H, int Hk, int Sq, int Sk, int q_offset, int causal, float scale) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + T::Q_OFF;
  const uint32_t k_s = base + T::K_OFF;
  const uint32_t v_s = base + T::V_OFF;
  const uint32_t bars = base + T::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // the causally heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  int k_end = Sk;  // keys this tile can see
  if (causal) k_end = max(0, min(Sk, q_offset + min(q0 + kBM, Sq)));
  const int n_kt = (k_end + kBN - 1) / kBN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ---------------------- //
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int p = 0; p < T::NP; ++p)
        tma_load_3d(q_s + p * T::Q_PANEL, &tm_q, p * T::PW, q0, b * H + h, q_full);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t phase = (kt / kStages) & 1;
        mbar_wait(empty(s), phase ^ 1);  // the first pass through the ring finds it free
        const int k0 = kt * kBN;
        mbar_expect_tx(k_full(s), T::KV_BYTES);
        for (int p = 0; p < T::NP; ++p)
          tma_load_3d(k_s + s * T::KV_BYTES + p * T::KV_PANEL, &tm_k, p * T::PW, k0, b * Hk + hk,
                      k_full(s));
        mbar_expect_tx(v_full(s), T::KV_BYTES);
        for (int p = 0; p < T::NP; ++p)
          tma_load_3d(v_s + s * T::KV_BYTES + p * T::KV_PANEL, &tm_v, p * T::PW, k0, b * Hk + hk,
                      v_full(s));
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ------------------------------------- //
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * c + 16 * warp + lane / 4;  // rows of this thread: row0, row0 + 8
  const int qpos0 = q_offset + row0, qpos1 = qpos0 + 8;
  const int first_qpos = q_offset + q0 + 64 * c;  // the warpgroup's first row
  const float sl2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const uint32_t phase = (kt / kStages) & 1;
    const int k0 = kt * kBN;

    // S = Q·Kᵀ: 64 rows x 128 keys, f32
    float sc[kBN / 2];
    mbar_wait(k_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk * 16 / T::PW, off = (kk * 16 % T::PW) * 2;
      const uint64_t da = make_desc(q_s + p * T::Q_PANEL + 64 * c * T::RB + off, 16, 8 * T::RB,
                                    T::MODE);
      const uint64_t db = make_desc(k_s + s * T::KV_BYTES + p * T::KV_PANEL + off, 16,
                                    8 * T::RB, T::MODE);
      wgmma_ss_n128(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in base 2; element i sits at row row0 + 8·((i >> 1) & 1),
    // key k0 + 8·(i >> 2) + 2·(lane % 4) + (i & 1)
    const bool masked = k0 + kBN > Sk || (causal && k0 + kBN - 1 > first_qpos);
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      float x = sc[i] * sl2;
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = (i & 2) ? qpos1 : qpos0;
        if (key >= Sk || (causal && key > qp)) x = kNeg;
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    // a row that sees no key yet has only masked scores: subtracting +inf makes them 0
    const float ref0 = mn0 > kNeg ? mn0 : INFINITY, ref1 = mn1 > kNeg ? mn1 : INFINITY;
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const float pr = exp2f(sc[i] - ((i & 2) ? ref1 : ref0));
      sc[i] = pr;
      if (i & 2) rs1 += pr;
      else rs0 += pr;
    }
    l0 = l0 * alpha0 + rs0;  // this thread's part of the row sum; reduced at the end
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

    // P as two bf16 parts, in the register layout of wgmma's A operand
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
    }

    // O += P_lo·V + P_hi·V
    mbar_wait(v_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = make_desc(v_s + s * T::KV_BYTES + kk * 16 * T::RB, T::KV_PANEL,
                                    8 * T::RB, T::MODE);
      wgmma_rs<D>(acc, p_lo[kk], dv);
      wgmma_rs<D>(acc, p_hi[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // a row with no visible key: 0
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const size_t o_base = (static_cast<size_t>(b) * H + h) * Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + o_base + static_cast<size_t>(row0) * D + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + o_base + static_cast<size_t>(row0 + 8) * D + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [heads, rows, D] bf16 tensor read in boxes of box_rows x PW
template <int D>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int heads, int rows, int box_rows) {
  using T = Tiles<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::PW), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            T::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int Sq,
           int Sk, int q_offset, int causal, float scale, cudaStream_t stream) {
  if (Sk == 0)  // no key at all: every row is 0
    return static_cast<int>(cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * Sq * D * 2, stream));
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode<D>(fn, &tq, q, B * H, Sq, kBM) || !encode<D>(fn, &tk, k, B * Hk, Sk, kBN) ||
      !encode<D>(fn, &tv, v, B * Hk, Sk, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Tiles<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Hk, Sq, Sk, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// --------------------------------------------------------------------------- //
// 2. the decode kernels: split KV across the grid, then merge the splits
// --------------------------------------------------------------------------- //

namespace dec {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 4;  // query rows of a KV head (the wrapper's DECODE_MAX_ROWS)
constexpr int kStep = 8;  // keys a warp takes at once

// EPL elements of a row starting at p, as f32 (one vector load)
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float (&out)[EPL]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (EPL == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
    } else if constexpr (EPL == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x, out[1] = v.y;
    } else {
      out[0] = to_f32(p[0]);
    }
  } else {
    if constexpr (EPL == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
      const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
      out[0] = __low2float(a), out[1] = __high2float(a), out[2] = __low2float(c),
      out[3] = __high2float(c);
    } else if constexpr (EPL == 2) {
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
      out[0] = __low2float(a), out[1] = __high2float(a);
    } else {
      out[0] = to_f32(p[0]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the keys every row can see at most: those up to q_offset + Sq - 1
__host__ __device__ inline int visible_end(int Sq, int Sk, int q_offset, int causal) {
  if (!causal) return Sk;
  const long long e = static_cast<long long>(q_offset) + Sq;
  return static_cast<int>(e < 0 ? 0 : (e < Sk ? e : Sk));
}

// One CTA per (split, hk, b): the R = Sq·H/Hk query rows of KV head hk over
// keys [split·split_len, (split + 1)·split_len) ∩ [0, visible_end).  Row r
// is query i = r % Sq of head hk·g + r / Sq.  Writes the split's (m, l) and
// unnormalised acc of each row, in base 2.  ROWS bounds R at compile time.
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    float2* __restrict__ part_ml, float* __restrict__ part_acc, int H, int Hk,
                    int Sq, int Sk, int q_offset, int causal, float scale, int split_len) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  extern __shared__ float sm[];  // [kWarps][R][D + 2]: each warp's acc, m, l
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int g = H / Hk, R = g * Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kend = visible_end(Sq, Sk, q_offset, causal);
  const int kbeg = split * split_len;
  const int klast = min(kbeg + split_len, kend);
  const float sl2 = scale * kLog2e;

  float qr[ROWS][EPL], acc[ROWS][EPL], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = qr[r][e] = 0.f;
    if (r < R) {
      const int h = hk * g + r / Sq, i = r % Sq;
      load_row<T, EPL>(q + ((static_cast<size_t>(b) * H + h) * Sq + i) * D + lane * EPL, qr[r]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[r][e] *= sl2;
    }
  }

  const size_t kv_base = (static_cast<size_t>(b) * Hk + hk) * Sk * D + lane * EPL;
  for (int j0 = kbeg + warp * kStep; j0 < klast; j0 += kWarps * kStep) {
    float kf[kStep][EPL], vf[kStep][EPL];
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      if (j0 + j < klast) {
        load_row<T, EPL>(k + kv_base + static_cast<size_t>(j0 + j) * D, kf[j]);
        load_row<T, EPL>(v + kv_base + static_cast<size_t>(j0 + j) * D, vf[j]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[j][e] = vf[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= R) break;
      const int qpos = q_offset + r % Sq;
      float s[kStep], mx = kNeg;
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[r][e], kf[j][e], part);
        s[j] = warp_sum(part);
        const int key = j0 + j;
        if (key >= klast || (causal && key > qpos)) s[j] = kNeg;
        mx = fmaxf(mx, s[j]);
      }
      const float mn = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - mn);
      const float ref = mn > kNeg ? mn : INFINITY;  // no visible key yet: every p is 0
      m[r] = mn;
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        const float p = exp2f(s[j] - ref);
        ps += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vf[j][e], acc[r][e]);
      }
      l[r] = l[r] * alpha + ps;
    }
  }

  // merge the warps of the CTA in shared memory
  const int ld = D + 2;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= R) break;
    float* row = sm + (warp * R + r) * ld;
#pragma unroll
    for (int e = 0; e < EPL; ++e) row[lane * EPL + e] = acc[r][e];
    if (lane == 0) row[D] = m[r], row[D + 1] = l[r];
  }
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    float mm = kNeg;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm[(w * R + r) * ld + D]);
    float ll = 0.f, a[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) a[e] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = sm + (w * R + r) * ld;
      const float f = exp2f(row[D] - mm);
      ll += f * row[D + 1];
#pragma unroll
      for (int e = 0; e < EPL; ++e) a[e] = fmaf(f, row[lane * EPL + e], a[e]);
    }
    const int h = hk * g + r / Sq, i = r % Sq;
    const size_t prow = (static_cast<size_t>(b) * H + h) * Sq + i;
    float* out = part_acc + (prow * n_splits + split) * D + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = a[e];
    if (lane == 0) part_ml[prow * n_splits + split] = make_float2(mm, ll);
  }
}

// One warp per (b, h, i) row: o = sum_s 2^(m_s - m) acc_s / sum_s 2^(m_s - m) l_s.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_combine_kernel(const float2* __restrict__ part_ml, const float* __restrict__ part_acc,
                     T* __restrict__ o, long long rows, int n_splits) {
  constexpr int EPL = D / 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float2* ml = part_ml + row * n_splits;
  float mm = kNeg;
  for (int s = 0; s < n_splits; ++s) mm = fmaxf(mm, ml[s].x);
  float ll = 0.f, a[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) a[e] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float f = exp2f(ml[s].x - mm);
    ll += f * ml[s].y;
    const float* src = part_acc + (row * n_splits + s) * D + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) a[e] = fmaf(f, src[e], a[e]);
  }
  const float inv = ll > 0.f ? 1.f / ll : 0.f;  // a row with no visible key: 0
#pragma unroll
  for (int e = 0; e < EPL; ++e) store(o + row * D + lane * EPL + e, a[e] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* part_ml, void* part_acc,
           int B, int H, int Hk, int Sq, int Sk, int q_offset, int causal, float scale,
           int split_len, int n_splits, cudaStream_t stream) {
  const int R = (H / Hk) * Sq;
  if (R > kMaxRows || split_len <= 0 || n_splits <= 0 ||
      static_cast<long long>(split_len) * n_splits <
          visible_end(Sq, Sk, q_offset, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kWarps * R * (D + 2) * static_cast<int>(sizeof(float));
  auto kernel = flash_decode_kernel<T, D, kMaxRows>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_splits, Hk, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float2*>(part_ml), static_cast<float*>(part_acc), H, Hk, Sq, Sk, q_offset,
      causal, scale, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * H * Sq;
  flash_combine_kernel<T, D><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
                               stream>>>(static_cast<const float2*>(part_ml),
                                         static_cast<const float*>(part_acc), static_cast<T*>(o),
                                         rows, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dec

template <typename T>
int launch_decode_d(const void* q, const void* k, const void* v, void* o, void* part_ml,
                    void* part_acc, int B, int H, int Hk, int Sq, int Sk, int D, int q_offset,
                    int causal, float scale, int split_len, int n_splits, cudaStream_t s) {
  switch (D) {
    case 32: return dec::launch<T, 32>(q, k, v, o, part_ml, part_acc, B, H, Hk, Sq, Sk, q_offset,
                                       causal, scale, split_len, n_splits, s);
    case 64: return dec::launch<T, 64>(q, k, v, o, part_ml, part_acc, B, H, Hk, Sq, Sk, q_offset,
                                       causal, scale, split_len, n_splits, s);
    case 128: return dec::launch<T, 128>(q, k, v, o, part_ml, part_acc, B, H, Hk, Sq, Sk,
                                         q_offset, causal, scale, split_len, n_splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Hk, int Sq, int Sk, int D, int q_offset,
                                      int causal, float scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Hk <= 0 || H % Hk != 0 || Sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (is_bf16 ? 1 : 0)) {
    case 64: return f32k::launch<32>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, s);
    case 128: return f32k::launch<64>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, s);
    case 256: return f32k::launch<128>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, s);
    case 65: return wg::launch<32>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, s);
    case 129: return wg::launch<64>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, s);
    case 257: return wg::launch<128>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_decode_launch(const void* q, const void* k, const void* v,
                                             void* o, void* part_ml, void* part_acc, int B,
                                             int H, int Hk, int Sq, int Sk, int D, int q_offset,
                                             int causal, float scale, int is_bf16, int split_len,
                                             int n_splits, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Hk <= 0 || H % Hk != 0 || Sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_decode_d<__nv_bfloat16>(q, k, v, o, part_ml, part_acc, B, H, Hk, Sq, Sk, D,
                                          q_offset, causal, scale, split_len, n_splits, s);
  return launch_decode_d<float>(q, k, v, o, part_ml, part_acc, B, H, Hk, Sq, Sk, D, q_offset,
                                causal, scale, split_len, n_splits, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
