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
// What bounds it: operations.  The work is 4·D FLOPs per (query, visible
// key) pair and head (q·k and p·v): at qwen3-0.6b's prefill shape (B = 8,
// H = 16, Hk = 8, Sq = Sk = 4096, D = 128, causal) about 5.5e11 FLOPs,
// against 0.40 GB of q, k, v and o moved once in bf16 (0.12 ms at 3.35
// TB/s).  On bf16 tensor cores (989 TFLOP/s) that is 0.56 ms; this kernel
// computes in f32 on the CUDA cores (67 TFLOP/s), where it is 8.2 ms.
//
// What this design does about it: the TPU kernel runs the KV tiles as the
// innermost, sequential grid axis with m, l and acc in VMEM scratch; blocks
// on the card run in no order, so one CTA of 256 threads takes one (b, h,
// 64-row q tile) and loops over the 64-key KV tiles itself, stopping at the
// last tile at or below q_offset + the tile's last row when causal (the
// tiles above the diagonal are never loaded).  The q tile and each KV tile
// are staged in shared memory as f32 (zero past the ragged Sq and Sk
// edges).  Thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 of the
// tile: the scores of keys tx + 16j and the output columns tx + 16c, all in
// registers (at D = 128: 16 scores and 32 accumulators a thread, so no row
// of D lives in one thread), with the running max and sum of its rows; the
// 16 threads of a row reduce them with warp shuffles.  The probabilities
// go through shared memory to the P·V product.  Row strides are padded
// (q: D + 4, k: D + 1, p: 64 + 4) so that the reads of each product hit
// distinct banks or broadcast.  Consecutive CTAs are the q tiles of one
// (b, h), heaviest first, so their KV tiles come from L2.  At D = 128 a CTA
// holds 117 KB of shared memory: one CTA (8 warps) per SM.  Tensor cores
// (mma.sync / wgmma on bf16 with f32 accumulation), TMA with a pipelined
// ring of KV tiles and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16 (rows), tx = tid % 16 (columns)
constexpr int kBQ = 64;  // query rows of a CTA
constexpr int kBK = 64;  // keys of a KV tile
constexpr int kTM = kBQ / 16;  // rows of a thread: 4ty .. 4ty + 3
constexpr int kSC = kBK / 16;  // score columns of a thread: tx + 16j
constexpr float kNeg = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H, int Hk, int Sq,
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
    T* out = o + q_base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < kOC; ++c) store(out + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int Sq,
           int Sk, int q_offset, int causal, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout<D>::floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hk, Sq, Sk, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int Sq,
             int Sk, int D, int q_offset, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hk, Sq, Sk, q_offset, causal, scale, stream);
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
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hk, Sq, Sk, D, q_offset, causal, scale, s);
  return launch_d<float>(q, k, v, o, B, H, Hk, Sq, Sk, D, q_offset, causal, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
