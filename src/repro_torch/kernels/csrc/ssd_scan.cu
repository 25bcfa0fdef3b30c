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
// cumsum of A·dt within the chunk,
//
//   y_t = sum_{s<=t} (C_t·B_s)·exp(acum_t - acum_s)·dt_s·x_s + exp(acum_t)·(C_t·h)
//   h   = exp(acum_last)·h + sum_s B_s ⊗ (dt_s·exp(acum_last - acum_s)·x_s)
//
// y is written in x's dtype, everything else is f32.
//
// What bounds it: operations.  Per (b, h, chunk) the work is c(c+1)·N
// (C·Bᵀ on and below the diagonal) + c(c+1)·P (W·x) + 2cNP (C·h) + 2cNP (the
// state update) FLOPs; at mamba2-2.7b's prefill shape (B=8, L=4096, H=80,
// P=64, N=128, c=128) that is 7.4 MFLOP per chunk and 151 GFLOP per call,
// about 2.3 ms at the f32 peak outside the tensor cores, against 0.72 GB of
// x (bf16), y, dt, B and C moved once (0.21 ms at 3.35 TB/s).  No TF32: the
// plain version and the reference are f32 throughout.
//
// What this design does about it: one CTA of 256 threads per (b, h) loops
// over the chunks in order with the state h[N, P] in shared memory (the
// loop takes the place of the TPU's sequential grid axis and its VMEM
// scratch).  Per chunk it stages dt, B[c, N] and x[c, P] (as f32) in shared
// memory and scans acum in one warp; then, 32 rows t at a time, it stages
// those rows of C, forms W[t, s] only for s <= t (exp is never evaluated
// above the diagonal, where acum_t - acum_s > 0 could overflow; the TPU
// kernel masks after exp), and adds W·x and exp(acum_t)·(C·h) into y; then
// it scales x in place by dt·exp(acum_last - acum) and updates h.  Every
// product is a register tile of 4 rows x 2 columns per thread over shared
// memory (f32 FMAs on CUDA cores); B's rows are padded to N + 1 floats so
// the column reads of C·Bᵀ hit 32 banks.  Consecutive CTAs share b, so the
// B and C rows of the 80 heads come from L2.  At c = N = 128, P = 64 a CTA
// holds 165 KB of shared memory: one CTA (8 warps) per SM, 640 CTAs over
// 132 SMs.  Tensor cores, TMA, and splitting C·Bᵀ (the same for every head)
// out of the per-head CTAs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTM = 4;  // rows of a thread's register tile (consecutive)
constexpr int kTN = 2;  // columns of a thread's register tile (32 apart)
constexpr int kTileRows = (kThreads / 32) * kTM;  // 32: warp ty owns rows 4ty..4ty+3
constexpr int kTileCols = 32 * kTN;  // 64: lane tx owns columns tx, tx + 32
constexpr int kRowBlock = kTileRows;  // rows t of y formed together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// acc[i][j] += sum_{k<K} a[rows[i]*a_rs + k*a_ks] * b[k*b_ks + cols[j]*b_cs]
__device__ __forceinline__ void tile_mma(float (&acc)[kTM][kTN], int K,
                                         const float* a, int a_rs, int a_ks,
                                         const int (&rows)[kTM], const float* b,
                                         int b_ks, int b_cs, const int (&cols)[kTN]) {
  const float* ap[kTM];
  const float* bp[kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) ap[i] = a + rows[i] * a_rs;
#pragma unroll
  for (int j = 0; j < kTN; ++j) bp[j] = b + cols[j] * b_cs;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[kTM], bv[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) av[i] = ap[i][k * a_ks];
#pragma unroll
    for (int j = 0; j < kTN; ++j) bv[j] = bp[j][k * b_ks];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__host__ __device__ inline long long smem_floats(int P, int N, int chunk) {
  return static_cast<long long>(N) * P  // h
         + static_cast<long long>(chunk) * (N + 1)  // B, padded rows
         + static_cast<long long>(chunk) * P  // x
         + static_cast<long long>(kRowBlock) * N  // rows of C
         + static_cast<long long>(kRowBlock) * chunk  // rows of W
         + 2LL * chunk;  // acum, dt
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, T* __restrict__ y, int L, int H, int P,
                int N, int chunk) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int h = static_cast<int>(blockIdx.x % H);
  const long long b = blockIdx.x / H;
  const int ldb = N + 1;
  float* hs = smem;  // [N][P] the carried state
  float* bs = hs + N * P;  // [chunk][N + 1] B of the chunk
  float* xs = bs + chunk * ldb;  // [chunk][P] x of the chunk, f32
  float* cs = xs + chunk * P;  // [kRowBlock][N] rows of C
  float* ws = cs + kRowBlock * N;  // [kRowBlock][chunk] rows of W
  float* acum = ws + kRowBlock * chunk;  // [chunk]
  float* dts = acum + chunk;  // [chunk]

  for (int e = tid; e < N * P; e += kThreads) hs[e] = 0.0f;
  const float a_h = A[h];
  const long long pos_stride = static_cast<long long>(H) * P;  // x / y, one position
  const long long head_off = static_cast<long long>(h) * P;

  for (int c0 = 0; c0 < L; c0 += chunk) {
    __syncthreads();  // the previous chunk is done with bs, xs, dts, acum and hs
    const long long l0 = b * L + c0;  // the chunk's first position, all rows
    for (int s = tid; s < chunk; s += kThreads) dts[s] = dt[(l0 + s) * H + h];
    for (int e = tid; e < chunk * N; e += kThreads) {
      const int s = e / N, n = e - s * N;
      bs[s * ldb + n] = Bm[(l0 + s) * N + n];
    }
    for (int e = tid; e < chunk * P; e += kThreads) {
      const int s = e / P, p = e - s * P;
      xs[e] = to_f32(x[(l0 + s) * pos_stride + head_off + p]);
    }
    __syncthreads();
    if (ty == 0) {  // one warp: acum = inclusive cumsum of A·dt over the chunk
      const int per = (chunk + 31) / 32;
      const int s0 = tx * per;
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
        if (tx >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tx == 0) excl = 0.0f;
      for (int s = s0; s < s1; ++s) acum[s] += excl;
    }
    __syncthreads();

    for (int t0 = 0; t0 < chunk; t0 += kRowBlock) {
      const int nt = min(kRowBlock, chunk - t0);  // rows t of this block
      const int ns = t0 + nt;  // columns s <= t reach below ns
      for (int e = tid; e < nt * N; e += kThreads) cs[e] = Cm[(l0 + t0) * N + e];
      __syncthreads();
      int rows[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) rows[i] = min(ty * kTM + i, nt - 1);

      // W[t][s] = (C_t·B_s)·exp(acum_t - acum_s)·dt_s for s <= t, else 0
      for (int col0 = 0; col0 < ns; col0 += kTileCols) {
        int cols[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) cols[j] = min(col0 + tx + 32 * j, ns - 1);
        float acc[kTM][kTN] = {};
        tile_mma(acc, N, cs, N, 1, rows, bs, 1, ldb, cols);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int t = ty * kTM + i, s = col0 + tx + 32 * j;
            if (t < nt && s < ns) {
              const int tg = t0 + t;
              ws[t * chunk + s] =
                  s <= tg ? acc[i][j] * expf(acum[tg] - acum[s]) * dts[s] : 0.0f;
            }
          }
        }
      }
      __syncthreads();

      // y_t = exp(acum_t)·(C_t·h) + sum_{s<=t} W[t][s]·x_s
      for (int p0 = 0; p0 < P; p0 += kTileCols) {
        int cols[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) cols[j] = min(p0 + tx + 32 * j, P - 1);
        float acc[kTM][kTN] = {};
        tile_mma(acc, N, cs, N, 1, rows, hs, P, 1, cols);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float g = expf(acum[t0 + rows[i]]);
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] *= g;
        }
        tile_mma(acc, ns, ws, chunk, 1, rows, xs, P, 1, cols);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int t = ty * kTM + i, p = p0 + tx + 32 * j;
            if (t < nt && p < P) store(y + (l0 + t0 + t) * pos_stride + head_off + p, acc[i][j]);
          }
        }
      }
      __syncthreads();  // cs and ws are rewritten by the next block of rows
    }

    // h = exp(acum_last)·h + sum_s B_s ⊗ (dt_s·exp(acum_last - acum_s)·x_s)
    const float last = acum[chunk - 1];
    for (int e = tid; e < chunk * P; e += kThreads) {
      const int s = e / P;
      xs[e] *= dts[s] * expf(last - acum[s]);
    }
    __syncthreads();
    const float g = expf(last);
    for (int n0 = 0; n0 < N; n0 += kTileRows) {
      int rows[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) rows[i] = min(n0 + ty * kTM + i, N - 1);
      for (int p0 = 0; p0 < P; p0 += kTileCols) {
        int cols[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) cols[j] = min(p0 + tx + 32 * j, P - 1);
        float acc[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = g * hs[rows[i] * P + cols[j]];
        }
        tile_mma(acc, chunk, bs, 1, ldb, rows, xs, P, 1, cols);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const int n = n0 + ty * kTM + i, p = p0 + tx + 32 * j;
            if (n < N && p < P) hs[n * P + p] = acc[i][j];
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, long long batch, long long L, int H, int P, int N, int chunk,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats(P, N, chunk)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<static_cast<unsigned>(batch * H), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<T*>(y),
      static_cast<int>(L), H, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long ssd_scan_smem_bytes(int P, int N, int chunk) {
  return smem_floats(P, N, chunk) * static_cast<long long>(sizeof(float));
}

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, long long batch, long long L, int H,
                               int P, int N, int chunk, int x_is_bf16, void* stream) {
  if (batch <= 0 || H <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, batch, L, H, P, N, chunk, s);
  return launch<float>(x, dt, A, Bm, Cm, y, batch, L, H, P, N, chunk, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
