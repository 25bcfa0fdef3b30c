// One switch's masked FIFO serial-queue scan for Hopper (sm_90a): a
// single-pass chained scan with decoupled look-back.
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
// (1 B) and writing start and delay (8 B): 13 B per event, 0.065 ms for the
// wide fabric's [32, 524288] batch at 3.35 TB/s.  The arithmetic is a
// handful of f32 ops per masked event.
//
// What this design does about it: every SM streams, whatever the batch's
// shape.  The batch is cut into tiles of kTile events (ref.SCAN_TILE), a
// row's tiles consecutive; one CTA a tile, and each CTA takes the next tile
// from an atomic counter, so every tile before it has already started and
// a wait on a predecessor always ends.  A CTA loads its tile before it
// waits on anything: each warp reads its events as coalesced 16-byte
// vectors (neighbouring lanes on neighbouring addresses) and hands each
// thread its kItems consecutive events through a swizzled shared-memory
// buffer, and writes start and delay back the same way.  The TPU kernel's
// carry across its sequential grid becomes decoupled look-back (Merrill
// and Garland, 2016) over per-tile status words, in two phases:
//
//   1. count: the CTA publishes its masked count as an aggregate, sums its
//      predecessors' aggregates (one warp reads 32 status words at a time)
//      back to the nearest inclusive prefix, and publishes its own;
//   2. max: with the exact rank base, g = t - stt*rank of the masked events,
//      the tile's max published and looked back the same way.
//
// Counting first gives the global rank before any f32 product: an f32 max
// cannot be shifted by stt*rank_base afterwards.  Integer sums and f32
// maxima are exact in any grouping, so every order in which the tiles
// publish gives the serial scan bit for bit (ref.congestion_scan_tiled
// mirrors this on the CPU).  A tile whose events are not whole 16-byte
// vectors (rows of N not a multiple of 16, a row's ragged last tile) takes
// a scalar path.  The status words and the tile counter live in a scratch
// the wrapper allocates per call; the launch zeroes it on the stream.
//
// Numerics: every f32 product and sum rounded by itself (__fmul_rn,
// __fsub_rn, __fadd_rn), the int32 rank converted once, as the plain version
// rounds them.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;  // consecutive events per thread: whole 16-byte mask vectors
constexpr int kTile = kThreads * kItems;  // ref.SCAN_TILE
constexpr int kWarps = kThreads / 32;
constexpr int kVec = kItems / 4;  // float4 vectors of t per thread
constexpr int kMaskVecs = kItems / 16;  // 16-byte mask vectors per thread
constexpr int kWarpVecs = 32 * kVec;  // float4 vectors a warp's events fill
constexpr int kMinBlocks = 1024 / kThreads;  // CTAs an SM holds: at most 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems % 16 == 0 && kItems <= 32, "a thread's mask bits fit one 32-bit word");

// A status word: the flag in the high 32 bits, the value (an int32 count or
// the bits of an f32 max) in the low 32.  One 64-bit store writes both, so
// a reader needs the word's single-copy atomicity and coherence at the
// card's scope, not the ordering of any other data: relaxed gpu-scope
// accesses, which poll L2 without invalidating the SM's L1.
constexpr unsigned kEmpty = 0, kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ void publish(unsigned long long* word, unsigned flag, unsigned value) {
  const unsigned long long w = (static_cast<unsigned long long>(flag) << 32) | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long observe(const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  return w;
}

struct Count {  // the count phase's value: an int32 sum
  using T = int;
  __device__ static int id() { return 0; }
  __device__ static int op(int a, int b) { return a + b; }
  __device__ static unsigned bits(int v) { return static_cast<unsigned>(v); }
  __device__ static int value(unsigned b) { return static_cast<int>(b); }
};

struct Max {  // the max phase's value: an f32 max
  using T = float;
  __device__ static float id() { return -INFINITY; }
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
  __device__ static unsigned bits(float v) { return __float_as_uint(v); }
  __device__ static float value(unsigned b) { return __uint_as_float(b); }
};

// The combination of the values of every tile of the row before `tile`,
// whose row begins at tile `first` (< tile).  One warp calls it, all lanes:
// lane j reads the status word of tile hi - j, the window waits until every
// word up to its nearest inclusive prefix is published, and it moves back
// 32 tiles while it has found aggregates only.  Lanes before the row's
// first tile read the identity as an inclusive prefix; the first tile
// itself publishes only an inclusive prefix, so the walk stops there.
template <typename V>
__device__ typename V::T look_back(const unsigned long long* status, long long tile,
                                   long long first) {
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  T prefix = V::id();
  for (long long hi = tile - 1;; hi -= 32) {
    const long long p = hi - lane;
    unsigned long long w;
    unsigned inc, upto;
    for (;;) {
      w = p >= first ? observe(status + p)
                     : (static_cast<unsigned long long>(kInclusive) << 32) | V::bits(V::id());
      const unsigned flag = static_cast<unsigned>(w >> 32);
      inc = __ballot_sync(kFull, flag == kInclusive);
      const unsigned empty = __ballot_sync(kFull, flag == kEmpty);
      // the lanes up to and including the nearest inclusive prefix (all
      // 32 if none is inclusive yet)
      upto = inc ? ((inc & (0u - inc)) << 1) - 1u : kFull;
      if (!(empty & upto)) break;
      __nanosleep(64);
    }
    T v = (upto >> lane) & 1u ? V::value(static_cast<unsigned>(w)) : V::id();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = V::op(v, __shfl_xor_sync(kFull, v, o));
    prefix = V::op(prefix, v);
    if (inc) return prefix;
  }
}

// The prefix of the tiles before this one, returned to every thread (warp
// 0 passes it through `slot`), given this tile's own value `total`.  Every
// thread of the block calls it; warp 0 publishes the tile's aggregate,
// looks back and publishes its inclusive prefix.
template <typename V>
__device__ __forceinline__ typename V::T chain(unsigned long long* status, long long tile,
                                               long long first, typename V::T total,
                                               typename V::T* slot) {
  if (threadIdx.x < 32) {
    typename V::T prefix = V::id();
    if (tile == first) {
      if (threadIdx.x == 0) publish(status + tile, kInclusive, V::bits(total));
    } else {
      if (threadIdx.x == 0) publish(status + tile, kAggregate, V::bits(total));
      prefix = look_back<V>(status, tile, first);
      if (threadIdx.x == 0) publish(status + tile, kInclusive, V::bits(V::op(prefix, total)));
    }
    if (threadIdx.x == 0) *slot = prefix;
  }
  __syncthreads();
  return *slot;
}

struct Smem {
  float4 buf[kWarps][kWarpVecs];  // each warp's events in transit, swizzled
  int c[kWarps];  // per-warp inclusive counts
  float g[kWarps];  // per-warp maxima
  long long tile;
  int base_c;  // masked events of the row before this tile
  float base_g;  // max of g over the row before this tile
};

// A warp's float4 slot q in shared memory: eight consecutive lanes reading
// their k-th vectors (q = lane * kVec + k) or the j-th coalesced ones (q =
// 32 j + lane) hit eight distinct 16-byte bank groups.
__device__ __forceinline__ int swizzle(int q) { return q ^ ((q >> 3) & 7); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The warp's coalesced vectors `raw` (vector j of lane l is the warp's
// (32 j + l)-th) into this thread's kItems consecutive events `tv`.
__device__ __forceinline__ void unstage(const float4 (&raw)[kVec], float4* buf, int lane,
                                        float (&tv)[kItems]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) buf[swizzle(32 * j + lane)] = raw[j];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float4 v = buf[swizzle(lane * kVec + j)];
    tv[4 * j] = v.x;
    tv[4 * j + 1] = v.y;
    tv[4 * j + 2] = v.z;
    tv[4 * j + 3] = v.w;
  }
}

// The warp's staged vectors out to its events at `dst` (the warp's first),
// coalesced.
__device__ __forceinline__ void flush(const float4* buf, int lane, float* dst) {
  __syncwarp();
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int j = 0; j < kVec; ++j) d4[32 * j + lane] = buf[swizzle(32 * j + lane)];
  __syncwarp();  // the buffer may be written again
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const float* __restrict__ t_in, const unsigned char* __restrict__ mask_in,
            float stt, long long n, long long tiles_per_row, unsigned long long* status,
            float* __restrict__ start_out, float* __restrict__ delay_out) {
  __shared__ Smem sm;
  const long long n_tiles = gridDim.x;
  unsigned long long* count_status = status;
  unsigned long long* max_status = status + n_tiles;
  unsigned* counter = reinterpret_cast<unsigned*>(status + 2 * n_tiles);
  if (threadIdx.x == 0) sm.tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = sm.tile;
  const long long row = tile / tiles_per_row;
  const long long first = row * tiles_per_row;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile_off = row * n + (tile - first) * kTile;  // the tile's first event
  const long long warp_off = tile_off + warp * 32 * kItems;
  const long long off = warp_off + lane * kItems;  // this thread's first event
  const long long i0 = (tile - first) * kTile + (off - tile_off);  // ... within its row
  float4* buf = sm.buf[warp];

  // -- load: the mask as bits, t as coalesced vectors (still in flight
  //    while the count phase runs) -------------------------------------------- //
  const bool vec = (tile - first + 1) * kTile <= n && aligned16(t_in + tile_off) &&
                   aligned16(mask_in + tile_off) && aligned16(start_out + tile_off) &&
                   aligned16(delay_out + tile_off);
  float tv[kItems];
  float4 raw[kVec];
  unsigned m = 0;  // bit k: event k is masked
  if (vec) {
    const float4* t4 = reinterpret_cast<const float4*>(t_in + warp_off);
#pragma unroll
    for (int j = 0; j < kVec; ++j) raw[j] = t4[32 * j + lane];
#pragma unroll
    for (int h = 0; h < kMaskVecs; ++h) {
      const uint4 v = reinterpret_cast<const uint4*>(mask_in + off)[h];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const unsigned word = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
        if ((word >> (8 * (k & 3))) & 0xffu) m |= 1u << (16 * h + k);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool ok = i0 + k < n;
      tv[k] = ok ? t_in[off + k] : 0.0f;
      if (ok && mask_in[off + k]) m |= 1u << k;
    }
  }

  // -- 1. count: the rank base ---------------------------------------------- //
  const int cnt = __popc(m);
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sm.c[warp] = inc;
  __syncthreads();
  int tile_c = 0, warp_c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = sm.c[w];
    tile_c += x;
    if (w < warp) warp_c += x;
  }
  const int rank0 = chain<Count>(count_status, tile, first, tile_c, &sm.base_c) + warp_c +
                    (inc - cnt);

  // -- 2. max: the running max of g = t - stt*rank -------------------------- //
  if (vec) unstage(raw, buf, lane, tv);  // t has landed by now
  float run = -INFINITY;
  int r = rank0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((m >> k) & 1u) {
      const float p = __fmul_rn(stt, __int2float_rn(r));
      run = fmaxf(run, __fsub_rn(tv[k], p));
      ++r;
    }
  }
  float incg = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incg, o);
    if (lane >= o) incg = fmaxf(incg, y);
  }
  float excl_g = __shfl_up_sync(kFull, incg, 1);
  if (lane == 0) excl_g = -INFINITY;
  if (lane == 31) sm.g[warp] = incg;
  __syncthreads();
  float tile_g = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float x = sm.g[w];
    tile_g = fmaxf(tile_g, x);
    if (w < warp) excl_g = fmaxf(excl_g, x);
  }
  run = fmaxf(chain<Max>(max_status, tile, first, tile_g, &sm.base_g), excl_g);

  // -- write: start (staged, or straight out), then delay (from tv) -------- //
  r = rank0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float start[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * j + q;
      if ((m >> k) & 1u) {
        const float p = __fmul_rn(stt, __int2float_rn(r));
        run = fmaxf(run, __fsub_rn(tv[k], p));
        start[q] = __fadd_rn(run, p);
        tv[k] = __fsub_rn(start[q], tv[k]);
        ++r;
      } else {
        start[q] = tv[k];
        tv[k] = 0.0f;
      }
    }
    if (vec) {
      buf[swizzle(lane * kVec + j)] = make_float4(start[0], start[1], start[2], start[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (i0 + 4 * j + q < n) start_out[off + 4 * j + q] = start[q];
      }
    }
  }
  if (vec) {
    flush(buf, lane, start_out + warp_off);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      buf[swizzle(lane * kVec + j)] =
          make_float4(tv[4 * j], tv[4 * j + 1], tv[4 * j + 2], tv[4 * j + 3]);
    }
    flush(buf, lane, delay_out + warp_off);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (i0 + k < n) delay_out[off + k] = tv[k];
    }
  }
}

}  // namespace

// status: 2 * n_rows * ceil(n / kTile) + 1 64-bit words (the count and max
// status words of every tile, then the tile counter), zeroed here on the
// stream before the launch.
extern "C" int congestion_scan_launch(const void* t, const void* mask, float stt, void* start,
                                      void* delay, void* status, long long status_words,
                                      long long n_rows, long long n, void* stream) {
  if (n_rows <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const long long tiles_per_row = (n + kTile - 1) / kTile;
  const long long n_tiles = n_rows * tiles_per_row;
  if (n_tiles > INT_MAX || status_words < 2 * n_tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(status, 0, sizeof(unsigned long long) * status_words, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const float*>(t), static_cast<const unsigned char*>(mask), stt, n,
      tiles_per_row, static_cast<unsigned long long*>(status), static_cast<float*>(start),
      static_cast<float*>(delay));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* congestion_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
