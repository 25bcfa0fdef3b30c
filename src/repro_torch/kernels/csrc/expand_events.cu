// The analyzer's padded event planes for Hopper (sm_90a), written on the card
// from the compact staging.
//
// Replaces no TPU kernel.  The reference stages full [B, N] planes on the
// host (repro/core/events.py:EventStager.stage) and moves them to the device
// whole, padding included.  The port's default dispatch stages only the real
// events (repro_torch/core/events.py:EventStager.stage_compact: flat 32-bit
// columns in row order, and [B + 1] row offsets), copies those, and this
// kernel writes the planes the analysis reads: row r's events into the
// prefix of row r, zero (false for valid) in every other slot of every row.
// Its plain version is repro_torch/kernels/ref.py:expand_events; both give
// the host fill's planes (EventStager._fill_rows) bit for bit: a value is
// moved, never converted.
//
// What bounds it: memory.  It reads each real event's columns once (16 B,
// 20 with the host column, 24 with QoS) and writes every slot of every plane
// once (17 B a slot, 21 with host, 25 with QoS).  At the pooled fabric's
// [64, 524288] with 14.2M real events: (284 MB + 705 MB) / 3.35 TB/s = 0.30
// ms.  No arithmetic.
//
// What this design does about it: one thread a slot, a 2-D grid of (chunks
// of a row, rows), so a warp reads 32 consecutive events of each column and
// writes 32 consecutive slots of each plane (128-byte stores, 32 bytes for
// valid), and a thread loads its row's two offsets from L1.  A block
// strides over the rest of its row, and over further rows past the grid's
// 65535 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1024;  // blocks along a row; each strides over the rest
constexpr long long kMaxBlocksY = 65535;  // the grid's y limit; blocks stride over more rows

struct Columns {  // the compact columns, [E] each; host and qos null when not staged
  const float* t;
  const int* pool;
  const float* bytes;
  const float* weight;
  const int* host;
  const int* qos;
};

struct Planes {  // the padded planes, [B, N] each; host and qos null when not staged
  float* t;
  int* pool;
  float* bytes;
  float* weight;
  int* host;
  int* qos;
  bool* valid;
};

__global__ void __launch_bounds__(kThreads)
    expand_kernel(const int* __restrict__ offsets, Columns src, Planes dst, long long n_rows,
                  long long n) {
  for (long long row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const long long begin = offsets[row];
    const long long count = offsets[row + 1] - begin;
    for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < n;
         j += static_cast<long long>(gridDim.x) * kThreads) {
      const long long o = row * n + j;
      const bool real = j < count;
      float t = 0.0f, nbytes = 0.0f, weight = 0.0f;
      int pool = 0, host = 0, qos = 0;
      if (real) {
        const long long s = begin + j;
        t = src.t[s];
        pool = src.pool[s];
        nbytes = src.bytes[s];
        weight = src.weight[s];
        if (src.host != nullptr) host = src.host[s];
        if (src.qos != nullptr) qos = src.qos[s];
      }
      dst.t[o] = t;
      dst.pool[o] = pool;
      dst.bytes[o] = nbytes;
      dst.weight[o] = weight;
      if (dst.host != nullptr) dst.host[o] = host;
      if (dst.qos != nullptr) dst.qos[o] = qos;
      dst.valid[o] = real;
    }
  }
}

}  // namespace

// offsets: [n_rows + 1] int32, non-decreasing, offsets[0] = 0, no row longer
// than n; the columns: [offsets[n_rows]] each; the planes: [n_rows, n] each.
// host and qos (and their planes) may be null, together.
extern "C" int expand_events_launch(const void* offsets, const void* t, const void* pool,
                                    const void* bytes, const void* weight, const void* host,
                                    const void* qos, void* t_out, void* pool_out,
                                    void* bytes_out, void* weight_out, void* host_out,
                                    void* qos_out, void* valid, long long n_rows, long long n,
                                    void* stream) {
  if (n_rows <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if ((host == nullptr) != (host_out == nullptr) || (qos == nullptr) != (qos_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Columns src{static_cast<const float*>(t),      static_cast<const int*>(pool),
                    static_cast<const float*>(bytes),  static_cast<const float*>(weight),
                    static_cast<const int*>(host),     static_cast<const int*>(qos)};
  const Planes dst{static_cast<float*>(t_out),    static_cast<int*>(pool_out),
                   static_cast<float*>(bytes_out), static_cast<float*>(weight_out),
                   static_cast<int*>(host_out),    static_cast<int*>(qos_out),
                   static_cast<bool*>(valid)};
  const long long bx = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(bx < kMaxBlocksX ? bx : kMaxBlocksX),
                  static_cast<unsigned>(n_rows < kMaxBlocksY ? n_rows : kMaxBlocksY));
  expand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), src, dst, n_rows, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* expand_events_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
