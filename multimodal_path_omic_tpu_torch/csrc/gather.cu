// Row gather for the device-resident bag cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of multimodal_path_omic_tpu/ops/gather.py:
//   * mpo_gather_rows <- gather_rows (_copy_kernel under a scalar-prefetch
//       grid): out[b] = pool[idx[b]] for pool [N, M, D], idx [B].
//
// A pure copy, bound by bytes: every gathered row is read once and written
// once (2 * B * M * D * itemsize bytes; 2.15 GB at B=32, M=8192, D=1024,
// float32: 0.64 ms at 3.35 TB/s). Rows are copied as bytes, 16 at a time, so
// the element type does not matter (float32, bfloat16 and int8 pools alike);
// the wrapper refuses rows whose byte length is not a multiple of 16. The
// TPU kernel learns each block's source row from a prefetched index vector;
// here every block reads its own index. One block copies one contiguous span
// of a row with four independent 16-byte loads in flight per thread.
//
// Interface: plain C, called through ctypes; returns cudaGetLastError() after
// its launch (0 = success); allocates nothing; runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int SPAN = THREADS * UNROLL * 4;  // 16-byte words per block: 64 KB

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ pool, const long long* __restrict__ idx,
                   uint4* __restrict__ out, long long row_words, long long n_rows) {
  const long long src = idx[blockIdx.y];
  if (src < 0 || src >= n_rows) __trap();  // as index_select's device assert
  const uint4* s = pool + src * row_words;
  uint4* d = out + (long long)blockIdx.y * row_words;
  const long long start = (long long)blockIdx.x * SPAN;
  const long long end = start + SPAN < row_words ? start + SPAN : row_words;
  for (long long i = start + threadIdx.x; i < end; i += THREADS * UNROLL) {
    uint4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * THREADS < end) x[u] = s[i + u * THREADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * THREADS < end) d[i + u * THREADS] = x[u];
  }
}

}  // namespace

extern "C" {

// pool: n_rows rows of row_bytes bytes each (row_bytes % 16 == 0, 16-byte
// aligned), idx [B] int64 on the device with 0 <= idx < n_rows, out: B rows.
int mpo_gather_rows(const void* pool, const long long* idx, void* out, long long row_bytes,
                    long long n_rows, int B, void* stream) {
  if (B < 1 || B > 65535 || row_bytes < 16 || row_bytes % 16 != 0 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long row_words = row_bytes / 16;
  const long long chunks = (row_words + SPAN - 1) / SPAN;
  if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<dim3((unsigned)chunks, (unsigned)B), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pool), idx, static_cast<uint4*>(out), row_words, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
