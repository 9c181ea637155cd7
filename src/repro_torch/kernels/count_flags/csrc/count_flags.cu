// Count the set flags of a byte matrix for Hopper (sm_90a), plain C interface.
//
// count = sum of flags[r, c] over r < rows, c < cols, for a contiguous
// [rows, width] matrix of bytes that are 0 or 1 (a bool tensor), summed
// into one unsigned 64-bit word. The lockstep search counts its visited
// rows with it: `visited` is [lanes, N + 1] (column N is the sink that
// invalid neighbours scatter into), 32,768 x 262,145 bytes in the search
// cells, 8.6 GB.
//
// What bounds it: one read of every byte, so HBM bytes (2.6 ms for 8.6 GB
// at 3.35 TB/s). PyTorch's own bool sum widens its input to int64 first,
// and past 2^31 bytes splits a reduction into 32-bit-indexable pieces.
//
// Design: the whole matrix is summed as one flat array, and the columns at
// and past `cols` are taken off row by row. A 0/1 byte is one set bit, so
// the population count of a 16-byte word is the number of flags in it.
//   * a persistent grid (16 blocks an SM) walks the 16-byte words
//     grid-stride with 64-bit offsets, four loads in flight a thread, each
//     with the streaming hint (ld.global.cs: the flags are read once);
//   * the bytes before the first 16-byte boundary and after the last word
//     are added one by one, as are the excluded columns' bytes taken off;
//   * a thread's count wraps modulo 2^64 (the columns it takes off may lie
//     in another thread's words); warps and blocks reduce it by shuffles
//     and shared memory, and one atomicAdd a block adds it into the
//     result, which the launcher zeroes first. Unsigned sums wrap, so the
//     total is exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int BLOCKS_PER_SM = 16;

__device__ __forceinline__ unsigned long long popc16(uint4 w) {
  return (unsigned long long)(__popc(w.x) + __popc(w.y) + __popc(w.z) +
                              __popc(w.w));
}

__global__ void __launch_bounds__(THREADS)
count_flags_kernel(const unsigned char* __restrict__ f, long long n,
                   long long head, long long rows, long long width,
                   long long cols, unsigned long long* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const uint4* v = reinterpret_cast<const uint4*>(f + head);
  const long long nv = (n - head) / 16;
  unsigned long long acc = 0;

  long long i = tid;
  for (; i + (UNROLL - 1) * stride < nv; i += UNROLL * stride) {
    uint4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) w[u] = __ldcs(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += popc16(w[u]);
  }
  for (; i < nv; i += stride) acc += popc16(__ldcs(v + i));

  const long long tail = head + nv * 16;
  if (tid < head) acc += f[tid];
  if (tid < n - tail) acc += f[tail + tid];
  for (long long r = tid; r < rows; r += stride)
    for (long long c = cols; c < width; ++c) acc -= f[r * width + c];

  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ unsigned long long warp_sum[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < THREADS / 32 ? warp_sum[threadIdx.x] : 0ull;
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (threadIdx.x == 0) atomicAdd(out, acc);
  }
}

}  // namespace

extern "C" {

// Zero *out and count flags[:rows, :cols] of the [rows, width] bytes at
// `flags` into it, on `stream`. Returns cudaGetLastError() (0 on success).
int count_flags_launch(const void* flags, long long rows, long long width,
                       long long cols, void* out, void* stream) {
  if (rows < 0 || width < 0 || cols < 0 || cols > width)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const long long n = rows * width;
  if (n == 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(flags);
  long long head = (long long)((16 - p % 16) % 16);
  if (head > n) head = n;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long work = (n - head) / 16 / UNROLL;
  if (work < rows) work = rows;
  if (work < 16) work = 16;
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long room = (long long)sms * BLOCKS_PER_SM;
  if (blocks > room) blocks = room;
  count_flags_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const unsigned char*>(flags), n, head, rows, width, cols,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
