// EmbeddingBag (gather + segment sum) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/embed_bag/embed_bag.py::
// embed_bag_pallas (with the mean of its wrapper, ops.py): out[b] is the
// f32 sum of table[idx[b, l]] over the bag's valid indices (-1 is padding),
// and "mean" divides by max(count of idx >= 0, 1). Indices at or past V
// contribute nothing, as in the TPU kernel's one-hot.
//
// What bounds it on an H100: it does one add per gathered element, so it
// is bound by bytes: the gathered rows (at a wide-deep shape, 4096 bags of
// 32 indices over a 1,000,000 x 32 f32 table, ~118k valid rows of 128 B,
// ~15 MB) plus the indices and the output, ~5 us at 3.35 TB/s.
//
// Design: the TPU kernel turns the gather into one-hot matmuls over
// vocabulary tiles because a TPU has no fast gather. Hopper gathers
// directly, so this kernel reads only the rows it needs:
//   * one warp per bag, lanes across D: a lane takes 4 adjacent columns
//     (one 16-byte float4, or 8 bytes of bf16) where D % 4 == 0 and the
//     table is aligned, else one column; a D wider than 32 lanes takes
//     several passes;
//   * each index is loaded once, by one lane, 32 at a time, and broadcast
//     to the warp with __shfl_sync; padding is skipped;
//   * rows are loaded four at a time so that four gathers are in flight,
//     then added in l order in f32, whatever the table's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&v)[VEC]);

template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p,
                                                   float (&v)[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p,
                                                   float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
embed_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                 int B, int L, int V, int D, int mean,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;   // warp-uniform; no block barrier follows
  const int* bag = idx + (size_t)b * L;
  const int chunks = D / VEC;

  for (int cb = 0; cb < chunks; cb += 32) {
    const int c = cb + lane;
    const bool active = c < chunks;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    int count = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int j = l0 + lane < L ? __ldg(bag + l0 + lane) : -1;
      count += __popc(__ballot_sync(FULL, j >= 0));
      const int n = min(32, L - l0);
      for (int t = 0; t < n; t += UNROLL) {
        float v[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int jj = __shfl_sync(FULL, j, (t + u) & 31);
          if (active && t + u < n && jj >= 0 && jj < V) {
            load_row<T, VEC>(table + (size_t)jj * D + (size_t)c * VEC, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += v[u][e];
      }
    }
    if (!active) continue;
    const float cnt = (float)max(count, 1);
    float* dst = out + (size_t)b * D + (size_t)c * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = mean ? acc[e] / cnt : acc[e];
  }
}

template <typename T>
int launch(const void* table, const int* idx, int B, int L, int V, int D,
           int vec, int mean, float* out, cudaStream_t s) {
  const int blocks = (B + WARPS - 1) / WARPS;
  if (vec == 4)
    embed_bag_kernel<T, 4><<<blocks, WARPS * 32, 0, s>>>(
        static_cast<const T*>(table), idx, B, L, V, D, mean, out);
  else
    embed_bag_kernel<T, 1><<<blocks, WARPS * 32, 0, s>>>(
        static_cast<const T*>(table), idx, B, L, V, D, mean, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`: writes out[B, D] (f32). dtype 0 = f32, 1 = bf16
// table; vec 4 needs D % 4 == 0 and a table aligned to 4 elements (vec 1
// takes any D); mean 0 = "sum", 1 = "mean". Returns cudaGetLastError().
int embed_bag_launch(const void* table, const int* idx, int B, int L, int V,
                     int D, int dtype, int vec, int mean, float* out,
                     void* stream) {
  if (B < 1 || L < 1 || V < 1 || D < 1 || (dtype != 0 && dtype != 1) ||
      (vec != 1 && vec != 4) || (vec == 4 && D % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0
      ? launch<float>(table, idx, B, L, V, D, vec, mean, out, s)
      : launch<__nv_bfloat16>(table, idx, B, L, V, D, vec, mean, out, s);
}

}  // extern "C"
