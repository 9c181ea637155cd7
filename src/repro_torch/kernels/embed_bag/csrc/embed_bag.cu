// EmbeddingBag (gather + segment sum) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/embed_bag/embed_bag.py::
// embed_bag_pallas (with the mean of its wrapper, ops.py): out[b] is the
// f32 sum of table[idx[b, l]] over the bag's valid indices (-1 is padding),
// and "mean" divides by max(count of idx >= 0, 1). Indices at or past V
// contribute nothing, as in the TPU kernel's one-hot.
//
// What bounds it on an H100: one add per gathered value, so bytes. At
// wide-deep's shapes (a 1,000,000 x 32 f32 table, 128-byte rows, bags of
// 32): 4,096 bags with ~10% padding read ~118k distinct rows (15 MB) plus
// ids and output, 0.0046 ms at 3.35 TB/s; serve_bulk, 262,144 bags with
// ~30% padding, 997,236 distinct rows (128 MB) plus 34 MB of ids and 34 MB
// of output, 0.058 ms. There the table is 2.5x the 50 MB L2, so most of
// the 5.87 M gathers are random 128-byte reads from HBM (0.224 ms to read
// each gathered row once at the peak rate); only L2 hits on re-read rows
// take a kernel below that.
//
// Design: the TPU kernel turns the gather into one-hot matmuls over
// vocabulary tiles because a TPU has no fast gather. Hopper gathers
// directly, so this kernel reads only the rows it needs, and keeps as many
// of them in flight as it can:
//   * a warp per bag, split into 32 / G lane groups of G lanes (G = the
//     16-byte loads across a row, rounded up to a power of two, at most
//     32); each group gathers a different row, a lane 16 bytes of it (4
//     f32 or 8 bf16 values; one value where D or the table's alignment
//     does not allow 16 bytes). At D = 32 that is 4 rows a load
//     instruction in f32, 8 in bf16; D = 128 f32 takes one row across the
//     warp; a D past 32 loads takes several column passes;
//   * each lane issues up to U = 8 row loads before its first add (all 8
//     of a bag of 32 at D = 32 f32: the bag's 4 KB in flight per warp),
//     then adds them in row order in f32; the groups' partial sums meet by
//     __shfl_xor_sync in a fixed butterfly, so repeated runs give the same
//     bits (no atomics);
//   * a persistent grid (as many blocks as fit on the card at once) walks
//     the bags grid-stride; each warp loads the next bag's ids while the
//     current bag's rows are in flight;
//   * cache policy per access: ids are loaded and the output stored with
//     the streaming hint (ld/st.global.cs), table rows with an L2
//     evict_last policy (createpolicy + L2::cache_hint), so the L2 keeps
//     table rows rather than streams. Nothing process-wide is set (no
//     persisting-L2 carve-out, no access-policy window).
//
// At serve_bulk on the H100 this runs within ~10% of the gather-once time:
// the random 128-byte reads from HBM bound it. tools/embed_bag_variants.py
// times the alternatives (PERF.md, Findings): other L2 policies and stream
// hints move it by ~1%; 16 loads a lane cost occupancy and run slower; the
// TPU kernel's loop order (vocabulary slabs that stay in L2, one pass
// each) re-reads the ids and read-modify-writes the output every pass and
// runs slower from two slabs on. ptxas (CUDA 12.8): 64 registers on the
// 16-byte paths (the bf16 one spills 20 bytes), 40 on the one-value path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int U = 8;   // row loads in flight per lane
constexpr unsigned FULL = 0xffffffffu;

// 32-bit words of one lane's load: 16 bytes, or one value.
template <typename T, int VPL>
__host__ __device__ constexpr int words() {
  return VPL * (int)sizeof(T) >= 4 ? VPL * (int)sizeof(T) / 4 : 1;
}

template <typename T, int VPL>
__device__ __forceinline__ void load_row(const T* p, uint64_t pol,
                                         uint32_t (&w)[words<T, VPL>()]) {
  if constexpr (VPL * sizeof(T) == 16) {
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
        : "l"(p), "l"(pol));
  } else if constexpr (sizeof(T) == 4) {
    asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
        : "=r"(w[0])
        : "l"(p), "l"(pol));
  } else {
    unsigned short h;
    asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
        : "=h"(h)
        : "l"(p), "l"(pol));
    w[0] = h;
  }
}

// acc += the widened values of one load.
template <typename T, int VPL>
__device__ __forceinline__ void add_row(float (&acc)[VPL],
                                        const uint32_t (&w)[words<T, VPL>()]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[e] += __uint_as_float(w[e]);
  } else if constexpr (VPL == 1) {
    acc[0] += __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int e = 0; e < VPL / 2; ++e) {
      acc[2 * e] += __uint_as_float(w[e] << 16);
      acc[2 * e + 1] += __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

template <int VPL>
__device__ __forceinline__ void store(float* dst, const float (&v)[VPL]) {
  if constexpr (VPL % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VPL; e += 4)
      __stcs(reinterpret_cast<float4*>(dst + e),
             make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
  } else {
#pragma unroll
    for (int e = 0; e < VPL; ++e) __stcs(dst + e, v[e]);
  }
}

// VPL values a lane load; G lanes a group (a power of two, lg = log2 G).
template <typename T, int VPL>
__global__ void __launch_bounds__(WARPS * 32)
embed_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                 int B, int L, int V, int D, int lg, int mean,
                 float* __restrict__ out) {
  constexpr int W = words<T, VPL>();
  const int lane = threadIdx.x & 31;
  const int G = 1 << lg, R = 32 >> lg;       // lanes a group, rows a load
  const int gi = lane >> lg, gl = lane & (G - 1);
  const int C = D / VPL;                      // lane loads across a row
  const int stride = gridDim.x * WARPS;
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));

  int bag = blockIdx.x * WARPS + (threadIdx.x >> 5);
  int next = bag < B && lane < L ? __ldcs(idx + (size_t)bag * L + lane) : -1;
  for (; bag < B; bag += stride) {
    const int* ids = idx + (size_t)bag * L;
    const int head = next;   // the bag's first 32 ids, loaded a bag ago
    const int nb = bag + stride;
    next = nb < B && lane < L ? __ldcs(idx + (size_t)nb * L + lane) : -1;
    int count = 0;
    for (int c0 = 0; c0 < C; c0 += G) {
      const int c = c0 + gl;
      const bool active = c < C;
      float acc[VPL];
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[e] = 0.f;
      for (int l0 = 0; l0 < L; l0 += 32) {
        const int j = l0 == 0 ? head
                              : (l0 + lane < L ? __ldcs(ids + l0 + lane) : -1);
        if (c0 == 0) count += __popc(__ballot_sync(FULL, j >= 0));
        const int n = min(32, L - l0);
        for (int b0 = 0; b0 < n; b0 += R * U) {
          uint32_t w[U][W];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = b0 + R * u + gi;
            const int jj = __shfl_sync(FULL, j, r & 31);
            if (active && r < n && jj >= 0 && jj < V) {
              load_row<T, VPL>(table + (size_t)jj * D + (size_t)c * VPL, pol,
                               w[u]);
            } else {
#pragma unroll
              for (int e = 0; e < W; ++e) w[u][e] = 0u;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) add_row<T, VPL>(acc, w[u]);
        }
      }
      for (int o = G; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < VPL; ++e)
          acc[e] += __shfl_xor_sync(FULL, acc[e], o);
      if (gi == 0 && active) {
        if (mean) {
          const float cnt = (float)max(count, 1);
#pragma unroll
          for (int e = 0; e < VPL; ++e) acc[e] = acc[e] / cnt;
        }
        store<VPL>(out + (size_t)bag * D + (size_t)c * VPL, acc);
      }
    }
  }
}

template <typename T, int VPL>
int launch(const void* table, const int* idx, int B, int L, int V, int D,
           int mean, float* out, cudaStream_t s) {
  const int C = D / VPL;
  int lg = 0;
  while ((1 << lg) < C && lg < 5) ++lg;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, embed_bag_kernel<T, VPL>, WARPS * 32, 0);
  if (err != cudaSuccess) return (int)err;
  const int need = (B + WARPS - 1) / WARPS;
  const int room = sms * (per_sm > 0 ? per_sm : 1);
  embed_bag_kernel<T, VPL><<<need < room ? need : room, WARPS * 32, 0, s>>>(
      static_cast<const T*>(table), idx, B, L, V, D, lg, mean, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The lane-group layout a launch takes: packed as values a lane load (VPL)
// * 64 + lanes a group (G), for the report.
int embed_bag_layout(int D, int dtype, int vec) {
  const int vpl = vec ? (dtype == 0 ? 4 : 8) : 1;
  const int C = D / vpl;
  int g = 1;
  while (g < C && g < 32) g <<= 1;
  return vpl * 64 + g;
}

// Launch on `stream`: writes out[B, D] (f32). dtype 0 = f32, 1 = bf16
// table; vec 1 loads 16 bytes a lane and needs D a multiple of 16 bytes
// (4 f32, 8 bf16) and a 16-byte aligned table (vec 0 takes any D); mean 0
// = "sum", 1 = "mean". Returns cudaGetLastError().
int embed_bag_launch(const void* table, const int* idx, int B, int L, int V,
                     int D, int dtype, int vec, int mean, float* out,
                     void* stream) {
  const int per = dtype == 0 ? 4 : 8;
  if (B < 1 || L < 1 || V < 1 || D < 1 || (dtype != 0 && dtype != 1) ||
      (vec != 0 && vec != 1) ||
      (vec && (D % per != 0 || reinterpret_cast<uintptr_t>(table) % 16)) ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch<float, 4>(table, idx, B, L, V, D, mean, out, s)
               : launch<float, 1>(table, idx, B, L, V, D, mean, out, s);
  return vec ? launch<__nv_bfloat16, 8>(table, idx, B, L, V, D, mean, out, s)
             : launch<__nv_bfloat16, 1>(table, idx, B, L, V, D, mean, out, s);
}

}  // extern "C"
