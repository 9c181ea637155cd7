// Dense pairwise distance matrix for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/l2dist/l2dist.py::l2dist_pallas:
// out[i, j] for X[nq, d] and Y[N, d], f32 or bf16 inputs, f32 accumulation
// over d, in form "l2" = max(|x|^2 + |y|^2 - 2 x.y, 0) (the clamp of the
// plain version, repro/kernels/l2dist/ref.py; the TPU body does not clamp)
// or "ip" = 1 - x.y.
//
// What bounds it on an H100: at a serving batch against a SIFT1M-sized
// index (nq = 64, N = 2^20, d = 128) the bytes are Y read once (512 MiB
// f32, 256 MiB bf16) plus the f32 output written once (256 MiB): 0.240 ms
// (f32) and 0.160 ms (bf16) at 3.35 TB/s. The f32 contraction (17.2 GFLOP)
// takes 0.104 ms as exact-f32 3xTF32 on the tensor cores (0.256 ms as f32
// FMA), bf16 0.017 ms: both are bound by bytes.
//
// Design (../../_csrc/contract.cuh holds the contraction core and why
// 3xTF32):
//   * grid = query tiles (BQ = 64) x splits of N, as many blocks as fit on
//     the card at once; each block walks a contiguous run of 128-candidate
//     tiles through the TMA ring; f32 runs 3xTF32 mma.sync, bf16 one
//     m16n8k16 bf16 mma per fragment, f32 accumulation for both;
//   * |x|^2 once per block, |y|^2 from the fragment registers (f32 FMA);
//   * the epilogue forms the distances in the accumulator registers,
//     clamps, and writes them straight from the fragments: each quad of
//     lanes writes 32 contiguous bytes of a row (8-byte streaming stores,
//     st.global.cs, so the 256 MiB output does not evict Y from L2), and a
//     warp's four column tiles cover 128 contiguous bytes of the row.
//
// Shared memory: the ring (3-6 stages of 16 KiB, + 8 KiB each when X is not
// resident; 2 KiB of mbarriers and alignment), the resident X tile (8 KiB
// per 128-byte slice of d), |x|^2. ptxas (-Xptxas -v, CUDA 12.8):
// l2dist_kernel<float> 181 registers, <__nv_bfloat16> 173, no spills, no
// stack.
#include "../../_csrc/contract.cuh"

namespace {

using namespace contract;

// The tile epilogue: distances from the accumulators, straight to `out`.
struct Write {
  float* out;
  int nq, N, q0;
  bool l2;
  const float* xx;   // [BQ] |x|^2

  __device__ void operator()(int t, Frag& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
    float yv[4][2];
    if (l2) f.norms(yv, tq);
    const int n0 = t * BN + 32 * wn + 2 * tq;
    const bool pairs = (N & 1) == 0;   // 8-byte aligned (q, n even)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * mi + 8 * h + g, q = q0 + r;
        if (q >= nq) continue;
        const float xq = l2 ? xx[r] : 0.f;
        float* row = out + (size_t)q * N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j;
          if (n >= N) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = f.dot[mi][j][2 * h + e];
            v[e] = l2 ? fmaxf(xq + yv[j][e] - 2.f * a, 0.f) : 1.f - a;
          }
          if (pairs) {
            __stcs(reinterpret_cast<float2*>(row + n),
                   make_float2(v[0], v[1]));
          } else {
            __stcs(row + n, v[0]);
            if (n + 1 < N) __stcs(row + n + 1, v[1]);
          }
        }
      }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
l2dist_kernel(const __grid_constant__ CUtensorMap mapX,
              const __grid_constant__ CUtensorMap mapY,
              const T* __restrict__ X, int nq, int N, int d, int metric,
              int tiles_per_split, int q_resident, int stages,
              float* __restrict__ out) {
  extern __shared__ __align__(1024) char smem[];
  const int slices = (d * (int)sizeof(T) + ROW_BYTES - 1) / ROW_BYTES;
  const Ring R(smem, slices, q_resident != 0, stages);
  float* xx = reinterpret_cast<float*>(R.rest(smem, slices, q_resident));
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (N + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const bool l2 = metric == 0;
  if (threadIdx.x == 0) R.init();
  if (l2) query_norms(X, nq, d, q0, xx);
  __syncthreads();
  Write w{out, nq, N, q0, l2, xx};
  run<T>(&mapX, &mapY, d, q0, t_begin, t_end, q_resident != 0, l2, R, w);
}

// Shared memory, residency and grid of one launch; returns a CUDA error.
template <typename T>
int launch(const T* X, const T* Y, int nq, int N, int d, int metric,
           float* out, cudaStream_t s) {
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int slices = (d * (int)sizeof(T) + ROW_BYTES - 1) / ROW_BYTES;
  bool q_resident = false;
  int stages = 0;
  const int smem = plan_ring(max_smem, slices, BQ * 4, q_resident, stages);
  if (smem == 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap mapX, mapY;
  if (int e = make_map(&mapX, X, (int)sizeof(T), d, nq, BQ)) return e;
  if (int e = make_map(&mapY, Y, (int)sizeof(T), d, N, BN)) return e;
  err = cudaFuncSetAttribute(l2dist_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, l2dist_kernel<T>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (nq + BQ - 1) / BQ;
  const int n_tiles = (N + BN - 1) / BN;
  const int room = sms * (per_sm > 0 ? per_sm : 1) / q_tiles;
  int splits = room < 1 ? 1 : (room < n_tiles ? room : n_tiles);
  const int tps = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + tps - 1) / tps;
  dim3 grid(q_tiles, splits);
  l2dist_kernel<T><<<grid, THREADS, smem, s>>>(mapX, mapY, X, nq, N, d, metric,
                                               tps, q_resident, stages, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`: writes out[nq, N] (f32, row-major). dtype 0 = f32,
// 1 = bf16 (both inputs); metric 0 = "l2", 1 = "ip". A row of X and Y
// (d values) must be a multiple of 16 bytes and both 16-byte aligned (the
// wrapper pads). Returns cudaGetLastError() (0 on success).
int l2dist_launch(const void* X, const void* Y, int nq, int N, int d,
                  int dtype, int metric, float* out, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (nq < 1 || N < 1 || d < 1 || (dtype != 0 && dtype != 1) ||
      (metric != 0 && metric != 1) || (d * itemsize) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const float*>(X), static_cast<const float*>(Y),
                  nq, N, d, metric, out, s);
  return launch(static_cast<const __nv_bfloat16*>(X),
                static_cast<const __nv_bfloat16*>(Y), nq, N, d, metric, out,
                s);
}

}  // extern "C"
