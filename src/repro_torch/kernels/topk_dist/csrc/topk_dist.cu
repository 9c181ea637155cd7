// Streaming masked distance + top-k for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/topk_dist/topk_dist.py::
// topk_dist_pallas: for every query row of Q[nq, d] the k nearest
// mask-eligible rows of Y[N, d], "l2" = max(|q|^2 + |y|^2 - 2 q.y, 0) or
// "ip" = 1 - q.y, ordered by (distance, id) so that ties go to the lowest
// id; masked or padded candidates never enter, unfilled slots are (inf, -1).
//
// What bounds it on an H100: at the exact tier's main-path shape
// (nq = 64, N = 2^20, d = 128, f32) the contraction is 2*64*2^20*128 =
// 17.2 GFLOP, 0.26 ms at the 67 TFLOP/s f32 (non-tensor-core) peak, while
// Y is 512 MiB, 0.16 ms at 3.35 TB/s: the kernel is bound by f32
// operations, and reads Y from device memory once.
//
// Design (simple and correct first; no wgmma, TMA or TF32, which would
// change the distances):
//   * grid = query tiles (BQ = 64 rows) x splits of N; one block streams
//     its split in tiles of BN = 128 candidates through shared memory, d
//     in slices of DT = 32, so any d works (GIST's 960 included);
//   * each thread accumulates a 4 x 8 register tile of q.y with FMA;
//     query tiles cover all 64 queries of a serving batch, so Y is read
//     once per query tile, and the splits give enough blocks to fill the
//     132 SMs;
//   * every warp keeps the running top-k of 8 queries in shared memory, as
//     a list sorted by (distance, id); a tile's candidates are offered 32
//     at a time, a ballot against the current k-th entry rejects almost
//     all of them once the list is full, and survivors are inserted by a
//     warp-wide shift;
//   * a second kernel merges each query's per-split lists into the final
//     k with the same insertion (skipped when there is one split).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BN = 128;
constexpr int DT = 32;
constexpr int THREADS = 256;
constexpr int QS_STRIDE = BQ + 4;   // conflict-free transposed stores
constexpr int YS_STRIDE = BN + 4;
constexpr int MAX_K = 128;
constexpr int MERGE_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Offer one candidate per lane to the sorted list (Ld, Li)[k] that the
// whole warp shares; candidates that beat the k-th entry are inserted one
// by one. Empty slots hold (inf, -1), which every finite candidate beats.
__device__ void warp_offer(float* Ld, int* Li, int k, float cd, int cid,
                           bool has, int lane) {
  float wd = Ld[k - 1];
  int wi = Li[k - 1];
  unsigned m = __ballot_sync(FULL, has && before(cd, cid, wd, wi));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float d = __shfl_sync(FULL, cd, src);
    const int id = __shfl_sync(FULL, cid, src);
    if (!before(d, id, wd, wi)) continue;   // warp-uniform
    int cnt = 0;
    for (int i = lane; i < k; i += 32) cnt += before(Ld[i], Li[i], d, id);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
    float vd[MAX_K / 32] = {0.f, 0.f, 0.f, 0.f};
    int vi[MAX_K / 32] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < MAX_K / 32; ++t) {
      const int i = lane + 32 * t;
      if (i < k && i > cnt) { vd[t] = Ld[i - 1]; vi[t] = Li[i - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < MAX_K / 32; ++t) {
      const int i = lane + 32 * t;
      if (i < k && i > cnt) { Ld[i] = vd[t]; Li[i] = vi[t]; }
    }
    if (lane == 0) { Ld[cnt] = d; Li[cnt] = id; }
    __syncwarp();
    wd = Ld[k - 1];
    wi = Li[k - 1];
  }
}

// Slice element e of a (rows x DT) tile, in 4-row x 8-column patches per
// warp: 32-byte global segments, and transposed shared stores that hit 32
// distinct banks with the padded strides above.
__device__ __forceinline__ void patch_coords(int e, int& row, int& col) {
  const int patch = e >> 5, l = e & 31;
  col = (patch & (DT / 8 - 1)) * 8 + (l & 7);
  row = (patch / (DT / 8)) * 4 + (l >> 3);
}

__global__ void __launch_bounds__(THREADS)
topk_dist_partial(const float* __restrict__ Q, const float* __restrict__ Y,
                  const uint8_t* __restrict__ mask, int nq, int N, int d,
                  int k, int metric, int tiles_per_split, int splits,
                  float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [DT][QS_STRIDE]
  float* Ys = Qs + DT * QS_STRIDE;          // [DT][YS_STRIDE]
  float* Ds = Ys + DT * YS_STRIDE;          // [BQ][BN]
  float* qq = Ds + BQ * BN;                 // [BQ]
  float* yy = qq + BQ;                      // [BN]
  float* Ld = yy + BN;                      // [BQ][k]
  int* Li = reinterpret_cast<int*>(Ld + BQ * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_tiles = (N + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const bool l2 = metric == 0;

  for (int i = tid; i < BQ * k; i += THREADS) { Ld[i] = INFINITY; Li[i] = -1; }
  if (tid < BQ) {
    float s = 0.f;
    const int q = q0 + tid;
    if (l2 && q < nq)
      for (int c = 0; c < d; ++c) {
        const float v = Q[(size_t)q * d + c];
        s = fmaf(v, v, s);
      }
    qq[tid] = s;
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;   // rows ty*4.., columns tx*8..
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * BN;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float ysum = 0.f;
    for (int c0 = 0; c0 < d; c0 += DT) {
#pragma unroll
      for (int it = 0; it < BQ * DT / THREADS; ++it) {
        int row, col;
        patch_coords(it * THREADS + tid, row, col);
        const int q = q0 + row, c = c0 + col;
        Qs[col * QS_STRIDE + row] =
            (q < nq && c < d) ? Q[(size_t)q * d + c] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < BN * DT / THREADS; ++it) {
        int row, col;
        patch_coords(it * THREADS + tid, row, col);
        const int n = n0 + row, c = c0 + col;
        Ys[col * YS_STRIDE + row] =
            (n < N && c < d) ? Y[(size_t)n * d + c] : 0.f;
      }
      __syncthreads();
      if (l2 && tid < BN)
#pragma unroll 8
        for (int kk = 0; kk < DT; ++kk) {
          const float v = Ys[kk * YS_STRIDE + tid];
          ysum = fmaf(v, v, ysum);
        }
#pragma unroll 4
      for (int kk = 0; kk < DT; ++kk) {
        const float4 a =
            *reinterpret_cast<const float4*>(&Qs[kk * QS_STRIDE + ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Ys[kk * YS_STRIDE + tx * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &Ys[kk * YS_STRIDE + tx * 8 + 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < BN) yy[tid] = ysum;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = ty * 4 + i, cc = tx * 8 + j, n = n0 + cc;
        const float dist = l2 ? fmaxf(qq[r] + yy[cc] - 2.f * acc[i][j], 0.f)
                              : 1.f - acc[i][j];
        const bool ok = n < N && (mask == nullptr || mask[n] != 0);
        Ds[r * BN + cc] = ok ? dist : INFINITY;
      }
    __syncthreads();

    for (int qi = 0; qi < BQ / 8; ++qi) {
      const int r = warp * (BQ / 8) + qi;
      if (q0 + r >= nq) break;
      for (int c = 0; c < BN; c += 32) {
        const float dv = Ds[r * BN + c + lane];
        warp_offer(Ld + r * k, Li + r * k, k, dv, n0 + c + lane,
                   dv < INFINITY, lane);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < BQ * k; i += THREADS) {
    const int r = i / k, j = i % k, q = q0 + r;
    if (q < nq) {
      const size_t o = ((size_t)q * splits + split) * k + j;
      part_d[o] = Ld[i];
      part_i[o] = Li[i];
    }
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_dist_merge(const float* __restrict__ part_d,
                const int* __restrict__ part_i, int nq, int splits, int k,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float msmem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  float* Ld = msmem + warp * k;
  int* Li = reinterpret_cast<int*>(msmem + MERGE_WARPS * k) + warp * k;
  if (q >= nq) return;   // warp-uniform; no block barrier follows
  for (int i = lane; i < k; i += 32) { Ld[i] = INFINITY; Li[i] = -1; }
  __syncwarp();
  const size_t base = (size_t)q * splits * k;
  const int total = splits * k;
  for (int c = 0; c < total; c += 32) {
    const int e = c + lane;
    const float dv = e < total ? part_d[base + e] : INFINITY;
    const int iv = e < total ? part_i[base + e] : -1;
    warp_offer(Ld, Li, k, dv, iv, dv < INFINITY, lane);
  }
  for (int i = lane; i < k; i += 32) {
    out_d[(size_t)q * k + i] = Ld[i];
    out_i[(size_t)q * k + i] = Li[i];
  }
}

}  // namespace

extern "C" {

int topk_dist_max_k() { return MAX_K; }

// Launch on `stream`: writes out_d/out_i[nq, k]. With splits > 1 the
// caller provides part_d/part_i[nq, splits, k] scratch; with splits == 1
// they may be the outputs themselves and the merge pass is skipped.
// Returns cudaGetLastError() (0 on success).
int topk_dist_launch(const float* Q, const float* Y, const uint8_t* mask,
                     int nq, int N, int d, int k, int metric,
                     int tiles_per_split, int splits, float* part_d,
                     int* part_i, float* out_d, int* out_i, void* stream) {
  if (nq < 1 || N < 1 || d < 1 || k < 1 || k > MAX_K || splits < 1 ||
      tiles_per_split < 1 || (metric != 0 && metric != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) *
      (DT * QS_STRIDE + DT * YS_STRIDE + BQ * BN + BQ + BN + 2 * BQ * k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_dist_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  topk_dist_partial<<<grid, THREADS, smem, s>>>(
      Q, Y, mask, nq, N, d, k, metric, tiles_per_split, splits, part_d,
      part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t msmem = sizeof(float) * 2 * MERGE_WARPS * k;
  topk_dist_merge<<<(nq + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32,
                    msmem, s>>>(part_d, part_i, nq, splits, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
