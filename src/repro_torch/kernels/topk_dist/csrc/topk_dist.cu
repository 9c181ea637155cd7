// Streaming masked distance + top-k for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/topk_dist/topk_dist.py::
// topk_dist_pallas: for every query row of Q[nq, d] the k nearest
// mask-eligible rows of Y[N, d], "l2" = max(|q|^2 + |y|^2 - 2 q.y, 0) or
// "ip" = 1 - q.y, ordered by (distance, id) so that ties go to the lowest
// id; masked or padded candidates never enter, unfilled slots are (inf, -1).
//
// What bounds it on an H100: at the exact tier's main-path shape
// (nq = 64, N = 2^20, d = 128, f32) the kernel must read Y, 512 MiB:
// 0.160 ms at 3.35 TB/s. The contraction is 17.2 GFLOP: 0.256 ms at the
// 67 TFLOP/s f32 FMA peak, 0.104 ms as exact-f32 3xTF32 on the tensor
// cores (495 / 3 TFLOP/s). The least time of an exact-f32 route is the
// byte time, 0.160 ms; why 3xTF32 and not TF32 or FMA: the header.
//
// Design (../../_csrc/contract.cuh holds the contraction core):
//   * grid = query tiles (BQ = 64) x splits of N, one block per SM (the
//     shared memory below allows one); each block walks a contiguous run
//     of 128-candidate tiles through the TMA ring;
//   * selection runs on the accumulators: each distance is formed in the
//     fragment's registers and tested against its query's current k-th
//     (distance, id) (`before`, so a tie at the k-th with a lower id still
//     enters); the few survivors (~k (1 + ln(tiles / k)) per query after
//     the first tile) are appended to a per-query buffer in shared memory
//     (atomicAdd on a per-query count). Masked candidates and rows past N
//     never reach it. After each tile the buffers are merged into the
//     sorted lists, so the next tile's test sees fresh k-th entries: for
//     k <= 32 one thread per query inserts from the tail; for larger k a
//     warp per query with the list in registers;
//   * a second kernel merges each query's per-split lists into the final k
//     (skipped when there is one split).
//
// Shared memory: the ring (3-6 stages of 16 KiB, + 8 KiB each when Q is not
// resident; 2 KiB of mbarriers and alignment), the resident Q tile (8 KiB
// per 128-byte slice of d: 32 KiB at d = 128), lists BQ x k x 8 bytes and
// buffers BQ x BN x 8 bytes (64 KiB): 6 stages at k = 10, d = 128; 4 at
// k = 128. ptxas (-Xptxas -v, CUDA 12.8): topk_dist_partial 185 registers,
// topk_dist_merge 32, no spills, no stack.
#include "../../_csrc/contract.cuh"

#include <math.h>

namespace {

using namespace contract;

constexpr int MAX_K = 128;
constexpr int ROWS = MAX_K / 32;
constexpr int MERGE_WARPS = 4;
constexpr int MERGE_CHUNKS = 4;   // 32-entry chunks a merge warp loads at once

__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// One query's running top-k, sorted by (distance, id), held in a warp's
// registers while it merges candidates: lane L holds positions L + 32 t.
// Positions past k and empty slots hold (inf, -1), which every finite
// candidate beats.
struct WarpList {
  float d[ROWS];
  int i[ROWS];
  int k, lane;

  // Position p of the list at Ld[p * stride], Li[p * stride].
  __device__ __forceinline__ void load(const float* Ld, const int* Li,
                                       int stride) {
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int p = lane + 32 * t;
      d[t] = p < k ? Ld[p * stride] : INFINITY;
      i[t] = p < k ? Li[p * stride] : -1;
    }
  }
  __device__ __forceinline__ void store(float* Ld, int* Li, int stride) const {
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int p = lane + 32 * t;
      if (p < k) { Ld[p * stride] = d[t]; Li[p * stride] = i[t]; }
    }
  }
  // The k-th entry, in every lane.
  __device__ __forceinline__ void kth(float& kd, int& ki) const {
    const int t = (k - 1) >> 5, src = (k - 1) & 31;
    float v = d[0];
    int w = i[0];
#pragma unroll
    for (int u = 1; u < ROWS; ++u)
      if (t == u) { v = d[u]; w = i[u]; }
    kd = __shfl_sync(FULL, v, src);
    ki = __shfl_sync(FULL, w, src);
  }
  // Insert (cd, cid), the same in every lane, which beats the k-th entry:
  // count the entries before it, then shift the rest up one position.
  __device__ __forceinline__ void insert(float cd, int cid) {
    const int rows = (k + 31) >> 5;
    int pos = 0;
#pragma unroll
    for (int t = 0; t < ROWS; ++t)
      if (t < rows)
        pos += __popc(__ballot_sync(FULL, before(d[t], i[t], cd, cid)));
#pragma unroll
    for (int t = ROWS - 1; t >= 0; --t) {
      if (t >= rows) continue;
      float ud = __shfl_up_sync(FULL, d[t], 1);
      int ui = __shfl_up_sync(FULL, i[t], 1);
      if (t > 0) {
        const float cd0 = __shfl_sync(FULL, d[t - 1], 31);
        const int ci0 = __shfl_sync(FULL, i[t - 1], 31);
        if (lane == 0) { ud = cd0; ui = ci0; }
      }
      const int p = lane + 32 * t;
      if (p > pos) { d[t] = ud; i[t] = ui; }
      else if (p == pos) { d[t] = cd; i[t] = cid; }
    }
  }
  // Offer one candidate per lane (has = false for none).
  __device__ __forceinline__ void offer(float cd, int cid, bool has) {
    float kd;
    int ki;
    kth(kd, ki);
    unsigned m = __ballot_sync(FULL, has && before(cd, cid, kd, ki));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float c = __shfl_sync(FULL, cd, src);
      const int ci = __shfl_sync(FULL, cid, src);
      if (!before(c, ci, kd, ki)) continue;   // warp-uniform
      insert(c, ci);
      kth(kd, ki);
    }
  }
};

// Per-block selection state in shared memory, and the tile epilogue. The
// lists and buffers are stored query-minor ([position][BQ]), so the threads
// that each merge one query touch consecutive words.
struct Select {
  const uint8_t* mask;
  int nq, N, k, q0;
  bool l2;
  const float* qq;   // [BQ] |q|^2
  int* cnt;          // [BQ] entries in each candidate buffer
  int* fill;         // [BQ] entries in each list (k <= 32 only)
  float* Ld;         // [k][BQ] sorted lists
  int* Li;
  float* Cd;         // [BN][BQ] candidate buffers
  int* Ci;

  // Merge the candidate buffers into the lists and empty them: warp w
  // takes the 8 queries 8 w + l. For k <= 32 lane l < 8 takes query l,
  // inserting from the tail (after the first tiles a survivor is rare and
  // lands near the end); for larger k, where a serial insertion walks up to
  // k entries, the warp takes its queries one by one, with the list in
  // registers and warp-wide insertion.
  __device__ void flush() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = 8 * warp;
    if (k <= 32) {
      if (lane >= 8) return;
      const int r = r0 + lane, c = cnt[r];
      int n = fill[r];   // entries in the list (k once full)
      float kd = Ld[(k - 1) * BQ + r];
      int ki = Li[(k - 1) * BQ + r];
      for (int e = 0; e < c; ++e) {
        const float cd = Cd[e * BQ + r];
        const int ci = Ci[e * BQ + r];
        if (!before(cd, ci, kd, ki)) continue;
        int p = n < k ? n++ : k - 1;   // the new entry's slot, then down
        for (; p > 0; --p) {
          const float pd = Ld[(p - 1) * BQ + r];
          const int pi = Li[(p - 1) * BQ + r];
          if (!before(cd, ci, pd, pi)) break;
          Ld[p * BQ + r] = pd;
          Li[p * BQ + r] = pi;
        }
        Ld[p * BQ + r] = cd;
        Li[p * BQ + r] = ci;
        if (n == k) {
          kd = Ld[(k - 1) * BQ + r];
          ki = Li[(k - 1) * BQ + r];
        }
      }
      fill[r] = n;
      cnt[r] = 0;
      return;
    }
    const int mine = lane < 8 ? cnt[r0 + lane] : 0;
    unsigned todo = __ballot_sync(FULL, mine > 0);
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      const int r = r0 + l, c = __shfl_sync(FULL, mine, l);
      WarpList L{{}, {}, k, lane};
      L.load(Ld + r, Li + r, BQ);
      for (int o = 0; o < c; o += 32) {
        const int e = o + lane;
        const bool has = e < c;
        L.offer(has ? Cd[e * BQ + r] : INFINITY, has ? Ci[e * BQ + r] : -1,
                has);
      }
      L.store(Ld + r, Li + r, BQ);
      if (lane == 0) cnt[r] = 0;
    }
  }

  __device__ void operator()(int t, Frag& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
    float yv[4][2];
    if (l2) f.norms(yv, tq);
    __syncthreads();   // the last flush is done: fresh k-th, empty buffers
    const int n0 = t * BN + 32 * wn + 2 * tq;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * mi + 8 * h + g;
        if (q0 + r >= nq) continue;
        const float kd = Ld[(k - 1) * BQ + r];
        const int ki = Li[(k - 1) * BQ + r];
        const float xq = l2 ? qq[r] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * j + e;
            const float a = f.dot[mi][j][2 * h + e];
            const float dist =
                l2 ? fmaxf(xq + yv[j][e] - 2.f * a, 0.f) : 1.f - a;
            if (n < N && before(dist, n, kd, ki) &&
                (mask == nullptr || __ldg(mask + n) != 0)) {
              const int slot = atomicAdd(cnt + r, 1);
              Cd[slot * BQ + r] = dist;
              Ci[slot * BQ + r] = n;
            }
          }
      }
    __syncthreads();
    flush();
  }
};

__global__ void __launch_bounds__(THREADS, 1)
topk_dist_partial(const __grid_constant__ CUtensorMap mapQ,
                  const __grid_constant__ CUtensorMap mapY,
                  const float* __restrict__ Q,
                  const uint8_t* __restrict__ mask,
                  int nq, int N, int d, int k, int metric,
                  int tiles_per_split, int splits, int q_resident,
                  int stages, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
  extern __shared__ __align__(1024) char smem[];
  const int slices = (d * 4 + ROW_BYTES - 1) / ROW_BYTES;
  const Ring R(smem, slices, q_resident != 0, stages);
  float* qq = reinterpret_cast<float*>(R.rest(smem, slices, q_resident));
  int* cnt = reinterpret_cast<int*>(qq + BQ);
  int* fill = cnt + BQ;
  float* Ld = reinterpret_cast<float*>(fill + BQ);
  int* Li = reinterpret_cast<int*>(Ld + BQ * k);
  float* Cd = reinterpret_cast<float*>(Li + BQ * k);
  int* Ci = reinterpret_cast<int*>(Cd + BQ * BN);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int n_tiles = (N + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const bool l2 = metric == 0;

  if (tid == 0) R.init();
  for (int i = tid; i < BQ * k; i += THREADS) { Ld[i] = INFINITY; Li[i] = -1; }
  if (tid < BQ) cnt[tid] = fill[tid] = 0;
  if (l2) query_norms(Q, nq, d, q0, qq);
  __syncthreads();

  Select sel{mask, nq, N, k, q0, l2, qq, cnt, fill, Ld, Li, Cd, Ci};
  run<float>(&mapQ, &mapY, d, q0, t_begin, t_end, q_resident != 0, l2, R,
             sel);
  __syncthreads();   // every tile's epilogue has flushed

  for (int i = tid; i < BQ * k; i += THREADS) {
    const int r = i / k, j = i % k, q = q0 + r;
    if (q < nq) {
      const size_t o = ((size_t)q * splits + split) * k + j;
      part_d[o] = Ld[j * BQ + r];
      part_i[o] = Li[j * BQ + r];
    }
  }
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
topk_dist_merge(const float* __restrict__ part_d,
                const int* __restrict__ part_i, int nq, int splits, int k,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= nq) return;   // warp-uniform; no block barrier follows
  WarpList L{{}, {}, k, lane};
#pragma unroll
  for (int t = 0; t < ROWS; ++t) { L.d[t] = INFINITY; L.i[t] = -1; }
  const size_t base = (size_t)q * splits * k;
  const int total = splits * k;
  for (int c = 0; c < total; c += 32 * MERGE_CHUNKS) {
    float dv[MERGE_CHUNKS];
    int iv[MERGE_CHUNKS];
#pragma unroll
    for (int u = 0; u < MERGE_CHUNKS; ++u) {   // loads in flight together
      const int e = c + 32 * u + lane;
      dv[u] = e < total ? part_d[base + e] : INFINITY;
      iv[u] = e < total ? part_i[base + e] : -1;
    }
#pragma unroll
    for (int u = 0; u < MERGE_CHUNKS; ++u)
      L.offer(dv[u], iv[u], dv[u] < INFINITY);
  }
  L.store(out_d + (size_t)q * k, out_i + (size_t)q * k, 1);
}

}  // namespace

extern "C" {

int topk_dist_max_k() { return MAX_K; }

// Launch on `stream`: writes out_d/out_i[nq, k]. d is the row length in
// floats and must be a multiple of 4, with Q and Y 16-byte aligned (the
// wrapper pads). With splits > 1 the caller provides part_d/part_i[nq,
// splits, k] scratch; with splits == 1 they may be the outputs themselves
// and the merge pass is skipped. Returns cudaGetLastError() (0 on success).
int topk_dist_launch(const float* Q, const float* Y, const uint8_t* mask,
                     int nq, int N, int d, int k, int metric,
                     int tiles_per_split, int splits, float* part_d,
                     int* part_i, float* out_d, int* out_i, void* stream) {
  if (nq < 1 || N < 1 || d < 1 || d % 4 != 0 || k < 1 || k > MAX_K ||
      splits < 1 || tiles_per_split < 1 || (metric != 0 && metric != 1) ||
      (reinterpret_cast<uintptr_t>(Q) | reinterpret_cast<uintptr_t>(Y)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int slices = (d * 4 + ROW_BYTES - 1) / ROW_BYTES;
  // |q|^2, counts, fills, lists and candidate buffers beside ring and Q
  const int fixed = 3 * BQ * 4 + 2 * BQ * k * 4 + 2 * BQ * BN * 4;
  bool q_resident = false;
  int stages = 0;
  const int smem = plan_ring(max_smem, slices, fixed, q_resident, stages);
  if (smem == 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap mapQ, mapY;
  if (int e = make_map(&mapQ, Q, 4, d, nq, BQ)) return e;
  if (int e = make_map(&mapY, Y, 4, d, N, BN)) return e;
  err = cudaFuncSetAttribute(topk_dist_partial,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  topk_dist_partial<<<grid, THREADS, smem, s>>>(
      mapQ, mapY, Q, mask, nq, N, d, k, metric, tiles_per_split, splits,
      q_resident, stages, part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  topk_dist_merge<<<(nq + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32,
                    0, s>>>(part_d, part_i, nq, splits, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
