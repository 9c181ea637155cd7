// Streaming masked distance + top-k for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/topk_dist/topk_dist.py::
// topk_dist_pallas: for every query row of Q[nq, d] the k nearest
// mask-eligible rows of Y[N, d], "l2" = max(|q|^2 + |y|^2 - 2 q.y, 0) or
// "ip" = 1 - q.y, ordered by (distance, id) so that ties go to the lowest
// id; masked or padded candidates never enter, unfilled slots are (inf, -1).
// Like the TPU kernel it takes any k and widens its inputs to f32: Q
// arrives as f32 (the wrapper widens a bf16 Q, a small copy), Y as f32 or
// bf16, read in its own type (a bf16 index moves half the bytes; no f32
// copy of it is made).
//
// What bounds it on an H100: at the exact tier's main-path shape
// (nq = 64, N = 2^20, d = 128) the kernel must read Y, 512 MiB in f32
// (0.160 ms at 3.35 TB/s), 256 MiB in bf16 (0.080 ms). The f32 contraction
// is 17.2 GFLOP: 0.256 ms at the 67 TFLOP/s f32 FMA peak, 0.104 ms as
// exact-f32 3xTF32 on the tensor cores (495 / 3 TFLOP/s); a bf16 Y needs
// two TF32 products, not three (0.069 ms). The least time of an exact-f32
// route is the byte time; why 3xTF32 and not TF32 or FMA: the header.
//
// Two routes, switched on k:
//   k <= 128 (MAX_K; every caller's k = 10 and the batcher's tiers): the
//   streaming route below, never forming [q, N];
//   k > 128: the lists no longer fit shared memory beside the ring (64 x k
//   x 8 bytes), so the wrapper walks the queries in chunks whose distance
//   rows fit 256 MiB of scratch: topk_dist_rows forms the rows with the
//   same contraction and the same distance expression (`form`, so both
//   routes give the same bits), masked and padded candidates at +inf, and
//   topk_dist_select finds each row's k-th (distance, id) by radix select,
//   compacts the survivors in id order and sorts them by a stable LSD
//   radix sort on the distance: (distance, id) order, no library sort.
//
// Design of the streaming route (../../_csrc/contract.cuh holds the
// contraction core):
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
// Shared memory: the ring (3-6 stages of 16 KiB, + 8 KiB per Q slice when Q
// is not resident; 2 KiB of mbarriers and alignment), the resident Q tile
// (8 KiB per 128-byte slice of Q's row: 32 KiB at d = 128, f32 or a bf16
// Y's padded f32 Q), lists BQ x k x 8 bytes and buffers BQ x BN x 8 bytes
// (64 KiB): 6 stages at k = 10, d = 128; 4 at k = 128. ptxas (-Xptxas -v,
// CUDA 12.8): topk_dist_partial 187 registers (f32 Y), 212 (bf16 Y);
// topk_dist_rows 181, 206; topk_dist_select 40 (18 KiB of static shared
// memory); topk_dist_merge 32; no spills, no stack.
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

// The distance of dot product a, in both routes: rounded explicitly, so
// that the compiler cannot contract it differently in the two kernels.
__device__ __forceinline__ float form(float a, float xq, float yy, bool l2) {
  return l2 ? fmaxf(__fmaf_rn(-2.f, a, __fadd_rn(xq, yy)), 0.f)
            : __fsub_rn(1.f, a);
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
            const float dist = form(a, xq, yv[j][e], l2);
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

// Q slices per Y slice: 2 for a bf16 Y (Q stays f32), else 1.
template <typename TY>
__host__ __device__ constexpr int qps() {
  return (int)(sizeof(float) / sizeof(TY));
}

// d: Y's row length in elements; dq: Q's (f32), d or, for a bf16 Y, d
// padded to a multiple of 64.
template <typename TY>
__global__ void __launch_bounds__(THREADS, 1)
topk_dist_partial(const __grid_constant__ CUtensorMap mapQ,
                  const __grid_constant__ CUtensorMap mapY,
                  const float* __restrict__ Q,
                  const uint8_t* __restrict__ mask,
                  int nq, int N, int d, int dq, int k, int metric,
                  int tiles_per_split, int splits, int q_resident,
                  int stages, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
  extern __shared__ __align__(1024) char smem[];
  const int slices = (dq * 4 + ROW_BYTES - 1) / ROW_BYTES;
  const Ring R(smem, slices, q_resident != 0, stages, qps<TY>());
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
  if (l2) query_norms(Q, nq, dq, q0, qq);
  __syncthreads();

  Select sel{mask, nq, N, k, q0, l2, qq, cnt, fill, Ld, Li, Cd, Ci};
  run<TY, float>(&mapQ, &mapY, d, q0, t_begin, t_end, q_resident != 0, l2, R,
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

// ---------------------------------------------------------------------------
// The large-k route: distance rows, then a radix select per row.
// ---------------------------------------------------------------------------

// The rows epilogue: D[q][n] = form(...) for n < N, +inf where masked.
// Columns N .. ld - 1 of a row may be written with anything; the select
// never reads them.
struct Rows {
  const uint8_t* mask;
  float* D;
  int nq, N, ld, q0;
  bool l2;
  const float* qq;

  __device__ void operator()(int t, Frag& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
    float yv[4][2];
    if (l2) f.norms(yv, tq);
    const int n0 = t * BN + 32 * wn + 2 * tq;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * mi + 8 * h + g, q = q0 + r;
        if (q >= nq) continue;
        const float xq = l2 ? qq[r] : 0.f;
        float* row = D + (size_t)q * ld;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j;   // even; n + 1 < ld (ld % 4 == 0)
          if (n >= N) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = form(f.dot[mi][j][2 * h + e], xq, yv[j][e], l2);
            if (mask != nullptr && n + e < N && __ldg(mask + n + e) == 0)
              v[e] = INFINITY;
          }
          __stcs(reinterpret_cast<float2*>(row + n), make_float2(v[0], v[1]));
        }
      }
  }
};

template <typename TY>
__global__ void __launch_bounds__(THREADS, 1)
topk_dist_rows(const __grid_constant__ CUtensorMap mapQ,
               const __grid_constant__ CUtensorMap mapY,
               const float* __restrict__ Q, const uint8_t* __restrict__ mask,
               int nq, int N, int d, int dq, int metric, int tiles_per_split,
               int q_resident, int stages, int ld, float* __restrict__ D) {
  extern __shared__ __align__(1024) char smem[];
  const int slices = (dq * 4 + ROW_BYTES - 1) / ROW_BYTES;
  const Ring R(smem, slices, q_resident != 0, stages, qps<TY>());
  float* qq = reinterpret_cast<float*>(R.rest(smem, slices, q_resident));
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (N + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const bool l2 = metric == 0;
  if (threadIdx.x == 0) R.init();
  if (l2) query_norms(Q, nq, dq, q0, qq);
  __syncthreads();
  Rows w{mask, D, nq, N, ld, q0, l2, qq};
  run<TY, float>(&mapQ, &mapY, d, q0, t_begin, t_end, q_resident != 0, l2, R,
                 w);
}

constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_VEC = 8;                        // row values a thread loads
constexpr int SEL_TILE = SEL_THREADS * SEL_VEC;   // at once (two float4)
constexpr uint32_t KEY_INF = 0xff800000u;         // key(+inf)

// The order-preserving key of a distance: unsigned order = float order
// (-0 counts as +0).
__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float value_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Add one to hist[dg] for every lane with `on`, one atomic per distinct
// digit in the warp. Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(int* hist, int dg, bool on) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL, on ? dg : -1);
  if (on && lane == __ffs(peers) - 1) atomicAdd(hist + dg, __popc(peers));
}

// Exclusive prefix sum of v over the block, in thread order; *total gets
// the sum. Every thread calls it; it synchronises the block.
__device__ __forceinline__ int block_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < SEL_WARPS ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < SEL_WARPS) sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp ? sums[warp - 1] : 0) + x - v;
  *total = sums[SEL_WARPS - 1];
  __syncthreads();
  return before;
}

// SEL_VEC keys of row values [i0, i0 + SEL_VEC): +inf's key past N.
__device__ __forceinline__ void load_keys(const float* row, int i0, int N,
                                          uint32_t (&kv)[SEL_VEC]) {
  float v[SEL_VEC];
  if (i0 + SEL_VEC <= N) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(row + i0));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(row + i0 + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < SEL_VEC; ++e)
      v[e] = i0 + e < N ? __ldcs(row + i0 + e) : INFINITY;
  }
#pragma unroll
  for (int e = 0; e < SEL_VEC; ++e) kv[e] = key_of(v[e]);
}

// One block per distance row (ld values, N of them candidates): the row's
// k smallest (distance, id) into out_d / out_i[k] (row stride k), sorted,
// padded with (inf, -1); sk / si[kk] (kk = min(k, N)) is the sort's
// second buffer. Masked candidates are +inf and never selected.
__global__ void __launch_bounds__(SEL_THREADS)
topk_dist_select(const float* __restrict__ D, int N, int ld, int k, int kk,
                 float* __restrict__ out_d, int* __restrict__ out_i,
                 uint32_t* __restrict__ sk, int* __restrict__ si) {
  __shared__ int hist[256];
  __shared__ int wcnt[SEL_WARPS][256];
  __shared__ int sums[SEL_WARPS];
  __shared__ int bcast[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = D + (size_t)blockIdx.x * ld;
  uint32_t* ak = reinterpret_cast<uint32_t*>(out_d + (size_t)blockIdx.x * k);
  int* ai = out_i + (size_t)blockIdx.x * k;
  sk += (size_t)blockIdx.x * kk;
  si += (size_t)blockIdx.x * kk;

  // 1. Radix select, 8 bits a pass from the top: the k-th smallest key T
  // among the finite values, and how many values equal to T to take
  // (`need`, the lowest ids first). Fewer than k finite values: take all.
  uint32_t prefix = 0, pmask = 0;
  int need = k;
  bool take_all = false;
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < N; t0 += SEL_TILE) {
      uint32_t kv[SEL_VEC];
      load_keys(row, t0 + SEL_VEC * tid, N, kv);
#pragma unroll
      for (int e = 0; e < SEL_VEC; ++e)
        hist_add(hist, (kv[e] >> shift) & 255,
                 kv[e] < KEY_INF && (kv[e] & pmask) == prefix);
    }
    __syncthreads();
    if (tid == 0) {
      int cum = 0, b = 0;
      for (; b < 256; ++b) {
        if (cum + hist[b] >= need) break;
        cum += hist[b];
      }
      // b == 256: fewer than k finite values (first pass only)
      bcast[0] = b;
      bcast[1] = need - cum;
    }
    __syncthreads();
    const int b = bcast[0];
    need = bcast[1];
    __syncthreads();
    if (b == 256) {
      take_all = true;
      break;
    }
    prefix |= (uint32_t)b << shift;
    pmask |= 0xffu << shift;
  }

  // 2. Compact the selected values in id order into ak / ai: every finite
  // value below T, and the first `need` equal to T.
  int m = 0, eq_seen = 0;
  for (int t0 = 0; t0 < N; t0 += SEL_TILE) {
    const int i0 = t0 + SEL_VEC * tid;
    uint32_t kv[SEL_VEC];
    load_keys(row, i0, N, kv);
    int lt = 0, eq = 0;
#pragma unroll
    for (int e = 0; e < SEL_VEC; ++e) {
      const bool fin = kv[e] < KEY_INF;
      lt += take_all ? fin : (fin && kv[e] < prefix);
      eq += !take_all && fin && kv[e] == prefix;
    }
    int total;
    const int before = block_scan(lt | (eq << 16), sums, &total);
    const int quota = max(need - eq_seen, 0);
    int eq_before = before >> 16;
    int pos = m + (before & 0xffff) + min(eq_before, quota);
#pragma unroll
    for (int e = 0; e < SEL_VEC; ++e) {
      const bool fin = kv[e] < KEY_INF;
      bool take = take_all ? fin : (fin && kv[e] < prefix);
      if (!take_all && fin && kv[e] == prefix) take = eq_before++ < quota;
      if (take) {
        ak[pos] = kv[e];
        ai[pos] = i0 + e;
        ++pos;
      }
    }
    m += (total & 0xffff) + min(total >> 16, quota);
    eq_seen += total >> 16;
  }
  __syncthreads();

  // 3. Stable LSD radix sort of the m survivors by key, 8 bits a pass,
  // ak -> sk -> ak -> sk -> ak; they arrive in id order, so equal keys
  // stay in id order. Each pass: a histogram, the digits' offsets, then
  // tiles of SEL_THREADS in order, each element placed at its digit's
  // offset + the count of equal digits before it (earlier warps:
  // wcnt's column prefix; earlier lanes: __match_any_sync).
  for (int i = tid; i < SEL_WARPS * 256; i += SEL_THREADS)
    (&wcnt[0][0])[i] = 0;
  for (int p = 0; p < 4; ++p) {
    const int shift = 8 * p;
    const uint32_t* srck = p & 1 ? sk : ak;
    const int* srci = p & 1 ? si : ai;
    uint32_t* dstk = p & 1 ? ak : sk;
    int* dsti = p & 1 ? ai : si;
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < m; t0 += SEL_THREADS) {
      const int i = t0 + tid;
      hist_add(hist, i < m ? (srck[i] >> shift) & 255 : 0, i < m);
    }
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int b = 0; b < 256; ++b) {
        const int c = hist[b];
        hist[b] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < m; t0 += SEL_THREADS) {
      const int i = t0 + tid;
      const bool valid = i < m;
      const uint32_t key = valid ? srck[i] : 0;
      const int id = valid ? srci[i] : 0;
      const int dg = valid ? (int)((key >> shift) & 255) : 256;
      const unsigned peers = __match_any_sync(FULL, dg);
      const int rank = __popc(peers & ((1u << lane) - 1));
      if (valid && lane == __ffs(peers) - 1) wcnt[warp][dg] = __popc(peers);
      __syncthreads();
      if (tid < 256) {
        int run = hist[tid];
        for (int w = 0; w < SEL_WARPS; ++w) {
          const int c = wcnt[w][tid];
          wcnt[w][tid] = run;
          run += c;
        }
        hist[tid] = run;
      }
      __syncthreads();
      if (valid) {
        const int pos = wcnt[warp][dg] + rank;
        dstk[pos] = key;
        dsti[pos] = id;
      }
      __syncthreads();
      for (int j = tid; j < SEL_WARPS * 256; j += SEL_THREADS)
        (&wcnt[0][0])[j] = 0;
      __syncthreads();
    }
  }

  // 4. Keys back to distances; (inf, -1) past the survivors.
  for (int j = tid; j < k; j += SEL_THREADS) {
    if (j < m) {
      out_d[(size_t)blockIdx.x * k + j] = value_of(ak[j]);
    } else {
      out_d[(size_t)blockIdx.x * k + j] = INFINITY;
      ai[j] = -1;
    }
  }
}

// Shared memory, residency and tensor maps of a contraction launch.
struct Plan {
  int smem, stages;
  bool q_resident;
  CUtensorMap mapQ, mapY;
};

template <typename TY>
int plan(Plan& P, const void* kern, const float* Q, const void* Y, int nq,
         int N, int d, int dq, int fixed) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int slices = (dq * 4 + ROW_BYTES - 1) / ROW_BYTES;
  P.smem = plan_ring(max_smem, slices, fixed, P.q_resident, P.stages,
                     qps<TY>());
  if (P.smem == 0) return (int)cudaErrorInvalidConfiguration;
  if (int e = make_map(&P.mapQ, Q, 4, dq, nq, BQ)) return e;
  if (int e = make_map(&P.mapY, Y, (int)sizeof(TY), d, N, BN)) return e;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
}

template <typename TY>
int launch_partial(const float* Q, const void* Y, const uint8_t* mask,
                   int nq, int N, int d, int dq, int k, int metric,
                   int tiles_per_split, int splits, float* part_d,
                   int* part_i, float* out_d, int* out_i, cudaStream_t s) {
  // |q|^2, counts, fills, lists and candidate buffers beside ring and Q
  const int fixed = 3 * BQ * 4 + 2 * BQ * k * 4 + 2 * BQ * BN * 4;
  Plan P;
  if (int e = plan<TY>(P, (const void*)topk_dist_partial<TY>, Q, Y, nq, N, d,
                       dq, fixed))
    return e;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  topk_dist_partial<TY><<<grid, THREADS, P.smem, s>>>(
      P.mapQ, P.mapY, Q, mask, nq, N, d, dq, k, metric, tiles_per_split,
      splits, P.q_resident, P.stages, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  topk_dist_merge<<<(nq + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32,
                    0, s>>>(part_d, part_i, nq, splits, k, out_d, out_i);
  return (int)cudaGetLastError();
}

template <typename TY>
int launch_rows(const float* Q, const void* Y, const uint8_t* mask, int nq,
                int N, int d, int dq, int metric, int tiles_per_split,
                int splits, int ld, float* D, cudaStream_t s) {
  Plan P;
  if (int e = plan<TY>(P, (const void*)topk_dist_rows<TY>, Q, Y, nq, N, d,
                       dq, BQ * 4))
    return e;
  dim3 grid((nq + BQ - 1) / BQ, splits);
  topk_dist_rows<TY><<<grid, THREADS, P.smem, s>>>(
      P.mapQ, P.mapY, Q, mask, nq, N, d, dq, metric, tiles_per_split,
      P.q_resident, P.stages, ld, D);
  return (int)cudaGetLastError();
}

bool bad_args(const float* Q, const void* Y, int nq, int N, int d, int dq,
              int ytype, int metric, int tiles_per_split, int splits) {
  const int per = ytype == 0 ? 4 : 8;   // elements in 16 bytes
  return nq < 1 || N < 1 || d < 1 || d % per != 0 ||
         (ytype != 0 && ytype != 1) || (metric != 0 && metric != 1) ||
         (ytype == 0 ? dq != d : (dq % 64 != 0 || dq < d || dq - d >= 64)) ||
         splits < 1 || tiles_per_split < 1 ||
         (reinterpret_cast<uintptr_t>(Q) | reinterpret_cast<uintptr_t>(Y)) %
             16;
}

}  // namespace

extern "C" {

int topk_dist_max_k() { return MAX_K; }

// The streaming route (k <= MAX_K), on `stream`: writes out_d/out_i[nq, k].
// Q is f32 [nq, dq], Y [N, d] f32 (ytype 0, dq == d) or bf16 (ytype 1, dq =
// d rounded up to a multiple of 64, Q's extra columns zero); Y's row is a
// multiple of 16 bytes and both are 16-byte aligned (the wrapper pads).
// With splits > 1 the caller provides part_d/part_i[nq, splits, k]
// scratch; with splits == 1 they may be the outputs themselves and the
// merge pass is skipped. Returns cudaGetLastError() (0 on success).
int topk_dist_launch(const float* Q, const void* Y, const uint8_t* mask,
                     int nq, int N, int d, int dq, int ytype, int k,
                     int metric, int tiles_per_split, int splits,
                     float* part_d, int* part_i, float* out_d, int* out_i,
                     void* stream) {
  if (bad_args(Q, Y, nq, N, d, dq, ytype, metric, tiles_per_split, splits) ||
      k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return ytype == 0
      ? launch_partial<float>(Q, Y, mask, nq, N, d, dq, k, metric,
                              tiles_per_split, splits, part_d, part_i, out_d,
                              out_i, s)
      : launch_partial<__nv_bfloat16>(Q, Y, mask, nq, N, d, dq, k, metric,
                                      tiles_per_split, splits, part_d, part_i,
                                      out_d, out_i, s);
}

// The large-k route for one chunk of queries, on `stream`: D[nq, ld] (ld a
// multiple of 4, >= N) gets the distance rows (+inf where masked), then
// out_d/out_i[nq, k] the k smallest of each, sorted by (distance, id) and
// padded with (inf, -1); sk/si[nq, min(k, N)] is the sort's scratch. Q and
// Y as for topk_dist_launch. Returns cudaGetLastError().
int topk_dist_large_launch(const float* Q, const void* Y,
                           const uint8_t* mask, int nq, int N, int d, int dq,
                           int ytype, int k, int metric, int tiles_per_split,
                           int splits, int ld, float* D, float* out_d,
                           int* out_i, uint32_t* sk, int* si, void* stream) {
  if (bad_args(Q, Y, nq, N, d, dq, ytype, metric, tiles_per_split, splits) ||
      k < 1 || ld < N || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(D) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int err = ytype == 0
      ? launch_rows<float>(Q, Y, mask, nq, N, d, dq, metric, tiles_per_split,
                           splits, ld, D, s)
      : launch_rows<__nv_bfloat16>(Q, Y, mask, nq, N, d, dq, metric,
                                   tiles_per_split, splits, ld, D, s);
  if (err != 0) return err;
  topk_dist_select<<<nq, SEL_THREADS, 0, s>>>(D, N, ld, k, k < N ? k : N,
                                              out_d, out_i, sk, si);
  return (int)cudaGetLastError();
}

}  // extern "C"
