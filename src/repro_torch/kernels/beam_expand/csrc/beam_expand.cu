// One expansion step of the lockstep beam search for Hopper (sm_90a),
// plain C interface.
//
// It replaces no TPU kernel: the reference's search_layer is plain jnp
// (src/repro/core/search.py). It was added because the port's expansion,
// as whole PyTorch tensors, took about half of the bulk search's device
// time, most of it on rows that were already visited.
//
// For each lane b (one query) that is running, expanding the candidate
// c = cur[b]:
//   nb[s]    = nbrs[c, s] for s < M0 (-1 is padding; valid: nb[s] >= 0)
//   fresh[s] = valid && !visited[b, nb[s]], judged on the flags as they
//              stood before this step (an id twice in one row is fresh twice)
//   visited[b, nb[s]] = 1 for every valid slot
//   nd[b, s] = dist(Q[b], X[nb[s]]) where fresh, else +inf
//   ni[b, s] = nb[s] where fresh, else -1
// A lane that is not running reads no row, sets no flag, and gets
// (+inf, -1) in every slot. Column N of `visited` (the plain form's sink
// for invalid slots) is never written.
//
// Distances round as core/metrics.py states: "l2" is sum((x - q)^2) with
// the difference in the inputs' common dtype (rounded to bf16 or f16 when
// both are), its square and the sum in f32; "ip" is 1 - sum(x * q) in f32.
// Rows are f32, bf16 or f16, queries f32 or the rows' dtype.
//
// What bounds it: bytes, read at random. A step of the search cells (32,768
// lanes, M0 32, d 128 f32) reads the fresh rows, ~24% of 32 a lane at 512 B
// each (~130 MB), 4 MB of neighbour rows and ~1M flag sectors; the plain
// form gathers every slot's row into a [B, M0, d] tensor and passes over it
// three more times, finished lanes and seen rows included.
//
// Design: one warp a lane (M0 = 32 is the warp width; up to 128 slots, four
// a thread).
//   * thread j reads slot j of the lane's neighbour row (one coalesced
//     load) and that slot's flag; __syncwarp orders every read before the
//     writes, then each fresh slot's flag is set (a valid slot that is not
//     fresh is set already, so every valid slot ends set, and no seen
//     flag's sector is written back);
//   * a ballot compacts the fresh slots into a list in shared memory, beside
//     the lane's query (widened to f32 once a lane);
//   * the warp splits into groups of G threads, G the power of two at or
//     above the row's vector chunks (32 at d 128 f32, 16 at d 128 bf16,
//     32 at d 100 f32 with 25 busy), so a pass reads 32 / G rows, and
//     UNROLL passes' loads are in flight at once; each thread scores its
//     chunks against the query and a shuffle sum within the group gives a
//     row's distance;
//   * the distances go to shared memory by slot, and thread j writes slot
//     j's (nd, ni): coalesced.
// The chunk is the widest load (16, 8, 4 or 2 bytes) that divides the row
// and the base address. Blocks hold up to 8 lanes; each lane's shared
// memory is its query plus three lists of MAX_SLOTS words.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // lanes a block at most, one warp each
constexpr int MAX_SLOTS = 128;       // M0 at most: four slots a thread
constexpr int SLOTS_PER_THREAD = MAX_SLOTS / 32;
constexpr int UNROLL = 4;            // passes of rows in flight a warp
constexpr int SMEM_BYTES = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

enum Form { L2 = 0, L2_ROUNDED = 1, IP = 2 };   // L2_ROUNDED: the diff in T
enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

template <int LB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// f32 rounded to T and widened back (round to nearest even, as PyTorch's
// bf16 and f16 arithmetic rounds its f32 result).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

template <typename T, int FORM>
__device__ __forceinline__ float term(float acc, float x, float q) {
  if (FORM == IP) return fmaf(x, q, acc);
  float diff = x - q;
  if (FORM == L2_ROUNDED) diff = round_to<T>(diff);
  return fmaf(diff, diff, acc);
}

// Shared floats a lane holds: its query, rounded up to whole float4s, then
// the fresh rows, their slots and the distances by slot.
__host__ __device__ __forceinline__ long long lane_words(long long d) {
  return (d + 3) / 4 * 4 + 3 * MAX_SLOTS;
}

template <typename T, int LB, int FORM>
__global__ void __launch_bounds__(WARPS * 32)
beam_expand_kernel(const void* __restrict__ Q, int q_dtype,
                   const T* __restrict__ X, const int* __restrict__ nbrs,
                   const long long* __restrict__ cur,
                   const bool* __restrict__ running,
                   unsigned char* __restrict__ visited, long long B, int d,
                   int M0, long long width, int chunks, int group,
                   float* __restrict__ nd, long long* __restrict__ ni) {
  using RawT = typename Raw<LB>::type;
  constexpr int VEC = LB / (int)sizeof(T);
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  float* qs = smem + warp * lane_words(d);
  int* rows = reinterpret_cast<int*>(qs + (d + 3) / 4 * 4);
  int* slot_of = rows + MAX_SLOTS;
  float* dist = reinterpret_cast<float*>(slot_of + MAX_SLOTS);
  float* ndb = nd + b * M0;
  long long* nib = ni + b * M0;
  if (!running[b]) {
    for (int s = t; s < M0; s += 32) {
      ndb[s] = CUDART_INF_F;
      nib[s] = -1;
    }
    return;
  }

  if (q_dtype == F32) {
    const float* q = static_cast<const float*>(Q) + b * d;
    for (int i = t; i < d; i += 32) qs[i] = q[i];
  } else {                               // the rows' own dtype
    const T* q = static_cast<const T*>(Q) + b * d;
    for (int i = t; i < d; i += 32) qs[i] = widen(q[i]);
  }

  const int* nrow = nbrs + cur[b] * M0;
  unsigned char* vrow = visited + b * width;
  int nb[SLOTS_PER_THREAD];
  bool fresh[SLOTS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < SLOTS_PER_THREAD; ++k) {
    const int s = t + 32 * k;
    nb[k] = s < M0 ? __ldg(nrow + s) : -1;
    fresh[k] = nb[k] >= 0 && !vrow[nb[k]];
  }
  __syncwarp();                          // every flag read before any write
  int nfresh = 0;
#pragma unroll
  for (int k = 0; k < SLOTS_PER_THREAD; ++k) {
    if (fresh[k]) vrow[nb[k]] = 1;       // a valid slot not fresh is set
    const unsigned m = __ballot_sync(FULL, fresh[k]);
    if (fresh[k]) {
      const int pos = nfresh + __popc(m & ((1u << t) - 1u));
      rows[pos] = nb[k];
      slot_of[pos] = t + 32 * k;
    }
    nfresh += __popc(m);
  }
  __syncwarp();                          // the query and the list are shared

  const int g = t & (group - 1), r = t / group, per_pass = 32 / group;
  for (int base = 0; base < nfresh; base += per_pass * UNROLL) {
    long long row[UNROLL];
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = base + u * per_pass + r;
      row[u] = k < nfresh ? rows[k] : -1;
      acc[u] = 0.f;
    }
    for (int c = g; c < chunks; c += group) {
      RawT x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (row[u] >= 0)
          x[u] = __ldg(reinterpret_cast<const RawT*>(X + row[u] * d) + c);
      float q[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) q[e] = qs[c * VEC + e];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (row[u] < 0) continue;
        const T* xe = reinterpret_cast<const T*>(&x[u]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[u] = term<T, FORM>(acc[u], widen(xe[e]), q[e]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      for (int o = group >> 1; o > 0; o >>= 1)
        acc[u] += __shfl_xor_sync(FULL, acc[u], o);
    if (g == 0) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = base + u * per_pass + r;
        if (k < nfresh) dist[slot_of[k]] = FORM == IP ? 1.f - acc[u] : acc[u];
      }
    }
  }
  __syncwarp();                          // every distance is in place

#pragma unroll
  for (int k = 0; k < SLOTS_PER_THREAD; ++k) {
    const int s = t + 32 * k;
    if (s < M0) {
      ndb[s] = fresh[k] ? dist[s] : CUDART_INF_F;
      nib[s] = fresh[k] ? (long long)nb[k] : -1ll;
    }
  }
}

struct Args {
  const void* Q;
  int q_dtype;
  const void* X;
  const int* nbrs;
  const long long* cur;
  const bool* running;
  unsigned char* visited;
  long long B, width;
  int d, M0, chunks, group, warps;
  size_t smem;
  float* nd;
  long long* ni;
  cudaStream_t stream;
};

template <typename T, int LB, int FORM>
int launch(const Args& a) {
  const long long blocks = (a.B + a.warps - 1) / a.warps;
  beam_expand_kernel<T, LB, FORM><<<(unsigned)blocks, a.warps * 32, a.smem,
                                    a.stream>>>(
      a.Q, a.q_dtype, static_cast<const T*>(a.X), a.nbrs, a.cur, a.running,
      a.visited, a.B, a.d, a.M0, a.width, a.chunks, a.group, a.nd, a.ni);
  return (int)cudaGetLastError();
}

template <typename T, int FORM>
int launch_width(const Args& a, int lb) {
  switch (lb) {
    case 16: return launch<T, 16, FORM>(a);
    case 8: return launch<T, 8, FORM>(a);
    case 4: return launch<T, 4, FORM>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int FORM>
int launch_half(const Args& a, int lb) {
  if (lb == 2) return launch<T, 2, FORM>(a);
  return launch_width<T, FORM>(a, lb);
}

template <typename T>
int launch_form(const Args& a, int lb, int ip) {
  if (ip) return launch_half<T, IP>(a, lb);
  return a.q_dtype == F32 ? launch_half<T, L2>(a, lb)
                          : launch_half<T, L2_ROUNDED>(a, lb);
}

}  // namespace

extern "C" {

int beam_expand_max_slots() { return MAX_SLOTS; }

// The widest query one lane's shared memory holds.
int beam_expand_max_dim() {
  return (int)((SMEM_BYTES / 4 - lane_words(0)) / 4 * 4);
}

// Expand one beam step on `stream` (see the top of this file). X is
// [rows, d] of x_dtype (0 f32, 1 bf16, 2 f16); Q is [B, d] of q_dtype, f32
// or x_dtype; ip picks the form (0 "l2", 1 "ip"); nbrs [rows, M0] int32;
// cur [B] int64;
// running [B] bool; visited [B, width] bytes, updated; nd [B, M0] f32 and
// ni [B, M0] int64 are written whole. All contiguous. Returns
// cudaGetLastError() (0 on success).
int beam_expand_launch(const void* Q, int q_dtype, const void* X, int x_dtype,
                       int ip, const void* nbrs, const void* cur,
                       const void* running, void* visited, long long B,
                       long long d, long long M0, long long width, void* nd,
                       void* ni, void* stream) {
  if (B < 0 || d < 1 || d > beam_expand_max_dim() || M0 < 0 ||
      M0 > MAX_SLOTS || width < 1 || B > 0x7fffffffll * WARPS ||
      x_dtype < F32 || x_dtype > F16 || (q_dtype != F32 && q_dtype != x_dtype))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M0 == 0) return 0;
  const int es = x_dtype == F32 ? 4 : 2;
  const long long row_bytes = d * es;
  const uintptr_t p = reinterpret_cast<uintptr_t>(X);
  int lb = 16;
  while (lb > es && (row_bytes % lb || p % lb)) lb >>= 1;
  Args a;
  a.Q = Q;
  a.q_dtype = q_dtype;
  a.X = X;
  a.nbrs = static_cast<const int*>(nbrs);
  a.cur = static_cast<const long long*>(cur);
  a.running = static_cast<const bool*>(running);
  a.visited = static_cast<unsigned char*>(visited);
  a.B = B;
  a.width = width;
  a.d = (int)d;
  a.M0 = (int)M0;
  a.chunks = (int)(row_bytes / lb);
  a.group = 1;
  while (a.group < 32 && a.group < a.chunks) a.group <<= 1;
  const size_t lane_bytes = (size_t)lane_words(d) * 4;
  a.warps = (int)(SMEM_BYTES / lane_bytes);
  if (a.warps > WARPS) a.warps = WARPS;
  a.smem = lane_bytes * a.warps;
  a.nd = static_cast<float*>(nd);
  a.ni = static_cast<long long*>(ni);
  a.stream = reinterpret_cast<cudaStream_t>(stream);
  if (x_dtype == F32) return ip ? launch_width<float, IP>(a, lb)
                                : launch_width<float, L2>(a, lb);
  if (x_dtype == BF16) return launch_form<__nv_bfloat16>(a, lb, ip);
  return launch_form<__half>(a, lb, ip);
}

}  // extern "C"
