// The contraction core shared by topk_dist.cu and l2dist.cu (sm_90a).
//
// A block owns BQ = 64 query rows (the A operand) and walks a contiguous run
// of candidate tiles, BN = 128 rows of Y each (the B operand). d is cut into
// slices of 128 bytes (32 f32 or 64 bf16 values); the callers pad a row to a
// multiple of 16 bytes (TMA's stride rule), and a partial last slice is
// zero-filled.
//
// Loads: a ring of 3 to 6 slices of Y in shared memory (as many as fit
// beside the rest), filled by TMA (cp.async.bulk.tensor, 2-D, 128-byte
// swizzle, zero fill past N and past d) with a "full" and an "empty"
// mbarrier per stage. Thread 0 issues each load stages - 2 slices ahead,
// once every warp has released the stage two slices back; the warps never
// wait on a block barrier for a slice and spend no instructions on loads
// (16-byte cp.async from every thread took a sizeable share of the time in
// a clock64 profile on the H100). A separate producer warp would cap the
// block's registers below what the loop needs (ptxas counts 288 threads as
// 384) and spill. The
// flattened sequence (tile, slice) runs through the ring, so a tile's
// epilogue overlaps the next tile's loads. The Q tile is staged once per
// block when all of its slices fit beside the ring ("resident");
// otherwise (large d) its slice rides in each ring stage beside Y's.
//
// Layout: a slice is [rows][128 B] with the 16-byte chunk index XORed with
// row mod 8 (TMA's 128-byte swizzle, on 1024-byte aligned stages). A
// fragment reads rows g and g + 8 of an m16n8 tile (g = lane / 4), so
// without the swizzle all eight rows would sit on the same four banks.
//
// Math: mma.sync on the tensor cores. 8 warps as 2 (queries, warp / 4) x 4
// (candidates, warp mod 4); a warp's tile is 32 queries x 32 candidates,
// 2 x 4 m16n8 accumulators. The k order inside a slice is permuted so that
// each lane's operands for the four k-steps of a slice are 32 contiguous
// bytes of one row: two conflict-free 16-byte loads per row. The same
// permutation applies to Q and Y, so the sum runs over every column once.
//   * f32: 3xTF32. Each operand value x is split in registers into
//     hi = x rounded to TF32 and lo = x - hi, rounded too (22 of f32's 24
//     significant bits), and lo*hi + hi*lo + hi*hi replace the one product,
//     the small terms first. Plain TF32 keeps ~11 bits and changes the
//     distances; the f32 FMA route cannot reach the byte floor (17.2 GFLOP
//     at 67 TFLOP/s is 0.256 ms against 0.160 ms to read 512 MiB of Y);
//     3xTF32 at 495 / 3 = 165 TFLOP/s would need 0.104 ms. mma.sync does
//     not reach that rate on Hopper: tools/kernel_phases.py puts one
//     m16n8k8 TF32 mma at ~10.6 cycles per SM sub-partition (~38% of the
//     TF32 peak), and the mma issue at ~60% of f32 l2dist's cycles. wgmma
//     is the route to the full rate.
//   * bf16: m16n8k16 bf16 with f32 accumulation, one product per fragment
//     (a bf16 x bf16 product is exact in f32).
//   * f32 Q with bf16 Y (run<__nv_bfloat16, float>, topk_dist's exact tier
//     over a bf16 index): Y is read in its own type, half the bytes. A bf16
//     value widens to f32 exactly and its 8 significant bits fit TF32's 11,
//     so Y's lo half is zero and 3xTF32 loses a product: lo*hi + hi*hi, as
//     exact as an f32 sum. A 128-byte Y slice holds 64 values, so each Y
//     slice pairs with two Q slices (the wrapper pads Q to a multiple of 64
//     columns); lane (g, tq) takes values 16 tq .. 16 tq + 15 of each row
//     (Y: chunks 2 tq, 2 tq + 1; Q: half of one Q slice), as eight k-steps.
//   * |y|^2 is plain f32 FMA over the same fragment registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace contract {

constexpr int BQ = 64;            // query rows of a block
constexpr int BN = 128;           // candidate rows of a tile
constexpr int ROW_BYTES = 128;    // one row of one d slice
constexpr int MIN_STAGES = 3;     // slices in the ring
constexpr int MAX_STAGES = 6;
constexpr int THREADS = 256;      // 8 warps: 2 (queries) x 4 (candidates)
constexpr int Y_SLICE_BYTES = BN * ROW_BYTES;   // 16 KiB
constexpr int Q_SLICE_BYTES = BQ * ROW_BYTES;   //  8 KiB
constexpr unsigned FULL = 0xffffffffu;

// Bytes of dynamic shared memory the ring and the Q tile take; the ring
// starts at a 1024-byte boundary (the swizzle's period), so 1 KiB of slack
// and the 2 MAX_STAGES + 1 mbarriers come first.
constexpr int HEAD_BYTES = 1024 + 1024;
// qps: Q slices per Y slice (2 for f32 Q with bf16 Y, else 1).
__host__ __device__ inline int ring_bytes(bool q_resident, int stages,
                                          int qps = 1) {
  return HEAD_BYTES +
         stages * (Y_SLICE_BYTES + (q_resident ? 0 : qps * Q_SLICE_BYTES));
}
__host__ __device__ inline int q_bytes(bool q_resident, int slices) {
  return q_resident ? slices * Q_SLICE_BYTES : 0;
}
// The ring of one launch beside `fixed` more bytes: the Q tile (`slices`
// Q slices) resident if a ring of MIN_STAGES fits beside it, and as many
// stages (up to MAX_STAGES) as fit. Returns the dynamic shared memory, or 0
// if nothing fits.
inline int plan_ring(int max_smem, int slices, int fixed, bool& q_resident,
                     int& stages, int qps = 1) {
  for (int res = 1; res >= 0; --res) {
    const int room = max_smem - ring_bytes(res, 0, qps) -
                     q_bytes(res, slices) - fixed;
    const int n = room / (ring_bytes(res, 1, qps) - ring_bytes(res, 0, qps));
    if (n >= MIN_STAGES) {
      q_resident = res;
      stages = n < MAX_STAGES ? n : MAX_STAGES;
      return ring_bytes(res, stages, qps) + q_bytes(res, slices) + fixed;
    }
  }
  return 0;
}

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][128 B] slice.
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One TMA box (128 bytes of a row x the map's box rows) at element column
// c0, row r0, into dst; completion counts on bar.
__device__ __forceinline__ void tma_load(char* dst, const CUtensorMap* map,
                                         int c0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// The tensor map of a row-major [rows][d] matrix (d a multiple of 16 bytes,
// 16-byte aligned) in boxes of 128 bytes x box_rows, 128-byte swizzle, zero
// fill out of bounds. cuTensorMapEncodeTiled comes from the driver through
// the runtime, so the library needs no -lcuda. Returns a CUDA error code.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline int make_map(CUtensorMap* map, const void* ptr, int itemsize, int d,
                    int rows, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * itemsize};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW_BYTES / itemsize),
                             (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, itemsize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Split an f32 (as its bits) into two TF32 values, hi + lo ~= x: hi rounds
// x to nearest TF32, ties away from zero (cvt.rna.tf32.f32's rounding, done
// with integer ops at full rate), lo = x - hi is exact, and its own rounding
// to TF32 is the + 0x1000: the tensor cores ignore a TF32 operand's low 13
// bits.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_0(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 32 bytes of row r that lane (g, tq) owns in a slice: chunks 2tq and
// 2tq + 1, as eight 32-bit words.
__device__ __forceinline__ void load_row(uint32_t (&w)[8], const char* s,
                                         int r, int tq) {
  const uint4 lo = *reinterpret_cast<const uint4*>(s + swz(r, 2 * tq));
  const uint4 hi = *reinterpret_cast<const uint4*>(s + swz(r, 2 * tq + 1));
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// One warp's accumulators. dot[mi][j][c]: q.y of query row 32 wm + 16 mi
// + g (+ 8 for c >= 2) and candidate column 32 wn + 8 j + 2 tq (+ 1 for odd
// c). The tensor cores truncate when they add to an accumulator, so a long
// run of mma into one accumulator of steady sign builds up a biased error
// (beyond 1e-4 over d = 960 in f32). So acc holds one slice's products,
// started from zero, and each slice's sum is added to dot in f32, rounded
// to nearest. yn[j]: this lane's share of |y|^2 of candidate 32 wn + 8 j +
// g.
struct Frag {
  float acc[2][4][4];
  float dot[2][4][4];
  float yn[4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[mi][j][c] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) yn[j] = 0.f;
  }
  __device__ __forceinline__ void clear_acc() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][j][c] = 0.f;
  }
  __device__ __forceinline__ void add_acc() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[mi][j][c] += acc[mi][j][c];
  }

  // |y|^2 of the candidates of this lane's accumulator columns:
  // yv[j][e] for column 32 wn + 8 j + 2 tq + e.
  __device__ __forceinline__ void norms(float (&yv)[4][2], int tq) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = yn[j];
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      yv[j][0] = __shfl_sync(FULL, s, (2 * tq) << 2);
      yv[j][1] = __shfl_sync(FULL, s, (2 * tq + 1) << 2);
    }
  }
};

// One 128-byte slice of the contraction: qs is the Q slice [BQ][128 B], ys
// the Y slice [BN][128 B], both swizzled. The last mma run is left in acc,
// for the caller to add (f.add_acc()) once it has issued other work.
template <typename T>
__device__ __forceinline__ void slice_mma(Frag& f, const char* qs,
                                          const char* ys, bool norms, int wm,
                                          int wn, int g, int tq) {
  uint32_t a[2][2][8], b[4][8];
  if constexpr (sizeof(T) == 2) f.clear_acc();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      load_row(a[mi][h], qs, 32 * wm + 16 * mi + 8 * h + g, tq);
#pragma unroll
  for (int j = 0; j < 4; ++j) load_row(b[j], ys, 32 * wn + 8 * j + g, tq);
  if (norms) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        if constexpr (sizeof(T) == 4) {
          const float v = __uint_as_float(b[j][w]);
          f.yn[j] = fmaf(v, v, f.yn[j]);
        } else {
          const float v0 = __uint_as_float(b[j][w] << 16);
          const float v1 = __uint_as_float(b[j][w] & 0xffff0000u);
          f.yn[j] = fmaf(v0, v0, f.yn[j]);
          f.yn[j] = fmaf(v1, v1, f.yn[j]);
        }
      }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if constexpr (sizeof(T) == 4) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        split_tf32(a[mi][0][2 * s], ah[mi][0], al[mi][0]);
        split_tf32(a[mi][1][2 * s], ah[mi][1], al[mi][1]);
        split_tf32(a[mi][0][2 * s + 1], ah[mi][2], al[mi][2]);
        split_tf32(a[mi][1][2 * s + 1], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(b[j][2 * s], bh[j][0], bl[j][0]);
        split_tf32(b[j][2 * s + 1], bh[j][1], bl[j][1]);
      }
      // The two small products, then hi*hi; each pass runs over all eight
      // accumulators, so no mma waits on the one before it.
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s == 0)
            mma_tf32_0(f.acc[mi][j], al[mi], bh[j][0], bh[j][1]);
          else
            mma_tf32(f.acc[mi][j], al[mi], bh[j][0], bh[j][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(f.acc[mi][j], ah[mi], bl[j][0], bl[j][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(f.acc[mi][j], ah[mi], bh[j][0], bh[j][1]);
    } else {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint32_t ar[4] = {a[mi][0][2 * s], a[mi][1][2 * s],
                                a[mi][0][2 * s + 1], a[mi][1][2 * s + 1]};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(f.acc[mi][j], ar, b[j][2 * s], b[j][2 * s + 1]);
      }
    }
  }
}

// One 128-byte Y slice of f32 Q against bf16 Y: qs holds the two Q slices
// of the same 64 columns, Q_SLICE_BYTES apart. Lane (g, tq) owns columns
// 16 tq .. 16 tq + 15: Y's chunks 2 tq, 2 tq + 1 (word w = columns 16 tq +
// 2w, 2w + 1), Q's in slice tq / 2 at chunks 4 (tq & 1) .. + 3, taken as
// two halves of four k-steps; k-step s of half hh pairs column 16 tq + 8 hh
// + 2 s with k = tq and the next column with k = tq + 4, in A and in B.
// Y widened is exact in TF32 (lo = 0), so each k-step is lo*hi + hi*hi.
__device__ __forceinline__ void slice_mma_mixed(Frag& f, const char* qs,
                                                const char* ys, bool norms,
                                                int wm, int wn, int g,
                                                int tq) {
  uint32_t b[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) load_row(b[j], ys, 32 * wn + 8 * j + g, tq);
  if (norms) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const float v0 = __uint_as_float(b[j][w] << 16);
        const float v1 = __uint_as_float(b[j][w] & 0xffff0000u);
        f.yn[j] = fmaf(v0, v0, f.yn[j]);
        f.yn[j] = fmaf(v1, v1, f.yn[j]);
      }
  }
  const char* qsl = qs + (tq >> 1) * Q_SLICE_BYTES;
  const int c0 = 4 * (tq & 1);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    uint32_t a[2][2][8];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * mi + 8 * h + g;
        const uint4 lo =
            *reinterpret_cast<const uint4*>(qsl + swz(r, c0 + 2 * hh));
        const uint4 hi =
            *reinterpret_cast<const uint4*>(qsl + swz(r, c0 + 2 * hh + 1));
        uint32_t(&w)[8] = a[mi][h];
        w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
        w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
      }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t ah[2][4], al[2][4], bh[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        split_tf32(a[mi][0][2 * s], ah[mi][0], al[mi][0]);
        split_tf32(a[mi][1][2 * s], ah[mi][1], al[mi][1]);
        split_tf32(a[mi][0][2 * s + 1], ah[mi][2], al[mi][2]);
        split_tf32(a[mi][1][2 * s + 1], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w = b[j][4 * hh + s];
        bh[j][0] = w << 16;
        bh[j][1] = w & 0xffff0000u;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (hh == 0 && s == 0)
            mma_tf32_0(f.acc[mi][j], al[mi], bh[j][0], bh[j][1]);
          else
            mma_tf32(f.acc[mi][j], al[mi], bh[j][0], bh[j][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(f.acc[mi][j], ah[mi], bh[j][0], bh[j][1]);
    }
  }
}

// |q|^2 of the block's query rows into qq[BQ] (threads 0..BQ-1; the caller
// synchronises before reading it).
template <typename T>
__device__ __forceinline__ void query_norms(const T* Q, int nq, int d, int q0,
                                            float* qq) {
  const int r = threadIdx.x;
  if (r < BQ) {
    float s = 0.f;
    if (q0 + r < nq)
      for (int c = 0; c < d; ++c) {
        const float v = to_f32(Q[(size_t)(q0 + r) * d + c]);
        s = fmaf(v, v, s);
      }
    qq[r] = s;
  }
}

// The shared memory of the ring: HEAD_BYTES (mbarriers, alignment), the
// ring, then the resident Q tile (slices * Q_SLICE_BYTES) when q_resident.
struct Ring {
  uint64_t* full;    // [stages] TMA bytes landed
  uint64_t* empty;   // [stages] every warp done with the stage
  uint64_t* qbar;    // resident Q landed
  char* ring;
  char* qres;
  int stages;
  int qps;   // Q slices per Y slice

  __device__ Ring(char* smem, int slices, bool q_resident, int n, int qps = 1)
      : stages(n), qps(qps) {
    char* base = reinterpret_cast<char*>(
        (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(base);
    empty = full + MAX_STAGES;
    qbar = empty + MAX_STAGES;
    ring = base + 1024;
    qres = ring + ring_bytes(q_resident, stages, qps) - HEAD_BYTES;
  }
  // The bytes past the ring and the Q tile.
  __device__ char* rest(char* smem, int slices, bool q_resident) const {
    return smem + ring_bytes(q_resident, stages, qps) +
           q_bytes(q_resident, slices);
  }
  // Thread 0, before the block barrier that precedes run().
  __device__ void init() const {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, THREADS / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
};

// Walk tiles [t_begin, t_end) of Y for the query tile at q0, calling
// epi(t, frag) with each tile's finished accumulators. d is Y's row length
// in elements of T; Q's elements are TQ (T, or float with a bf16 Y, whose
// Q the caller pads to 2 S slices). Every thread of the block calls this,
// after a block barrier that follows R.init().
template <typename T, typename TQ = T, typename Epi>
__device__ __forceinline__ void run(const CUtensorMap* mapQ,
                                    const CUtensorMap* mapY, int d, int q0,
                                    int t_begin, int t_end, bool q_resident,
                                    bool norms, const Ring& R, Epi& epi) {
  constexpr bool MIXED = sizeof(TQ) != sizeof(T);
  constexpr int QPS = (int)(sizeof(TQ) / sizeof(T));   // Q slices a slice
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
  const int S = (d * (int)sizeof(T) + ROW_BYTES - 1) / ROW_BYTES;
  const int per_slice = ROW_BYTES / (int)sizeof(T);    // Y elements
  const int q_per_slice = ROW_BYTES / (int)sizeof(TQ);  // Q elements
  const int stage = Y_SLICE_BYTES + (q_resident ? 0 : QPS * Q_SLICE_BYTES);
  const int total = (t_end - t_begin) * S;

  // Thread 0 loads slice j into its stage once all warps released it.
  const int stages = R.stages;
  auto produce = [&](int j) {
    const int st = j % stages, t = t_begin + j / S, s = j % S;
    mbar_wait(R.empty + st, ((j / stages) & 1) ^ 1);
    char* dst = R.ring + st * stage;
    mbar_expect_tx(R.full + st, stage);
    tma_load(dst, mapY, s * per_slice, t * BN, R.full + st);
    if (!q_resident)
      for (int u = 0; u < QPS; ++u)
        tma_load(dst + Y_SLICE_BYTES + u * Q_SLICE_BYTES, mapQ,
                 (s * QPS + u) * q_per_slice, q0, R.full + st);
  };
  if (tid == 0) {
    if (q_resident) {
      mbar_expect_tx(R.qbar, S * QPS * Q_SLICE_BYTES);
      for (int s = 0; s < S * QPS; ++s)
        tma_load(R.qres + s * Q_SLICE_BYTES, mapQ, s * q_per_slice, q0,
                 R.qbar);
    }
    for (int j = 0; j < stages - 2 && j < total; ++j) produce(j);
  }
  if (q_resident) mbar_wait(R.qbar, 0);

  Frag f;
  for (int i = 0; i < total; ++i) {
    const int st = i % stages, s = i % S;
    mbar_wait(R.full + st, (i / stages) & 1);
    const char* ys = R.ring + st * stage;
    if (s == 0) f.zero();
    const char* qs =
        q_resident ? R.qres + s * QPS * Q_SLICE_BYTES : ys + Y_SLICE_BYTES;
    if constexpr (MIXED)
      slice_mma_mixed(f, qs, ys, norms, wm, wn, g, tq);
    else
      slice_mma<T>(f, qs, ys, norms, wm, wn, g, tq);
    __syncwarp();   // every lane's fragments are in registers (the mma read
    if (lane == 0) mbar_arrive(R.empty + st);   // them): the stage is free
    if (tid == 0 && i + stages - 2 < total) produce(i + stages - 2);
    f.add_acc();
    if (s == S - 1) epi(t_begin + i / S, f);
  }
}

}  // namespace contract
