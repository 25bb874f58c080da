// Inline-PTX building blocks for the 16-bit tensor-core kernels (sm_80+,
// built here for sm_90a): 16-byte cp.async staging with a zero fill for rows
// past a sequence's end, ldmatrix fragment loads from shared memory, and the
// m16n8k16 mma.sync with f32 accumulation.  Each kernel is one template over
// its 16-bit element type T, bf16 (__nv_bfloat16) or f16 (__half); the
// traits struct Mma16<T> holds the only two things that differ, the mma.sync
// form and the f32 -> T2 rounding.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register holding two consecutive columns:
//   A (16 x 16, row major): a[0] (g, 2t), a[1] (g + 8, 2t),
//                           a[2] (g, 2t + 8), a[3] (g + 8, 2t + 8)
//   B (16 x 8, k x n):      b[0] (k = 2t, n = g), b[1] (k = 2t + 8, n = g)
//   C (16 x 8, f32):        c[0..1] (g, 2t..2t+1), c[2..3] (g + 8, 2t..2t+1)
// So the C fragments of two neighbouring 8-column blocks are, rounded to
// T, the A fragment of the 16-wide k-slice they cover (to_a below): a
// product's result feeds the next product without leaving registers.
//
// Shared-memory tiles are row major with rows padded by 8 elements (16
// bytes): the 8 rows an ldmatrix reads then start in 8 distinct groups of 4
// banks, for every head dim used here (16 to 128), so each load is free of
// bank conflicts, and every row stays 16-byte aligned for cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mma_bf16 {

// The 16-bit element types: the mma.sync form (d += a * b, m16n8k16, f32
// accumulation) and two f32 rounded to T and packed, lo in the lower half.
template <typename T> struct Mma16;

template <> struct Mma16<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ T2 pack2(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Mma16<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ T2 pack2(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared, asynchronously; with valid = false nothing
// is read and the 16 bytes are zeroed (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// The same for 4 bytes (an f32 statistic).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Address, for this lane, of an A fragment (16 rows x 16 columns) of a
// row-major tile with row stride ld, at (row0, col0).
template <typename T>
__device__ __forceinline__ const T* a_addr(const T* tile, int ld, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}

// Address of two B fragments (n-blocks n0 and n0 + 8, k-slice k0..k0+15)
// read from a tile stored n x k row major (B = tile^T), without transpose:
// r[0], r[1] = b[0], b[1] of n0; r[2], r[3] those of n0 + 8.
template <typename T>
__device__ __forceinline__ const T* bt_addr(const T* tile, int ld, int n0, int k0, int lane) {
  return tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
}

// Address of two B fragments read from a tile stored k x n row major (B =
// tile), for ldmatrix_x4_trans; the registers as for bt_addr.
template <typename T>
__device__ __forceinline__ const T* b_addr(const T* tile, int ld, int k0, int n0, int lane) {
  return tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 + (lane >> 4) * 8;
}

// d += a * b: m16n8k16, T operands, f32 accumulation.
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  Mma16<T>::mma(d, a, b0, b1);
}

// Two f32 rounded to T and packed; lo takes the lower column.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const typename Mma16<T>::T2 v = Mma16<T>::pack2(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The same, stored to p (4-byte aligned): two neighbouring output columns.
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<typename Mma16<T>::T2*>(p) = Mma16<T>::pack2(lo, hi);
}

// The T A fragment of a 16-wide k-slice from the f32 C fragments of its two
// 8-column halves.
template <typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack<T>(lo[0], lo[1]);
  a[1] = pack<T>(lo[2], lo[3]);
  a[2] = pack<T>(hi[0], hi[1]);
  a[3] = pack<T>(hi[2], hi[3]);
}

// Stage rows [r0, r0 + ROWS) of a (L, D) 16-bit operand with row stride ld
// (elements) into a padded shared tile (row stride D + 8), zero past row
// `end`.  Every thread of the block takes its share of the 16-byte chunks.
template <int D, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(T* tile, const T* src, long long ld, int r0,
                                           int end) {
  constexpr int kChunks = D / 8;
  constexpr int kPerThread = (ROWS * kChunks + THREADS - 1) / THREADS;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = i * THREADS + threadIdx.x;
    if (ROWS * kChunks % THREADS != 0 && c >= ROWS * kChunks) break;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool ok = r0 + r < end;
    cp_async16(tile + r * (D + 8) + col, ok ? src + (long long)(r0 + r) * ld + col : src, ok);
  }
}

}  // namespace mma_bf16
