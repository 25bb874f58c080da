// Inline-PTX building blocks for Hopper (sm_90a) kernels: mbarriers, TMA
// tensor loads and plain bulk copies, thread-block cluster barriers and
// distributed shared memory, warpgroup matrix products (wgmma), register
// hand-over between warpgroups (setmaxnreg), and the 16-bit packing and
// 4-byte cp.async copies around them.
//
// Shared-memory operand layout (both wgmma operands and every TMA box that
// feeds one): 16-bit tiles in column blocks of 64 elements (128 bytes), each
// block `rows x 128 B`, written by TMA with the 128-byte swizzle (16-byte
// chunk c of row r lands at chunk c ^ (r % 8)); every block starts on 1024
// bytes, so the swizzle pattern and the wgmma descriptor agree.
//   - K-major operand (the k dim contiguous, as Q and K are for S = Q K^T):
//     8-row groups 1024 bytes apart (SBO), a 16-wide k-step 32 bytes further
//     along the row, the next 64 columns one block further.
//   - MN-major operand (the n dim contiguous, as V is for O += P V): 8 k-rows
//     1024 bytes apart (SBO), the next 64 columns of n one block further
//     (LBO), a 16-wide k-step 2048 bytes further.
//
// wgmma accumulator layout, m64nN (warp w of the warpgroup, lane = 4 g + t):
// d[4 i + 0..1] = (row 16 w + g, cols 8 i + 2 t, +1), d[4 i + 2..3] = (row
// 16 w + g + 8, the same cols): mma.sync's C layout, block by block.  Its
// register A fragment for rows 16 w.. and the 16-wide k-slice kk is that of
// mma.sync: a[0] (g, 2t), a[1] (g + 8, 2t), a[2] (g, 2t + 8), a[3] (g + 8,
// 2t + 8), so an accumulator rounded to 16 bits feeds the next product as A
// without leaving registers.
//
// ss_issue, rs_issue and pack_a are the two product shapes of the flash
// kernels (a 64-row tile against a staged operand, K-major or MN-major);
// encode_qkv builds the per-call tensor map of a (B, H, L, D) operand.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 rounded to T (bf16 or f16) and packed, lo in the lower half.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>,
                "pack: T is bf16 or f16");
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The same, stored to p (4-byte aligned): two neighbouring output columns.
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack<T>(lo, hi);
}

// Copy 4 bytes (an f32) global -> shared, asynchronously; with valid = false
// nothing is read and the 4 bytes are zeroed (src must still be a mapped
// address).  Completion reaches an mbarrier through mbar_arrive_cp_async.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make initialised barriers visible to the async proxy (TMA) and the CTA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive once this thread's earlier cp.async copies have landed (the
// barrier's count includes this arrival: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a box of a tensor map into shared memory; the
// barrier's transaction count falls by the box's bytes (out-of-bounds
// elements are zero-filled and counted) when it lands.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Bulk copy of `bytes` contiguous bytes global -> shared (no tensor map):
// dst, src and bytes multiples of 16; the barrier's transaction count falls
// by `bytes` when they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters: every thread of every block of the cluster arrives
// (release: its earlier writes become visible) and waits (acquire) once per
// phase; distributed shared memory is addressed through mapa.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in block `rank`
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ int ld_cluster(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// 2^x, the special-function unit's approximation (as __expf uses it)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Register hand-over between warpgroups (every warp of a warpgroup executes it)
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at `p`:
// start address, leading and stride byte offsets (16-byte units), swizzle
// mode 1 (128 B) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// A descriptor moved `bytes` further (a multiple of 16) in shared memory.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point of the program: a product in flight reads or
// writes them, which the compiler does not see.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_ACC32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_ACC64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_OPS8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_OPS32 HOPPER_OPS8(0), HOPPER_OPS8(8), HOPPER_OPS8(16), HOPPER_OPS8(24)
#define HOPPER_OPS64 HOPPER_OPS32, HOPPER_OPS8(32), HOPPER_OPS8(40), HOPPER_OPS8(48), HOPPER_OPS8(56)

// d (+)= A B with A and B in shared memory, both K-major: m64nNk16, f32
// accumulation; scale_d = 0 overwrites d instead of adding to it.
#define HOPPER_WGMMA_SS(N, ACC, OPS, A, B, S, TY)                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " \
               ACC ", " A ", " B ", p, 1, 1, 0, 0;\n}\n"                        \
               : OPS                                                           \
               : "l"(a), "l"(b), "r"(scale_d))

// d += A B with A in registers (the fragment above) and B in shared memory,
// MN-major (transposed): m64nNk16, f32 accumulation.
#define HOPPER_WGMMA_RS(N, ACC, OPS, A, B, TY)                                 \
  asm volatile("wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " \
               ACC ", " A ", " B ", 1, 1, 1, 1;\n"                              \
               : OPS                                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (N == 64) {
      HOPPER_WGMMA_SS(64, HOPPER_ACC32, HOPPER_OPS32, "%32", "%33", "%34", "bf16");
    } else {
      HOPPER_WGMMA_SS(128, HOPPER_ACC64, HOPPER_OPS64, "%64", "%65", "%66", "bf16");
    }
  } else {
    static_assert(std::is_same_v<T, __half>, "wgmma_ss: T is bf16 or f16");
    if constexpr (N == 64) {
      HOPPER_WGMMA_SS(64, HOPPER_ACC32, HOPPER_OPS32, "%32", "%33", "%34", "f16");
    } else {
      HOPPER_WGMMA_SS(128, HOPPER_ACC64, HOPPER_OPS64, "%64", "%65", "%66", "f16");
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (N == 64) {
      HOPPER_WGMMA_RS(64, HOPPER_ACC32, HOPPER_OPS32, "{%32, %33, %34, %35}", "%36", "bf16");
    } else {
      HOPPER_WGMMA_RS(128, HOPPER_ACC64, HOPPER_OPS64, "{%64, %65, %66, %67}", "%68", "bf16");
    }
  } else {
    static_assert(std::is_same_v<T, __half>, "wgmma_rs: T is bf16 or f16");
    if constexpr (N == 64) {
      HOPPER_WGMMA_RS(64, HOPPER_ACC32, HOPPER_OPS32, "{%32, %33, %34, %35}", "%36", "f16");
    } else {
      HOPPER_WGMMA_RS(128, HOPPER_ACC64, HOPPER_OPS64, "{%64, %65, %66, %67}", "%68", "f16");
    }
  }
}

#undef HOPPER_WGMMA_SS
#undef HOPPER_WGMMA_RS
#undef HOPPER_OPS64
#undef HOPPER_OPS32
#undef HOPPER_OPS8
#undef HOPPER_ACC64
#undef HOPPER_ACC32

// acc = A B^T over D: A the 64 rows at a_desc, B the N rows staged at b_st,
// both K-major in 64-column blocks (A's 64 x 128 B, B's N x 128 B apart);
// the first k-step overwrites acc.  Issued and committed, not waited for.
template <typename T, int D, int N>
__device__ __forceinline__ void ss_issue(float (&acc)[N / 2], uint64_t a_desc,
                                         const unsigned char* b_st) {
  const uint64_t b_desc = desc_sw128(b_st, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T, N>(acc, desc_add(a_desc, (kk / 4) * 64 * 128 + (kk % 4) * 32),
                   desc_add(b_desc, (kk / 4) * N * 128 + (kk % 4) * 32), kk > 0);
  wgmma_commit();
  fence_regs(acc);
}

// acc += A B over K: A (64 x K, rounded to T) the register fragments pa, B
// the K rows staged at b_st (stored K x DP, the MN-major operand).  Issued
// and committed, not waited for.
template <typename T, int DP, int K>
__device__ __forceinline__ void rs_issue(float (&acc)[DP / 2], uint32_t (&pa)[K / 16][4],
                                         const unsigned char* b_st) {
  const uint64_t b_desc = desc_sw128(b_st, K * 128, 1024);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<T, DP>(acc, pa[kk], desc_add(b_desc, kk * 16 * 128));
  wgmma_commit();
  // pin the operands in their registers while the product runs
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) fence_regs(pa[kk]);
}

// A (64 x K) accumulator rounded to T, packed as the A fragments of rs_issue
template <typename T, int K>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[K / 16][4], const float (&acc)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    pa[kk][0] = pack<T>(acc[8 * kk], acc[8 * kk + 1]);
    pa[kk][1] = pack<T>(acc[8 * kk + 2], acc[8 * kk + 3]);
    pa[kk][2] = pack<T>(acc[8 * kk + 4], acc[8 * kk + 5]);
    pa[kk][3] = pack<T>(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// Tensor maps, encoded on the host for each call
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda at run time: the library
// links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A (B, H, L, D) 16-bit operand with (b, h, l) element strides s as a TMA
// map: dims (D, L, H, B), boxes of 64 columns (128 bytes, swizzled) by
// `rows`; zero-filled past D and L.
template <typename Strides>
bool encode_qkv(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type, const void* ptr,
                Strides s, int d, int l, int heads, int batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)l, (cuuint64_t)heads, (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)s.l * 2, (cuuint64_t)s.h * 2, (cuuint64_t)s.b * 2};
  // a dimension of size 1 is never stepped: give it a stride the encoder takes
  if (l == 1) strides[0] = (cuuint64_t)d * 2 + 16 - (d * 2) % 16;
  if (heads == 1) strides[1] = strides[0] * l;
  if (batch == 1) strides[2] = strides[1] * heads;
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
CUtensorMapDataType tensor_map_type() {
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

}  // namespace hopper
