// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Two kernels, from the forward's saved (out, lse) statistics:
//   flash_bwd_dq_*   replaces tpu_air/ops/flash_attention.py::_bwd_dq_kernel
//                    (and _bwd_dq_nm), launched there by _pallas_bwd;
//   flash_bwd_dkv_*  replaces tpu_air/ops/flash_attention.py::_bwd_dkv_kernel
//                    (and _bwd_dkv_nm), launched there by _pallas_bwd.
//
// What they compute, per (batch*head), query row i and key row j:
//   s_ij  = (q_i . k_j) * scale + (1 - mask[b][j]) * -1e30
//   p_ij  = 0 where key j is after query i (causal) or past Lk or Lq (ragged),
//           or where s_ij <= -5e29 (masked: the hard zero of _bwd_p, which
//           keeps a fully masked row's gradients at exactly 0 -- its lse
//           rounds to -1e30 in f32, so exp(s - lse) would weigh every key 1);
//           exp(s_ij - lse_i) elsewhere
//   ds_ij = p_ij * (do_i . v_j - delta_i)     delta = rowsum(do*out) - glse,
//                                              computed by the caller
//   dq_i  = sum_j ds_ij k_j * scale           (dq kernel)
//   dk_j  = sum_i ds_ij q_i * scale,  dv_j = sum_i p_ij do_i   (dk/dv kernel)
// Sums are f32; outputs are written in the input type.  p and ds are rounded
// to the input type before they become a product's operand, as the Pallas
// kernels cast them.
//
// What bounds them on the H100 (989 TFLOP/s bf16 and f16 dense, 3.35 TB/s):
// operations.  At the long-context LM shape (B*H 8, L 8192, D 128, causal)
// dq does 206 GFLOP (3 products of 2 * D flops per live (i, j) pair: S, dP,
// dQ) and dk/dv 275 GFLOP (4: S, dP, dV, dK) on 84 and 101 MB of inputs and
// outputs: 0.21 and 0.28 ms at peak, against ~0.03 ms of memory traffic.
// dq stays a pass of its own, as in the Pallas reference, and recomputes S
// and dP: folding it into dk/dv would take f32 atomics, and results here are
// bitwise deterministic.
//
// Hopper has no ordered grid: the TPU kernels carry their accumulators in
// VMEM across a sequential grid axis.  Here a consumer warpgroup owns its
// output rows and loops over the other axis itself, with the accumulators in
// registers.  q/k/v/do are read and dq/dk/dv written through (b, h, l)
// strides with D contiguous, so the model's [b, L, h, d] projections need no
// transposed copy.
//
// bf16 and f16 (flash_bwd_dq_wgmma_kernel<T, D>, flash_bwd_dkv_wgmma_kernel<T,
// D>) run every product on Hopper's warpgroup products, fed by TMA, in the
// forward's shape (flash_attention.cu):
//   - Warp roles.  A block is 3 warpgroups: a producer and two consumers of
//     64 rows each.  The producer gives its registers to the consumers
//     (setmaxnreg: 40 left to it, 232 to each consumer, which dk/dv's dK and
//     dV accumulators, 128 registers, beside S and dP, 64, need at D = 128);
//     its thread 0 issues the TMA copies and its 128 threads copy the small
//     per-tile rows (key mask, lse, delta) with cp.async.
//   - The operand a consumer keeps for a whole item (dq: its 64 query rows of
//     Q and dO; dk/dv: its 64 keys of K and V) is loaded once per item.  The
//     other operand streams through a ring of 4 stages of 64 rows (dq: K, V
//     and the key-mask row; dk/dv: Q, dO and the tile's lse and delta), each
//     with a full and an empty mbarrier.  Boxes are 64 columns (128 bytes,
//     128-byte swizzle, what the wgmma descriptors read), zero-filled past D,
//     Lq and Lk; D < 64 is staged 64 wide.  Four tensor maps a call are
//     encoded on the host (cuTensorMapEncodeTiled from libcuda at run time).
//   - Every product reads both operands from shared memory or registers,
//     never ldmatrix fragments: S = Q K^T and dP = dO V^T (dk/dv: S^T = K
//     Q^T, dP^T = V dO^T) are wgmma with both operands K-major in shared
//     memory; dQ += dS K, dV += P^T dO and dK += dS^T Q take P or dS, rounded
//     to T in registers, as the register A operand and the staged tile as
//     the MN-major B, as the forward's O += P V reads V.  P and dS never
//     touch shared memory.  Scores go to log2 units after the hard zero (the
//     natural-unit test: exp2 at -1e30 is not exact).
//   - dq overlaps the tensor cores with its own arithmetic: key tile j's S
//     and dP are issued together with tile j-1's dQ += dS K, and tile j's dS
//     is computed while that product runs.  dk/dv has no registers left for
//     a second tile in flight: its P is computed while dP runs, then dV and
//     dK are issued together; the other consumer's products fill the gaps.
//   - Persistent: one block an SM walks over work items (128 rows of one
//     (b, h)), so the producer loads the next item's tiles while the
//     consumers finish this one's.  Causal items go longest first (dq: the
//     last query rows, dk/dv: the first keys) and the blocks take them in
//     rounds walked forth and back, which evens their work.  Tiles wholly
//     past the diagonal are never loaded; masks are applied element by
//     element only on tiles that cross the diagonal, Lq or Lk.  Under causal
//     masking dk/dv's second consumer skips the ring's first query tile (its
//     keys all come after it) by arriving on its empty barrier.
//   tests/_flash_bwd_schedule.py restates the layout and the walks for the
//   CPU tests.
//
// In f32 both run on the CUDA cores (flash_bwd_dq_kernel<float, D>,
// flash_bwd_dkv_kernel<float, D>; the tensor cores' only f32 product is
// TF32, too coarse for the f32 parity of the port): every operand
// is read from shared memory as float4 (one load per four FMAs) and the
// threads that share a row read neighbouring 16-byte words, so a warp's load
// is one conflict-free wavefront; FMA throughput and those loads bound them.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float kNegInf = -1e30f;
constexpr float kMaskedAtOrBelow = 0.5f * kNegInf;  // _bwd_p's hard-zero line
constexpr int kThreads = 128;
constexpr int kTile = 32;  // rows of the looped-over operand staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tiling for head dim D: TPR threads share one row, each owning DP of its D
// columns as V4 float4 chunks; chunk c of thread `part` is chunk index
// c * TPR + part of the row, so the TPR threads of a row read neighbouring
// 16-byte words of shared memory.
template <int D> struct Tiling {
  static constexpr int TPR = D <= 32 ? 1 : D / 32;
  static constexpr int DP = D / TPR;
  static constexpr int V4 = DP / 4;
  static constexpr int ROWS = kThreads / TPR;  // output rows per block
};

// the column of element e of a thread's DP columns
template <int D>
__device__ __forceinline__ int column(int e, int part) {
  return ((e / 4) * Tiling<D>::TPR + part) * 4 + e % 4;
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {  // element strides of a (B, H, L, D) view; D is contiguous
  long long b, h, l;
};

template <typename T, int D>
__device__ __forceinline__ void load_row(const T* base, bool ok, int part, float* dst) {
#pragma unroll
  for (int e = 0; e < Tiling<D>::DP; ++e) dst[e] = ok ? to_f32(base[column<D>(e, part)]) : 0.f;
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* base, int part, const float* src) {
#pragma unroll
  for (int e = 0; e < Tiling<D>::DP; ++e) base[column<D>(e, part)] = from_f32<T>(src[e]);
}

// a thread's part of (row . x) for a shared-memory row x, and its float4s
template <int D>
__device__ __forceinline__ float dot_part(const float* reg, const float* row, int part) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < Tiling<D>::V4; ++c) {
    const float4 x = r4[c * Tiling<D>::TPR + part];
    acc = fmaf(reg[4 * c], x.x, acc);
    acc = fmaf(reg[4 * c + 1], x.y, acc);
    acc = fmaf(reg[4 * c + 2], x.z, acc);
    acc = fmaf(reg[4 * c + 3], x.w, acc);
  }
  return acc;
}

// acc += w * row for a shared-memory row, over a thread's columns
template <int D>
__device__ __forceinline__ void axpy_part(float w, const float* row, int part, float* acc) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < Tiling<D>::V4; ++c) {
    const float4 x = r4[c * Tiling<D>::TPR + part];
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

// Stage rows [r0, r0 + n) of two (L, D) operands into shared memory as f32,
// zero past n.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* a, Strides sa, const T* b, Strides sb,
                                      int r0, int n, float (*a_s)[D], float (*b_s)[D]) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int j = i / D;
    const int e = i % D;
    float ax = 0.f, bx = 0.f;
    if (j < n) {
      ax = to_f32(a[(long long)(r0 + j) * sa.l + e]);
      bx = to_f32(b[(long long)(r0 + j) * sb.l + e]);
    }
    a_s[j][e] = ax;
    b_s[j][e] = bx;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdq, int heads, int lq,
                    int lk, int heads_per_mask, float scale, int causal) {
  constexpr int TPR = Tiling<D>::TPR;
  constexpr int DP = Tiling<D>::DP;
  constexpr int ROWS = Tiling<D>::ROWS;

  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];
  __shared__ float m_s[kTile];

  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int q0 = blockIdx.x * ROWS;
  const int part = threadIdx.x % TPR;
  const int qi = q0 + threadIdx.x / TPR;
  const bool row_ok = qi < lq;

  const T* kb = k + bi * sk.b + hi * sk.h;
  const T* vb = v + bi * sv.b + hi * sv.h;
  const float* maskb = mask ? mask + (long long)(bh / heads_per_mask) * lk : nullptr;

  float qv[DP], dov[DP], acc[DP];
  load_row<T, D>(q + bi * sq.b + hi * sq.h + (long long)qi * sq.l, row_ok, part, qv);
  load_row<T, D>(dout + bi * sdo.b + hi * sdo.h + (long long)qi * sdo.l, row_ok, part, dov);
#pragma unroll
  for (int e = 0; e < DP; ++e) acc[e] = 0.f;
  const float lse_i = row_ok ? lse[(long long)bh * lq + qi] : 0.f;
  const float delta_i = row_ok ? delta[(long long)bh * lq + qi] : 0.f;

  // causal: key tiles wholly after this query tile's last row carry no weight
  const int k_end = causal ? min(lk, q0 + ROWS) : lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, lk - k0);
    __syncthreads();  // the previous tile is fully consumed
    stage<T, D>(kb, sk, vb, sv, k0, nk, k_s, v_s);
    if (threadIdx.x < kTile) {
      const int j = threadIdx.x;
      m_s[j] = (maskb != nullptr && j < nk) ? (1.f - maskb[k0 + j]) * kNegInf : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kTile; ++j) {
      const float s = row_sum<TPR>(dot_part<D>(qv, k_s[j], part)) * scale + m_s[j];
      const float dp = row_sum<TPR>(dot_part<D>(dov, v_s[j], part));
      const bool live = row_ok && j < nk && !(causal && k0 + j > qi) && s > kMaskedAtOrBelow;
      const float p = live ? expf(s - lse_i) : 0.f;
      axpy_part<D>(p * (dp - delta_i) * scale, k_s[j], part, acc);
    }
  }
  if (row_ok) store_row<T, D>(dq + bi * sdq.b + hi * sdq.h + (long long)qi * sdq.l, part, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk, T* __restrict__ dv,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, int heads, int lq, int lk, int heads_per_mask,
                     float scale, int causal) {
  constexpr int TPR = Tiling<D>::TPR;
  constexpr int DP = Tiling<D>::DP;
  constexpr int ROWS = Tiling<D>::ROWS;

  __shared__ __align__(16) float q_s[kTile][D];
  __shared__ __align__(16) float do_s[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int k0 = blockIdx.x * ROWS;
  const int part = threadIdx.x % TPR;
  const int kj = k0 + threadIdx.x / TPR;
  const bool key_ok = kj < lk;

  const T* qb = q + bi * sq.b + hi * sq.h;
  const T* dob = dout + bi * sdo.b + hi * sdo.h;
  const float* lseb = lse + (long long)bh * lq;
  const float* deltab = delta + (long long)bh * lq;

  float kv[DP], vv[DP], dk_acc[DP], dv_acc[DP];
  load_row<T, D>(k + bi * sk.b + hi * sk.h + (long long)kj * sk.l, key_ok, part, kv);
  load_row<T, D>(v + bi * sv.b + hi * sv.h + (long long)kj * sv.l, key_ok, part, vv);
#pragma unroll
  for (int e = 0; e < DP; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  const float madd =
      (mask != nullptr && key_ok) ? (1.f - mask[(long long)(bh / heads_per_mask) * lk + kj]) * kNegInf
                                  : 0.f;

  // causal: queries before this block's first key see none of its keys
  for (int qs = causal ? k0 : 0; qs < lq; qs += kTile) {
    const int nq = min(kTile, lq - qs);
    __syncthreads();  // the previous tile is fully consumed
    stage<T, D>(qb, sq, dob, sdo, qs, nq, q_s, do_s);
    if (threadIdx.x < kTile) {
      const int i = threadIdx.x;
      lse_s[i] = i < nq ? lseb[qs + i] : 0.f;
      delta_s[i] = i < nq ? deltab[qs + i] : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < kTile; ++i) {
      const float s = row_sum<TPR>(dot_part<D>(kv, q_s[i], part)) * scale + madd;
      const float dp = row_sum<TPR>(dot_part<D>(vv, do_s[i], part));
      const bool live = key_ok && i < nq && !(causal && kj > qs + i) && s > kMaskedAtOrBelow;
      const float p = live ? expf(s - lse_s[i]) : 0.f;
      axpy_part<D>(p, do_s[i], part, dv_acc);
      axpy_part<D>(p * (dp - delta_s[i]) * scale, q_s[i], part, dk_acc);
    }
  }
  if (key_ok) {
    store_row<T, D>(dk + bi * sdk.b + hi * sdk.h + (long long)kj * sdk.l, part, dk_acc);
    store_row<T, D>(dv + bi * sdv.b + hi * sdv.h + (long long)kj * sdv.l, part, dv_acc);
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma on a TMA-fed ring
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kWgmmaThreads = 3 * kWg;  // the producer warpgroup, two consumers
constexpr int kRows = 64;               // rows a consumer owns: query rows (dq), keys (dk/dv)
constexpr int kBlock = 64;              // rows of a ring stage: keys (dq), queries (dk/dv)
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;      // the most dynamic shared memory a block may take
constexpr int kBarBytes = 128;          // the item's full and empty, then the stages'
// registers a thread after the hand-over; the block keeps the 384 * 168 it
// was launched with, so 128 * 40 + 256 * 232 <= 64512, or a consumer's
// setmaxnreg.inc waits forever (with 24 the producer spilled)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct WgmmaBwd {
  static constexpr int DP = D < 64 ? 64 : D;        // columns staged, zero past D
  static constexpr int NB = DP / 64;                // 128-byte column blocks
  static constexpr int ROW_BYTES = kRows * DP * 2;  // one consumer's rows of one operand
  static constexpr int TILE_BYTES = kBlock * DP * 2;  // one operand's tile in a stage
};

struct BwdParams {
  const float* lse;    // (B*H, lq) f32
  const float* delta;  // (B*H, lq) f32
  const float* mask;   // null, or (mask_b, lk) f32, 1 = attend; row bh / heads_per_mask
  void *out0, *out1;   // dq, or dk and dv
  Strides s0, s1;
  int heads, lq, lk, heads_per_mask, causal;
  float scale;
  int stages, stage_bytes;
  int units, tiles;    // work items: units (b*h) x tiles of 2 * kRows rows
};

// The work item `w` of a launch: 128 rows (query rows for dq, keys for
// dk/dv) of one (b, h).  Causal: the longest items first, across all units
// (dq: the last query rows, which see the most keys; dk/dv: the first keys,
// which the most queries see); else a unit's items next to each other, so
// the streamed operand stays in L2.
struct BwdItem {
  int bh, r0;
};

__device__ __forceinline__ BwdItem bwd_item(const BwdParams& p, int w, bool dkv) {
  BwdItem it;
  if (p.causal) {
    it.bh = w % p.units;
    it.r0 = (dkv ? w / p.units : p.tiles - 1 - w / p.units) * 2 * kRows;
  } else {
    it.bh = w / p.tiles;
    it.r0 = (w % p.tiles) * 2 * kRows;
  }
  return it;
}

// dq: the key tiles that query rows [row0, row0 + 64) need, up to the
// diagonal (causal)
__device__ __forceinline__ int dq_key_tiles(const BwdParams& p, int row0) {
  const int end = p.causal ? min(p.lk, min(p.lq, row0 + kRows)) : p.lk;
  return (end + kBlock - 1) / kBlock;
}

// dk/dv: the first query row an item's ring carries (causal: its first key;
// the ring's tiles start there) and the query tiles it carries
__device__ __forceinline__ int dkv_first_query(const BwdParams& p, const BwdItem& it) {
  return p.causal ? it.r0 : 0;
}
__device__ __forceinline__ int dkv_query_tiles(const BwdParams& p, const BwdItem& it) {
  const int qs0 = dkv_first_query(p, it);
  return qs0 < p.lq ? (p.lq - qs0 + kBlock - 1) / kBlock : 0;
}

// The tile's p in place of S, in the accumulator layout (rows r and r + 8,
// columns 8 n + 2 t and + 1 of each 8-column block n).  kDkv: rows are keys
// and columns queries (S^T), else rows are queries and columns keys.  p =
// exp(s * scale + mask - lse) is hard-zeroed where the score is masked (<=
// -5e29, tested in natural units before the move to log2 units, where exp2
// at -1e30 is not exact), and on an edge tile where the pair is hidden
// (causal) or past Lq or Lk.  The per-query lse comes as row_lse2 (dq's rows,
// times log2(e)) or from the stage's col_lse (dk/dv's columns); the key
// mask as row_madd (dk/dv's rows, additive) or from the stage's col_mask
// (dq's columns, 1 = attend).
template <bool kDkv, bool kMask>
__device__ __forceinline__ void p_tile(float (&sacc)[kBlock / 2], const BwdParams& p,
                                       const float (&row_lse2)[2], const float (&row_madd)[2],
                                       const float* col_lse, const float* col_mask, int row0,
                                       int col0, int t, bool edge) {
  const float scale_log2 = p.scale * kLog2e;
#pragma unroll
  for (int n8 = 0; n8 < kBlock / 8; ++n8) {
    const int c = n8 * 8 + 2 * t;  // this thread's first column of the block
    float2 lse2 = make_float2(row_lse2[0], row_lse2[1]);
    float2 madd = make_float2(row_madd[0], row_madd[1]);
    if constexpr (kDkv) {
      lse2 = *reinterpret_cast<const float2*>(col_lse + c);
      lse2 = make_float2(lse2.x * kLog2e, lse2.y * kLog2e);
    } else if constexpr (kMask) {
      madd = *reinterpret_cast<const float2*>(col_mask + c);
      madd = make_float2((1.f - madd.x) * kNegInf, (1.f - madd.y) * kNegInf);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e / 2, lo = e & 1;  // row r + 8 hi, column c + lo
      const float l2 = (kDkv ? lo : hi) ? lse2.y : lse2.x;
      const float ma = (kDkv ? hi : lo) ? madd.y : madd.x;
      const float s = sacc[4 * n8 + e];
      float pe;
      if constexpr (kMask) {
        const float x = s * p.scale + ma;
        pe = x > kMaskedAtOrBelow ? hopper::exp2_approx(fmaf(x, kLog2e, -l2)) : 0.f;
      } else {
        pe = hopper::exp2_approx(fmaf(s, scale_log2, -l2));
      }
      if (edge) {
        const int row = row0 + 8 * hi, col = col0 + c + lo;
        const int query = kDkv ? col : row, key = kDkv ? row : col;
        if (query >= p.lq || key >= p.lk || (p.causal && key > query)) pe = 0.f;
      }
      sacc[4 * n8 + e] = pe;
    }
  }
}

// ds = p (dP - delta) in place of dP: delta per row (dq's row_delta) or per
// column (dk/dv's col_delta, from the stage)
template <bool kDkv>
__device__ __forceinline__ void ds_tile(float (&dpacc)[kBlock / 2],
                                        const float (&pacc)[kBlock / 2],
                                        const float (&row_delta)[2], const float* col_delta,
                                        int t) {
#pragma unroll
  for (int n8 = 0; n8 < kBlock / 8; ++n8) {
    float2 delta = make_float2(row_delta[0], row_delta[1]);
    if constexpr (kDkv) delta = *reinterpret_cast<const float2*>(col_delta + n8 * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dl = ((kDkv ? e & 1 : e / 2) ? delta.y : delta.x);
      dpacc[4 * n8 + e] = pacc[4 * n8 + e] * (dpacc[4 * n8 + e] - dl);
    }
  }
}

// dq's dS of the key tile at k0 in place of dP (sacc: S in, p out)
template <bool kMask>
__device__ __forceinline__ void dq_ds(float (&sacc)[kBlock / 2], float (&dpacc)[kBlock / 2],
                                      const BwdParams& p, const float (&lse2)[2],
                                      const float (&delta)[2], const float* mask_t, int row0,
                                      int cq0, int k0, int t) {
  const bool edge =
      k0 + kBlock > p.lk || cq0 + kRows > p.lq || (p.causal && k0 + kBlock - 1 > cq0);
  const float no_madd[2] = {0.f, 0.f};
  p_tile<false, kMask>(sacc, p, lse2, no_madd, nullptr, mask_t, row0, k0, t, edge);
  ds_tile<false>(dpacc, sacc, delta, nullptr, t);
}

// The n-th item of this block: rounds of gridDim.x items, walked forth and
// back in turn, so that under causal masking (items longest first) every
// block's total work comes out nearly equal.
__device__ __forceinline__ int item_of(int n) {
  return n * gridDim.x + ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// dq = sum_j ds k * scale.  Shared memory: Q then dO of both consumers
// (loaded once per item), then the ring: a stage holds K, V and the key-mask
// row of one key tile.
template <typename T, int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const BwdParams p) {
  using namespace hopper;
  using Cfg = WgmmaBwd<D>;
  constexpr int DP = Cfg::DP, NB = Cfg::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles start on 1024 bytes (the launch adds 1 KB of slack)
  unsigned char* const q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const do_s = q_s + 2 * Cfg::ROW_BYTES;
  unsigned char* const ring = do_s + 2 * Cfg::ROW_BYTES;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* const q_empty = q_full + 1;
  uint64_t* const full = q_full + 2;
  uint64_t* const empty = full + kMaxStages;
  const bool has_mask = p.mask != nullptr;
  const int mask_off = 2 * Cfg::TILE_BYTES;  // after K and V in a stage
  const int n_items = p.units * p.tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * kWg);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1 + (has_mask ? kWg : 0));
      mbar_init(&empty[s], 2 * kWg);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so the compiler sees it is
  // uniform in a warp: a wgmma under a branch it cannot prove uniform is
  // serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  if (wg == 0) {
    // ---- producer warpgroup: thread 0 issues TMA; with a key mask all 128
    // copy its rows with cp.async ----
    regs_dealloc<kProducerRegs>();
    const int ptid = threadIdx.x;
    if (!has_mask && ptid != 0) return;
    if (ptid == 0) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&do_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
    }
    int ring_i = 0;  // key tiles through the ring so far
    for (int n = 0, w = item_of(n); w < n_items; w = item_of(++n)) {
      const BwdItem it = bwd_item(p, w, false);
      const int b = it.bh / p.heads, h = it.bh % p.heads;
      const bool live1 = it.r0 + kRows < p.lq;  // consumer 0's rows start below lq
      const int n_tiles = dq_key_tiles(p, it.r0 + kRows);
      for (int j = 0; j < n_tiles; ++j, ++ring_i) {
        const int s = ring_i % p.stages;
        if (ring_i >= p.stages) mbar_wait(&empty[s], ((ring_i / p.stages) - 1) & 1);
        unsigned char* const st = ring + s * p.stage_bytes;
        const int k0 = j * kBlock;
        if (ptid == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * Cfg::TILE_BYTES);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            tma_load_4d(st + nb * kBlock * 128, &k_map, &full[s], nb * 64, k0, h, b);
            tma_load_4d(st + Cfg::TILE_BYTES + nb * kBlock * 128, &v_map, &full[s], nb * 64, k0,
                        h, b);
          }
        }
        if (has_mask) {
          if (ptid < kBlock) {
            const bool ok = k0 + ptid < p.lk;
            const float* row = p.mask + (long long)(it.bh / p.heads_per_mask) * p.lk;
            cp_async4(st + mask_off + ptid * 4, ok ? row + k0 + ptid : p.mask, ok);
          }
          mbar_arrive_cp_async(&full[s]);
        }
        if (j == 0 && ptid == 0) {  // Q and dO, once the consumers are done with the last item's
          if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
          mbar_arrive_expect_tx(q_full, (1 + live1) * 2 * Cfg::ROW_BYTES);
          for (int c = 0; c < 1 + live1; ++c) {
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              const int off = c * Cfg::ROW_BYTES + nb * kRows * 128;
              tma_load_4d(q_s + off, &q_map, q_full, nb * 64, it.r0 + c * kRows, h, b);
              tma_load_4d(do_s + off, &do_map, q_full, nb * 64, it.r0 + c * kRows, h, b);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  regs_alloc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the 64
  const uint64_t q_desc = desc_sw128(q_s + c * Cfg::ROW_BYTES, 16, 1024);
  const uint64_t do_desc = desc_sw128(do_s + c * Cfg::ROW_BYTES, 16, 1024);
  auto mask_at = [&](int s) {
    return reinterpret_cast<const float*>(ring + s * p.stage_bytes + mask_off);
  };

  int ring_i = 0;
  for (int n = 0, w = item_of(n); w < n_items; w = item_of(++n)) {
    const BwdItem it = bwd_item(p, w, false);
    const int cq0 = it.r0 + c * kRows, row0 = cq0 + r0;
    const bool active = cq0 < p.lq;
    const int n_tiles = dq_key_tiles(p, it.r0 + kRows);
    const int my_tiles = active ? dq_key_tiles(p, cq0) : 0;
    float lse2[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row0 + 8 * i < p.lq;
      const long long at = (long long)it.bh * p.lq + row0 + 8 * i;
      lse2[i] = ok ? p.lse[at] * kLog2e : 0.f;
      delta[i] = ok ? p.delta[at] : 0.f;
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    // every consumer follows q_full's phases, live or not
    mbar_wait(q_full, n & 1);
    if (!active) mbar_arrive(q_empty);
    if (my_tiles > 0) {
      // Tile 0: S and dP, then dS.  Then each next tile's S and dP and the
      // previous tile's dQ += dS K go to the tensor cores together, and this
      // tile's dS is computed while that product runs.  Every product is
      // waited for in the block that issues it, so the compiler never sees
      // accumulators read while a product may be writing them.
      float sacc[kBlock / 2], dpacc[kBlock / 2];
      uint32_t pa[kBlock / 16][4];  // dS of the tile whose dQ += dS K is next
      int s = ring_i % p.stages;
      mbar_wait(&full[s], (ring_i / p.stages) & 1);
      ss_issue<T, D, kBlock>(sacc, q_desc, ring + s * p.stage_bytes);
      ss_issue<T, D, kBlock>(dpacc, do_desc, ring + s * p.stage_bytes + Cfg::TILE_BYTES);
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);
      if (my_tiles == 1) mbar_arrive(q_empty);  // the item's last use of Q and dO
      if (has_mask)
        dq_ds<true>(sacc, dpacc, p, lse2, delta, mask_at(s), row0, cq0, 0, t);
      else
        dq_ds<false>(sacc, dpacc, p, lse2, delta, nullptr, row0, cq0, 0, t);
      pack_a<T, kBlock>(pa, dpacc);
      int pend_s = s;
      ++ring_i;
      for (int j = 1; j < my_tiles; ++j, ++ring_i) {
        s = ring_i % p.stages;
        mbar_wait(&full[s], (ring_i / p.stages) & 1);
        ss_issue<T, D, kBlock>(sacc, q_desc, ring + s * p.stage_bytes);
        ss_issue<T, D, kBlock>(dpacc, do_desc, ring + s * p.stage_bytes + Cfg::TILE_BYTES);
        rs_issue<T, DP, kBlock>(dq, pa, ring + pend_s * p.stage_bytes);  // K, MN-major
        wgmma_wait<1>();
        fence_regs(sacc);
        fence_regs(dpacc);
        if (j == my_tiles - 1) mbar_arrive(q_empty);
        if (has_mask)
          dq_ds<true>(sacc, dpacc, p, lse2, delta, mask_at(s), row0, cq0, j * kBlock, t);
        else
          dq_ds<false>(sacc, dpacc, p, lse2, delta, nullptr, row0, cq0, j * kBlock, t);
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk) fence_regs(pa[kk]);
        mbar_arrive(&empty[pend_s]);
        pack_a<T, kBlock>(pa, dpacc);
        pend_s = s;
      }
      rs_issue<T, DP, kBlock>(dq, pa, ring + pend_s * p.stage_bytes);
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&empty[pend_s]);
    }
    for (int j = my_tiles; j < n_tiles; ++j, ++ring_i) {  // keys past this consumer's rows
      const int s = ring_i % p.stages;
      mbar_wait(&full[s], (ring_i / p.stages) & 1);
      mbar_arrive(&empty[s]);
    }
    if (!active) continue;

    const int b = it.bh / p.heads, h = it.bh % p.heads;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= p.lq) continue;
      T* out =
          static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h + (long long)row * p.s0.l + 2 * t;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        store2(out + n8 * 8, dq[4 * n8 + 2 * i] * p.scale, dq[4 * n8 + 2 * i + 1] * p.scale);
    }
  }
}

// dk = sum_i ds q * scale, dv = sum_i p do.  Shared memory: K then V of both
// consumers (loaded once per item), then the ring: a stage holds Q, dO and
// the lse and delta of one query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const BwdParams p) {
  using namespace hopper;
  using Cfg = WgmmaBwd<D>;
  constexpr int DP = Cfg::DP, NB = Cfg::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const k_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const v_s = k_s + 2 * Cfg::ROW_BYTES;
  unsigned char* const ring = v_s + 2 * Cfg::ROW_BYTES;
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* const kv_empty = kv_full + 1;
  uint64_t* const full = kv_full + 2;
  uint64_t* const empty = full + kMaxStages;
  const int lse_off = 2 * Cfg::TILE_BYTES;  // after Q and dO in a stage; delta follows
  const int n_items = p.units * p.tiles;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2 * kWg);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1 + kWg);
      mbar_init(&empty[s], 2 * kWg);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  if (wg == 0) {
    // ---- producer warpgroup: thread 0 issues TMA, all 128 copy the tile's
    // lse and delta with cp.async ----
    regs_dealloc<kProducerRegs>();
    const int ptid = threadIdx.x;
    if (ptid == 0) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&do_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
    }
    int ring_i = 0, kv_i = 0;  // query tiles through the ring, items with K/V loaded
    for (int n = 0, w = item_of(n); w < n_items; w = item_of(++n)) {
      const BwdItem it = bwd_item(p, w, true);
      const int b = it.bh / p.heads, h = it.bh % p.heads;
      const bool live1 = it.r0 + kRows < p.lk;  // consumer 0's keys start below lk
      const int qs0 = dkv_first_query(p, it), n_tiles = dkv_query_tiles(p, it);
      for (int j = 0; j < n_tiles; ++j, ++ring_i) {
        const int s = ring_i % p.stages;
        if (ring_i >= p.stages) mbar_wait(&empty[s], ((ring_i / p.stages) - 1) & 1);
        unsigned char* const st = ring + s * p.stage_bytes;
        const int qs = qs0 + j * kBlock;
        if (ptid == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * Cfg::TILE_BYTES);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            tma_load_4d(st + nb * kBlock * 128, &q_map, &full[s], nb * 64, qs, h, b);
            tma_load_4d(st + Cfg::TILE_BYTES + nb * kBlock * 128, &do_map, &full[s], nb * 64, qs,
                        h, b);
          }
        }
        {  // threads 0-63 copy the tile's lse, 64-127 its delta; 0 past lq
          const int col = ptid % kBlock;
          const float* src = ptid < kBlock ? p.lse : p.delta;
          const bool ok = qs + col < p.lq;
          cp_async4(st + lse_off + ptid * 4, ok ? src + (long long)it.bh * p.lq + qs + col : src,
                    ok);
          mbar_arrive_cp_async(&full[s]);
        }
        if (j == 0 && ptid == 0) {  // K and V, once the consumers are done with the last item's
          if (kv_i > 0) mbar_wait(kv_empty, (kv_i - 1) & 1);
          mbar_arrive_expect_tx(kv_full, (1 + live1) * 2 * Cfg::ROW_BYTES);
          for (int c = 0; c < 1 + live1; ++c) {
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              const int off = c * Cfg::ROW_BYTES + nb * kRows * 128;
              tma_load_4d(k_s + off, &k_map, kv_full, nb * 64, it.r0 + c * kRows, h, b);
              tma_load_4d(v_s + off, &v_map, kv_full, nb * 64, it.r0 + c * kRows, h, b);
            }
          }
        }
      }
      if (n_tiles > 0) ++kv_i;  // an item no query sees (causal, keys past lq) loads nothing
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  regs_alloc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's keys r0 and r0 + 8 of the 64
  const uint64_t k_desc = desc_sw128(k_s + c * Cfg::ROW_BYTES, 16, 1024);
  const uint64_t v_desc = desc_sw128(v_s + c * Cfg::ROW_BYTES, 16, 1024);
  const float no_row[2] = {0.f, 0.f};

  int ring_i = 0, kv_i = 0;
  for (int n = 0, w = item_of(n); w < n_items; w = item_of(++n)) {
    const BwdItem it = bwd_item(p, w, true);
    const int ck0 = it.r0 + c * kRows, key0 = ck0 + r0;
    const bool active = ck0 < p.lk;
    const int qs0 = dkv_first_query(p, it), n_tiles = dkv_query_tiles(p, it);
    // under causal masking the second consumer's keys come after the ring's
    // first query tile: it skips that tile
    const int first = p.causal ? c : 0;
    const int skip = active && first < n_tiles ? first : n_tiles;
    float madd[2] = {0.f, 0.f};  // the additive key mask of this thread's keys
    if (p.mask != nullptr) {
      const float* row = p.mask + (long long)(it.bh / p.heads_per_mask) * p.lk;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (key0 + 8 * i < p.lk) madd[i] = (1.f - row[key0 + 8 * i]) * kNegInf;
    }
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

    // every consumer follows kv_full's phases, live or not
    if (n_tiles > 0) {
      mbar_wait(kv_full, kv_i & 1);
      if (skip == n_tiles) mbar_arrive(kv_empty);
      ++kv_i;
    }
    for (int j = 0; j < skip; ++j, ++ring_i) {  // query tiles before this consumer's keys
      const int s = ring_i % p.stages;
      mbar_wait(&full[s], (ring_i / p.stages) & 1);
      mbar_arrive(&empty[s]);
    }
    for (int j = skip; j < n_tiles; ++j, ++ring_i) {
      // S^T and dP^T, each its own group: P^T is computed while dP^T runs;
      // then dV += P^T dO and dK += dS^T Q together.  Each is waited for
      // here, in the block that issues it.
      const int s = ring_i % p.stages;
      const unsigned char* const st = ring + s * p.stage_bytes;
      const int qs = qs0 + j * kBlock;
      const bool edge = qs + kBlock > p.lq || ck0 + kRows > p.lk ||
                        (p.causal && qs < ck0 + kRows - 1);
      const float* lse_t = reinterpret_cast<const float*>(st + lse_off);
      mbar_wait(&full[s], (ring_i / p.stages) & 1);
      float sacc[kBlock / 2], dpacc[kBlock / 2];
      ss_issue<T, D, kBlock>(sacc, k_desc, st);                     // S^T = K Q^T
      ss_issue<T, D, kBlock>(dpacc, v_desc, st + Cfg::TILE_BYTES);  // dP^T = V dO^T
      wgmma_wait<1>();
      fence_regs(sacc);
      if (p.mask != nullptr)
        p_tile<true, true>(sacc, p, no_row, madd, lse_t, nullptr, key0, qs, t, edge);
      else
        p_tile<true, false>(sacc, p, no_row, madd, lse_t, nullptr, key0, qs, t, edge);
      wgmma_wait<0>();
      fence_regs(dpacc);
      if (j == n_tiles - 1) mbar_arrive(kv_empty);  // the item's last use of K and V
      ds_tile<true>(dpacc, sacc, no_row, lse_t + kBlock, t);
      uint32_t pp[kBlock / 16][4], pds[kBlock / 16][4];
      pack_a<T, kBlock>(pp, sacc);
      pack_a<T, kBlock>(pds, dpacc);
      rs_issue<T, DP, kBlock>(dv, pp, st + Cfg::TILE_BYTES);  // dO, MN-major
      rs_issue<T, DP, kBlock>(dk, pds, st);                   // Q, MN-major
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        fence_regs(pp[kk]);
        fence_regs(pds[kk]);
      }
      mbar_arrive(&empty[s]);
    }
    if (!active) continue;

    const int b = it.bh / p.heads, h = it.bh % p.heads;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= p.lk) continue;
      T* dkp =
          static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h + (long long)key * p.s0.l + 2 * t;
      T* dvp =
          static_cast<T*>(p.out1) + b * p.s1.b + h * p.s1.h + (long long)key * p.s1.l + 2 * t;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        store2(dkp + n8 * 8, dk[4 * n8 + 2 * i] * p.scale, dk[4 * n8 + 2 * i + 1] * p.scale);
        store2(dvp + n8 * 8, dv[4 * n8 + 2 * i], dv[4 * n8 + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *mask;
  void *out0, *out1;  // dq, or dk and dv
  Strides sq, sk, sv, sdo, s0, s1;
  int bh, heads, lq, lk, heads_per_mask, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq_f32(const Args& a) {
  dim3 grid((a.lq + Tiling<D>::ROWS - 1) / Tiling<D>::ROWS, a.bh);
  flash_bwd_dq_kernel<float, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.mask, static_cast<float*>(a.out0), a.sq, a.sk, a.sv, a.sdo, a.s0, a.heads, a.lq,
      a.lk, a.heads_per_mask, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a) {
  dim3 grid((a.lk + Tiling<D>::ROWS - 1) / Tiling<D>::ROWS, a.bh);
  flash_bwd_dkv_kernel<float, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.mask, static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.sq, a.sk, a.sv,
      a.sdo, a.s0, a.s1, a.heads, a.lq, a.lk, a.heads_per_mask, a.scale, a.causal);
  return cudaGetLastError();
}

// How a launch of a 16-bit kernel is laid out (tests/_flash_bwd_schedule.py
// restates it for the CPU tests).
struct BwdPlan {
  int stages;       // ring stages
  int stage_bytes;  // one stage: two 64-row tiles, then the small rows
  int smem;         // dynamic shared memory of a block
  int units, tiles; // work items: units (b*h) x tiles of 128 rows
};

// dkv: the dk/dv kernel (its stage carries lse and delta), else dq (its
// stage carries the key-mask row when there is a mask)
BwdPlan plan_bwd(int d, int batch, int heads, int lq, int lk, bool mask, bool dkv) {
  BwdPlan pl{};
  const int dp = d < 64 ? 64 : d;
  const int extra = dkv ? 2 * kBlock * 4 : (mask ? kBlock * 4 : 0);
  pl.stage_bytes = (2 * kBlock * dp * 2 + extra + 1023) / 1024 * 1024;
  const int fixed = 1024 + 2 * 2 * kRows * dp * 2 + kBarBytes;
  pl.stages = min(kMaxStages, (kSmemLimit - fixed) / pl.stage_bytes);
  pl.smem = fixed + pl.stages * pl.stage_bytes;
  pl.units = batch * heads;
  pl.tiles = ((dkv ? lk : lq) + 2 * kRows - 1) / (2 * kRows);
  return pl;
}

template <typename T, int D>
cudaError_t launch_wgmma(const Args& a, bool dkv) {
  const int batch = a.bh / a.heads;
  const BwdPlan pl = plan_bwd(D, batch, a.heads, a.lq, a.lk, a.mask != nullptr, dkv);
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (pl.stages < 2) return cudaErrorInvalidConfiguration;
  if ((long long)pl.units * pl.tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const BwdParams p{a.lse, a.delta, a.mask, a.out0, a.out1, a.s0, a.s1, a.heads, a.lq, a.lk,
                    a.heads_per_mask, a.causal, a.scale, pl.stages, pl.stage_bytes, pl.units,
                    pl.tiles};

  // one tensor map per operand per call: the maps hold the pointers
  const CUtensorMapDataType type = hopper::tensor_map_type<T>();
  CUtensorMap q_map, do_map, k_map, v_map;
  if (!hopper::encode_qkv(&q_map, encode, type, a.q, a.sq, D, a.lq, a.heads, batch, 64) ||
      !hopper::encode_qkv(&do_map, encode, type, a.dout, a.sdo, D, a.lq, a.heads, batch, 64) ||
      !hopper::encode_qkv(&k_map, encode, type, a.k, a.sk, D, a.lk, a.heads, batch, 64) ||
      !hopper::encode_qkv(&v_map, encode, type, a.v, a.sv, D, a.lk, a.heads, batch, 64))
    return cudaErrorInvalidPitchValue;

  auto kernel = dkv ? flash_bwd_dkv_wgmma_kernel<T, D> : flash_bwd_dq_wgmma_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  // one block an SM, each walking over work items
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int blocks = (int)min((long long)sms, (long long)pl.units * pl.tiles);
  kernel<<<blocks, kWgmmaThreads, pl.smem, a.stream>>>(q_map, do_map, k_map, v_map, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, bool dkv, int dtype) {
  if (dtype == 0) return dkv ? launch_dkv_f32<D>(a) : launch_dq_f32<D>(a);
  if (dtype == 1) return launch_wgmma<bf16, D>(a, dkv);
  return launch_wgmma<f16, D>(a, dkv);
}

// TMA reads boxes from 16-byte-aligned bases with strides that are multiples
// of 16 bytes: every row of q, k, v and do must start on 16 bytes
bool rows_16b_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.l % 8 == 0;
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const float* mask, void* out0, void* out1,
        const long long* st, int batch, int heads, int lq, int lk, int d, int dtype,
        int mask_b, float scale, int causal, void* stream) {
  const int bh = batch * heads;
  if (bh <= 0 || lq <= 0 || lk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  if (mask != nullptr && (mask_b <= 0 || bh % mask_b != 0)) return cudaErrorInvalidValue;
  if (out0 == nullptr || (dkv && out1 == nullptr)) return cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, mask, out0, out1,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
         {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         bh, heads, lq, lk, mask != nullptr ? bh / mask_b : 1, causal, scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype != 0 &&
      !(rows_16b_aligned(q, a.sq) && rows_16b_aligned(k, a.sk) && rows_16b_aligned(v, a.sv) &&
        rows_16b_aligned(dout, a.sdo)))
    return cudaErrorMisalignedAddress;
  switch (d) {
    case 16: return launch<16>(a, dkv, dtype);
    case 32: return launch<32>(a, dkv, dtype);
    case 64: return launch<64>(a, dkv, dtype);
    case 128: return launch<128>(a, dkv, dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Both entries take the same arguments.  dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.
// Pointers to device memory: q, k, v, do in the input type; lse and delta
// contiguous (B*H, lq) f32; mask (mask_b, lk) f32 (1 = attend) or null;
// out0/out1 = dq (the dq entry; out1 unused) or dk, dv.  The 18 strides (in
// elements) are the (b, h, l) strides of q, k, v, do, out0, out1, each a
// (B, H, L, D) view with D contiguous; in bfloat16 and float16 every row of q, k, v and
// do must start on a 16-byte boundary (else cudaErrorMisalignedAddress).
// Returns the cudaError_t of the launch (cudaErrorInvalidPitchValue: libcuda
// refused a tensor map of these operands).
#define TPU_AIR_BWD_ENTRY(NAME, DKV)                                                   \
  int NAME(const void* q, const void* k, const void* v, const void* dout,             \
           const float* lse, const float* delta, const float* mask, void* out0,       \
           void* out1, long long sq_b, long long sq_h, long long sq_l, long long sk_b, \
           long long sk_h, long long sk_l, long long sv_b, long long sv_h,            \
           long long sv_l, long long sdo_b, long long sdo_h, long long sdo_l,         \
           long long s0_b, long long s0_h, long long s0_l, long long s1_b,            \
           long long s1_h, long long s1_l, int batch, int heads, int lq, int lk,      \
           int d, int dtype, int mask_b, float scale, int causal, void* stream) {      \
    const long long st[18] = {sq_b, sq_h, sq_l, sk_b, sk_h, sk_l, sv_b, sv_h, sv_l,   \
                              sdo_b, sdo_h, sdo_l, s0_b, s0_h, s0_l, s1_b, s1_h, s1_l}; \
    return run(DKV, q, k, v, dout, lse, delta, mask, out0, out1, st, batch, heads,    \
               lq, lk, d, dtype, mask_b, scale, causal, stream);                      \
  }

TPU_AIR_BWD_ENTRY(flash_attention_bwd_dq, false)
TPU_AIR_BWD_ENTRY(flash_attention_bwd_dkv, true)
#undef TPU_AIR_BWD_ENTRY

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
