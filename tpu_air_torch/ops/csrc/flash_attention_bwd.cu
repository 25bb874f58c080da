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
// Sums are f32; outputs are written in the input type.
//
// What bounds them on the H100: operations.  At the long-context LM shape
// (B*H = 8, L = 8192, D = 128, causal, bf16) dq does 206 GFLOP (3 products
// of 2 * D flops per live (i, j) pair) and dk/dv 275 GFLOP (4 products) on
// 84 and 101 MB of inputs and outputs: 0.21 and 0.28 ms at the 989 TFLOP/s bf16
// tensor-core peak, far above the ~0.03 ms of memory traffic.
//
// Hopper has no ordered grid: the TPU kernels carry their accumulators in
// VMEM across a sequential grid axis.  Here each block owns its output rows
// and loops over the other axis itself -- the dq kernel one block per
// (batch*head, query tile) over key tiles up to the causal end, the dk/dv
// kernel one block per (batch*head, key tile) over query tiles from the
// first one the causal mask leaves live -- with the accumulators in
// registers.  No atomics, so results are deterministic.  q/k/v/do are read
// and dq/dk/dv written through (b, h, l) strides with D contiguous, so the
// model's [b, L, h, d] projections need no transposed copy.
//
// In bf16 and f16 both kernels run every product on the tensor cores
// (mma.sync m16n8k16, 16-bit operands, f32 accumulation), from the helpers
// of mma_bf16.cuh, and each is the mirror image of the other.  Each is one
// template over the 16-bit type T: the two instances differ only in the
// mma.sync form and in the rounding of P and dS (to T).
//
// dq (flash_bwd_dq_mma_kernel): one block of 4 warps per (b*h, 64-row query
// tile), each warp owning 16 query rows, with its dQ accumulator in f32
// fragments (D / 2 registers a lane).  Q and dO stay in shared memory and
// their A fragments are fetched by ldmatrix at each use: holding them in
// registers as well (D / 2 more a lane each) would leave no room for one key
// tile's S and dP fragments (32 registers each) at D = 128.  64-key K/V
// tiles and the key mask row pass through a two-stage cp.async ring, tile
// j + 1 loading while tile j multiplies.  Per tile, all in registers: S = Q
// K^T, P = exp(S - lse) with the hard zero, dP = dO V^T, dS = P (dP -
// delta), dQ += dS K, with K read as B through ldmatrix.trans from the
// tile S read it from; dS is rounded to T as the A operand, as the
// Pallas kernel casts ds before its product.  Under causal masking only key
// tiles up to the diagonal are visited, only the tile(s) that cross it mask
// element by element, and the last query tiles (the most keys) start first.
// The scale multiplies once, in the epilogue.
//
// dk/dv (flash_bwd_dkv_mma_kernel): one block of 4 warps per
// (b*h, 64-key tile), each warp owning 16 keys, with its dK and dV
// accumulators in f32 fragments.  K and V stay in shared memory and their
// fragments are fetched by ldmatrix at each use, which keeps the two
// accumulators (2 * D / 2 registers a lane) plus one query tile's score
// fragments under the register limit; at D = 128 the query tile is 32 rows
// for the same reason.  Query tiles (Q, dO, lse, delta) pass through a
// two-stage cp.async ring, tile i + 1 loading while tile i multiplies.  Per
// tile, all in registers: S^T = K Q^T, P^T = exp(S^T - lse) with the hard
// zero, dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T
// Q; P^T and dS^T are rounded to T as the A operand of the next product,
// as the Pallas kernel casts p and ds before its products.  Key tiles
// launch in order, so under causal masking the longest (the first) start
// first.
//
// In f32 both run on the CUDA cores (flash_bwd_dq_kernel<float, D>,
// flash_bwd_dkv_kernel<float, D>; the tensor cores' only f32 product is
// TF32, too coarse for the f32 parity of the port): every operand
// is read from shared memory as float4 (one load per four FMAs) and the
// threads that share a row read neighbouring 16-byte words, so a warp's load
// is one conflict-free wavefront; FMA throughput and those loads bound them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

template <int D> struct MmaDkv {
  static constexpr int BK = 64;                  // keys per block, 16 per warp
  static constexpr int BQ = D >= 128 ? 32 : 64;  // query rows per step
  static constexpr int LD = D + 8;               // padded shared row, elements
  // K, V; two stages of Q, dO; two stages of lse, delta; the key mask row
  static constexpr int SMEM = (2 * BK + 4 * BQ) * LD * 2 +
                              (4 * BQ + BK) * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ mask, T* __restrict__ dk,
                         T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, int heads, int lq, int lk,
                         int heads_per_mask, float scale, int causal) {
  using namespace mma_bf16;
  constexpr int BK = MmaDkv<D>::BK, BQ = MmaDkv<D>::BQ, LD = MmaDkv<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* v_s = k_s + BK * LD;                      // [BK][LD]
  T* q_s = v_s + BK * LD;                      // [2][BQ][LD]
  T* do_s = q_s + 2 * BQ * LD;                 // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                              // [2][BQ]
  float* madd_s = delta_s + 2 * BQ;  // [BK] the additive key mask of this block's keys

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;  // this lane's keys: k0 + row0 and k0 + row0 + 8

  const T* qb = q + bi * sq.b + hi * sq.h;
  const T* dob = dout + bi * sdo.b + hi * sdo.h;
  const float* lseb = lse + (long long)bh * lq;
  const float* deltab = delta + (long long)bh * lq;
  if (threadIdx.x < BK) {  // read after the first __syncthreads below
    const int key = k0 + threadIdx.x;
    madd_s[threadIdx.x] = (mask != nullptr && key < lk)
                              ? (1.f - mask[(long long)(bh / heads_per_mask) * lk + key]) * kNegInf
                              : 0.f;
  }

  // causal: queries before this block's first key see none of its keys
  const int qs0 = causal ? k0 : 0;
  const int n_q = qs0 < lq ? (lq - qs0 + BQ - 1) / BQ : 0;
  auto stage_q = [&](int it) {
    const int qs = qs0 + it * BQ, buf = it & 1;
    stage_rows<D, BQ, kThreads>(q_s + buf * BQ * LD, qb, sq.l, qs, lq);
    stage_rows<D, BQ, kThreads>(do_s + buf * BQ * LD, dob, sdo.l, qs, lq);
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x;
      const bool ok = qs + i < lq;
      cp_async4(lse_s + buf * BQ + i, ok ? lseb + qs + i : lseb, ok);
      cp_async4(delta_s + buf * BQ + i, ok ? deltab + qs + i : deltab, ok);
    }
  };
  stage_rows<D, BK, kThreads>(k_s, k + bi * sk.b + hi * sk.h, sk.l, k0, lk);
  stage_rows<D, BK, kThreads>(v_s, v + bi * sv.b + hi * sv.h, sv.l, k0, lk);
  if (n_q > 0) stage_q(0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int qs = qs0 + it * BQ, buf = it & 1;
    if (it + 1 < n_q) {  // tile it + 1 loads while tile it multiplies
      stage_q(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qt = q_s + buf * BQ * LD;
    const T* do_t = do_s + buf * BQ * LD;
    const float* lset = lse_s + buf * BQ;
    const float* deltat = delta_s + buf * BQ;

    // S^T = K Q^T: 16 keys x BQ queries per warp
    float s[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr(k_s, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < BQ / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, bt_addr(qt, LD, n2 * 16, kk * 16, lane));
        mma<T>(s[2 * n2], a, b[0], b[1]);
        mma<T>(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    // P^T = exp(S^T - lse), hard-zeroed where masked, causal or ragged
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 8 * (e / 2);
        const int key = k0 + r;
        const int col = n * 8 + 2 * t + (e & 1);
        const float x = s[n][e] * scale + madd_s[r];
        const bool live = key < lk && qs + col < lq && !(causal && key > qs + col) &&
                          x > kMaskedAtOrBelow;
        s[n][e] = live ? __expf(x - lset[col]) : 0.f;
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      to_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_addr(do_t, LD, kk * 16, n2 * 16, lane));
        mma<T>(dv_acc[2 * n2], a, b[0], b[1]);
        mma<T>(dv_acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    // dP^T = V dO^T
    float dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr(v_s, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < BQ / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, bt_addr(do_t, LD, n2 * 16, kk * 16, lane));
        mma<T>(dp[2 * n2], a, b[0], b[1]);
        mma<T>(dp[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - deltat[n * 8 + 2 * t + (e & 1)]);
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      to_a<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_addr(qt, LD, kk * 16, n2 * 16, lane));
        mma<T>(dk_acc[2 * n2], a, b[0], b[1]);
        mma<T>(dk_acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }
  cp_async_wait<0>();  // no copy outlives the block (n_q == 0 never waited)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + 8 * i;
    if (key >= lk) continue;
    T* dkp = dk + bi * sdk.b + hi * sdk.h + (long long)key * sdk.l + 2 * t;
    T* dvp = dv + bi * sdv.b + hi * sdv.h + (long long)key * sdv.l + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(dkp + n * 8, dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      store2(dvp + n * 8, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D> struct MmaDq {
  static constexpr int BQ = 64;     // query rows per block, 16 per warp
  static constexpr int BK = 64;     // keys per step
  static constexpr int LD = D + 8;  // padded shared row, elements
  // Q, dO; two stages of K, V and of the key mask row
  static constexpr int SMEM = (2 * BQ + 4 * BK) * LD * 2 +
                              2 * BK * (int)sizeof(float);
};

// Two blocks an SM, what the shared memory allows at D = 128 (104,960 B each).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ mask, T* __restrict__ dq, Strides sq,
                        Strides sk, Strides sv, Strides sdo, Strides sdq, int heads, int lq,
                        int lk, int heads_per_mask, float scale, int causal) {
  using namespace mma_bf16;
  constexpr int BQ = MmaDq<D>::BQ, BK = MmaDq<D>::BK, LD = MmaDq<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* do_s = q_s + BQ * LD;                     // [BQ][LD]
  T* k_s = do_s + BQ * LD;                     // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]
  float* mask_s = reinterpret_cast<float*>(v_s + 2 * BK * LD);  // [2][BK]

  const int bh = blockIdx.x;
  // causal: the query tiles that see the most keys (the last ones) start first
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * BQ;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this lane's query rows

  const T* kb = k + bi * sk.b + hi * sk.h;
  const T* vb = v + bi * sv.b + hi * sv.h;
  const float* maskb = mask ? mask + (long long)(bh / heads_per_mask) * lk : nullptr;

  // causal: key tiles wholly after this query tile's last row carry no weight
  const int k_end = causal ? min(lk, q0 + BQ) : lk;
  const int n_tiles = (k_end + BK - 1) / BK;

  // K, V and key mask of key tile j into stage j & 1
  auto stage_keys = [&](int j) {
    const int k0 = j * BK, buf = j & 1;
    stage_rows<D, BK, kThreads>(k_s + buf * BK * LD, kb, sk.l, k0, lk);
    stage_rows<D, BK, kThreads>(v_s + buf * BK * LD, vb, sv.l, k0, lk);
    if (maskb != nullptr && threadIdx.x < BK) {
      const bool ok = k0 + threadIdx.x < lk;
      cp_async4(mask_s + buf * BK + threadIdx.x, ok ? maskb + k0 + threadIdx.x : maskb, ok);
    }
  };
  stage_rows<D, BQ, kThreads>(q_s, q + bi * sq.b + hi * sq.h, sq.l, q0, lq);
  stage_rows<D, BQ, kThreads>(do_s, dout + bi * sdo.b + hi * sdo.h, sdo.l, q0, lq);
  stage_keys(0);
  cp_async_commit();

  const float* lseb = lse + (long long)bh * lq;
  const float* deltab = delta + (long long)bh * lq;
  const float lse_r[2] = {row0 < lq ? lseb[row0] : 0.f, row1 < lq ? lseb[row1] : 0.f};
  const float delta_r[2] = {row0 < lq ? deltab[row0] : 0.f, row1 < lq ? deltab[row1] : 0.f};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_tiles) {  // tile j + 1 loads while tile j multiplies
      stage_keys(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_s + (j & 1) * BK * LD;
    const T* vs = v_s + (j & 1) * BK * LD;
    const float* mask_t = mask_s + (j & 1) * BK;

    // S = Q K^T: 16 rows x BK keys per warp; Q fragments from shared memory
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr(q_s, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, bt_addr(ks, LD, n2 * 16, kk * 16, lane));
        mma<T>(s[2 * n2], a, b[0], b[1]);
        mma<T>(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    // P = exp(S * scale + mask - lse), hard-zeroed where masked; causal and
    // ragged keys only on the tiles that reach past the diagonal or Lk
    const bool edge = k0 + BK > lk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float2 madd = make_float2(0.f, 0.f);
      if (maskb != nullptr) {
        const float2 m2 = *reinterpret_cast<const float2*>(mask_t + n * 8 + 2 * t);
        madd = make_float2((1.f - m2.x) * kNegInf, (1.f - m2.y) * kNegInf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float x = s[n][e] * scale + ((e & 1) ? madd.y : madd.x);
        bool live = x > kMaskedAtOrBelow;
        if (edge) live = live && key < lk && !(causal && key > row);
        s[n][e] = live ? __expf(x - lse_r[e / 2]) : 0.f;
      }
    }
    // dP = dO V^T
    float dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr(do_s, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, bt_addr(vs, LD, n2 * 16, kk * 16, lane));
        mma<T>(dp[2 * n2], a, b[0], b[1]);
        mma<T>(dp[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    // dS = P (dP - delta)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - delta_r[e / 2]);
    // dQ += dS K: dS rounded to T as the A operand, K (keys x D) as B
    // through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      to_a<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_addr(ks, LD, kk * 16, n2 * 16, lane));
        mma<T>(acc[2 * n2], a, b[0], b[1]);
        mma<T>(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row0 : row1;
    if (row >= lq) continue;
    T* dqp = dq + bi * sdq.b + hi * sdq.h + (long long)row * sdq.l + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(dqp + n * 8, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

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

template <typename T, int D>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr int smem = MmaDq<D>::SMEM;
  const int tiles = (a.lq + MmaDq<D>::BQ - 1) / MmaDq<D>::BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<T, D><<<dim3(a.bh, tiles), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      a.mask, static_cast<T*>(a.out0), a.sq, a.sk, a.sv, a.sdo, a.s0, a.heads, a.lq,
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

template <typename T, int D>
cudaError_t launch_dkv_mma(const Args& a) {
  constexpr int smem = MmaDkv<D>::SMEM;
  const int tiles = (a.lk + MmaDkv<D>::BK - 1) / MmaDkv<D>::BK;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_mma_kernel<T, D><<<dim3(a.bh, tiles), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      a.mask, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.sq, a.sk, a.sv,
      a.sdo, a.s0, a.s1, a.heads, a.lq, a.lk, a.heads_per_mask, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, bool dkv, int dtype) {
  if (dtype == 0) return dkv ? launch_dkv_f32<D>(a) : launch_dq_f32<D>(a);
  if (dtype == 1) return dkv ? launch_dkv_mma<bf16, D>(a) : launch_dq_mma<bf16, D>(a);
  return dkv ? launch_dkv_mma<f16, D>(a) : launch_dq_mma<f16, D>(a);
}

// cp.async reads 16-byte chunks: every row of q, k, v and do must start on one
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
// Returns the cudaError_t of the launch.
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
