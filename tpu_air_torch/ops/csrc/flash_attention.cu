// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces tpu_air/ops/flash_attention.py::_kernel (and its _kernel_nb /
// _kernel_nm / _kernel_nbm arities), launched there by _pallas_fwd.
//
// What it computes, per (batch*head, query row):
//   s_j   = (q . k_j) * scale + bias[bh % nb][i][j] + (1 - mask[b][j]) * -1e30
//   out_i = sum_j softmax(s)_j v_j      (f32 online softmax, f32 accumulation)
//   lse_i = m_i + log(l_i)              (f32)
// Keys after the query (causal) and keys past Lk (a ragged last tile) get
// weight exactly 0.  The key mask uses the finite -1e30, so a row whose
// every visible key is masked yields the mean of the visible V, finite.
//
// What bounds it on the H100: operations, at the long-context LM shape (B*H
// 8, L 8192, D 128, causal: 137.5 GFLOP, 0.14 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 0.02 ms of memory traffic); bytes, just, at the
// T5-base encoder shape (B 64, H 12, L 512, D 64, with the f32 batch-shared
// bias: ~170 MB and ~52 GFLOP).  Only the tensor cores come near either
// bound: the CUDA cores peak at 67 TFLOP/s in f32.
//
// bf16 (flash_fwd_mma_kernel), the FlashAttention-2 form on mma.sync: one
// block of 4 warps per (b*h, 64-row query tile), each warp owning 16 query
// rows whose Q fragments it loads once into registers.  64-key K/V tiles
// pass through a two-stage cp.async ring in dynamic shared memory (padded
// rows, so ldmatrix is free of bank conflicts), tile j + 1 loading while
// tile j multiplies.  S = Q K^T runs on the tensor cores into f32
// fragments; scale, bias and key mask are applied there.  The key mask row
// and the (64, 64) tile of the f32 bias ride the same cp.async ring as K/V,
// so their latency hides behind the previous tile's products; the bias is
// read from the (1|H|B*H, Lq, Lk) array, which L2 keeps for the other batch
// elements, and is never expanded over the batch.  The online softmax takes
// each row's max and sum across the 4 lanes that hold it.  P is rounded to bf16 in registers
// and is directly the A operand of O += P V (V through ldmatrix.trans): P
// never touches shared memory.  This is the reference's precision: the
// Pallas kernel casts p to v's type before its product and accumulates in
// f32.  Under causal masking, tiles wholly past the diagonal are skipped,
// only tiles on it (or past Lk) mask element by element, and the query tiles
// launch longest first so the triangle leaves no SM idle at the end.
//
// f32 (flash_fwd_kernel<float, D>) keeps the CUDA-core kernel: the tensor
// cores have no f32 product but TF32, whose 10-bit mantissa would break the
// f32 parity of the port against its plain version.  One block per (b*h,
// query tile) streams 32-key tiles through static shared memory; every
// score is a dot product of scalar FMAs fed from shared memory, which bounds
// it.
//
// q/k/v/out are read and written through (b, h, l) strides with D
// contiguous, so the [b, L, h, d] projection layout needs no transposed
// copy; the bf16 path needs every row 16-byte aligned (the wrapper checks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBlockK = 32;

struct Strides {  // element strides of a (B, H, L, D) view; D is contiguous
  long long b, h, l;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// Tiling for head dim D: TPR threads share one query row, each owning DP of
// its D columns, strided by TPR so that the threads of one row read
// neighbouring shared-memory words (distinct banks).
template <int D> struct Tiling {
  static constexpr int TPR = D <= 32 ? 1 : D / 32;
  static constexpr int DP = D / TPR;
  static constexpr int BQ = kThreads / TPR;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int heads, int lq, int lk, int bias_n,
                 int heads_per_mask, float scale, int causal) {
  constexpr int TPR = Tiling<D>::TPR;
  constexpr int DP = Tiling<D>::DP;
  constexpr int BQ = Tiling<D>::BQ;
  constexpr int BK = kBlockK;

  __shared__ float k_s[BK][D];
  __shared__ float v_s[BK][D];
  __shared__ float b_s[BQ][BK + 1];  // +1: rows of one warp hit distinct banks
  __shared__ float m_s[BK];

  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int part = tid % TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < lq;

  const T* qb = q + bi * sq.b + hi * sq.h;
  const T* kb = k + bi * sk.b + hi * sk.h;
  const T* vb = v + bi * sv.b + hi * sv.h;
  const float* biasb =
      bias ? bias + (long long)(bias_n == 1 ? 0 : bh % bias_n) * lq * lk : nullptr;
  const float* maskb = mask ? mask + (long long)(bh / heads_per_mask) * lk : nullptr;

  float qv[DP];
  float acc[DP];
#pragma unroll
  for (int e = 0; e < DP; ++e) {
    qv[e] = row_ok ? qb[qi * sq.l + e * TPR + part] : 0.f;
    acc[e] = 0.f;
  }
  float m_run = kNegInf;
  float l_run = 0.f;

  // causal: key tiles wholly after this query tile's last row carry no weight
  const int k_end = causal ? min(lk, q0 + BQ) : lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int nk = min(BK, lk - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BK * D; i += kThreads) {
      const int j = i / D;
      const int e = i % D;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        kx = kb[(k0 + j) * sk.l + e];
        vx = vb[(k0 + j) * sv.l + e];
      }
      k_s[j][e] = kx;
      v_s[j][e] = vx;
    }
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int rr = i / BK;
      const int j = i % BK;
      float bx = 0.f;
      if (biasb != nullptr && j < nk && q0 + rr < lq)
        bx = biasb[(long long)(q0 + rr) * lk + k0 + j];
      b_s[rr][j] = bx;
    }
    if (tid < BK) {
      float mx = 0.f;
      if (maskb != nullptr && tid < nk) mx = (1.f - maskb[k0 + tid]) * kNegInf;
      m_s[tid] = mx;
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < DP; ++e) dot = fmaf(qv[e], k_s[j][e * TPR + part], dot);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float sx = dot * scale;
      sx = sx + b_s[r][j];
      sx = sx + m_s[j];
      // after the query, or past the sequence: weight exactly 0
      if ((causal && k0 + j > qi) || j >= nk) sx = -INFINITY;
      s[j] = sx;
      tile_max = fmaxf(tile_max, sx);
    }
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l_run = l_run * alpha + psum;
#pragma unroll
    for (int e = 0; e < DP; ++e) {
      float a = acc[e] * alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) a = fmaf(s[j], v_s[j][e * TPR + part], a);
      acc[e] = a;
    }
    m_run = m_new;
  }

  if (row_ok) {
    const float safe_l = l_run == 0.f ? 1.f : l_run;
    T* ob = out + bi * so.b + hi * so.h + qi * so.l;
#pragma unroll
    for (int e = 0; e < DP; ++e) ob[e * TPR + part] = acc[e] / safe_l;
    if (part == 0) lse[(long long)bh * lq + qi] = m_run + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

template <int D> struct MmaFwd {
  static constexpr int BQ = 64;                 // query rows per block, 16 per warp
  static constexpr int BK = 64;                 // keys per tile
  static constexpr int LD = D + 8;              // padded shared row, elements
  static constexpr int LDB = BK + 8;            // padded bias row, floats (see below)
  // Q, two stages of K, V and of the key mask row; with a bias, two stages of
  // its (BQ, BK) tile
  static constexpr int SMEM = (BQ + 4 * BK) * LD * (int)sizeof(bf16) + 2 * BK * (int)sizeof(float);
  static constexpr int SMEM_BIAS = SMEM + 2 * BQ * LDB * (int)sizeof(float);
};

// Stage the (BQ, BK) f32 bias tile at (q0, k0), zero past lq or lk: 16-byte
// copies when every row of the bias is 16-byte aligned (lk % 4 == 0), else
// 4-byte ones.
template <int D>
__device__ __forceinline__ void stage_bias(float* tile, const float* bias, int q0, int k0,
                                           int lq, int lk) {
  using namespace mma_bf16;
  constexpr int BQ = MmaFwd<D>::BQ, BK = MmaFwd<D>::BK, LDB = MmaFwd<D>::LDB;
  if (lk % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BQ * BK / 4 / kThreads; ++i) {
      const int c = i * kThreads + threadIdx.x;
      const int r = c / (BK / 4), col = (c % (BK / 4)) * 4;
      const bool ok = q0 + r < lq && k0 + col < lk;
      cp_async16(tile + r * LDB + col, ok ? bias + (long long)(q0 + r) * lk + k0 + col : bias, ok);
    }
  } else {
    for (int i = 0; i < BQ * BK / kThreads; ++i) {
      const int c = i * kThreads + threadIdx.x;
      const int r = c / BK, col = c % BK;
      const bool ok = q0 + r < lq && k0 + col < lk;
      cp_async4(tile + r * LDB + col, ok ? bias + (long long)(q0 + r) * lk + k0 + col : bias, ok);
    }
  }
}

// Two blocks an SM: that also keeps ptxas from capping the D = 32 instance at
// 128 registers, where it would spill.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ out,
                     float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                     Strides so, int heads, int lq, int lk, int bias_n,
                     int heads_per_mask, float scale, int causal) {
  using namespace mma_bf16;
  constexpr int BQ = MmaFwd<D>::BQ, BK = MmaFwd<D>::BK, LD = MmaFwd<D>::LD;
  constexpr int LDB = MmaFwd<D>::LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * LD;  // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;
  float* mask_s = reinterpret_cast<float*>(v_s + 2 * BK * LD);  // [2][BK]
  // [2][BQ][LDB]: with rows of 72 floats a warp's float2 fragment read (8
  // rows x 32 bytes) takes the 2 wavefronts its 256 bytes need, no more
  float* bias_s = mask_s + 2 * BK;

  const int bh = blockIdx.x;
  // causal: the longest query tiles (the last ones) are launched first
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * BQ;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const bf16* qb = q + bi * sq.b + hi * sq.h;
  const bf16* kb = k + bi * sk.b + hi * sk.h;
  const bf16* vb = v + bi * sv.b + hi * sv.h;
  const float* biasb =
      bias ? bias + (long long)(bias_n == 1 ? 0 : bh % bias_n) * lq * lk : nullptr;
  const float* maskb = mask ? mask + (long long)(bh / heads_per_mask) * lk : nullptr;

  // causal: key tiles wholly after this query tile's last row carry no weight
  const int k_end = causal ? min(lk, q0 + BQ) : lk;
  const int n_tiles = (k_end + BK - 1) / BK;

  // K, V, key mask and bias of key tile j into stage j & 1
  auto stage_keys = [&](int j) {
    const int k0 = j * BK, buf = j & 1;
    stage_rows<D, BK, kThreads>(k_s + buf * BK * LD, kb, sk.l, k0, lk);
    stage_rows<D, BK, kThreads>(v_s + buf * BK * LD, vb, sv.l, k0, lk);
    if (maskb != nullptr && threadIdx.x < BK) {
      const bool ok = k0 + threadIdx.x < lk;
      cp_async4(mask_s + buf * BK + threadIdx.x, ok ? maskb + k0 + threadIdx.x : maskb, ok);
    }
    if (biasb != nullptr) stage_bias<D>(bias_s + buf * BQ * LDB, biasb, q0, k0, lq, lk);
  };
  stage_rows<D, BQ, kThreads>(q_s, qb, sq.l, q0, lq);
  stage_keys(0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's part of the row sums

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
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], a_addr(q_s, LD, warp * 16, kk * 16, lane));
    }
    const bf16* ks = k_s + (j & 1) * BK * LD;
    const bf16* vs = v_s + (j & 1) * BK * LD;
    const float* mask_t = mask_s + (j & 1) * BK;
    const float* bias_t = bias_s + (j & 1) * BQ * LDB + (warp * 16 + g) * LDB + 2 * t;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, bt_addr(ks, LD, n2 * 16, kk * 16, lane));
        mma(s[2 * n2], qf[kk], b[0], b[1]);
        mma(s[2 * n2 + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, bias, key mask; weight exactly 0 after the query or past Lk
    const bool edge = k0 + BK > lk || (causal && k0 + BK - 1 > q0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      // the staged bias and mask are 0 past lq and lk, where keys get -inf below
      float2 bias_r0 = make_float2(0.f, 0.f), bias_r1 = bias_r0, mask2 = bias_r0;
      if (biasb != nullptr) {
        bias_r0 = *reinterpret_cast<const float2*>(bias_t + n * 8);
        bias_r1 = *reinterpret_cast<const float2*>(bias_t + 8 * LDB + n * 8);
      }
      if (maskb != nullptr) {
        mask2 = *reinterpret_cast<const float2*>(mask_t + n * 8 + 2 * t);
        mask2 = make_float2((1.f - mask2.x) * kNegInf, (1.f - mask2.y) * kNegInf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        const float2 bias2 = e < 2 ? bias_r0 : bias_r1;
        x += (e & 1) ? bias2.y : bias2.x;
        x += (e & 1) ? mask2.y : mask2.x;
        if (edge && ((causal && key > row) || key >= lk)) x = -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    // online softmax: a row lives in the 4 lanes of a quad
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - mx[e / 2]);
        l_run[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_addr(vs, LD, kk * 16, n2 * 16, lane));
        mma(o[2 * n2], a, b[0], b[1]);
        mma(o[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load overwrites it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = l == 0.f ? 1.f : l;
    const int row = i == 0 ? row0 : row1;
    if (row < lq) {
      bf16* ob = out + bi * so.b + hi * so.h + (long long)row * so.l + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(ob + n * 8) =
            __floats2bfloat162_rn(o[n][2 * i] / safe_l, o[n][2 * i + 1] / safe_l);
      if (t == 0) lse[(long long)bh * lq + row] = m_run[i] + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float *bias, *mask;
  void* out;
  float* lse;
  Strides sq, sk, sv, so;
  int bh, heads, lq, lk, bias_n, heads_per_mask, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_f32(const Args& a) {
  dim3 grid((a.lq + Tiling<D>::BQ - 1) / Tiling<D>::BQ, a.bh);
  flash_fwd_kernel<float, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, a.mask, static_cast<float*>(a.out), a.lse,
      a.sq, a.sk, a.sv, a.so, a.heads, a.lq, a.lk, a.bias_n, a.heads_per_mask, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  const int smem = a.bias != nullptr ? MmaFwd<D>::SMEM_BIAS : MmaFwd<D>::SMEM;
  const int tiles = (a.lq + MmaFwd<D>::BQ - 1) / MmaFwd<D>::BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MmaFwd<D>::SMEM_BIAS);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<D><<<dim3(a.bh, tiles), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.bias, a.mask, static_cast<bf16*>(a.out), a.lse,
      a.sq, a.sk, a.sv, a.so, a.heads, a.lq, a.lk, a.bias_n, a.heads_per_mask, a.scale,
      a.causal);
  return cudaGetLastError();
}

// cp.async reads 16-byte chunks: every row of q, k and v must start on one
bool rows_16b_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.l % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Pointers to device memory; bias
// (bias_n, lq, lk) f32 and mask (B, lk) f32 (1 = attend) may be null.  The
// q/k/v/out strides (in elements) describe (B, H, L, D) views with D
// contiguous; for bfloat16 the q/k/v pointers and strides must be multiples
// of 16 bytes.  lse is a contiguous (B*H, lq) f32 array.  Returns the
// cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* bias, const float* mask, void* out, float* lse,
                        long long sq_b, long long sq_h, long long sq_l,
                        long long sk_b, long long sk_h, long long sk_l,
                        long long sv_b, long long sv_h, long long sv_l,
                        long long so_b, long long so_h, long long so_l,
                        int batch, int heads, int lq, int lk, int d, int dtype,
                        int bias_n, int mask_b, float scale, int causal,
                        void* stream) {
  const int bh = batch * heads;
  if (bh <= 0 || lq <= 0 || lk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  if (bias != nullptr && (bias_n <= 0 || bh % bias_n != 0)) return cudaErrorInvalidValue;
  if (mask != nullptr && (mask_b <= 0 || bh % mask_b != 0)) return cudaErrorInvalidValue;
  const Args a{q, k, v, bias, mask, out, lse,
               {sq_b, sq_h, sq_l}, {sk_b, sk_h, sk_l}, {sv_b, sv_h, sv_l}, {so_b, so_h, so_l},
               bh, heads, lq, lk, bias_n, mask != nullptr ? bh / mask_b : 1, causal, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(a);
      case 32: return launch_f32<32>(a);
      case 64: return launch_f32<64>(a);
      case 128: return launch_f32<128>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    if (!rows_16b_aligned(q, a.sq) || !rows_16b_aligned(k, a.sk) || !rows_16b_aligned(v, a.sv))
      return cudaErrorMisalignedAddress;
    switch (d) {
      case 16: return launch_bf16<16>(a);
      case 32: return launch_bf16<32>(a);
      case 64: return launch_bf16<64>(a);
      case 128: return launch_bf16<128>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
