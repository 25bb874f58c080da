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
// What bounds it on the H100: at the T5-base encoder shape (B=64, H=12,
// L=512, D=64, bf16) the function moves ~215 MB (q, k, v, out, the f32
// batch-shared bias, lse) and does ~52 GFLOP, so the card's bound is the
// ~64 us of memory traffic, just above the ~52 us of tensor-core work.  The
// design keeps the (Lq, Lk) score matrix out of device memory: one block per
// (bh, query tile) streams K/V tiles through shared memory and holds the
// softmax statistics and the output accumulator in registers.  The bias is
// never expanded over the batch: a block reads its head's tile of the
// (1|H|B*H, Lq, Lk) array, which the L2 cache (50 MB) keeps for the other
// batch elements.  q/k/v/out are read and written through strides, so the
// [b, L, h, d] projection layout needs no transposed copy.  The products run
// on the CUDA cores in f32; that leaves it far from the bound (the shared
// memory loads feeding the FMAs limit it).  Moving the two products onto the
// tensor cores (mma.sync / wgmma) is the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBlockK = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tiling for head dim D: TPR threads share one query row, each owning DP of
// its D columns, strided by TPR so that the threads of one row read
// neighbouring shared-memory words (distinct banks).
template <int D> struct Tiling {
  static constexpr int TPR = D <= 32 ? 1 : D / 32;
  static constexpr int DP = D / TPR;
  static constexpr int BQ = kThreads / TPR;
};

struct Strides {  // element strides of a (B, H, L, D) view; D is contiguous
  long long b, h, l;
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
    qv[e] = row_ok ? to_f32(qb[qi * sq.l + e * TPR + part]) : 0.f;
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
        kx = to_f32(kb[(k0 + j) * sk.l + e]);
        vx = to_f32(vb[(k0 + j) * sv.l + e]);
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
    for (int e = 0; e < DP; ++e) ob[e * TPR + part] = from_f32<T>(acc[e] / safe_l);
    if (part == 0) lse[(long long)bh * lq + qi] = m_run + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* mask, void* out, float* lse, Strides sq, Strides sk,
                   Strides sv, Strides so, int bh, int heads, int lq, int lk,
                   int bias_n, int heads_per_mask, float scale, int causal,
                   cudaStream_t stream) {
  dim3 grid((lq + Tiling<D>::BQ - 1) / Tiling<D>::BQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, mask, static_cast<T*>(out), lse, sq, sk, sv, so, heads, lq, lk, bias_n,
      heads_per_mask, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const float* bias, const float* mask, void* out, float* lse,
                       Strides sq, Strides sk, Strides sv, Strides so, int bh,
                       int heads, int lq, int lk, int bias_n, int heads_per_mask,
                       float scale, int causal, cudaStream_t stream) {
#define TPU_AIR_FLASH_CASE(DD)                                                      \
  case DD:                                                                          \
    return launch<T, DD>(q, k, v, bias, mask, out, lse, sq, sk, sv, so, bh, heads, \
                         lq, lk, bias_n, heads_per_mask, scale, causal, stream);
  switch (d) {
    TPU_AIR_FLASH_CASE(16)
    TPU_AIR_FLASH_CASE(32)
    TPU_AIR_FLASH_CASE(64)
    TPU_AIR_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef TPU_AIR_FLASH_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Pointers to device memory; bias
// (bias_n, lq, lk) f32 and mask (B, lk) f32 (1 = attend) may be null.  The
// q/k/v/out strides (in elements) describe (B, H, L, D) views with D
// contiguous; lse is a contiguous (B*H, lq) f32 array.  Returns the
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
  const int heads_per_mask = mask != nullptr ? bh / mask_b : 1;
  const Strides sq{sq_b, sq_h, sq_l}, sk{sk_b, sk_h, sk_l}, sv{sv_b, sv_h, sv_l},
      so{so_b, so_h, so_l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, bias, mask, out, lse, sq, sk, sv, so, bh,
                             heads, lq, lk, bias_n, heads_per_mask, scale, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, bias, mask, out, lse, sq, sk, sv, so,
                                     bh, heads, lq, lk, bias_n, heads_per_mask, scale,
                                     causal, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
