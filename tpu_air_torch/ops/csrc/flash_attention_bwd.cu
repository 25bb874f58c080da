// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C ABI.
//
// Two kernels, from the forward's saved (out, lse) statistics:
//   flash_bwd_dq_kernel  replaces tpu_air/ops/flash_attention.py::_bwd_dq_kernel
//                        (and _bwd_dq_nm), launched there by _pallas_bwd;
//   flash_bwd_dkv_kernel replaces tpu_air/ops/flash_attention.py::_bwd_dkv_kernel
//                        (and _bwd_dkv_nm), launched there by _pallas_bwd.
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
// What bounds it on the H100: at the long-context LM shape (B*H = 8,
// L = 8192, D = 128, causal, bf16) the two kernels do ~481 GFLOP (dq
// 3 * 2 * D flops per live (i, j) pair, dk/dv 4 * 2 * D) on ~134 MB of
// inputs and outputs, so the card's bound is the ~0.49 ms of tensor-core
// work, far above the ~0.04 ms of memory traffic.  These first versions
// run the products on the CUDA cores in f32 (67 TFLOP/s at most), so they
// are bound by FMA throughput and by the shared-memory loads that feed it; the
// design keeps the shared-memory side small: every operand is read from
// shared memory as float4 (one load per four FMAs), and the threads that
// share a row read neighbouring 16-byte words, so a warp's load is one
// conflict-free wavefront.  Moving the products onto the tensor cores
// (mma.sync / wgmma) is the next step.
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *mask;
  void *out0, *out1;  // dq, or dk and dv
  Strides sq, sk, sv, sdo, s0, s1;
  int bh, heads, lq, lk, heads_per_mask, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(const Args& a, bool dkv) {
  constexpr int ROWS = Tiling<D>::ROWS;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (dkv) {
    dim3 grid((a.lk + ROWS - 1) / ROWS, a.bh);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.sq, a.sk, a.sv, a.sdo, a.s0, a.s1, a.heads, a.lq,
        a.lk, a.heads_per_mask, a.scale, a.causal);
  } else {
    dim3 grid((a.lq + ROWS - 1) / ROWS, a.bh);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.mask, static_cast<T*>(a.out0), a.sq, a.sk,
        a.sv, a.sdo, a.s0, a.heads, a.lq, a.lk, a.heads_per_mask, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const Args& a, bool dkv) {
  switch (d) {
    case 16: return launch<T, 16>(a, dkv);
    case 32: return launch<T, 32>(a, dkv);
    case 64: return launch<T, 64>(a, dkv);
    case 128: return launch<T, 128>(a, dkv);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, const float* mask, void* out0, void* out1,
        const long long* st, int batch, int heads, int lq, int lk, int d, int dtype,
        int mask_b, float scale, int causal, void* stream) {
  const int bh = batch * heads;
  if (bh <= 0 || lq <= 0 || lk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  if (mask != nullptr && (mask_b <= 0 || bh % mask_b != 0)) return cudaErrorInvalidValue;
  if (out0 == nullptr || (dkv && out1 == nullptr)) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, mask, out0, out1,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
         {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         bh, heads, lq, lk, mask != nullptr ? bh / mask_b : 1, causal, scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(d, a, dkv);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, a, dkv);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Both entries take the same arguments.  dtype: 0 = float32, 1 = bfloat16.
// Pointers to device memory: q, k, v, do in the input type; lse and delta
// contiguous (B*H, lq) f32; mask (mask_b, lk) f32 (1 = attend) or null;
// out0/out1 = dq (the dq entry; out1 unused) or dk, dv.  The 18 strides (in
// elements) are the (b, h, l) strides of q, k, v, do, out0, out1, each a
// (B, H, L, D) view with D contiguous.  Returns the cudaError_t of the
// launch.
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
