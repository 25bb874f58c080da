// Single-token decode attention over flat [b, L, h*d] K/V slabs, for Hopper
// (sm_90a), CUDA C++ with a plain C ABI.
//
// Replaces tpu_air/ops/decode_attention.py::_kernel, launched there by
// decode_attention.
//
// What it computes, per (batch row b, head h), for one query token:
//   s_l   = (q . K[b, l, h]) + bias[h, l] + (mask[b, l] > 0 ? 0 : -1e20)
//   m     = max(max_l s_l, -1e20)
//   p_l   = exp(s_l - m);  den = sum_l p_l
//   out   = sum_l p_l V[b, l, h] / max(den, 1e-20)
// int8 slabs stay int8 in memory and their scales fold into the arithmetic
// exactly as the TPU kernel folds them: a per-channel K scale [b, 1, h*d]
// into q, a per-position K scale [b, L, h] into the scores, a per-position
// V scale into p (after den is taken), a per-channel V scale into the
// output.  No dequantized slab is ever written.  A row whose every key is
// masked sits at the -1e20 floor everywhere and yields mean(V), finite.
//
// What bounds it on the H100: bytes.  Each decode step reads the whole
// cache once and does 4 flops per cached element, far below the card's
// ~295 flops per byte.  At the T5-base cross step (b=64, L=512, h*d=768,
// bf16) that is ~100 MB, ~30 us at 3.35 TB/s.  The design reads each slab
// byte once, with each warp's loads covering consecutive bytes of one
// position's head slice: one block per (b, h) keeps the scores of its L
// positions in shared memory (exact softmax, no rescaling), then streams V
// once.  768 blocks at that shape fill the 132 SMs; splitting L over
// several blocks (flash-decoding) for small batches is the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskFloor = -1e20f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

enum ScaleKind { kNone = 0, kPerPosition = 1, kPerChannel = 2 };

__device__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red[] may still be read from a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// TQ: query/output type.  TKV: slab type (TQ, or int8_t with scales).
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ mask, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, TQ* __restrict__ out, int L,
              int heads, int k_kind, int v_kind) {
  // G lanes share one position's head slice, EPL elements each, strided by
  // G so that one load instruction covers consecutive bytes.
  constexpr int G = D < 32 ? D : 32;
  constexpr int EPL = D / G;
  constexpr int PPW = 32 / G;  // positions per warp per iteration
  constexpr int SLICES = kThreads / D > 0 ? kThreads / D : 1;

  extern __shared__ float smem[];
  float* s_sh = smem;                // [L] scores, then probabilities
  float* q_sh = smem + L;            // [D]
  float* red = q_sh + D;             // [kWarps]
  float* part = red + kWarps;        // [SLICES * D]

  const int b = blockIdx.y;
  const int h = blockIdx.x;
  const int hd = heads * D;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const TKV* kb = k + (long long)b * L * hd + h * D;
  const TKV* vb = v + (long long)b * L * hd + h * D;

  for (int e = tid; e < D; e += kThreads) {
    float x = to_f32(q[(long long)b * hd + h * D + e]);
    if (k_kind == kPerChannel) x *= k_scale[(long long)b * hd + h * D + e];
    q_sh[e] = x;
  }
  __syncthreads();

  const int g = lane / G;   // which position of the warp's PPW
  const int gl = lane % G;  // lane within the position's group
  float qv[EPL];
#pragma unroll
  for (int t = 0; t < EPL; ++t) qv[t] = q_sh[gl + t * G];

  float local_max = -INFINITY;
#pragma unroll 4
  for (int l0 = warp * PPW; l0 < L; l0 += kWarps * PPW) {
    const int l = l0 + g;
    float dot = 0.f;
    if (l < L) {
      const TKV* kr = kb + (long long)l * hd;
#pragma unroll
      for (int t = 0; t < EPL; ++t) dot = fmaf(qv[t], to_f32(kr[gl + t * G]), dot);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (l < L && gl == 0) {
      float sx = dot;
      if (k_kind == kPerPosition) sx *= k_scale[((long long)b * L + l) * heads + h];
      if (bias != nullptr) sx += bias[(long long)h * L + l];
      if (mask != nullptr) sx += mask[(long long)b * L + l] > 0.f ? 0.f : kMaskFloor;
      s_sh[l] = sx;
      local_max = fmaxf(local_max, sx);
    }
  }
  const float m = fmaxf(block_reduce(local_max, red, true), kMaskFloor);

  float local_sum = 0.f;
  for (int l = tid; l < L; l += kThreads) {
    const float p = expf(s_sh[l] - m);
    local_sum += p;
    s_sh[l] = v_kind == kPerPosition ? p * v_scale[((long long)b * L + l) * heads + h] : p;
  }
  const float den = fmaxf(block_reduce(local_sum, red, false), 1e-20f);
  // block_reduce ended in __syncthreads(): every p is in s_sh

  const int e = tid % D;
  const int slice = tid / D;
  if (slice < SLICES) {
    float acc = 0.f;
    for (int l = slice; l < L; l += SLICES) acc = fmaf(s_sh[l], to_f32(vb[(long long)l * hd + e]), acc);
    part[slice * D + e] = acc;
  }
  __syncthreads();
  for (int c = tid; c < D; c += kThreads) {
    float acc = 0.f;
    for (int sl = 0; sl < SLICES; ++sl) acc += part[sl * D + c];
    float o = acc / den;
    if (v_kind == kPerChannel) o *= v_scale[(long long)b * hd + h * D + c];
    out[(long long)b * hd + h * D + c] = from_f32<TQ>(o);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* mask, const float* ks, const float* vs, void* out,
                   int b, int L, int heads, int k_kind, int v_kind, cudaStream_t st) {
  constexpr int SLICES = kThreads / D > 0 ? kThreads / D : 1;
  const size_t smem = sizeof(float) * ((size_t)L + D + kWarps + SLICES * D);
  auto kernel = decode_kernel<TQ, TKV, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(heads, b);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      bias, mask, ks, vs, static_cast<TQ*>(out), L, heads, k_kind, v_kind);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const float* bias, const float* mask, const float* ks,
                       const float* vs, void* out, int b, int L, int heads,
                       int k_kind, int v_kind, cudaStream_t st) {
#define TPU_AIR_DECODE_CASE(DD) \
  case DD:                      \
    return launch<TQ, TKV, DD>(q, k, v, bias, mask, ks, vs, out, b, L, heads, k_kind, v_kind, st);
  switch (d) {
    TPU_AIR_DECODE_CASE(16)
    TPU_AIR_DECODE_CASE(32)
    TPU_AIR_DECODE_CASE(64)
    TPU_AIR_DECODE_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef TPU_AIR_DECODE_CASE
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16 (also the output type).  kv_int8: 0 =
// slabs in q's type, 1 = int8 slabs.  k_kind / v_kind: 0 none, 1 per-position
// scale [b, L, h], 2 per-channel scale [b, 1, h*d] (f32).  bias [h, L] f32 and
// mask [b, L] f32 (1 = attend) may be null.  All arrays contiguous on the
// device.  Returns the cudaError_t of the launch.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const float* bias, const float* mask, const float* k_scale,
                         const float* v_scale, void* out, int b, int L, int heads,
                         int d, int q_dtype, int kv_int8, int k_kind, int v_kind,
                         void* stream) {
  if (b <= 0 || L <= 0 || heads <= 0 || b > 65535) return cudaErrorInvalidValue;
  if ((k_kind != kNone) != (k_scale != nullptr)) return cudaErrorInvalidValue;
  if ((v_kind != kNone) != (v_scale != nullptr)) return cudaErrorInvalidValue;
  if (!kv_int8 && (k_kind != kNone || v_kind != kNone)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && !kv_int8)
    return dispatch_d<float, float>(d, q, k, v, bias, mask, k_scale, v_scale, out, b, L,
                                    heads, k_kind, v_kind, st);
  if (q_dtype == 0 && kv_int8)
    return dispatch_d<float, int8_t>(d, q, k, v, bias, mask, k_scale, v_scale, out, b, L,
                                     heads, k_kind, v_kind, st);
  if (q_dtype == 1 && !kv_int8)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, q, k, v, bias, mask, k_scale,
                                                    v_scale, out, b, L, heads, k_kind,
                                                    v_kind, st);
  if (q_dtype == 1 && kv_int8)
    return dispatch_d<__nv_bfloat16, int8_t>(d, q, k, v, bias, mask, k_scale, v_scale,
                                             out, b, L, heads, k_kind, v_kind, st);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
