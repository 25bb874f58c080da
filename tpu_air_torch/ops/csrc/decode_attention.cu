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
// What bounds it on the H100: bytes.  Each step reads the cache once and
// does about 4 flops per cached element, far below the card's ~295 flops
// per byte, so the design reads each needed slab byte once with as many
// bytes in flight as the SMs can hold:
// - 16-byte loads: a lane reads 4 f32, 8 bf16, 8 f16 or 16 int8 of one position's
//   head slice, the D / (16 / sizeof) lanes of a group cover the slice, and
//   a warp covers 32 / that many positions per load instruction.
// - One pass: each group keeps an f32 online softmax (m, den, acc) over its
//   positions; the K and V loads of kUnroll positions are issued together,
//   then scored and accumulated, so V never waits for a second sweep.  The
//   groups of a block merge their (m, den, acc) through shared memory.
// - Split-K (flash-decoding): the grid is (h, b, L-chunk).  The wrapper
//   picks the chunk from b*h, L and the SM count; with more than one chunk
//   each block writes its (m, den, acc) to a workspace and
//   decode_combine_kernel merges them per (b, h), with the running max
//   floored at -1e20 as the reference floors it.
// - Masked chunks are skipped: a block reads its chunk's key mask first
//   (b * L * 4 bytes in all) and reads K/V only over the range from its
//   first to its last live key.  A chunk with no live key contributes
//   exactly 0 when the row has a live key elsewhere (exp(-1e20 - m)
//   underflows to 0 in f32), so its K/V bytes are never read; a row with no
//   live key at all reads everything and yields mean(V).  The bias is never
//   read as a mask: the self step reads its whole slab.
// Every slab and the query must start on a 16-byte boundary (the wrapper
// checks; the C entry refuses others with cudaErrorMisalignedAddress).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskFloor = -1e20f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Positions a lane group has in flight per step.  More cost registers, and
// with them resident blocks: at 2 an SM holds seven blocks of the bf16
// kernel, and 4 or 8 streamed slower on the H100.
constexpr int kUnroll = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

enum ScaleKind { kNone = 0, kPerPosition = 1, kPerChannel = 2 };

__device__ __forceinline__ uint4 load16(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// The 16 loaded bytes as floats: 4 f32, 8 bf16 (the high half of an f32), 8
// f16 or 16 int8; element i lies at the i-th lowest address.
template <typename TKV>
__device__ __forceinline__ void unpack(const uint4& w, float (&x)[16 / sizeof(TKV)]);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& w, float (&x)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<__half>(const uint4& w, float (&x)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(u[i] & 0xffffu)));
    x[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(u[i] >> 16)));
  }
}
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& w, float (&x)[16]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = static_cast<float>(static_cast<int32_t>(u[i] << (24 - 8 * j)) >> 24);
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red[] may still be read from a previous reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// TQ: query/output type.  TKV: slab type (TQ, or int8_t with scales).  One
// block per (head, batch row, chunk of `chunk` positions).
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ mask, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, TQ* __restrict__ out,
              float* __restrict__ part, int L, int heads, int chunk, int k_kind,
              int v_kind) {
  constexpr int EPL = 16 / (int)sizeof(TKV);  // elements of one 16-byte load
  constexpr int LPP = D / EPL;                // lanes that share one position
  constexpr int NG = kThreads / LPP;          // positions the block reads at once
  static_assert(D % EPL == 0 && LPP >= 1 && LPP <= 32, "a head slice is 1 to 32 loads");

  __shared__ __align__(16) float acc_s[NG * D];  // each group's acc, then merged
  __shared__ float w_s[NG];                      // each group's weight exp(m - M)
  __shared__ float red[kWarps];
  __shared__ int range_s[2];

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int hd = heads * D;
  const int tid = threadIdx.x, grp = tid / LPP, gl = tid % LPP;
  const int c0 = split * chunk, c1 = min(L, c0 + chunk);
  const float* mrow = mask != nullptr ? mask + (long long)b * L : nullptr;

  // this lane's EPL elements of q, the per-channel K scale folded in; loaded
  // first, so that their latency overlaps the mask scan's
  const long long qoff = (long long)b * hd + h * D + gl * EPL;
  float qv[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    float x = to_f32(q[qoff + i]);
    if (k_kind == kPerChannel) x *= k_scale[qoff + i];
    qv[i] = x;
  }

  // The range [lo, hi) of positions read: from the chunk's first live key to
  // its last; none when the chunk has no live key but the row has one; the
  // whole chunk when the row has none (every key at the floor: mean(V)).
  int lo = c0, hi = c1;
  bool drop_masked = false;  // masked keys inside [lo, hi) weigh exactly 0
  if (mrow != nullptr) {
    if (tid == 0) {
      range_s[0] = c1;
      range_s[1] = c0 - 1;
    }
    __syncthreads();
    int first = c1, last = c0 - 1;
#pragma unroll 4
    for (int l = c0 + tid; l < c1; l += kThreads) {
      if (mrow[l] > 0.f) {
        first = min(first, l);
        last = max(last, l);
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (tid % 32 == 0) {
      atomicMin(&range_s[0], first);
      atomicMax(&range_s[1], last);
    }
    __syncthreads();
    first = range_s[0];
    last = range_s[1];
    if (first <= last) {
      lo = first;
      hi = last + 1;
      drop_masked = true;
    } else {
      int any = 0;
      for (int l = tid; l < L && !any; l += kThreads) any = mrow[l] > 0.f;
      if (__syncthreads_or(any)) hi = lo;
    }
  }

  const TKV* kb = k + (long long)b * L * hd + h * D + gl * EPL;
  const TKV* vb = v + (long long)b * L * hd + h * D + gl * EPL;
  const float* bias_h = bias != nullptr ? bias + (long long)h * L : nullptr;
  // per-position scales [b, L, h]: position l of this head at l * heads
  const float* ksp = k_kind == kPerPosition ? k_scale + (long long)b * L * heads + h : nullptr;
  const float* vsp = v_kind == kPerPosition ? v_scale + (long long)b * L * heads + h : nullptr;

  float m = kMaskFloor, den = 0.f, acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  for (int base = lo; base < hi; base += NG * kUnroll) {
    uint4 kw[kUnroll], vw[kUnroll];
    float add[kUnroll], ks[kUnroll], vs[kUnroll];
    // every load of kUnroll positions first, then the arithmetic
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + u * NG + grp;
      const bool in = l < hi;
      kw[u] = load16(kb + (long long)l * hd, in);
      vw[u] = load16(vb + (long long)l * hd, in);
      float a = -INFINITY;  // past the range: weight exactly 0
      ks[u] = vs[u] = 1.f;
      if (in) {
        a = bias_h != nullptr ? bias_h[l] : 0.f;
        if (mrow != nullptr) {
          const bool live = mrow[l] > 0.f;
          a = drop_masked && !live ? -INFINITY : a + (live ? 0.f : kMaskFloor);
        }
        if (ksp != nullptr) ks[u] = ksp[(long long)l * heads];
        if (vsp != nullptr) vs[u] = vsp[(long long)l * heads];
      }
      add[u] = a;
    }
    float s[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[EPL];
      unpack<TKV>(kw[u], x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot = fmaf(qv[i], x[i], dot);
#pragma unroll
      for (int off = LPP / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = dot * ks[u] + add[u];
      mx = fmaxf(mx, s[u]);
    }
    const float alpha = expf(m - mx);  // both at or above the -1e20 floor
    den *= alpha;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(s[u] - mx);
      den += p;
      const float pv = p * vs[u];  // the per-position V scale after den
      float y[EPL];
      unpack<TKV>(vw[u], y);
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] = fmaf(pv, y[i], acc[i]);
    }
    m = mx;
  }

  // merge the groups: every lane of a group holds its m and den
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc_s[grp * D + gl * EPL + i] = acc[i];
  const float M = block_reduce<true>(m, red);
  const float w = expf(m - M);
  if (gl == 0) w_s[grp] = w;
  const float den_all = block_reduce<false>(gl == 0 ? den * w : 0.f, red);
  if (tid < D) {  // block_reduce's barriers published acc_s and w_s
    float a = 0.f;
    for (int g = 0; g < NG; ++g) a = fmaf(acc_s[g * D + tid], w_s[g], a);
    const long long o = (long long)b * hd + h * D + tid;
    if (gridDim.z == 1) {
      float y = a / fmaxf(den_all, 1e-20f);
      if (v_kind == kPerChannel) y *= v_scale[o];
      out[o] = from_f32<TQ>(y);
    } else {  // this chunk's (m, den, acc) for decode_combine_kernel
      float* pp = part + (((long long)b * heads + h) * gridDim.z + split) * (D + 2);
      if (tid == 0) {
        pp[0] = M;
        pp[1] = den_all;
      }
      pp[2 + tid] = a;
    }
  }
}

// Merge the (m, den, acc[d]) of `splits` chunks per (b, h): the output is
// sum_c acc_c e^(m_c - M) / max(sum_c den_c e^(m_c - M), 1e-20), M the
// largest m_c (each at or above the -1e20 floor).  A skipped chunk carries
// (-1e20, 0, 0) and adds nothing.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, const float* __restrict__ v_scale,
                      TQ* __restrict__ out, int heads, int d, int splits, int v_kind) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* pp = part + ((long long)b * heads + h) * splits * (d + 2);
  float M = kMaskFloor;
  for (int c = 0; c < splits; ++c) M = fmaxf(M, pp[c * (d + 2)]);
  float den = 0.f;
  for (int c = 0; c < splits; ++c) den = fmaf(pp[c * (d + 2) + 1], expf(pp[c * (d + 2)] - M), den);
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float a = 0.f;
    for (int c = 0; c < splits; ++c) a = fmaf(pp[c * (d + 2) + 2 + e], expf(pp[c * (d + 2)] - M), a);
    const long long o = (long long)b * heads * d + h * d + e;
    float y = a / fmaxf(den, 1e-20f);
    if (v_kind == kPerChannel) y *= v_scale[o];
    out[o] = from_f32<TQ>(y);
  }
}

struct Args {
  const void *q, *k, *v;
  const float *bias, *mask, *ks, *vs;
  void* out;
  float* part;
  int b, L, heads, chunk, k_kind, v_kind;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D>
cudaError_t launch(const Args& a) {
  const int splits = (a.L + a.chunk - 1) / a.chunk;
  decode_kernel<TQ, TKV, D><<<dim3(a.heads, a.b, splits), kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      a.bias, a.mask, a.ks, a.vs, static_cast<TQ*>(a.out), a.part, a.L, a.heads, a.chunk,
      a.k_kind, a.v_kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_combine_kernel<TQ><<<dim3(a.heads, a.b), kThreads, 0, a.stream>>>(
      a.part, a.vs, static_cast<TQ*>(a.out), a.heads, D, splits, a.v_kind);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<TQ, TKV, 16>(a);
    case 32: return launch<TQ, TKV, 32>(a);
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (also the output type).  kv_int8: 0 =
// slabs in q's type, 1 = int8 slabs.  k_kind / v_kind: 0 none, 1 per-position
// scale [b, L, h], 2 per-channel scale [b, 1, h*d] (f32).  bias [h, L] f32 and
// mask [b, L] f32 (1 = attend) may be null.  All arrays contiguous on the
// device; q, k and v start on 16-byte boundaries.  chunk: positions per
// block; with ceil(L / chunk) > 1 chunks, workspace holds b * h * chunks *
// (d + 2) floats.  Returns the cudaError_t of the launch.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const float* bias, const float* mask, const float* k_scale,
                         const float* v_scale, void* out, float* workspace, int b, int L,
                         int heads, int d, int q_dtype, int kv_int8, int k_kind, int v_kind,
                         int chunk, void* stream) {
  if (b <= 0 || L <= 0 || heads <= 0 || chunk <= 0 || b > 65535) return cudaErrorInvalidValue;
  const int splits = (L + chunk - 1) / chunk;
  if (splits > 65535 || (splits > 1 && workspace == nullptr)) return cudaErrorInvalidValue;
  if ((k_kind != kNone) != (k_scale != nullptr)) return cudaErrorInvalidValue;
  if ((v_kind != kNone) != (v_scale != nullptr)) return cudaErrorInvalidValue;
  if (!kv_int8 && (k_kind != kNone || v_kind != kNone)) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return cudaErrorMisalignedAddress;
  const Args a{q, k, v, bias, mask, k_scale, v_scale, out, workspace,
               b, L, heads, chunk, k_kind, v_kind, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && !kv_int8) return dispatch_d<float, float>(d, a);
  if (q_dtype == 0 && kv_int8) return dispatch_d<float, int8_t>(d, a);
  if (q_dtype == 1 && !kv_int8) return dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, a);
  if (q_dtype == 1 && kv_int8) return dispatch_d<__nv_bfloat16, int8_t>(d, a);
  if (q_dtype == 2 && !kv_int8) return dispatch_d<__half, __half>(d, a);
  if (q_dtype == 2 && kv_int8) return dispatch_d<__half, int8_t>(d, a);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
