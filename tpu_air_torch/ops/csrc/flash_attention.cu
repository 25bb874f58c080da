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
// What bounds it on the H100 (989 TFLOP/s bf16 and f16 dense, 3.35 TB/s,
// 50 MB of L2): operations at the long-context LM shape (B*H 8, L 8192, D
// 128, causal: 137.5 GFLOP, 0.139 ms at peak, against 0.02 ms of memory
// traffic); bytes at the T5-base shapes (W3's encoder: B 64, H 12, L 512,
// D 64, key mask, the f32 batch-shared bias (H, L, L): 51.5 GFLOP, 0.052
// ms; 170 MB to read once, 0.051 ms).  At the T5 shapes most bytes move
// from L2, by the count of the walk below (tests/_flash_schedule.py::
// staged_bytes models it; no L2 counter has been read): every 64-row query
// tile re-reads its rows of K, V and of the bias, and the bias is f32 and
// read per batch element, 64 x 12 x 512 x 512 x 4 B = 805 MB a W3 call if
// nothing shares it.
//
// bf16 and f16 (flash_fwd_wgmma_kernel<T, D, BK>, one template over the
// 16-bit type) on Hopper's warpgroup products, fed by TMA:
//   - Warp roles.  A block is 3 warpgroups: a producer and two consumers
//     of 64 query rows each.  The producer hands registers to the consumers
//     (setmaxnreg) and its thread 0 issues the TMA copies; with a key mask,
//     or a bias TMA cannot describe, all 128 of its threads also copy those
//     with cp.async.  The consumers only compute.
//   - TMA.  q, k and v are tensor maps over their (B, H, L, D) strided views,
//     encoded on the host for each call (cuTensorMapEncodeTiled, taken from
//     libcuda at run time, so the library links no -lcuda); boxes of 64
//     columns (128 bytes, 128-byte swizzle, what the wgmma descriptors read)
//     and zero fill past D, Lq and Lk.  The f32 bias is a map too when its
//     rows start on 16 bytes (lk % 4 == 0): swizzled boxes of 32 floats, so
//     a warp's float2 reads in the accumulator layout are conflict-free.
//   - A ring of 2-4 K/V stages (as many as fit 227 KB), each with a full
//     and an empty mbarrier; Q is loaded once per work item.  The grid is
//     one block an SM, each walking over work items (a query tile of one
//     unit), so the producer loads the next item's tiles while the
//     consumers finish this one's.  Causal items go longest first, across
//     all units, and the blocks take them in rounds walked forth and back,
//     which evens their work (one direction left the LM shape's busiest
//     block 25% over the mean); else one unit's query tiles run next to
//     each other, so its K/V (and bias) stay in L2.
//   - S = Q K^T: wgmma m64nBKk16, Q and K from shared memory, f32
//     accumulators; scale, bias, key mask and the -inf of causal and
//     ragged keys are applied in registers in the accumulator's layout
//     (elementwise only on tiles that reach the diagonal or Lk; tiles past
//     the diagonal are never loaded).  The softmax runs in log2 units with
//     each row's max and sum across the quad that holds it.
//   - O += P V: P rounded to T in registers is wgmma's register A operand;
//     V comes from shared memory through the transposed (MN-major) B
//     descriptor.  P never touches shared memory; rounding it is the
//     reference's precision (the Pallas kernel casts p to v's type before
//     its product and accumulates in f32).  Tile j's S = Q K^T and
//     tile j-1's O += P V are issued together, and tile j's softmax runs
//     while that product does.
//   - The bias.  Where the batch shares it (H % bias_n == 0), the two
//     consumers take the same head and rows of two batch elements, each
//     with its own K/V slots in the stage, and one staged bias tile serves
//     both: W3's encoder stages 402.7 MB of bias (32 pairs x 12 heads x 8
//     query tiles x 4 key tiles x 32 KB, by the model's count), half of the
//     805 MB.  An odd batch
//     leaves the last pair's second consumer idle.  Else the two consumers
//     take 128 rows of one (b, h) and share its K/V stream.
//   - Tiles: 64 query rows a consumer; BK = 128 keys, or 64 at D = 128 with
//     a bias (two stages of K, V and bias then fit); D < 64 is staged 64
//     wide (zeros past D).  ptxas: 168 registers at launch, 80 for the
//     producer and 208 for each consumer after the hand-over, no spills.
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
// copy; the 16-bit path needs every row 16-byte aligned, as TMA does (the
// wrapper copies a view that breaks that rule).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

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
// bf16 and f16: wgmma on a TMA-fed K/V ring
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                   // threads of a warpgroup
constexpr int kWgmmaThreads = 3 * kWg;     // the producer warpgroup, two consumers
constexpr int kRows = 64;                  // query rows of one consumer
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;         // the most dynamic shared memory a block may take
constexpr int kBarBytes = 128;             // q_full, q_empty, full[kMaxStages], empty[kMaxStages]
// registers a thread after the hand-over; the block keeps the 384 * 168
// it was launched with, so 128 * 80 + 256 * 208 <= 64512, or a consumer's
// setmaxnreg.inc waits forever
constexpr int kProducerRegs = 80, kConsumerRegs = 208;

template <int D, int BK> struct WgmmaFwd {
  static constexpr int DP = D < 64 ? 64 : D;        // columns staged, zero past D
  static constexpr int NB = DP / 64;                // 128-byte column blocks
  static constexpr int Q_BYTES = kRows * DP * 2;    // one consumer's Q
  static constexpr int KV_BYTES = BK * DP * 2;      // one K or V tile
  static constexpr int BIAS_BYTES = kRows * BK * 4; // one (64, BK) f32 bias tile
  static constexpr int MASK_BYTES = BK * 4;         // one key-mask row
};

struct WgmmaParams {
  const float* bias;  // null, or (bias_n, lq, lk) f32
  const float* mask;  // null, or (mask_b, lk) f32, 1 = attend; row bh / heads_per_mask
  void* out;
  float* lse;
  Strides so;
  int batch, heads, lq, lk, bias_n, heads_per_mask, causal;
  float scale;
  int paired;       // the consumers take batch elements 2p and 2p + 1 of one head
  int bias_tma;     // the bias comes by TMA (its rows start on 16 bytes), else by cp.async
  int stages, stage_bytes;
  int units, tiles; // work items: units (b*h, or pairs*h) x query tiles
};

// Byte offset, in a swizzled (64 rows, 32 floats) bias box, of row r and
// float column c (c % 32): 16-byte chunk c / 4 of the row lands at chunk
// (c / 4) ^ (r % 8).  A warp's float2 reads (8 rows x 4 lanes) then take the
// two wavefronts their 256 bytes need.
__device__ __forceinline__ int bias_swizzle(int r, int c) {
  return r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// The work item `w` of a launch: a query tile of one unit.  Causal: the
// longest query tiles first, across all units; else a unit's tiles next to
// each other, so its K/V stays in L2.
struct FwdItem {
  int h, b0, q0;
};

__device__ __forceinline__ FwdItem fwd_item(const WgmmaParams& p, int w) {
  const int tile = p.causal ? p.tiles - 1 - w / p.units : w % p.tiles;
  const int unit = p.causal ? w % p.units : w / p.tiles;
  FwdItem it;
  it.h = unit % p.heads;
  it.b0 = p.paired ? 2 * (unit / p.heads) : unit / p.heads;
  it.q0 = tile * (p.paired ? kRows : 2 * kRows);
  return it;
}

// consumer c of an item: batch b0 + c and rows [q0, q0 + 64) (paired), or
// batch b0 and rows [q0 + 64 c, q0 + 64 c + 64)
__device__ __forceinline__ int item_batch(const WgmmaParams& p, const FwdItem& it, int c) {
  return p.paired ? it.b0 + c : it.b0;
}
__device__ __forceinline__ int item_row0(const WgmmaParams& p, const FwdItem& it, int c) {
  return p.paired ? it.q0 : it.q0 + c * kRows;
}
__device__ __forceinline__ bool item_live(const WgmmaParams& p, const FwdItem& it, int c) {
  return item_batch(p, it, c) < p.batch && item_row0(p, it, c) < p.lq;
}
// key tiles that a consumer's rows [row0, row0 + 64) need: up to the
// diagonal (causal)
template <int BK>
__device__ __forceinline__ int key_tiles(const WgmmaParams& p, int row0) {
  const int end = p.causal ? min(p.lk, min(p.lq, row0 + kRows)) : p.lk;
  return (end + BK - 1) / BK;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The scores of one (64, BK) tile, in the accumulator layout, to log2
// units: (s * scale [+ bias + key mask]) * log2(e), -inf after the query
// (causal) or past Lk on an edge tile; mx takes each row's max over them.
// The staged bias and mask are 0 past lq and lk, where keys get -inf.
template <int BK, bool kAdd>
__device__ __forceinline__ void score_tile(float (&sacc)[BK / 2], float (&mx)[2],
                                           const WgmmaParams& p,
                                           const unsigned char* bias_t, const float* mask_t,
                                           const int (&bias_sw)[4], int k0, int row0, int cq0,
                                           int t, bool edge) {
  const bool has_bias = kAdd && p.bias != nullptr, has_mask = kAdd && p.mask != nullptr;
  const float scale = kAdd ? p.scale : p.scale * kLog2e;
#pragma unroll
  for (int n8 = 0; n8 < BK / 8; ++n8) {
    float2 bias_r0 = make_float2(0.f, 0.f), bias_r1 = bias_r0, mask2 = bias_r0;
    if (has_bias) {
      const unsigned char* bt = bias_t + (n8 / 4) * kRows * 128 + bias_sw[n8 % 4];
      bias_r0 = *reinterpret_cast<const float2*>(bt);
      bias_r1 = *reinterpret_cast<const float2*>(bt + 8 * 128);
    }
    if (has_mask) {
      mask2 = *reinterpret_cast<const float2*>(mask_t + n8 * 8 + 2 * t);
      mask2 = make_float2((1.f - mask2.x) * kNegInf, (1.f - mask2.y) * kNegInf);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e < 2 ? 0 : 8);
      const int key = k0 + n8 * 8 + 2 * t + (e & 1);
      float x = sacc[4 * n8 + e] * scale;
      if (kAdd) {
        const float2 bias2 = e < 2 ? bias_r0 : bias_r1;
        x += (e & 1) ? bias2.y : bias2.x;
        x += (e & 1) ? mask2.y : mask2.x;
        x *= kLog2e;
      }
      if (edge && ((p.causal && key > row) || key >= p.lk)) x = -INFINITY;
      sacc[4 * n8 + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
}

// One tile's online-softmax step on S, in place: scores in log2 units
// (score_tile), the row max across the quad that holds the row, P =
// exp2(x - max) (exactly 1 where x equals the max, as on a fully masked
// row), the running sums; alpha rescales the O accumulated so far.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             const WgmmaParams& p, const unsigned char* st,
                                             int bias_off, int mask_off, int bias_slot,
                                             int mask_slot, const int (&bias_sw)[4], int k0,
                                             int row0, int cq0, int t) {
  // elementwise masking only on tiles that reach the diagonal or Lk
  const bool edge = k0 + BK > p.lk || (p.causal && k0 + BK - 1 > cq0);
  float mx[2] = {m_run[0], m_run[1]};
  if (p.bias != nullptr || p.mask != nullptr)
    score_tile<BK, true>(sacc, mx, p, st + bias_off + bias_slot * kRows * BK * 4,
                         reinterpret_cast<const float*>(st + mask_off + mask_slot * BK * 4),
                         bias_sw, k0, row0, cq0, t, edge);
  else
    score_tile<BK, false>(sacc, mx, p, nullptr, nullptr, bias_sw, k0, row0, cq0, t, edge);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = hopper::exp2_approx(m_run[i] - mx[i]);
    m_run[i] = mx[i];
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = hopper::exp2_approx(sacc[4 * n8 + e] - mx[e / 2]);
      sacc[4 * n8 + e] = pe;
      l_run[e / 2] += pe;
    }
  }
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap bias_map, const WgmmaParams p) {
  using namespace hopper;
  using Cfg = WgmmaFwd<D, BK>;
  constexpr int DP = Cfg::DP, NB = Cfg::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles start on 1024 bytes (the launch adds 1 KB of slack)
  unsigned char* const q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const ring = q_s + 2 * Cfg::Q_BYTES;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* const q_empty = q_full + 1;
  uint64_t* const full = q_full + 2;
  uint64_t* const empty = full + kMaxStages;

  const bool has_bias = p.bias != nullptr, has_mask = p.mask != nullptr;
  // a stage: K then V of each K/V slot, the bias tiles, the key-mask rows
  const int kv_slots = p.paired ? 2 : 1;
  const int bias_slots = has_bias ? (p.paired ? 1 : 2) : 0;
  const int mask_slots = has_mask ? (p.paired ? 2 : 1) : 0;
  const int bias_off = kv_slots * 2 * Cfg::KV_BYTES;
  const int mask_off = bias_off + bias_slots * Cfg::BIAS_BYTES;
  // the mask, and a bias TMA cannot read, come by cp.async from every
  // producer thread, each of which then arrives on the stage's barrier
  const bool cp_fill = has_mask || (has_bias && !p.bias_tma);
  const int n_items = p.units * p.tiles;
  // the n-th item of this block: rounds of gridDim.x items, walked forth and
  // back in turn, so that under causal masking (items longest first) every
  // block's total work comes out nearly equal
  auto item_of = [&](int n) {
    return n * gridDim.x + ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * kWg);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1 + (cp_fill ? kWg : 0));
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
    // ---- producer warpgroup: thread 0 issues TMA; with cp_fill all 128
    // copy the mask (and a bias TMA cannot read) ----
    regs_dealloc<kProducerRegs>();
    const int ptid = threadIdx.x;
    if (!cp_fill && ptid != 0) return;
    if (ptid == 0) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      if (has_bias && p.bias_tma) tma_prefetch_map(&bias_map);
    }
    int ring_i = 0;  // K/V tiles through the ring so far
    for (int n = 0, w = item_of(n); w < n_items; w = item_of(++n)) {
      const FwdItem it = fwd_item(p, w);
      const bool live0 = item_live(p, it, 0), live1 = item_live(p, it, 1);
      const int n_tiles = key_tiles<BK>(p, item_row0(p, it, 1));
      const int bias_head = has_bias ? (it.b0 * p.heads + it.h) % p.bias_n : 0;
      for (int j = 0; j < n_tiles; ++j, ++ring_i) {
        const int s = ring_i % p.stages;
        if (ring_i >= p.stages) mbar_wait(&empty[s], ((ring_i / p.stages) - 1) & 1);
        unsigned char* const st = ring + s * p.stage_bytes;
        const int k0 = j * BK;
        if (ptid == 0) {
          const int kv_live = kv_slots == 2 ? live0 + live1 : 1;
          const int bias_live = bias_slots == 2 ? live0 + live1 : bias_slots;
          mbar_arrive_expect_tx(&full[s], kv_live * 2 * Cfg::KV_BYTES +
                                              (p.bias_tma ? bias_live * Cfg::BIAS_BYTES : 0));
          for (int slot = 0; slot < kv_slots; ++slot) {
            if (!(slot ? live1 : live0)) continue;
            unsigned char* const k_st = st + slot * 2 * Cfg::KV_BYTES;
            const int bb = item_batch(p, it, slot);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              tma_load_4d(k_st + nb * BK * 128, &k_map, &full[s], nb * 64, k0, it.h, bb);
              tma_load_4d(k_st + Cfg::KV_BYTES + nb * BK * 128, &v_map, &full[s], nb * 64, k0,
                          it.h, bb);
            }
          }
          if (p.bias_tma) {
            for (int slot = 0; slot < bias_slots; ++slot) {
              if (!(slot ? live1 : live0)) continue;
              for (int i = 0; i < BK / 32; ++i)
                tma_load_3d(st + bias_off + slot * Cfg::BIAS_BYTES + i * kRows * 128, &bias_map,
                            &full[s], k0 + 32 * i, item_row0(p, it, slot), bias_head);
            }
          }
        }
        if (cp_fill) {
          for (int i = ptid; i < mask_slots * BK; i += kWg) {
            const int slot = i / BK, col = i % BK;
            const int mrow = (item_batch(p, it, slot) * p.heads + it.h) / p.heads_per_mask;
            const bool ok = (slot ? live1 : live0) && k0 + col < p.lk;
            cp_async4(st + mask_off + slot * Cfg::MASK_BYTES + col * 4,
                      ok ? p.mask + (long long)mrow * p.lk + k0 + col : p.mask, ok);
          }
          if (has_bias && !p.bias_tma) {
            const float* src = p.bias + (long long)bias_head * p.lq * p.lk;
            for (int slot = 0; slot < bias_slots; ++slot) {
              for (int i = ptid; i < kRows * BK; i += kWg) {
                const int r = i / BK, col = i % BK, row = item_row0(p, it, slot) + r;
                const bool ok = row < p.lq && k0 + col < p.lk;
                cp_async4(st + bias_off + slot * Cfg::BIAS_BYTES + (col / 32) * kRows * 128 +
                              bias_swizzle(r, col),
                          ok ? src + (long long)row * p.lk + k0 + col : src, ok);
              }
            }
          }
          mbar_arrive_cp_async(&full[s]);
        }
        if (j == 0 && ptid == 0) {  // Q, once the consumers are done with the last item's
          if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
          mbar_arrive_expect_tx(q_full, (live0 + live1) * Cfg::Q_BYTES);
          for (int c = 0; c < 2; ++c) {
            if (!(c ? live1 : live0)) continue;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              tma_load_4d(q_s + c * Cfg::Q_BYTES + nb * kRows * 128, &q_map, q_full, nb * 64,
                          item_row0(p, it, c), it.h, item_batch(p, it, c));
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
  const int kv_slot = p.paired ? c : 0, bias_slot = p.paired ? 0 : c;
  const int mask_slot = p.paired ? c : 0;
  // the bias float2 of row r0 (and r0 + 8) at columns 8 n + 2 t, for n % 4
  int bias_sw[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) bias_sw[m] = bias_swizzle(r0, 8 * m + 2 * t);
  const uint64_t q_desc = desc_sw128(q_s + c * Cfg::Q_BYTES, 16, 1024);

  int ring_i = 0;
  for (int n = 0, w = item_of(n); w < n_items; w = item_of(++n)) {
    const FwdItem it = fwd_item(p, w);
    const bool active = item_live(p, it, c);
    const int b = item_batch(p, it, c), cq0 = item_row0(p, it, c), bh = b * p.heads + it.h;
    const int n_tiles = key_tiles<BK>(p, item_row0(p, it, 1));
    const int my_tiles = active ? key_tiles<BK>(p, cq0) : 0;
    const int row0 = cq0 + r0;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    // running row max in log2 units: the -1e30 of a masked key, scaled, so a
    // fully masked row weighs its keys 1 each (the mean of V)
    float m_run[2] = {kNegInf * kLog2e, kNegInf * kLog2e};
    float l_run[2] = {0.f, 0.f};  // this lane's part of the row sums

    // every consumer follows q_full's phases, live or not
    mbar_wait(q_full, n & 1);
    if (!active) mbar_arrive(q_empty);
    if (my_tiles > 0) {
      // Tile 0: S, softmax.  Then each next tile's S and the previous tile's
      // O += P V go to the tensor cores together, and this tile's softmax
      // runs while the product does.  Every product is waited for in the
      // block that issues it, so the compiler never sees accumulators read
      // while a product may be writing them.
      float sacc[BK / 2];
      uint32_t pa[BK / 16][4];  // P of the tile whose O += P V is next
      int s = ring_i % p.stages;
      mbar_wait(&full[s], (ring_i / p.stages) & 1);
      ss_issue<T, D, BK>(sacc, q_desc, ring + s * p.stage_bytes + kv_slot * 2 * Cfg::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(sacc);
      if (my_tiles == 1) mbar_arrive(q_empty);  // the item's last use of Q
      float alpha[2];
      softmax_tile<BK>(sacc, m_run, l_run, alpha, p, ring + s * p.stage_bytes, bias_off, mask_off,
                       bias_slot, mask_slot, bias_sw, 0, row0, cq0, t);
      pack_a<T, BK>(pa, sacc);
      int pend_s = s;
      ++ring_i;
      for (int j = 1; j < my_tiles; ++j, ++ring_i) {
        s = ring_i % p.stages;
        mbar_wait(&full[s], (ring_i / p.stages) & 1);
        ss_issue<T, D, BK>(sacc, q_desc, ring + s * p.stage_bytes + kv_slot * 2 * Cfg::KV_BYTES);
        rs_issue<T, DP, BK>(o, pa, ring + pend_s * p.stage_bytes + kv_slot * 2 * Cfg::KV_BYTES +
                                       Cfg::KV_BYTES);
        wgmma_wait<1>();
        fence_regs(sacc);
        if (j == my_tiles - 1) mbar_arrive(q_empty);
        softmax_tile<BK>(sacc, m_run, l_run, alpha, p, ring + s * p.stage_bytes, bias_off,
                         mask_off, bias_slot, mask_slot, bias_sw, j * BK, row0, cq0, t);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        mbar_arrive(&empty[pend_s]);
#pragma unroll
        for (int n8 = 0; n8 < DP / 8; ++n8) {
          o[4 * n8] *= alpha[0];
          o[4 * n8 + 1] *= alpha[0];
          o[4 * n8 + 2] *= alpha[1];
          o[4 * n8 + 3] *= alpha[1];
        }
        pack_a<T, BK>(pa, sacc);
        pend_s = s;
      }
      rs_issue<T, DP, BK>(o, pa, ring + pend_s * p.stage_bytes + kv_slot * 2 * Cfg::KV_BYTES +
                                     Cfg::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&empty[pend_s]);
    }
    for (int j = my_tiles; j < n_tiles; ++j, ++ring_i) {  // keys past this consumer's rows
      const int s = ring_i % p.stages;
      mbar_wait(&full[s], (ring_i / p.stages) & 1);
      mbar_arrive(&empty[s]);
    }
    if (!active) continue;

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float safe_l = l == 0.f ? 1.f : l;
      const int row = row0 + 8 * i;
      if (row < p.lq) {
        T* ob = static_cast<T*>(p.out) + b * p.so.b + it.h * p.so.h + (long long)row * p.so.l +
                2 * t;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          store2(ob + n8 * 8, o[4 * n8 + 2 * i] / safe_l, o[4 * n8 + 2 * i + 1] / safe_l);
        if (t == 0) p.lse[(long long)bh * p.lq + row] = m_run[i] * kLn2 + logf(safe_l);
      }
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

// The (bias_n, lq, lk) f32 bias as a TMA map: boxes of 32 columns (128
// bytes, swizzled) by 64 rows; zero-filled past lq and lk.
bool encode_bias(CUtensorMap* map, hopper::EncodeTiled encode, const float* bias, int bias_n,
                 int lq, int lk) {
  const cuuint64_t dims[3] = {(cuuint64_t)lk, (cuuint64_t)lq, (cuuint64_t)bias_n};
  const cuuint64_t strides[2] = {(cuuint64_t)lk * 4, (cuuint64_t)lq * lk * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(bias), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How a launch of the 16-bit kernel is laid out (tests/_flash_schedule.py
// restates it for the CPU tests).
struct FwdPlan {
  int paired;       // the consumers take batch elements 2p, 2p + 1 of one head
  int bias_tma;     // the bias comes by TMA, else by cp.async
  int bk;           // keys a tile
  int stages;       // K/V ring stages
  int stage_bytes;  // one stage: K/V of each slot, bias tiles, mask rows
  int smem;         // dynamic shared memory of a block
  int units, tiles; // work items: units x query tiles
};

// bias_n = 0: no bias.  bias_tma: the bias's rows start on 16 bytes (lk % 4
// == 0 and a 16-byte-aligned base), so a tensor map can describe it.
FwdPlan plan_fwd(int d, int batch, int heads, int lq, int lk, int bias_n, bool mask,
                 bool bias_tma) {
  FwdPlan pl{};
  const int dp = d < 64 ? 64 : d;
  // D = 128 with a bias: 64-key tiles, so that two stages of K, V and bias fit
  pl.bk = d == 128 && bias_n > 0 ? 64 : 128;
  // a bias the batch shares: the two consumers take one head's rows for
  // two batch elements, and one staged bias tile serves both
  pl.paired = bias_n > 0 && batch > 1 && heads % bias_n == 0;
  pl.bias_tma = bias_n > 0 && bias_tma;
  const int kv_slots = pl.paired ? 2 : 1;
  const int bias_slots = bias_n > 0 ? (pl.paired ? 1 : 2) : 0;
  const int mask_slots = mask ? (pl.paired ? 2 : 1) : 0;
  pl.stage_bytes = kv_slots * 2 * pl.bk * dp * 2 + bias_slots * kRows * pl.bk * 4 +
                   mask_slots * pl.bk * 4;
  pl.stage_bytes = (pl.stage_bytes + 1023) / 1024 * 1024;
  const int fixed = 1024 + 2 * kRows * dp * 2 + kBarBytes;
  pl.stages = min(kMaxStages, (kSmemLimit - fixed) / pl.stage_bytes);
  pl.smem = fixed + pl.stages * pl.stage_bytes;
  pl.units = pl.paired ? (batch + 1) / 2 * heads : batch * heads;
  const int rows = pl.paired ? kRows : 2 * kRows;
  pl.tiles = (lq + rows - 1) / rows;
  return pl;
}

template <typename T, int D, int BK>
cudaError_t launch_wgmma(const Args& a, const FwdPlan& pl) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (pl.stages < 2) return cudaErrorInvalidConfiguration;
  if ((long long)pl.units * pl.tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int batch = a.bh / a.heads;
  WgmmaParams p{a.bias, a.mask, a.out, a.lse, a.so, batch, a.heads, a.lq, a.lk, a.bias_n,
                a.heads_per_mask, a.causal, a.scale, pl.paired, pl.bias_tma, pl.stages,
                pl.stage_bytes, pl.units, pl.tiles};

  // one tensor map per operand per call: the maps hold the pointers
  const CUtensorMapDataType type = hopper::tensor_map_type<T>();
  CUtensorMap q_map, k_map, v_map, bias_map;
  memset(&bias_map, 0, sizeof(bias_map));
  if (!hopper::encode_qkv(&q_map, encode, type, a.q, a.sq, D, a.lq, a.heads, batch, kRows) ||
      !hopper::encode_qkv(&k_map, encode, type, a.k, a.sk, D, a.lk, a.heads, batch, BK) ||
      !hopper::encode_qkv(&v_map, encode, type, a.v, a.sv, D, a.lk, a.heads, batch, BK) ||
      (p.bias_tma && !encode_bias(&bias_map, encode, a.bias, a.bias_n, a.lq, a.lk)))
    return cudaErrorInvalidPitchValue;

  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  // one block an SM, each walking over work items (the producer loads the
  // next item's tiles while the consumers finish this one's)
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int blocks = (int)min((long long)sms, (long long)pl.units * pl.tiles);
  flash_fwd_wgmma_kernel<T, D, BK><<<blocks, kWgmmaThreads, pl.smem, a.stream>>>(
      q_map, k_map, v_map, bias_map, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_16bit(const Args& a) {
  const FwdPlan pl = plan_fwd(D, a.bh / a.heads, a.heads, a.lq, a.lk,
                              a.bias != nullptr ? a.bias_n : 0, a.mask != nullptr,
                              a.lk % 4 == 0 && reinterpret_cast<uintptr_t>(a.bias) % 16 == 0);
  if constexpr (D == 128) {
    if (pl.bk == 64) return launch_wgmma<T, D, 64>(a, pl);
  }
  return launch_wgmma<T, D, 128>(a, pl);
}

// TMA reads boxes from 16-byte-aligned bases with strides that are multiples
// of 16 bytes: every row of q, k and v must start on 16 bytes
bool rows_16b_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.l % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Pointers to device memory; bias
// (bias_n, lq, lk) f32 and mask (B, lk) f32 (1 = attend) may be null.  The
// q/k/v/out strides (in elements) describe (B, H, L, D) views with D
// contiguous; for bfloat16 and float16 the q/k/v pointers and strides must be multiples
// of 16 bytes.  lse is a contiguous (B*H, lq) f32 array.  Returns the
// cudaError_t of the launch (cudaErrorInvalidPitchValue: libcuda refused
// a tensor map of these operands).
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
  if (dtype == 1 || dtype == 2) {
    if (!rows_16b_aligned(q, a.sq) || !rows_16b_aligned(k, a.sk) || !rows_16b_aligned(v, a.sv))
      return cudaErrorMisalignedAddress;
    switch (d) {
      case 16: return dtype == 1 ? launch_16bit<bf16, 16>(a) : launch_16bit<f16, 16>(a);
      case 32: return dtype == 1 ? launch_16bit<bf16, 32>(a) : launch_16bit<f16, 32>(a);
      case 64: return dtype == 1 ? launch_16bit<bf16, 64>(a) : launch_16bit<f16, 64>(a);
      case 128: return dtype == 1 ? launch_16bit<bf16, 128>(a) : launch_16bit<f16, 128>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
