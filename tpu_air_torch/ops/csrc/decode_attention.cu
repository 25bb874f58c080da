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
// into q, a per-position K scale [b, L, h] into the scores (before the bias
// and mask are added), a per-position V scale into p (after den is taken), a
// per-channel V scale into the output.  No dequantized slab is ever written.
// A row whose every key is masked sits at the -1e20 floor everywhere and
// yields mean(V), finite.
//
// What bounds it on the H100: bytes.  Each step reads the cache once and
// does about 4 flops per cached element, far below the card's ~295 flops
// per byte, so the kernel reads each needed slab byte once with as many
// bytes in flight as the SMs can hold, splits L into chunks when the row's
// head groups alone cannot fill the card (the wrapper's split_chunk), and
// skips masked chunks: a block reads K/V only over the range from its first
// live key to its last.  A block with no live key contributes exactly 0
// when the row has a live key elsewhere (exp(-1e20 - m) underflows to 0 in
// f32), so its K/V bytes are never read; a row with no live key at all
// reads everything and yields mean(V).  The bias is never read as a mask:
// the self step reads its whole slab.
//
// One design, decode_ring_kernel<TQ, TKV, D>, for every call: TQ the query
// and output type (f32, bf16 or f16), TKV the slab type (TQ, or int8 with
// scales).
// - A block reads a group of heads of one row (ring_group: as many as one
//   warp load of 512 bytes covers: 4 of T5's heads of 64 in bf16, 6 in int8,
//   2 in f32; 2 of the LM's of 128 in bf16, 1 in f32), so a position's K (or
//   V) slices of the group are one contiguous span of up to 512 bytes,
//   copied by one bulk copy (cp.async.bulk, completed on an mbarrier's
//   transaction count) and read back by one 16-byte load a lane: 4 f32, 8
//   bf16 or f16, or 16 int8 elements, one head's slice among D * size / 16
//   lanes.  int8 becomes f32 by a byte permute into an f32 of exponent 2^23
//   and one subtraction, exact, at the integer and f32 pipes' rates (not the
//   conversion unit's).
// - Rings in shared memory, one a warp.  The block's positions are cut into
//   units of kUnitPos, dealt to its eight warps in turn; each warp copies
//   its own units into its own slots (the bias and per-position scale rows
//   of the group beside them by 4-byte cp.async), reads a unit back, scores
//   it with the f32 online softmax of its lane groups, and refills the slot.
//   The bytes in flight do not depend on registers: the blocks an SM runs
//   share kSmRingBytes of slots.  Every warp issues its own copies because
//   one warp issues a bulk copy only every few tens of nanoseconds (the
//   compiler serialises the lanes' copies through the uniform datapath),
//   which made one producer warp the bound of a block.  No tensor map:
//   nothing is encoded on the host per call.
// - One launch a call.  The chunks of a row form a thread-block cluster (at
//   most 8 blocks); the row's stages of kStagePos positions are dealt to
//   them in turn, so a prefix mask (the W3 prompts', the LM engine's) gives
//   each the same share.  Every other rank stores its (m, den, acc) of each
//   head into rank 0's shared memory (mapa, st.shared::cluster); after a
//   cluster barrier rank 0 merges them in rank order with the max floored at
//   -1e20, applies a per-channel V scale and writes the output: no
//   workspace, no second kernel, bitwise-deterministic results.
// - The live range without a serial pre-pass: the block reads the mask of
//   its positions once, keeps it a byte a position, and reduces its first
//   and last live key in each warp and then across the warps (no atomics).
//   Only a block with none needs to know whether the row has any: it reads
//   the other ranks' ranges from distributed shared memory after the
//   cluster's first barrier, which every other block passes without
//   waiting until its walk is done.
// Every slab and the query must start on a 16-byte boundary (the wrapper
// checks; the C entry refuses others with cudaErrorMisalignedAddress).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kMaskFloor = -1e20f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

enum ScaleKind { kNone = 0, kPerPosition = 1, kPerChannel = 2 };

// The 16 loaded bytes as floats: 4 f32, 8 bf16 (the high half of an f32), 8
// f16 or 16 int8; element i lies at the i-th lowest address.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float (&x)[16 / sizeof(T)]);
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
// int8: each byte with its sign bit flipped (x + 128, unsigned) becomes the
// low byte of the f32 2^23 + x + 128 by one byte permute; subtracting 2^23 +
// 128 leaves x, exactly.
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& w, float (&x)[16]) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = __uint_as_float(__byte_perm(u[i], 0x4b000000u, 0x7540u | j)) - 8388736.f;
}

constexpr int kRingWarps = 8;
constexpr int kRingThreads = 32 * kRingWarps;
constexpr int kUnitPos = 4;                          // positions a warp copies as one unit
constexpr int kStagePos = kRingWarps * kUnitPos;     // a stage: one unit of every warp
constexpr int kSmRingBytes = 160 * 1024;             // ring bytes an SM's blocks share
constexpr int kRingBlocksPerSm = 2;                  // the launch bound's residency
constexpr int kMaxSlots = 8;                         // ring slots a warp
constexpr int kMaxCluster = 8;                       // the portable cluster size
constexpr int kSmemLimit = 232448;                   // dynamic shared memory a block may take
constexpr int kLoadBytes = 512;                      // a warp's 32 16-byte loads

// Heads a block reads: the largest divisor of h whose slices of one
// position fit one warp load of 512 bytes (elem: the slab's bytes an
// element): a position's copy is then up to 512 contiguous bytes, and a
// warp reads it with one 16-byte load a lane.
int ring_group(int heads, int d, int elem) {
  int g = kLoadBytes / (d * elem);
  while (heads % g) --g;
  return g;
}

// How a launch is laid out (tests/_decode_schedule.py restates it).
struct RingPlan {
  int group;       // heads a block reads
  int slots;       // ring slots of each warp
  int unit_bytes;  // one slot: K rows, V rows (each group * d elements), the aux rows
  int part_off;    // rank 0's slots for the cluster's (m, den, acc) of every head
  int live_off;    // the key mask of the block's positions, a byte each
  int bar_off;     // full mbarriers (warp-major), then the live ranges
  int smem;        // dynamic shared memory of a block
};

// elem: the slab's bytes an element; aux: the f32 rows of the group copied
// beside a unit's K and V (the bias, a per-position K scale, a per-position
// V scale: 0 to 3); blocks: the grid's blocks; sms: the card's SMs.  Each
// block's ring takes its share of kSmRingBytes among the blocks an SM runs
// at once.
RingPlan plan_ring(int d, int elem, int heads, int chunk, int cluster, int aux, bool mask,
                   int blocks, int sms) {
  RingPlan pl{};
  pl.group = ring_group(heads, d, elem);
  const int span = pl.group * d;                      // elements of a position's group
  const int kv = kUnitPos * span * elem;              // one operand's bytes in a unit
  pl.unit_bytes = (2 * kv + aux * pl.group * kUnitPos * 4 + 127) / 128 * 128;
  const int need = (chunk + kStagePos - 1) / kStagePos;  // stages of a block (units of a warp)
  const int per_sm = min(kRingBlocksPerSm, max(1, (blocks + sms - 1) / sms));
  pl.slots = min(need, max(2, min(kMaxSlots, kSmRingBytes / per_sm / (kRingWarps * pl.unit_bytes))));
  const int scratch = kRingWarps * (span + 2 * pl.group) * 4;  // the warps' merge scratch
  const int ring = max(kRingWarps * pl.slots * pl.unit_bytes, scratch);
  pl.part_off = ring;
  pl.live_off = ring + (cluster * pl.group * (d + 2) * 4 + 15) / 16 * 16;
  pl.bar_off = pl.live_off + (mask ? (need * kStagePos + 15) / 16 * 16 : 0);
  pl.smem = pl.bar_off + kRingWarps * pl.slots * 8 + 16 + 8 * kRingWarps;
  return pl;
}

struct RingParams {
  const void *q, *k, *v;
  const float *bias, *mask, *ks, *vs;
  void* out;
  int L, heads, chunk, group, slots, unit_bytes, part_off, live_off, bar_off, k_kind, v_kind;
};

// Grid (h / group, b, chunks), clusters of (1, 1, chunks): block (x, y, z)
// reads heads [x * group, (x + 1) * group) of row y; the row's stages of
// kStagePos positions are dealt to the cluster's blocks in turn, and each
// stage's units of kUnitPos positions to the block's warps.  Each warp
// copies its own units into its own ring slots, one bulk copy a position
// and operand, and reads them back one position a load: lane l holds the
// EPL elements at EPL l of the group's span, one head's slice among LPP
// lanes.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kRingThreads, kRingBlocksPerSm)
decode_ring_kernel(const RingParams p) {
  constexpr int E = sizeof(TKV);                         // bytes of a slab element
  constexpr int EPL = 16 / E;                            // elements of a 16-byte load
  constexpr int LPP = D / EPL;                           // lanes of one head slice
  constexpr int QW = EPL * sizeof(TQ) / 16;              // 16-byte loads of a lane's q
  static_assert(D % EPL == 0 && LPP >= 1 && LPP <= 32, "a head slice is 1 to 32 loads");
  // only int8 slabs carry scales: the other instances compile without them
  constexpr bool kScaled = std::is_same_v<TKV, int8_t>;
  static_assert(std::is_same_v<TKV, TQ> || kScaled, "slabs in the query's type or int8");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  int* range_s = reinterpret_cast<int*>(full + kRingWarps * p.slots);  // first, last live key
  int* wrange = range_s + 4;                  // each warp's first and last live key
  float* part = reinterpret_cast<float*>(smem + p.part_off);
  unsigned char* live_s = smem + p.live_off;  // live_s[k]: position pos(k) is live

  const int G = p.group, h0 = blockIdx.x * G, b = blockIdx.y, rank = blockIdx.z;
  const int nrank = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = p.L, hd = p.heads * D, span = G * D, SB = span * E;  // SB: a span's bytes
  const int KV = kUnitPos * SB;                // bytes of one operand a unit
  const float* mrow = p.mask != nullptr ? p.mask + (long long)b * L : nullptr;
  const float* bias = p.bias != nullptr ? p.bias + (long long)h0 * L : nullptr;
  // per-position scales [b, L, h]: position l of the group's head g at l * heads + g
  const long long srow = (long long)b * L * p.heads + h0;
  const float* ksp = kScaled && p.k_kind == kPerPosition ? p.ks + srow : nullptr;
  const float* vsp = kScaled && p.v_kind == kPerPosition ? p.vs + srow : nullptr;
  // the aux rows of a slot, after its K and V: the bias, then the K scale,
  // then the V scale, each G rows of kUnitPos floats, those present only
  const int row_ks = bias != nullptr, row_vs = row_ks + (ksp != nullptr);
  const int naux = row_vs + (vsp != nullptr);
  // the row's stages dealt in turn: this block's local stage j is the row's
  // stage rank + j * nrank, and its position k is pos(k)
  const int stages = (L + kStagePos - 1) / kStagePos;
  const int own = stages > rank ? (stages - rank + nrank - 1) / nrank : 0;
  auto pos = [&](int k) { return (rank + k / kStagePos * nrank) * kStagePos + k % kStagePos; };

  // Each warp initialises its own slots' barriers: a slot's phase completes
  // with its copies' bytes, the expect_tx arrival and (with aux rows) one
  // cp.async arrival a lane.
  uint64_t* wfull = full + warp * p.slots;
  if (lane == 0) {
    for (int s = 0; s < p.slots; ++s) hopper::mbar_init(&wfull[s], naux ? 33 : 1);
    hopper::mbar_fence_init();
  }
  __syncwarp();
  // this lane's EPL elements of q, loaded now and unpacked once the first
  // copies are issued
  const int hh = lane / LPP;             // this lane's head in the group
  const bool active = lane * EPL < span;
  const long long qoff = ((long long)b * p.heads + h0) * D + lane * EPL;
  uint4 qw[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i)
    qw[i] = active ? __ldg(reinterpret_cast<const uint4*>(static_cast<const TQ*>(p.q) + qoff) + i)
                   : make_uint4(0u, 0u, 0u, 0u);
  // The block's live range: the mask of its positions read once, 8 loads a
  // thread in flight and kept a byte a position, each warp's first and
  // last live key reduced in the warp, then across the warps through
  // shared memory (no atomics).  Without a mask no block barrier comes
  // before the first copies.
  if (mrow != nullptr) {
    int first = L, last = -1;
    for (int base = 0; base < own * kStagePos; base += kRingThreads * 8) {
      float mv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = base + u * kRingThreads + tid;
        mv[u] = k < own * kStagePos && pos(k) < L ? __ldg(mrow + pos(k)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = base + u * kRingThreads + tid;
        if (k < own * kStagePos) live_s[k] = mv[u] > 0.f;
        if (mv[u] > 0.f) {
          first = min(first, pos(k));
          last = max(last, pos(k));
        }
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) {
      wrange[2 * warp] = first;
      wrange[2 * warp + 1] = last;
    }
    __syncthreads();
    if (tid == 0) {  // warp 0's range, widened by the others'
      for (int w = 1; w < kRingWarps; ++w) {
        first = min(first, wrange[2 * w]);
        last = max(last, wrange[2 * w + 1]);
      }
      range_s[0] = first;
      range_s[1] = last;
    }
    __syncthreads();
  }
  if (nrank > 1) hopper::cluster_arrive();  // phase 0: range_s published to the cluster

  // The range [lo, hi) of the row this block reads its own positions of:
  // from its first live key to its last; none when it has none but the
  // row has one; the whole row when the row has none (every key at the
  // floor: mean(V)) or there is no mask.
  int lo = 0, hi = L;
  bool drop_masked = false, waited = false;  // masked keys inside [lo, hi) weigh exactly 0
  if (mrow != nullptr) {
    if (range_s[0] <= range_s[1]) {
      lo = range_s[0];
      hi = range_s[1] + 1;
      drop_masked = true;
    } else if (nrank > 1) {
      hopper::cluster_wait();    // every rank's range_s is published
      waited = true;
      int any = 0;
      if (lane < nrank) {
        const uint32_t r = hopper::cluster_map(range_s, lane);
        any = hopper::ld_cluster(r) <= hopper::ld_cluster(r + 4);
      }
      if (__any_sync(0xffffffffu, any)) hi = lo;  // contributes (-1e20, 0, 0)
    }
  }

  // This warp's units: unit `warp` of each of the block's stages that
  // meet [lo, hi), from local stage j0 on; unit j's positions u0 + u with
  // u in [ulo, uhi) lie in [lo, hi) and are read.
  const int j0 = hi > lo ? max(0, (lo / kStagePos - rank + nrank - 1) / nrank) : 0;
  const int mine = hi > lo ? ((hi - 1) / kStagePos - rank) / nrank - j0 + 1 : 0;
  unsigned char* wring = smem + warp * p.slots * p.unit_bytes;
  const TKV* kb = static_cast<const TKV*>(p.k) + (long long)b * L * hd + h0 * D;
  const TKV* vb = static_cast<const TKV*>(p.v) + (long long)b * L * hd + h0 * D;
  auto unit0 = [&](int j) { return (rank + (j0 + j) * nrank) * kStagePos + warp * kUnitPos; };
  // unit j of this warp into its slot `slot`: lane u in [ulo, uhi) copies
  // position u0 + u's K and V spans of the group's heads, the lanes in turn
  // the group's aux values (4-byte cp.async: an aux row need not start on
  // 16 bytes)
  auto issue = [&](int j, int slot) {
    const int u0 = unit0(j), ulo = max(0, lo - u0), uhi = min(kUnitPos, hi - u0);
    unsigned char* st = wring + slot * p.unit_bytes;
    if (lane == 0) hopper::mbar_arrive_expect_tx(&wfull[slot], 2u * max(0, uhi - ulo) * SB);
    __syncwarp();
    if (lane >= ulo && lane < uhi) {
      const long long off = (long long)(u0 + lane) * hd;
      hopper::bulk_load(st + lane * SB, kb + off, SB, &wfull[slot]);
      hopper::bulk_load(st + KV + lane * SB, vb + off, SB, &wfull[slot]);
    }
    if (naux) {
      // aux row `row`: value (g, u) from src + g * gstride + (u0 + u) * ustride
      auto copy_row = [&](int row, const float* src, long long gstride, long long ustride) {
        float* dst = reinterpret_cast<float*>(st + 2 * KV) + row * G * kUnitPos;
        for (int x = lane; x < G * kUnitPos; x += 32) {
          const int u = x % kUnitPos;
          if (u >= ulo && u < uhi)
            hopper::cp_async4(dst + x, src + (x / kUnitPos) * gstride + (u0 + u) * ustride, true);
        }
      };
      if (bias != nullptr) copy_row(0, bias, L, 1);
      if (ksp != nullptr) copy_row(row_ks, ksp, 1, p.heads);
      if (vsp != nullptr) copy_row(row_vs, vsp, 1, p.heads);
      hopper::mbar_arrive_cp_async(&wfull[slot]);
    }
  };
  for (int j = 0; j < min(mine, p.slots); ++j) issue(j, j);
  float qv[EPL];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    float x[16 / sizeof(TQ)];
    unpack<TQ>(qw[i], x);
#pragma unroll
    for (int e = 0; e < 16 / (int)sizeof(TQ); ++e) qv[i * (16 / sizeof(TQ)) + e] = x[e];
  }
  if (kScaled && p.k_kind == kPerChannel && active) {  // the per-channel K scale folds into q
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[e] *= __ldg(p.ks + qoff + e);
  }

  float m = kMaskFloor, den = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int j = 0, slot = 0, phase = 0; j < mine; ++j) {
    hopper::mbar_wait(&wfull[slot], phase);
    const int u0 = unit0(j), ulo = max(0, lo - u0), uhi = min(kUnitPos, hi - u0);
    const unsigned char* st = wring + slot * p.unit_bytes;
    // this lane's head's aux values of position u of the unit
    auto aux = [&](int row, int u) {
      return reinterpret_cast<const float*>(st + 2 * KV)[(row * G + hh) * kUnitPos + u];
    };
    // the unit's K and V from the slot, then its scores; positions outside
    // [ulo, uhi) were not copied: their slot bytes are stale and never read
    // (weight exactly 0)
    uint4 kw[kUnitPos], vw[kUnitPos];
#pragma unroll
    for (int u = 0; u < kUnitPos; ++u) {
      const bool in = u >= ulo && u < uhi && active;
      kw[u] = in ? *reinterpret_cast<const uint4*>(st + u * SB + lane * 16)
                 : make_uint4(0u, 0u, 0u, 0u);
      vw[u] = in ? *reinterpret_cast<const uint4*>(st + KV + u * SB + lane * 16)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    const int k0 = (j0 + j) * kStagePos + warp * kUnitPos;  // live_s index of u0
    float sc[kUnitPos];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnitPos; ++u) {
      float x[EPL];
      unpack<TKV>(kw[u], x);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qv[e], x[e], dot);
#pragma unroll
      for (int off = LPP / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float add = -INFINITY;  // not read: weight exactly 0
      if (u >= ulo && u < uhi) {
        if (ksp != nullptr && active) dot *= aux(row_ks, u);  // the per-position K scale
        add = bias != nullptr && active ? aux(0, u) : 0.f;
        if (mrow != nullptr) {
          const bool live = live_s[k0 + u];
          add = drop_masked && !live ? -INFINITY : add + (live ? 0.f : kMaskFloor);
        }
      }
      sc[u] = dot + add;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);  // both at or above the -1e20 floor
    den *= alpha;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnitPos; ++u) {
      float pu = expf(sc[u] - mx);
      den += pu;
      // the per-position V scale after den
      if (vsp != nullptr && active && u >= ulo && u < uhi) pu *= aux(row_vs, u);
      float y[EPL];
      unpack<TKV>(vw[u], y);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pu, y[e], acc[e]);
    }
    m = mx;
    // the slot is read: refill it with this warp's unit j + slots
    __syncwarp();
    if (j + p.slots < mine) issue(j + p.slots, slot);
    if (++slot == p.slots) {
      slot = 0;
      phase ^= 1;
    }
  }

  // Merge the warps' states of each head; the ring is free once every warp
  // is past its last unit, and holds the scratch: each warp's acc of the
  // span, then its m and den of each head.  Thread tid owns the outputs o =
  // tid + kRingThreads t of the span.
  float* acc_s = reinterpret_cast<float*>(smem);   // [warp][span]
  float* md_s = acc_s + kRingWarps * span;         // [warp][m of G heads, den of G]
  __syncthreads();
  if (active) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc_s[warp * span + lane * EPL + e] = acc[e];
    if (lane % LPP == 0) {
      md_s[(warp * 2) * G + hh] = m;
      md_s[(warp * 2 + 1) * G + hh] = den;
    }
  }
  __syncthreads();
  // outputs a thread owns at most: a span is at most 512 bytes
  constexpr int NT = (kLoadBytes / E + kRingThreads - 1) / kRingThreads;
  float M[NT], den_all[NT], a[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int o = tid + t * kRingThreads, head = min(o / D, G - 1);
    M[t] = kMaskFloor;
    den_all[t] = a[t] = 0.f;
    if (o >= span) continue;
    for (int w = 0; w < kRingWarps; ++w) M[t] = fmaxf(M[t], md_s[(w * 2) * G + head]);
    for (int w = 0; w < kRingWarps; ++w) {
      const float e = expf(md_s[(w * 2) * G + head] - M[t]);
      den_all[t] = fmaf(md_s[(w * 2 + 1) * G + head], e, den_all[t]);
      a[t] = fmaf(acc_s[w * span + o], e, a[t]);
    }
  }

  if (nrank > 1) {
    if (!waited) hopper::cluster_wait();  // phase 0: every block of the cluster runs
    if (rank != 0) {                     // this chunk's (m, den, acc) into rank 0's slot
      float* slot = part + rank * G * (D + 2);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int o = tid + t * kRingThreads;
        if (o < span) {
          if (o % D == 0) {
            hopper::st_cluster(hopper::cluster_map(slot + o / D, 0), M[t]);
            hopper::st_cluster(hopper::cluster_map(slot + G + o / D, 0), den_all[t]);
          }
          hopper::st_cluster(hopper::cluster_map(slot + 2 * G + o, 0), a[t]);
        }
      }
    }
    hopper::cluster_arrive();             // phase 1: the slots are written
    hopper::cluster_wait();
    if (rank != 0) return;
#pragma unroll
    for (int t = 0; t < NT; ++t) {  // merge the chunks in rank order, the max floored at -1e20
      const int o = tid + t * kRingThreads;
      if (o >= span) continue;
      const int head = o / D;
      float top = M[t];
      for (int r = 1; r < nrank; ++r) top = fmaxf(top, part[r * G * (D + 2) + head]);
      float wsum = den_all[t] * expf(M[t] - top), asum = a[t] * expf(M[t] - top);
      for (int r = 1; r < nrank; ++r) {
        const float* slot = part + r * G * (D + 2);
        const float e = expf(slot[head] - top);
        wsum = fmaf(slot[G + head], e, wsum);
        asum = fmaf(slot[2 * G + o], e, asum);
      }
      den_all[t] = wsum;
      a[t] = asum;
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int o = tid + t * kRingThreads;
    if (o < span) {
      const long long at = ((long long)b * p.heads + h0) * D + o;
      float y = a[t] / fmaxf(den_all[t], 1e-20f);
      if (kScaled && p.v_kind == kPerChannel) y *= __ldg(p.vs + at);  // once, after the merge
      static_cast<TQ*>(p.out)[at] = from_f32<TQ>(y);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *bias, *mask, *ks, *vs;
  void* out;
  int b, L, heads, chunk, k_kind, v_kind;
  cudaStream_t stream;
};

// The card's SM count, read once a device.
int device_sms(int dev) {
  static std::atomic<int> count[64];
  int n = dev < 64 ? count[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      dev < 64)
    count[dev].store(n, std::memory_order_relaxed);
  return n;
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_ring(const Args& a, const RingPlan& pl, int cluster, int dev) {
  auto kernel = decode_ring_kernel<TQ, TKV, D>;
  // the attribute is set once a device (a bit each), not on every call
  static std::atomic<unsigned long long> ready{0};
  if (!(ready.load(std::memory_order_relaxed) & (1ull << dev))) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    ready.fetch_or(1ull << dev, std::memory_order_relaxed);
  }
  const RingParams p{a.q,        a.k,          a.v,         a.bias,      a.mask,
                     a.ks,       a.vs,         a.out,       a.L,         a.heads,
                     a.chunk,    pl.group,     pl.slots,    pl.unit_bytes, pl.part_off,
                     pl.live_off, pl.bar_off,  a.k_kind,    a.v_kind};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(a.heads / pl.group, a.b, cluster);
  cfg.blockDim = dim3(kRingThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one chunk: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One launch of decode_ring_kernel: the chunks of a row form a cluster.
template <typename TQ, typename TKV, int D>
cudaError_t launch_ring_d(const Args& a) {
  const int cluster = (a.L + a.chunk - 1) / a.chunk;
  if (cluster > kMaxCluster) return cudaErrorInvalidConfiguration;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int sms = device_sms(dev);
  if (dev >= 64 || sms <= 0) return cudaErrorInvalidDevice;
  const int elem = sizeof(TKV), group = ring_group(a.heads, D, elem);
  const int aux = (a.bias != nullptr) + (a.k_kind == kPerPosition) + (a.v_kind == kPerPosition);
  const RingPlan pl = plan_ring(D, elem, a.heads, a.chunk, cluster, aux, a.mask != nullptr,
                                a.heads / group * a.b * cluster, sms);
  if (pl.smem > kSmemLimit) return cudaErrorInvalidConfiguration;
  return launch_ring<TQ, TKV, D>(a, pl, cluster, dev);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_ring_d<TQ, TKV, 16>(a);
    case 32: return launch_ring_d<TQ, TKV, 32>(a);
    case 64: return launch_ring_d<TQ, TKV, 64>(a);
    case 128: return launch_ring_d<TQ, TKV, 128>(a);
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
// block, at most 8 chunks (a cluster).  Returns the cudaError_t of the
// launch.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const float* bias, const float* mask, const float* k_scale,
                         const float* v_scale, void* out, int b, int L, int heads, int d,
                         int q_dtype, int kv_int8, int k_kind, int v_kind, int chunk,
                         void* stream) {
  if (b <= 0 || L <= 0 || heads <= 0 || chunk <= 0 || b > 65535) return cudaErrorInvalidValue;
  if ((L + chunk - 1) / chunk > kMaxCluster) return cudaErrorInvalidValue;
  if ((k_kind != kNone) != (k_scale != nullptr)) return cudaErrorInvalidValue;
  if ((v_kind != kNone) != (v_scale != nullptr)) return cudaErrorInvalidValue;
  if (!kv_int8 && (k_kind != kNone || v_kind != kNone)) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return cudaErrorMisalignedAddress;
  const Args a{q,     k, v,     bias,  mask,   k_scale, v_scale,
               out,   b, L,     heads, chunk,  k_kind,  v_kind,
               static_cast<cudaStream_t>(stream)};
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
