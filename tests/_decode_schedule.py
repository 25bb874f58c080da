"""The decode kernel's layout and walk, restated in Python.

``plan`` is ``plan_ring`` of ``tpu_air_torch/ops/csrc/decode_attention.cu``
(with the chunk the wrapper's ``plan_chunk`` gives the call), ``walk`` the
positions each block of a row's cluster copies and reads under a key mask,
unit by unit and warp by warp, and ``copies`` its bulk copies.
``mirror`` computes the kernel's arithmetic along the walk in torch, on the
CPU.  ``tests/test_torch_decode_plan.py`` holds the walk to its rules and
the mirror to the references; the card tests of ``tests/test_torch_cuda.py``
hold the kernel itself to the plain version where the layout changes.
"""

import torch

WARPS = 8             # kRingWarps
UNIT_POS = 4          # kUnitPos: positions a warp copies as one unit
STAGE_POS = WARPS * UNIT_POS   # kStagePos
SM_RING_BYTES = 160 * 1024     # kSmRingBytes
RING_BLOCKS_PER_SM = 2         # kRingBlocksPerSm
MAX_SLOTS = 8         # kMaxSlots
MAX_CLUSTER = 8       # kMaxCluster
SMEM_LIMIT = 232448   # kSmemLimit
LOAD_BYTES = 512      # kLoadBytes: a warp's 32 16-byte loads


def _ceil(a, b):
    return -(-a // b)


def ring_group(h, d, elem):
    """``ring_group``: heads one block reads, the largest divisor of h whose
    slices of a position, ``elem`` bytes an element, fit one warp load."""
    g = LOAD_BYTES // (d * elem)
    while h % g:
        g -= 1
    return g


def plan(b, h, d, L, chunk, sms, bias=False, mask=False, elem=2, k_pos=False,
         v_pos=False) -> dict:
    """``plan_ring`` for a call whose wrapper chose ``chunk``: ``elem`` the
    slab's bytes an element (4 f32, 2 bf16/f16, 1 int8); ``bias``, ``k_pos``
    and ``v_pos`` the aux rows copied beside a unit's K and V (the bias, the
    per-position K and V scales)."""
    group = ring_group(h, d, elem)
    cluster = _ceil(L, chunk)
    blocks = h // group * b * cluster
    span = group * d
    kv = UNIT_POS * span * elem
    aux = (int(bias) + int(k_pos) + int(v_pos)) * group * UNIT_POS * 4
    unit_bytes = _ceil(2 * kv + aux, 128) * 128
    need = _ceil(chunk, STAGE_POS)
    per_sm = min(RING_BLOCKS_PER_SM, max(1, _ceil(blocks, sms)))
    slots = min(need, max(2, min(MAX_SLOTS, SM_RING_BYTES // per_sm // (WARPS * unit_bytes))))
    ring = max(WARPS * slots * unit_bytes, WARPS * (span + 2 * group) * 4)
    live_off = ring + _ceil(cluster * group * (d + 2) * 4, 16) * 16
    bar_off = live_off + (_ceil(need * STAGE_POS, 16) * 16 if mask else 0)
    return {"group": group, "cluster": cluster, "chunk": chunk, "grid": (h // group, b, cluster),
            "span_bytes": span * elem, "aux_rows": int(bias) + int(k_pos) + int(v_pos),
            "slots": slots, "unit_bytes": unit_bytes, "part_off": ring, "live_off": live_off,
            "bar_off": bar_off, "smem": bar_off + WARPS * slots * 8 + 16 + 8 * WARPS}


def block_positions(L, nrank, rank):
    """The row's positions block ``rank`` of a cluster of ``nrank`` owns: its
    share of the stages, dealt in turn."""
    stages = _ceil(L, STAGE_POS)
    return [p for s in range(rank, stages, nrank)
            for p in range(s * STAGE_POS, min(L, (s + 1) * STAGE_POS))]


def walk(L, nrank, live=None):
    """{rank: block} for one row: ``lo``, ``hi``, ``drop`` (masked keys in
    the range weigh 0), and ``units``: for each warp the (first position,
    positions read) of each unit in walk order.  ``live``: the row's key
    mask as booleans, or None."""
    ranges = {}
    for r in range(nrank):
        own = [p for p in block_positions(L, nrank, r) if live is None or live[p]]
        ranges[r] = (own[0], own[-1]) if own and live is not None else None
    row_any = live is not None and any(ranges.values())
    out = {}
    for r in range(nrank):
        lo, hi, drop = 0, L, False
        if live is not None:
            if ranges[r] is not None:
                lo, hi, drop = ranges[r][0], ranges[r][1] + 1, True
            elif row_any:
                hi = lo                       # skipped: contributes (-1e20, 0, 0)
        units = {w: [] for w in range(WARPS)}
        if hi > lo:
            j0 = max(0, _ceil(lo // STAGE_POS - r, nrank))
            j1 = ((hi - 1) // STAGE_POS - r) // nrank
            for w in range(WARPS):
                for j in range(j0, j1 + 1):
                    u0 = (r + j * nrank) * STAGE_POS + w * UNIT_POS
                    read = [u0 + u for u in range(UNIT_POS) if lo <= u0 + u < hi]
                    units[w].append((u0, read))
        out[r] = {"lo": lo, "hi": hi, "drop": drop, "units": units}
    return out


def copies(block):
    """The bulk copies a block issues an operand, in issue order per warp:
    one a position read, of the group's span."""
    return [p for w in range(WARPS) for _, read in block["units"][w] for p in read]


FLOOR = -1e20         # kMaskFloor


def _scale_rows(s, b, L, h):
    """A flat scale's kind: "pos" for per-position [b, L, h], "chan" for
    per-channel [b, 1, h*d], None without one."""
    if s is None:
        return None
    return "pos" if tuple(s.shape) == (b, L, h) else "chan"


def mirror(q, k, v, bias=None, kv_mask=None, k_scale=None, v_scale=None, *, chunk, sms=132):
    """What decode_ring_kernel computes, in torch f32 along ``walk``: per
    row, group and rank, each warp's online softmax (m, den, acc) of each
    head over its units, masked keys inside a block's range at -inf and
    the others at the -1e20 floor; the warps merged in warp order, then the
    cluster's ranks in rank order with the max floored at -1e20.  int8
    scales fold in where the kernel folds them: a per-channel K scale into
    q, a per-position K scale into the score before the bias and mask, a
    per-position V scale into p after den, a per-channel V scale into the
    output after the merge.  q [b, h, d]; k/v [b, L, h*d] (f32, bf16, f16
    or int8: the plan's group follows the element size); bias [h, L];
    kv_mask [b, L]; scales per-position [b, L, h] or per-channel
    [b, 1, h*d]."""
    b, h, d = q.shape
    L = k.shape[1]
    k_kind, v_kind = _scale_rows(k_scale, b, L, h), _scale_rows(v_scale, b, L, h)
    pl = plan(b, h, d, L, chunk, sms, bias=bias is not None, mask=kv_mask is not None,
              elem=k.element_size(), k_pos=k_kind == "pos", v_pos=v_kind == "pos")
    G, nrank = pl["group"], pl["cluster"]
    kf, vf, qf = k.float().reshape(b, L, h, d), v.float().reshape(b, L, h, d), q.float()
    if k_kind == "chan":
        qf = qf * k_scale.reshape(b, h, d)
    out = torch.empty(b, h, d)
    for bi in range(b):
        live = None if kv_mask is None else (kv_mask[bi] > 0)
        blocks = walk(L, nrank, None if live is None else live.tolist())
        for h0 in range(0, h, G):
            hs = slice(h0, h0 + G)
            ranks = []
            for r in range(nrank):
                blk = blocks[r]
                warps = []
                for w in range(WARPS):
                    m, den, acc = torch.full((G,), FLOOR), torch.zeros(G), torch.zeros(G, d)
                    for _, read in blk["units"][w]:
                        if not read:
                            continue
                        idx = torch.tensor(read)
                        s = torch.einsum("lgd,gd->gl", kf[bi, idx, hs], qf[bi, hs])
                        if k_kind == "pos":
                            s = s * k_scale[bi, idx, hs].T
                        add = torch.zeros(G, len(read))
                        if bias is not None:
                            add = add + bias[hs][:, idx]
                        if live is not None:
                            lv = live[idx][None]
                            add = add + torch.where(lv, 0.0, FLOOR)
                            if blk["drop"]:
                                add = torch.where(lv, add, float("-inf"))
                        s = s + add
                        mx = torch.maximum(m, s.max(1).values)
                        alpha = torch.exp(m - mx)
                        p = torch.exp(s - mx[:, None])
                        den = den * alpha + p.sum(1)
                        if v_kind == "pos":
                            p = p * v_scale[bi, idx, hs].T
                        acc = acc * alpha[:, None] + torch.einsum("gl,lgd->gd", p, vf[bi, idx, hs])
                        m = mx
                    warps.append((m, den, acc))
                top = torch.stack([wm for wm, _, _ in warps]).max(0).values
                e = [torch.exp(wm - top) for wm, _, _ in warps]
                ranks.append((top, sum(wd * ei for (_, wd, _), ei in zip(warps, e)),
                              sum(wa * ei[:, None] for (_, _, wa), ei in zip(warps, e))))
            top = torch.clamp(torch.stack([rm for rm, _, _ in ranks]).max(0).values, min=FLOOR)
            e = [torch.exp(rm - top) for rm, _, _ in ranks]
            den = sum(rd * ei for (_, rd, _), ei in zip(ranks, e))
            acc = sum(ra * ei[:, None] for (_, _, ra), ei in zip(ranks, e))
            out[bi, hs] = acc / torch.clamp(den, min=1e-20)[:, None]
    if v_kind == "chan":
        out = out * v_scale.reshape(b, h, d)
    return out.to(q.dtype)


def reads(L, nrank, live=None):
    """Positions one head group of a row reads under ``walk``."""
    return sum(len(rd) for blk in walk(L, nrank, live).values()
               for w in range(WARPS) for _, rd in blk["units"][w])
