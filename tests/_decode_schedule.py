"""The bf16/f16 decode kernel's layout and walk, restated in Python.

``plan`` is ``plan_ring`` of ``tpu_air_torch/ops/csrc/decode_attention.cu``
(with the chunk the wrapper's ``plan_chunk`` gives the call), ``walk`` the
positions each block of a row's cluster copies and reads under a key mask,
unit by unit and warp by warp, and ``copies`` its bulk copies.
``tests/test_torch_decode_plan.py`` holds the walk to its rules and mirrors
the kernel's arithmetic along it on the CPU; the card tests of ``tests/test_torch_cuda.py`` hold the kernel itself
to the plain version where the layout changes.
"""

WARPS = 8             # kRingWarps
UNIT_POS = 4          # kUnitPos: positions a warp copies as one unit
STAGE_POS = WARPS * UNIT_POS   # kStagePos
SM_RING_BYTES = 160 * 1024     # kSmRingBytes
RING_BLOCKS_PER_SM = 2         # kRingBlocksPerSm
MAX_SLOTS = 8         # kMaxSlots
MAX_CLUSTER = 8       # kMaxCluster
SMEM_LIMIT = 232448   # kSmemLimit
LOAD = 256            # kLoad: elements of a warp's 32 16-byte loads


def _ceil(a, b):
    return -(-a // b)


def ring_group(h, d):
    """``ring_group``: heads one block reads, the largest divisor of h whose
    slices of a position fit one warp load."""
    g = LOAD // d
    while h % g:
        g -= 1
    return g


def plan(b, h, d, L, chunk, sms, bias=False, mask=False) -> dict:
    """``plan_ring`` for a call whose wrapper chose ``chunk``."""
    group = ring_group(h, d)
    cluster = _ceil(L, chunk)
    blocks = h // group * b * cluster
    span = group * d
    kv = UNIT_POS * span * 2
    aux = (group if bias else 0) * UNIT_POS * 4
    unit_bytes = _ceil(2 * kv + aux, 128) * 128
    need = _ceil(chunk, STAGE_POS)
    per_sm = min(RING_BLOCKS_PER_SM, max(1, _ceil(blocks, sms)))
    slots = min(need, max(2, min(MAX_SLOTS, SM_RING_BYTES // per_sm // (WARPS * unit_bytes))))
    ring = max(WARPS * slots * unit_bytes, WARPS * (span + 2 * group) * 4)
    live_off = ring + _ceil(cluster * group * (d + 2) * 4, 16) * 16
    bar_off = live_off + (_ceil(need * STAGE_POS, 16) * 16 if mask else 0)
    return {"group": group, "cluster": cluster, "chunk": chunk, "grid": (h // group, b, cluster),
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
