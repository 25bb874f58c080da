"""The bf16/f16 flash forward's layout and walk, restated in Python.

``plan`` is ``plan_fwd`` of ``tpu_air_torch/ops/csrc/flash_attention.cu``,
``items`` and ``walk`` its kernel's map from a work item to (batch, head,
rows) and the key tiles each consumer computes, ``staged_bytes`` the bytes
that walk stages from L2 (a model: nothing here reads the card's counters).
``tests/test_torch_flash_plan.py`` mirrors the kernel along them on the CPU;
the card tests of ``tests/test_torch_cuda.py`` hold the kernel itself to
the plain version at the shapes where the layout changes.
"""

ROWS = 64            # query rows of one consumer warpgroup (kRows)
MAX_STAGES = 4       # kMaxStages
SMEM_LIMIT = 232448  # kSmemLimit: the most dynamic shared memory a block may take
BAR_BYTES = 128      # kBarBytes


def plan(d, batch, heads, lq, lk, bias_n=0, mask=False, bias_tma=True) -> dict:
    """``plan_fwd``: the layout of a 16-bit forward launch."""
    dp = max(d, 64)
    bk = 64 if d == 128 and bias_n else 128
    paired = bool(bias_n) and batch > 1 and heads % bias_n == 0
    kv_slots = 2 if paired else 1
    bias_slots = (1 if paired else 2) if bias_n else 0
    mask_slots = (2 if paired else 1) if mask else 0
    stage = kv_slots * 2 * bk * dp * 2 + bias_slots * ROWS * bk * 4 + mask_slots * bk * 4
    stage = -(-stage // 1024) * 1024
    fixed = 1024 + 2 * ROWS * dp * 2 + BAR_BYTES
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    rows = ROWS if paired else 2 * ROWS
    return {"paired": int(paired), "bias_tma": int(bool(bias_n) and bias_tma), "block_k": bk,
            "stages": stages, "stage_bytes": stage, "smem_bytes": fixed + stages * stage,
            "units": (batch + 1) // 2 * heads if paired else batch * heads,
            "query_tiles": -(-lq // rows)}


def items(pl, causal):
    """The work items in the order of their index w: (tile, unit)."""
    units, tiles = pl["units"], pl["query_tiles"]
    for w in range(units * tiles):
        if causal:
            yield tiles - 1 - w // units, w % units
        else:
            yield w % tiles, w // tiles


def block_items(pl, blocks):
    """The items each of ``blocks`` persistent blocks walks: rounds of
    ``blocks`` items, forth and back in turn."""
    n_items = pl["units"] * pl["query_tiles"]
    out = []
    for b in range(blocks):
        mine, n = [], 0
        while (w := n * blocks + (blocks - 1 - b if n % 2 else b)) < n_items:
            mine.append(w)
            n += 1
        out.append(mine)
    return out


def key_tiles(pl, lq, lk, causal, row0):
    end = min(lk, lq, row0 + ROWS) if causal else lk
    return -(-end // pl["block_k"])


def walk(pl, batch, heads, lq, lk, causal):
    """Every (batch, head, first row, key tile, edge) a consumer computes;
    edge: the tile is masked element by element."""
    bk = pl["block_k"]
    for tile, unit in items(pl, causal):
        h = unit % heads
        b0 = 2 * (unit // heads) if pl["paired"] else unit // heads
        q0 = tile * (ROWS if pl["paired"] else 2 * ROWS)
        for c in (0, 1):
            b = b0 + c if pl["paired"] else b0
            row0 = q0 if pl["paired"] else q0 + c * ROWS
            if b >= batch or row0 >= lq:
                continue
            for j in range(key_tiles(pl, lq, lk, causal, row0)):
                k0 = j * bk
                yield b, h, row0, j, k0 + bk > lk or (causal and k0 + bk - 1 > row0)


def staged_bytes(pl, batch, heads, lq, lk, d, causal, bias=True, itemsize=2):
    """The bytes one launch stages from L2, by operand: "bias", a (64,
    block_k) f32 tile for each consumer and key tile, one for both where the
    consumers pair; "kv", each consumer's K and V rows of each key tile;
    "q", each consumer's rows once an item.  Rows past lq and lk are
    zero-filled, not read."""
    bk = pl["block_k"]
    bias_tiles, kv, q_rows = set(), 0, set()
    for b, h, row0, j, _ in walk(pl, batch, heads, lq, lk, causal):
        bias_tiles.add((b // 2 if pl["paired"] else b, h, row0, j))
        kv += 2 * (min(lk, j * bk + bk) - j * bk) * d * itemsize
        q_rows.add((b, h, row0))
    return {"bias": len(bias_tiles) * ROWS * bk * 4 if bias else 0, "kv": kv,
            "q": sum(min(ROWS, lq - row0) for _, _, row0 in q_rows) * d * itemsize}
