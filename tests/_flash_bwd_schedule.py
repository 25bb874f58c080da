"""The bf16/f16 flash backward's layout and walks, restated in Python.

``plan_bwd`` is ``plan_bwd`` of ``tpu_air_torch/ops/csrc/flash_attention_bwd.cu``,
``items`` its kernels' map from a work item's index to (batch*head, first
row), ``walk_dq`` and ``walk_dkv`` the tiles each consumer of the dq and the
dk/dv kernel computes.  ``tests/test_torch_flash_bwd_plan.py`` mirrors the
kernels along them on the CPU; the card tests of ``tests/test_torch_cuda.py``
hold the kernels themselves to the plain version where the layout changes.
"""

ROWS = 64            # rows a consumer owns: query rows (dq), keys (dk/dv) (kRows)
BLOCK = 64           # rows of a ring stage: keys (dq), queries (dk/dv) (kBlock)
MAX_STAGES = 4       # kMaxStages
SMEM_LIMIT = 232448  # kSmemLimit: the most dynamic shared memory a block may take
BAR_BYTES = 128      # kBarBytes


def _ceil(a, b):
    return -(-a // b)


def plan_bwd(d, batch, heads, lq, lk, mask=False, dkv=False) -> dict:
    """``plan_bwd``: the layout of a 16-bit dq (or, ``dkv``, dk/dv) launch."""
    dp = max(d, 64)
    extra = 2 * BLOCK * 4 if dkv else (BLOCK * 4 if mask else 0)
    stage = _ceil(2 * BLOCK * dp * 2 + extra, 1024) * 1024
    fixed = 1024 + 2 * 2 * ROWS * dp * 2 + BAR_BYTES
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    return {"dkv": dkv, "stages": stages, "stage_bytes": stage,
            "smem_bytes": fixed + stages * stage, "units": batch * heads,
            "tiles": _ceil(lk if dkv else lq, 2 * ROWS)}


def items(pl, causal):
    """The work items in the order of their index w: (batch*head, first row
    of the 128).  Causal: the longest first (dq: the last query rows, dk/dv:
    the first keys); else a unit's items next to each other."""
    units, tiles = pl["units"], pl["tiles"]
    for w in range(units * tiles):
        if causal:
            tile = w // units if pl["dkv"] else tiles - 1 - w // units
            yield w % units, tile * 2 * ROWS
        else:
            yield w // tiles, w % tiles * 2 * ROWS


def block_items(n_items, blocks):
    """The item indices each of ``blocks`` persistent blocks walks: rounds of
    ``blocks`` items, forth and back in turn."""
    out = []
    for b in range(blocks):
        mine, n = [], 0
        while (w := n * blocks + (blocks - 1 - b if n % 2 else b)) < n_items:
            mine.append(w)
            n += 1
        out.append(mine)
    return out


def dq_key_tiles(lq, lk, causal, row0):
    """Key tiles that query rows [row0, row0 + 64) need."""
    end = min(lk, lq, row0 + ROWS) if causal else lk
    return _ceil(end, BLOCK)


def dkv_query_tiles(lq, causal, r0):
    """(first query row, query tiles) an item's ring carries."""
    qs0 = r0 if causal else 0
    return qs0, _ceil(lq - qs0, BLOCK) if qs0 < lq else 0


def item_tiles(pl, lq, lk, causal, r0):
    """The tiles both consumers of an item compute: its work."""
    if not pl["dkv"]:
        return sum(dq_key_tiles(lq, lk, causal, r0 + c * ROWS)
                   for c in (0, 1) if r0 + c * ROWS < lq)
    _, n = dkv_query_tiles(lq, causal, r0)
    return sum(max(0, n - (c if causal else 0)) for c in (0, 1) if r0 + c * ROWS < lk)


def walk_dq(pl, heads, lq, lk, causal):
    """Every (batch, head, first query row, first key, edge) a dq consumer
    computes; edge: the tile is masked element by element."""
    for bh, r0 in items(pl, causal):
        for c in (0, 1):
            cq0 = r0 + c * ROWS
            if cq0 >= lq:
                continue
            for j in range(dq_key_tiles(lq, lk, causal, cq0)):
                k0 = j * BLOCK
                edge = k0 + BLOCK > lk or cq0 + ROWS > lq or (causal and k0 + BLOCK - 1 > cq0)
                yield bh // heads, bh % heads, cq0, k0, edge


def walk_dkv(pl, heads, lq, lk, causal):
    """Every (batch, head, first key, first query, edge) a dk/dv consumer
    computes; under causal masking the second consumer skips the ring's
    first query tile."""
    for bh, r0 in items(pl, causal):
        qs0, n = dkv_query_tiles(lq, causal, r0)
        for c in (0, 1):
            ck0 = r0 + c * ROWS
            if ck0 >= lk:
                continue
            for j in range(c if causal else 0, n):
                qs = qs0 + j * BLOCK
                edge = qs + BLOCK > lq or ck0 + ROWS > lk or (causal and qs < ck0 + ROWS - 1)
                yield bh // heads, bh % heads, ck0, qs, edge
