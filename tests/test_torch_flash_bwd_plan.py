"""The bf16/f16 flash backward's schedule, mirrored in torch, on the CPU.

``csrc/flash_attention_bwd.cu`` runs the 16-bit dq and dk/dv kernels as work
items of one block: a producer warpgroup feeds two consumer warpgroups of 64
rows each (dq: query rows, dk/dv: keys) from a ring of 64-row tiles (dq: K
and V, dk/dv: Q, dO, lse and delta).  Each consumer walks the tiles its rows
see, masks element by element only on tiles that cross the diagonal, Lq or
Lk, computes p in log2 units after the hard zero of masked scores, and
rounds P and dS to the input type before they become a product's operand.
Causal items go longest first; the blocks take them forth and back.

``plan_bwd``, ``walk_dq`` and ``walk_dkv`` (``tests/_flash_bwd_schedule.py``)
restate that layout; ``mirror_dq`` and ``mirror_dkv`` compute the gradients
along it.  The tests hold the walks to covering every live (query, key) pair
exactly once, and the mirrors to the JAX package's ``_pallas_bwd`` (both
Pallas kernels, interpret mode, one tile) and the port's plain backward.
Tolerances: in f32 the three differ in summation order and in exp2 against
exp (2e-5); in bf16, where P, dS and the outputs are rounded, by one bf16
rounding of the output (2e-2 of max(1, |want|), as on the card).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import importlib  # noqa: E402

import chip_smoke  # noqa: E402
from _flash_bwd_schedule import (BLOCK, MAX_STAGES, ROWS, SMEM_LIMIT,  # noqa: E402
                                 block_items, dkv_query_tiles, dq_key_tiles, item_tiles,
                                 items, plan_bwd, walk_dkv, walk_dq)
from tpu_air_torch.ops import flash_attention as tflash  # noqa: E402

jflash = importlib.import_module("tpu_air.ops.flash_attention")

NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LENGTHS = (1, 63, 64, 65, 127, 128, 129, 200, 257)
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round(x, dtype):
    return x.to(dtype).float()


def _rows(x, start, n, limit):
    """Rows [start, start + n) of the (L, ...) tensor x, zero past ``limit``
    (TMA's zero fill)."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype)
    stop = min(start + n, limit)
    if stop > start:
        out[:stop - start] = x[start:stop]
    return out


def _p(s, madd, lse2, scale, hidden, mask):
    """The kernels' p of a tile: hard zero of masked scores in natural
    units, then exp2 in log2 units; hidden pairs (causal, ragged) at 0."""
    if mask:
        x = s * np.float32(scale) + madd
        p = torch.where(x > 0.5 * NEG_INF, torch.exp2(x * LOG2E - lse2), torch.zeros_like(x))
    else:
        p = torch.exp2(s * (np.float32(scale) * LOG2E) - lse2)
    return p.masked_fill(hidden, 0.0)


def mirror_dq(q, k, v, do, mask, lse, delta, scale, causal, dtype, visits=None):
    """dq along ``walk_dq`` in the kernel's arithmetic: q/k/v/do (B, H, L, D)
    holding ``dtype`` values, mask (B, Lk) or None, lse and delta (B*H, Lq)
    f32.  Returns dq in dtype; counts each live (query, key) pair in
    ``visits`` (B*H, Lq, Lk)."""
    b_, h_, lq, d = q.shape
    lk = k.shape[2]
    pl = plan_bwd(d, b_, h_, lq, lk, mask is not None)
    q, k, v, do = (x.float() for x in (q, k, v, do))
    dq = torch.zeros(b_, h_, lq, d)
    for b, h, cq0, k0, edge in walk_dq(pl, h_, lq, lk, causal):
        bh = b * h_ + h
        qt, dot = _rows(q[b, h], cq0, ROWS, lq), _rows(do[b, h], cq0, ROWS, lq)
        kt, vt = _rows(k[b, h], k0, BLOCK, lk), _rows(v[b, h], k0, BLOCK, lk)
        rows = torch.arange(cq0, cq0 + ROWS)[:, None]
        keys = torch.arange(k0, k0 + BLOCK)[None, :]
        hidden = torch.zeros(ROWS, BLOCK, dtype=torch.bool)
        if edge:
            hidden = (rows >= lq) | (keys >= lk) | ((keys > rows) if causal else hidden)
        madd = 0.0
        if mask is not None:   # the staged mask row, 0 past lk: those keys mask too
            row = mask[bh // (b_ * h_ // mask.shape[0])]
            madd = ((1.0 - _rows(row, k0, BLOCK, lk)) * NEG_INF)[None, :]
        lse2 = _rows(lse[bh], cq0, ROWS, lq)[:, None] * LOG2E
        p = _p(qt @ kt.T, madd, lse2, scale, hidden, mask is not None)
        ds = p * (dot @ vt.T - _rows(delta[bh], cq0, ROWS, lq)[:, None])
        acc = _round(ds, dtype) @ kt                            # dS rounded to T
        n = min(ROWS, lq - cq0)
        dq[b, h, cq0:cq0 + n] += acc[:n]
        if visits is not None:
            live = ~hidden
            r, c = torch.nonzero(live[:n, :max(0, min(BLOCK, lk - k0))], as_tuple=True)
            visits[bh, cq0 + r, k0 + c] += 1
    return (dq * np.float32(scale)).to(dtype)


def mirror_dkv(q, k, v, do, mask, lse, delta, scale, causal, dtype, visits=None):
    """dk and dv along ``walk_dkv`` in the kernel's arithmetic (S^T = K Q^T
    per 64-key consumer and 64-query tile); arguments as ``mirror_dq``."""
    b_, h_, lq, d = q.shape
    lk = k.shape[2]
    pl = plan_bwd(d, b_, h_, lq, lk, mask is not None, dkv=True)
    q, k, v, do = (x.float() for x in (q, k, v, do))
    dk = torch.zeros(b_, h_, lk, d)
    dv = torch.zeros(b_, h_, lk, d)
    for b, h, ck0, qs, edge in walk_dkv(pl, h_, lq, lk, causal):
        bh = b * h_ + h
        kt, vt = _rows(k[b, h], ck0, ROWS, lk), _rows(v[b, h], ck0, ROWS, lk)
        qt, dot = _rows(q[b, h], qs, BLOCK, lq), _rows(do[b, h], qs, BLOCK, lq)
        keys = torch.arange(ck0, ck0 + ROWS)[:, None]
        queries = torch.arange(qs, qs + BLOCK)[None, :]
        hidden = torch.zeros(ROWS, BLOCK, dtype=torch.bool)
        if edge:
            hidden = (queries >= lq) | (keys >= lk) | ((keys > queries) if causal else hidden)
        madd = 0.0
        if mask is not None:   # read per key, 0 past lk
            row = mask[bh // (b_ * h_ // mask.shape[0])]
            madd = _rows((1.0 - row) * NEG_INF, ck0, ROWS, lk)[:, None]
        lse2 = _rows(lse[bh], qs, BLOCK, lq)[None, :] * LOG2E   # the staged columns
        p = _p(kt @ qt.T, madd, lse2, scale, hidden, mask is not None)
        ds = p * (vt @ dot.T - _rows(delta[bh], qs, BLOCK, lq)[None, :])
        n = min(ROWS, lk - ck0)
        dv[b, h, ck0:ck0 + n] += (_round(p, dtype) @ dot)[:n]    # P rounded to T
        dk[b, h, ck0:ck0 + n] += (_round(ds, dtype) @ qt)[:n]   # dS rounded to T
        if visits is not None:
            r, c = torch.nonzero(~hidden[:n, :max(0, min(BLOCK, lq - qs))], as_tuple=True)
            visits[bh, qs + c, ck0 + r] += 1
    return (dk * np.float32(scale)).to(dtype), dv.to(dtype)


def _live(lq, lk, causal):
    want = np.ones((lq, lk), np.int64)
    return np.tril(want) if causal else want


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("dkv", [False, True])
def test_plan_fits_the_block(d, mask, dkv):
    """Every head dim, with and without a key mask, both kernels: two or
    more stages of 64-row tiles within 227 KB, each on 1024 bytes; at D =
    128 four stages (dq 197,760 B without a mask, dk/dv 201,856 B)."""
    for batch, heads, L in ((1, 8, 8192), (3, 2, 200), (64, 12, 512)):
        pl = plan_bwd(d, batch, heads, L, L, mask, dkv)
        assert 2 <= pl["stages"] <= MAX_STAGES
        assert pl["smem_bytes"] <= SMEM_LIMIT and pl["stage_bytes"] % 1024 == 0
        assert pl["stage_bytes"] >= 2 * BLOCK * max(d, 64) * 2
        assert pl["tiles"] == -(-L // (2 * ROWS)) and pl["units"] == batch * heads
    if d == 128:
        assert (pl["stages"], pl["smem_bytes"]) == (4, 201856 if dkv else
                                                    (201856 if mask else 197760))


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dkv", [False, True])
def test_walk_covers_each_live_pair_once(L, d, dkv):
    """Causal or not, lq = lk and lq != lk: every (query, key) pair a query
    may see (key < Lk, query < Lq, key <= query under causal) is computed on
    exactly one tile of one consumer; no tile is wholly past the diagonal;
    a tile that needs no elementwise mask holds only live pairs."""
    b, h = 2, 2
    for causal in (False, True):
        for lq, lk in ((L, L), (L, L + 37), (L + 37, L)):
            pl = plan_bwd(d, b, h, lq, lk, False, dkv)
            count = np.zeros((b * h, lq, lk), np.int64)
            walk = walk_dkv(pl, h, lq, lk, causal) if dkv else walk_dq(pl, h, lq, lk, causal)
            for bi, hi, r0, c0, edge in walk:
                rows = np.arange(r0, r0 + ROWS)[:, None]       # the consumer's rows
                cols = np.arange(c0, c0 + BLOCK)[None, :]      # the stage's rows
                queries, keys = (cols, rows) if dkv else (rows, cols)
                live = (queries < lq) & (keys < lk)
                if causal:
                    live = live & (keys <= queries)
                    assert live.any(), "a tile wholly past the diagonal was computed"
                if not edge:
                    assert live.all()
                qi, ki = np.broadcast_arrays(queries, keys)
                np.add.at(count[bi * h + hi], (qi[live], ki[live]), 1)
            np.testing.assert_array_equal(
                count, np.broadcast_to(_live(lq, lk, causal), count.shape))


@pytest.mark.parametrize("dkv", [False, True])
def test_causal_items_go_longest_first(dkv):
    """Under causal masking the items come in non-increasing order of the
    tiles their consumers compute (dq: the last query rows first, dk/dv: the
    first keys); causal or not, every item is visited once."""
    b, h, L = 3, 4, 1000
    pl = plan_bwd(64, b, h, L, L, False, dkv)
    order = list(items(pl, True))
    assert sorted(order) == sorted(items(pl, False))
    assert len(set(order)) == pl["units"] * pl["tiles"]
    work = [item_tiles(pl, L, L, True, r0) for _, r0 in order]
    assert work == sorted(work, reverse=True)
    assert order[0][1] == (0 if dkv else (pl["tiles"] - 1) * 2 * ROWS)


@pytest.mark.parametrize("dkv", [False, True])
@pytest.mark.parametrize("shape", [(1, 8, 8192), (2, 12, 2048), (3, 2, 200)])
def test_blocks_share_the_items_evenly(dkv, shape):
    """One block an SM (132 on an H100) walks the items: each item goes to
    exactly one block, and under causal masking the forth-and-back rounds
    keep the most loaded block within one item of the mean; at the LM shape
    (B*H 8, L 8192) within 1% (505 tiles against a mean of 500.4; round
    robin in one direction gives its busiest block 25% over the mean)."""
    b, h, L = shape
    pl = plan_bwd(128, b, h, L, L, False, dkv)
    order = list(items(pl, True))
    blocks = min(132, len(order))
    mine = block_items(len(order), blocks)
    assert sorted(w for ws in mine for w in ws) == list(range(len(order)))
    tiles = [item_tiles(pl, L, L, True, r0) for _, r0 in order]
    work = [sum(tiles[w] for w in ws) for ws in mine]
    assert max(work) <= np.mean(work) + max(tiles)
    one_way = [sum(tiles[w::blocks]) for w in range(blocks)]
    assert max(work) <= max(one_way)
    if L == 8192:
        assert max(work) <= 1.01 * np.mean(work) < 1.2 * np.mean(work) < max(one_way)


def test_tile_counts_at_the_lm_shape():
    """At B*H 8, L 8192, causal: the 64-row consumers of dq compute 8 x 128
    x 129 / 2 = 66,048 key tiles of 64 keys, and those of dk/dv as many
    query tiles: 8 x 8256 x 4096 pairs, 0.8% above the 8 x 8192 x 8193 / 2
    live ones (the diagonal tiles' hidden half)."""
    L = 8192
    for dkv in (False, True):
        pl = plan_bwd(128, 1, 8, L, L, False, dkv)
        total = sum(item_tiles(pl, L, L, True, r0) for _, r0 in items(pl, True))
        n = L // 64
        assert total == 8 * n * (n + 1) // 2
    assert dq_key_tiles(L, L, True, 0) == 1 and dkv_query_tiles(L, True, 0) == (0, n)


def _inputs(b, h, L, d, seed, dtype=torch.float32, lk=None):
    """q, k, v, do (B, H, L, D) in dtype; a key mask with one full, ragged
    rows and the last fully masked; a nonzero lse cotangent."""
    lk = L if lk is None else lk
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, lk, d)).astype(np.float32) for _ in range(2))
    lens = np.array([lk] + [max(1, lk - 37)] * (b - 2) + [0])
    mask = (np.arange(lk)[None] < lens[:, None]).astype(np.float32)
    glse = rng.standard_normal((b * h, L)).astype(np.float32)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    return q, k, v, do, torch.from_numpy(mask), torch.from_numpy(glse)


def _saved(q, k, v, do, mask, glse, scale, causal):
    """The forward's (out, lse) from the plain version, and delta."""
    b, h, L, d = q.shape
    lk = k.shape[2]
    out, lse = tflash.flash_attention_reference(
        q.reshape(b * h, L, d), k.reshape(b * h, lk, d), v.reshape(b * h, lk, d), None, mask,
        scale, causal)
    delta = (do.reshape(b * h, L, d).float() * out.float()).sum(-1) - glse
    return out, lse, delta


def _pallas(q, k, v, do, mask, out, lse, glse, scale, causal):
    b, h, L, d = q.shape
    lk = k.shape[2]
    jt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32

    def j(x, n):
        return jnp.asarray(x.float().numpy().reshape(b * h, n, d)).astype(jt)

    addmask = None if mask is None else (1.0 - jnp.asarray(mask.numpy())) * jflash._NEG_INF
    got = jflash._pallas_bwd(j(q, L), j(k, lk), j(v, lk), addmask,
                             jnp.asarray(out.float().numpy()).astype(jt), jnp.asarray(lse.numpy()),
                             j(do, L), jnp.asarray(glse.numpy()), scale, causal, 512, 512, True)
    return [torch.from_numpy(np.array(g, np.float32)) for g in got]


def _reference(q, k, v, do, mask, out, lse, glse, scale, causal):
    b, h, L, d = q.shape
    lk = k.shape[2]
    return tflash.flash_attention_backward_reference(
        q.reshape(b * h, L, d), k.reshape(b * h, lk, d), v.reshape(b * h, lk, d), mask, out,
        lse, do.reshape(b * h, L, d), glse, scale, causal)


def _mirrors(q, k, v, do, mask, lse, delta, scale, causal, dtype, visits=None):
    dq = mirror_dq(q, k, v, do, mask, lse, delta, scale, causal, dtype,
                   None if visits is None else visits[0])
    dk, dv = mirror_dkv(q, k, v, do, mask, lse, delta, scale, causal, dtype,
                        None if visits is None else visits[1])
    b, h = q.shape[:2]
    return [g.reshape(b * h, g.shape[2], g.shape[3]) for g in (dq, dk, dv)]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("with_mask", [False, True])
def test_mirror_matches_pallas_and_reference(L, with_mask):
    """f32, D 16, causal and not, with a nonzero lse cotangent: the mirrors'
    dq, dk and dv against ``_pallas_bwd`` and the plain backward (2e-5),
    every live pair computed once by each kernel; the fully masked batch
    row's dq and its keys' dk and dv are exactly 0."""
    b, h, d = 3, 2, 16
    q, k, v, do, mask, glse = _inputs(b, h, L, d, seed=L + 7 * with_mask)
    mask = mask if with_mask else None
    scale = d ** -0.5
    for causal in (False, True):
        out, lse, delta = _saved(q, k, v, do, mask, glse, scale, causal)
        visits = [torch.zeros(b * h, L, L, dtype=torch.long) for _ in range(2)]
        got = _mirrors(q, k, v, do, mask, lse, delta, scale, causal, torch.float32, visits)
        for count in visits:
            np.testing.assert_array_equal(count.numpy(),
                                          np.broadcast_to(_live(L, L, causal), count.shape))
        want = _reference(q, k, v, do, mask, out, lse, glse, scale, causal)
        pal = _pallas(q, k, v, do, mask, out, lse, glse, scale, causal)
        for name, g, w, p in zip(("dq", "dk", "dv"), got, want, pal):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=ATOL, err_msg=name)
            np.testing.assert_allclose(g.numpy(), p.numpy(), atol=ATOL, rtol=ATOL, err_msg=name)
            if mask is not None:
                assert g[-h:].abs().max().item() == 0.0, name   # the fully masked batch row
                assert g[:-h].abs().max().item() > 0.0, name


@pytest.mark.parametrize("L", [65, 200])
@pytest.mark.parametrize("d", [32, 128])
def test_mirror_rounds_p_and_ds_to_bf16_like_pallas(L, d):
    """bf16, a key mask with a fully masked row, causal or not: the mirrors
    round P and dS to bf16 before dV += P^T dO, dQ += dS K and dK += dS^T Q
    as the Pallas kernels do; against ``_pallas_bwd`` and the plain
    backward within one bf16 rounding of the output (2e-2 of max(1,
    |want|)), the fully masked row's gradients exactly 0."""
    b, h = 3, 2
    q, k, v, do, mask, glse = _inputs(b, h, L, d, seed=L + d, dtype=torch.bfloat16)
    scale = d ** -0.5
    for causal in (False, True):
        out, lse, delta = _saved(q, k, v, do, mask, glse, scale, causal)
        got = _mirrors(q, k, v, do, mask, lse, delta, scale, causal, torch.bfloat16)
        want = _reference(q, k, v, do, mask, out, lse, glse, scale, causal)
        pal = _pallas(q, k, v, do, mask, out, lse, glse, scale, causal)
        for name, g, w, p in zip(("dq", "dk", "dv"), got, want, pal):
            assert g.dtype == torch.bfloat16
            for ref in (w.float(), p):
                err = ((g.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
                assert err < 2e-2, (name, err)
            assert g[-h:].abs().max().item() == 0.0, name


def test_mirror_ragged_lengths_lq_ne_lk():
    """lq != lk (f32, key mask, not causal; and causal, where the keys past
    lq are seen by no query and get dk = dv = 0): the mirrors against the
    plain backward (2e-5)."""
    b, h, d, lq = 3, 2, 16, 70
    for lk, causal in ((133, False), (133, True), (41, False), (41, True)):
        q, k, v, do, mask, glse = _inputs(b, h, lq, d, seed=lk, lk=lk)
        out, lse, delta = _saved(q, k, v, do, mask, glse, 0.3, causal)
        got = _mirrors(q, k, v, do, mask, lse, delta, 0.3, causal, torch.float32)
        want = _reference(q, k, v, do, mask, out, lse, glse, 0.3, causal)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=ATOL)
        if causal and lk > lq:
            assert got[1][:, lq:].abs().max().item() == 0.0 == got[2][:, lq:].abs().max().item()


# cuobjdump -sass names of the backward's kernels (anonymous namespace,
# mangled as the build prints them)
_BWD = ("_ZN55_GLOBAL__N__9e2b4c1a_25_flash_attention_bwd_cu_5d1e2a7f{n}{kind}I{ty}Li{d}EEEv"
        "14CUtensorMap_stS2_S2_S2_NS_9BwdParamsE")
_OLD_MMA = ("_ZN55_GLOBAL__N__9e2b4c1a_25_flash_attention_bwd_cu_5d1e2a7f23flash_bwd_dq_mma_kernel"
            "I13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_S6_PS2_NS_7StridesES8_S8_S8_S8_iiiiif")
_BODY = {"HGMMA": "        /*0a40*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], "
                  "RZ, !UPT ;\n",
         "HMMA": "        /*0b10*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"}


def _bwd_sass(drop=None, extra=()):
    text = "\n\tcode for sm_90a\n"
    for kind in ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"):
        for ty in ("13__nv_bfloat16", "6__half"):
            for d in (16, 32, 64, 128):
                if (kind, ty, d) == drop:
                    continue
                name = _BWD.format(n=len(kind), kind=kind, ty=ty, d=d)
                text += f"\t\tFunction : {name}\n{_BODY['HGMMA']}"
    for name, body in extra:
        text += f"\t\tFunction : {name}\n{_BODY[body]}"
    return text


def test_build_check_requires_every_backward_wgmma_instance():
    """The build phase's check of ``flash_attention_bwd.cu``: a bf16 and an
    f16 ``flash_bwd_{dq,dkv}_wgmma_kernel`` for every head dim, each with
    HGMMA and no spill; a missing instance, a spill or a leftover
    ``mma.sync`` kernel fails; the ``[lm]`` profile finds the kernels by
    those names."""
    counts = chip_smoke.mma_counts(_bwd_sass())
    assert len(counts) == 16
    assert counts["flash_bwd_dkv_wgmma_kernel<f16,128>"] == {"HMMA": 0, "HGMMA": 1}
    chip_smoke.check_tensor_core_kernels("flash_attention_bwd", counts, {fn: 0 for fn in counts})
    with pytest.raises(AssertionError, match="spill"):
        chip_smoke.check_tensor_core_kernels("flash_attention_bwd", counts,
                                             {"flash_bwd_dq_wgmma_kernel<bf16,128>": 16})
    for drop in (("flash_bwd_dq_wgmma_kernel", "6__half", 64),
                 ("flash_bwd_dkv_wgmma_kernel", "13__nv_bfloat16", 128)):
        missing = chip_smoke.mma_counts(_bwd_sass(drop=drop))
        with pytest.raises(AssertionError, match=drop[0]):
            chip_smoke.check_tensor_core_kernels("flash_attention_bwd", missing, {})
    old = chip_smoke.mma_counts(_bwd_sass(extra=[(_OLD_MMA, "HMMA")]))
    with pytest.raises(AssertionError, match="flash_bwd_dq_mma_kernel"):
        chip_smoke.check_tensor_core_kernels("flash_attention_bwd", old, {})
    for name, kernel in chip_smoke.LM_PROFILED_KERNELS:
        assert any(kernel in fn for fn in counts) == name.startswith("flash_attention_bwd")
