"""The bf16/f16 flash forward's schedule, mirrored in torch, on the CPU.

``csrc/flash_attention.cu`` runs the 16-bit forward as work items of one
block: a producer warpgroup feeds two consumer warpgroups of 64 query rows
each.  Where the batch shares the bias, the two consumers take one head's
rows of two batch elements (an odd batch leaves the last pair's second one
idle); else they take 128 rows of one (batch, head).  Each consumer walks
key tiles of ``block_k`` keys up to its causal diagonal, masks element by
element only on tiles that reach the diagonal or Lk, runs the online softmax
in log2 units and rounds P to the input type before ``O += P V``.  Causal
items go longest first.

``plan`` and ``walk`` (``tests/_flash_schedule.py``) restate that layout
(``plan_fwd`` and the kernel's item map); ``mirror_forward`` computes
attention along it.  The
tests hold the walk to covering every (row, live key) pair exactly once,
and the mirror to the JAX Pallas forward (interpret mode, one tile) and the
port's plain version.  Tolerances: in f32 the three differ in summation
order and in exp2 against exp (2e-5); in bf16, where P and the output are
rounded, by one bf16 rounding of the output (2e-2 of max(1, |want|), as on
the card).  ``staged_bytes`` models the bytes the walk stages from L2: its
bias figure is the one the kernel's note and PERF.md give for a W3 call.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import importlib  # noqa: E402

import chip_smoke  # noqa: E402
from _flash_schedule import (MAX_STAGES, ROWS, SMEM_LIMIT, block_items,  # noqa: E402
                             items, key_tiles, plan, staged_bytes, walk)
from tpu_air_torch.ops import flash_attention as tflash  # noqa: E402

jflash = importlib.import_module("tpu_air.ops.flash_attention")

NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
LENGTHS = (1, 63, 64, 65, 127, 128, 129, 200)
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round(x, dtype):
    return x.to(dtype).float()


def mirror_forward(q, k, v, bias, mask, scale, causal, dtype, visits=None):
    """Attention along the kernel's walk, in its arithmetic: q/k/v (B, H, L,
    D) holding ``dtype`` values, bias (1|H|B*H, Lq, Lk) f32, mask (B, Lk).
    Returns (out in dtype, lse f32 (B*H, Lq)); counts each finite score of a
    key < Lk in ``visits`` (B*H, Lq, Lk)."""
    b_, h_, lq, d = q.shape
    lk = k.shape[2]
    bias_n = 0 if bias is None else bias.shape[0]
    pl = plan(d, b_, h_, lq, lk, bias_n, mask is not None)
    bk = pl["block_k"]
    q, k, v = (x.float() for x in (q, k, v))
    out = torch.zeros(b_, h_, lq, d)
    lse = torch.zeros(b_ * h_, lq)
    add = bias is not None or mask is not None
    for b, h, row0, j, edge in walk(pl, b_, h_, lq, lk, causal):
        bh = b * h_ + h
        rows = torch.arange(row0, min(row0 + ROWS, lq))
        keys = torch.arange(j * bk, j * bk + bk)           # the tile, zero past lk
        inside = keys < lk
        kt = torch.zeros(bk, d)
        vt = torch.zeros(bk, d)
        kt[inside] = k[b, h, keys[inside]]
        vt[inside] = v[b, h, keys[inside]]
        s = q[b, h, rows] @ kt.T
        if add:
            x = s * np.float32(scale)
            if bias is not None:
                tile = torch.zeros(len(rows), bk)
                tile[:, inside] = bias[bh % bias_n][rows][:, keys[inside]]
                x = x + tile
            if mask is not None:
                m = torch.zeros(bk)
                m[inside] = mask[bh // (b_ * h_ // mask.shape[0]), keys[inside]]
                x = x + (1.0 - m) * NEG_INF
            x = x * LOG2E
        else:
            x = s * (np.float32(scale) * LOG2E)
        if edge:
            hidden = (keys[None, :] >= lk).expand(len(rows), bk)
            if causal:
                hidden = hidden | (keys[None, :] > rows[:, None])
            x = x.masked_fill(hidden, float("-inf"))
        if visits is not None:
            visits[bh, rows[:, None], keys[inside][None, :]] += torch.isfinite(x[:, inside]).long()
        if j == 0:
            m_run = torch.full((len(rows),), float(NEG_INF * LOG2E))
            l_run = torch.zeros(len(rows))
            o = torch.zeros(len(rows), d)
        mx = torch.maximum(m_run, x.max(1).values)
        alpha = torch.exp2(m_run - mx)
        p = torch.exp2(x - mx[:, None])
        l_run = l_run * alpha + p.sum(1)
        o = o * alpha[:, None] + _round(p, dtype) @ vt          # P rounded to T
        m_run = mx
        if j == key_tiles(pl, lq, lk, causal, row0) - 1:
            safe = torch.where(l_run == 0, torch.ones_like(l_run), l_run)
            out[b, h, rows] = o / safe[:, None]
            lse[bh, rows] = m_run * LN2 + torch.log(safe)
    return out.to(dtype), lse


def _inputs(b, h, L, d, bias_lead, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(3))
    n = {"1": 1, "H": h, "BH": b * h, None: 0}[bias_lead]
    bias = rng.standard_normal((n, L, L)).astype(np.float32) if n else None
    # one full row, one ragged, the last fully masked
    lens = np.array([L] + [max(1, L - 37)] * (b - 2) + [0])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    return q, k, v, None if bias is None else torch.from_numpy(bias), torch.from_numpy(mask)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bias", [None, "1", "H", "BH"])
@pytest.mark.parametrize("mask", [False, True])
def test_plan_fits_the_block(d, bias, mask):
    """Every head dim, bias lead and mask: two or more stages, within 227 KB,
    tiles on 1024 bytes; paired exactly where the batch shares the bias."""
    for batch, heads, L in ((1, 12, 512), (3, 12, 512), (64, 12, 512), (8, 8, 8192)):
        n = {"1": 1, "H": heads, "BH": batch * heads, None: 0}[bias]
        pl = plan(d, batch, heads, L, L, n, mask)
        assert 2 <= pl["stages"] <= MAX_STAGES
        assert pl["smem_bytes"] <= SMEM_LIMIT and pl["stage_bytes"] % 1024 == 0
        assert pl["paired"] == (n in (1, heads) and batch > 1)
        assert pl["block_k"] == (64 if d == 128 and n else 128)


@pytest.mark.parametrize("L", LENGTHS + (255, 257))
@pytest.mark.parametrize("bias", [None, "1", "H", "BH"])
@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("d", [16, 128])
def test_walk_covers_each_live_pair_once(L, bias, b, d):
    """Causal or not: every (row, key) a row may see (key < Lk, and key <=
    row under causal) is scored on exactly one tile, with no tile wholly
    past the diagonal; a tile that needs no elementwise mask holds only
    such pairs; and with lq != lk too."""
    h = 2
    for causal in (False, True):
        for lq, lk in ((L, L), (L, L + 37)) if not causal else ((L, L),):
            n = {"1": 1, "H": h, "BH": b * h, None: 0}[bias]
            pl = plan(d, b, h, lq, lk, n)
            count = np.zeros((b * h, lq, lk), np.int64)
            bk = pl["block_k"]
            for bi, hi, row0, j, edge in walk(pl, b, h, lq, lk, causal):
                rows = np.arange(row0, min(row0 + ROWS, lq))[:, None]
                keys = np.arange(j * bk, min(j * bk + bk, lk))[None, :]
                live = np.ones((rows.size, keys.size), bool)
                if causal:
                    live = keys <= rows
                    assert live.any(), "a tile wholly past the diagonal was computed"
                if not edge:
                    assert live.all() and j * bk + bk <= lk
                count[bi * h + hi, rows, keys] += live
            want = np.ones((lq, lk), np.int64)
            if causal:
                want = np.tril(want)
            np.testing.assert_array_equal(count, np.broadcast_to(want, count.shape))


@pytest.mark.parametrize("paired", [False, True])
def test_causal_items_go_longest_first(paired):
    """Under causal masking the items come in non-increasing order of the
    key tiles their consumers walk; both orders visit every item once."""
    b, h, L = 3, 4, 1000
    pl = plan(64, b, h, L, L, h if paired else 0)
    assert pl["paired"] == int(paired)
    order = list(items(pl, True))
    assert sorted(order) == sorted(items(pl, False))
    assert len(set(order)) == pl["units"] * pl["query_tiles"]
    rows = ROWS if paired else 2 * ROWS
    work = [key_tiles(pl, L, L, True, tile * rows + rows - ROWS) for tile, _ in order]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("shape", [(1, 8, 8192, 128, 0), (8, 12, 512, 64, 12),
                                   (64, 12, 512, 64, 12), (3, 2, 200, 16, 0)])
def test_blocks_share_the_items_evenly(shape):
    """One block an SM (132 on an H100) walks the items: each item goes to
    exactly one block, and under causal masking the forth-and-back rounds
    keep the most loaded block's key tiles within one item of the mean, at
    the LM shape within 1% (round robin in one direction gives its first
    block 158 tiles against a mean of 126)."""
    b, h, L, d, bias_n = shape
    pl = plan(d, b, h, L, L, bias_n)
    order = list(items(pl, True))
    blocks = min(132, len(order))
    mine = block_items(pl, blocks)
    assert sorted(w for ws in mine for w in ws) == list(range(len(order)))
    rows = ROWS if pl["paired"] else 2 * ROWS
    tiles = [key_tiles(pl, L, L, True, tile * rows + rows - ROWS) for tile, _ in order]
    work = [sum(tiles[w] for w in ws) for ws in mine]
    assert max(work) <= np.mean(work) + max(tiles)
    if L == 8192:
        assert max(work) <= 1.01 * np.mean(work)


# the timed shapes: (bias, K/V, Q) bytes staged a launch where the batch
# shares the bias, and the bias bytes where each (batch, head) has its own
STAGED = {(64, 12, 512, 64, False): (402_653_184, 805_306_368, 50_331_648, 805_306_368),
          (8, 12, 512, 64, False): (50_331_648, 100_663_296, 6_291_456, 100_663_296),
          (8, 12, 512, 64, True): (31_457_280, 62_914_560, 6_291_456, 62_914_560)}


@pytest.mark.parametrize("b, h, L, d, causal", list(STAGED) + [(3, 2, 200, 16, False),
                                                               (3, 2, 200, 128, True)])
def test_bias_stream_halves_where_the_batch_shares_it(b, h, L, d, causal):
    """A bias of its own for each (batch, head) is staged once a consumer:
    every (64, block_k) tile of the rows' live key tiles.  A bias the batch
    shares (lead 1 or H) is staged once a pair of batch elements; an odd
    batch stages its last one alone.  K/V and Q are staged per consumer
    either way.  At the W3 encoder shape (B 64, H 12, L 512) that is 402.7
    MB of the 805.3 MB bias reads a call, beside 805.3 MB of K/V and 50.3 MB
    of Q."""
    own_pl = plan(d, b, h, L, L, b * h, True)
    bk = own_pl["block_k"]
    per_bh = sum(key_tiles(own_pl, L, L, causal, r) for r in range(0, L, ROWS)) * ROWS * bk * 4
    own = staged_bytes(own_pl, b, h, L, L, d, causal)
    assert own["bias"] == b * h * per_bh
    for n in (1, h):
        shared = staged_bytes(plan(d, b, h, L, L, n, True), b, h, L, L, d, causal)
        assert shared["bias"] == (b + 1) // 2 * h * per_bh
        assert (shared["kv"], shared["q"]) == (own["kv"], own["q"])
        assert shared["q"] == b * h * L * d * 2
    want = STAGED.get((b, h, L, d, causal))
    if want:
        assert (shared["bias"], shared["kv"], shared["q"], own["bias"]) == want
    assert staged_bytes(plan(d, b, h, L, L), b, h, L, L, d, causal, bias=False)["bias"] == 0


def _pallas(q, k, v, bias, mask, scale, causal):
    b, h, L, d = q.shape
    flat = [jnp.asarray(x.float().numpy().reshape(b * h, -1, d)).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32) for x in (q, k, v)]
    out, lse = jflash.flash_attention_with_lse(
        *flat, None if bias is None else jnp.asarray(bias.numpy()),
        kv_mask=None if mask is None else jnp.asarray(mask.numpy()), scale=scale,
        causal=causal, block_q=512, block_k=512, interpret=True)
    return (torch.from_numpy(np.array(out, np.float32)).reshape(b, h, L, d),
            torch.from_numpy(np.array(lse)))


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("bias", ["1", "H", "BH"])
@pytest.mark.parametrize("b", [2, 3])
def test_mirror_matches_pallas_and_reference(L, bias, b):
    """f32, D 16, causal and not: the mirror's output and lse against the
    Pallas forward and the plain version on live rows (2e-5), every live
    (row, key) pair scored once; the fully masked batch row gives the plain
    version's mean of the visible V (the Pallas kernel's answer there
    depends on its tiles under causal)."""
    h, d = 2, 16
    q, k, v, bias_t, mask = _inputs(b, h, L, d, bias, seed=L + 10 * b)
    scale = d ** -0.5
    for causal in (False, True):
        visits = torch.zeros(b * h, L, L, dtype=torch.long)
        got, lse = mirror_forward(q, k, v, bias_t, mask, scale, causal, torch.float32, visits)
        want = np.tril(np.ones((L, L), np.int64)) if causal else np.ones((L, L), np.int64)
        live = torch.from_numpy(mask.numpy().astype(bool).repeat(h, 0).any(1))  # (B*H,)
        np.testing.assert_array_equal(visits.numpy(), np.broadcast_to(want, visits.shape))
        ref, ref_lse = tflash.flash_attention_reference(
            *(x.reshape(b * h, L, d) for x in (q, k, v)), bias_t, mask, scale, causal)
        pal, pal_lse = _pallas(q, k, v, bias_t, mask, scale, causal)
        got_f, pal_f = got.reshape(b * h, L, d), pal.reshape(b * h, L, d)
        np.testing.assert_allclose(got_f.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got_f[live].numpy(), pal_f[live].numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(lse[live].numpy(), ref_lse[live].numpy(), atol=1e-4, rtol=ATOL)
        np.testing.assert_allclose(lse[live].numpy(), pal_lse[live].numpy(), atol=1e-4, rtol=ATOL)
        vd = v[-1].double()                                   # the fully masked batch row
        mean_v = (vd.cumsum(1) / torch.arange(1, L + 1)[None, :, None] if causal
                  else vd.mean(1, keepdim=True).expand_as(vd))
        np.testing.assert_allclose(got[-1].numpy(), mean_v.numpy(), atol=ATOL)


@pytest.mark.parametrize("L", [63, 129, 257])
def test_mirror_without_bias_or_mask(L):
    """No bias and no key mask (the LM's call), where the scale and log2(e)
    are one factor: against the Pallas forward and the plain version
    (2e-5), causal or not, with the LM's 1/sqrt(D) scale."""
    b, h, d = 2, 2, 32
    q, k, v, _, _ = _inputs(b, h, L, d, None, seed=L)
    for causal in (False, True):
        visits = torch.zeros(b * h, L, L, dtype=torch.long)
        got, lse = mirror_forward(q, k, v, None, None, d ** -0.5, causal, torch.float32, visits)
        want = np.tril(np.ones((L, L), np.int64)) if causal else np.ones((L, L), np.int64)
        np.testing.assert_array_equal(visits.numpy(), np.broadcast_to(want, visits.shape))
        ref, ref_lse = tflash.flash_attention_reference(
            *(x.reshape(b * h, L, d) for x in (q, k, v)), None, None, d ** -0.5, causal)
        pal, pal_lse = _pallas(q, k, v, None, None, d ** -0.5, causal)
        for want_o, want_lse in ((ref, ref_lse), (pal.reshape(b * h, L, d), pal_lse)):
            np.testing.assert_allclose(got.reshape(b * h, L, d).numpy(), want_o.numpy(),
                                       atol=ATOL, rtol=ATOL)
            np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-4, rtol=ATOL)


@pytest.mark.parametrize("L", [65, 200])
def test_mirror_rounds_p_to_bf16_like_pallas(L):
    """bf16, a shared bias (paired consumers), odd batch: the mirror rounds P
    to bf16 before O += P V as the Pallas kernel does; both agree with the
    plain version within one bf16 rounding of the output."""
    b, h, d = 3, 2, 32
    q, k, v, bias_t, mask = _inputs(b, h, L, d, "H", seed=L, dtype=torch.bfloat16)
    for causal in (False, True):
        got, lse = mirror_forward(q, k, v, bias_t, mask, 1.0, causal, torch.bfloat16)
        pal, _ = _pallas(q, k, v, bias_t, mask, 1.0, causal)
        ref, ref_lse = tflash.flash_attention_reference(
            *(x.reshape(b * h, L, d) for x in (q, k, v)), bias_t, mask, 1.0, causal)
        live = torch.from_numpy(mask.numpy().astype(bool).repeat(h, 0).any(1))
        got_f = got.reshape(b * h, L, d).float()
        for want in (ref.float(), pal.reshape(b * h, L, d)):
            err = ((got_f[live] - want[live]).abs() / want[live].abs().clamp(min=1.0)).max()
            assert err.item() < 2e-2
        assert (lse[live] - ref_lse[live]).abs().max().item() < 1e-3


# cuobjdump -sass excerpts of one wgmma and one mma.sync kernel (anonymous
# namespace, mangled names as the build prints them)
_WG = "_ZN51_GLOBAL__N__f13cdd90_18_flash_attention_cu_2c13897922flash_fwd_wgmma_kernelI{ty}Li{d}ELi{bk}EEEv14CUtensorMap_stS2_S2_S2_NS_11WgmmaParamsE"
_MMA = "_ZN55_GLOBAL__N__9e2b4c1a_25_flash_attention_bwd_cu_5d1e2a7f23flash_bwd_dq_mma_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_S6_PS2_NS_7StridesES8_S8_S8_S8_iiiiif"
_BODY = {
    "HGMMA": ("        /*0a40*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;\n"
              "        /*0a50*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;\n"),
    "HMMA": "        /*0b10*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n",
    "none": "        /*0010*/                   MOV R1, c[0x0][0x28] ;\n",
}


def _sass(kernels):
    text = "\n\tcode for sm_90a\n"
    for name, body in kernels:
        text += f"\t\tFunction : {name}\n\t.headerflags\t@\"EF_CUDA_SM90\"\n{_BODY[body]}"
    return text


def _wgmma_instances(body="HGMMA", drop=None):
    out = []
    for ty in ("13__nv_bfloat16", "6__half"):
        for d in (16, 32, 64, 128):
            for bk in ((128, 64) if d == 128 else (128,)):
                if (ty, d) != drop:
                    out.append((_WG.format(ty=ty, d=d, bk=bk), body))
    return out


def test_tensor_core_counter_on_canned_sass():
    """The build phase's count of HGMMA (wgmma) and HMMA (mma.sync) in
    ``cuobjdump -sass`` output, and its checks: every flash forward
    instance, bf16 and f16 for each head dim, with HGMMA and no spill; a
    ``*_mma_kernel`` with HMMA; a missing instance, a wgmma kernel compiled
    without HGMMA or a spill each fail."""
    sass = _sass(_wgmma_instances() + [(_MMA, "HMMA")])
    counts = chip_smoke.mma_counts(sass)
    assert counts["flash_fwd_wgmma_kernel<bf16,64,128>"] == {"HMMA": 0, "HGMMA": 2}
    assert counts["flash_fwd_wgmma_kernel<f16,128,64>"] == {"HMMA": 0, "HGMMA": 2}
    assert counts["flash_bwd_dq_mma_kernel<bf16,64>"] == {"HMMA": 1, "HGMMA": 0}
    assert len(counts) == 11
    chip_smoke.check_tensor_core_kernels("flash_attention", counts, {fn: 0 for fn in counts})
    with pytest.raises(AssertionError, match="spill"):
        chip_smoke.check_tensor_core_kernels(
            "flash_attention", counts, {"flash_fwd_wgmma_kernel<f16,32,128>": 8})
    idle = chip_smoke.mma_counts(_sass(_wgmma_instances(body="none")))
    with pytest.raises(AssertionError, match="without"):
        chip_smoke.check_tensor_core_kernels("flash_attention", idle, {})
    for drop in (("6__half", 64), ("13__nv_bfloat16", 16)):
        missing = chip_smoke.mma_counts(_sass(_wgmma_instances(drop=drop)))
        with pytest.raises(AssertionError, match="flash_fwd_wgmma_kernel"):
            chip_smoke.check_tensor_core_kernels("flash_attention", missing, {})
    # an mma.sync kernel compiled without HMMA fails as before
    with pytest.raises(AssertionError, match="without"):
        chip_smoke.check_tensor_core_kernels(
            "flash_attention_bwd", chip_smoke.mma_counts(_sass([(_MMA, "none")])), {})
