"""The decode kernel's schedule, mirrored in torch, on the CPU.

``csrc/decode_attention.cu`` runs every call, f32, bf16 or f16 queries over
slabs of their own type or int8, as one block per (row, group of heads, chunk)
in a thread-block cluster per row: the row's stages of 32 positions are
dealt to the cluster's blocks in turn, each stage's units of 4 positions to
a block's eight warps, and every warp copies its own units into its own ring
slots, one bulk copy a position and operand.  A block reads K/V only from its first live key to its last (masked
keys inside weigh 0); a block with none reads nothing when the row has a
live key, and everything (mean(V)) when it has none.  The warps' and then
the cluster's (m, den, acc) states merge in a fixed order.

``plan``, ``walk`` and ``mirror`` (``tests/_decode_schedule.py``) restate
that layout and compute the output along it.  The tests hold the walk to
its rules at the full W3, LM-engine and ``chip_smoke.SPLIT_CASES`` shapes
(plan only) and the mirror to the port's plain version and to the JAX
package's ``decode_attention`` (its Pallas kernel in interpret mode) and
``decode_attention_reference``, on f32 slabs and on int8 slabs with both
scale kinds.  Tolerances: in f32 the three differ in summation order
(2e-5; int8 slabs hold integers exactly in f32, and their scales multiply
once in every version); on bf16 slabs, or under a bf16 query, the kernel
computes in f32 from the rounded values and rounds the output once (2e-2
of max(1, |want|), as on the card).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import importlib  # noqa: E402

import chip_smoke  # noqa: E402
from _decode_schedule import (MAX_CLUSTER, SMEM_LIMIT, STAGE_POS, UNIT_POS, WARPS,  # noqa: E402
                              block_positions, copies, mirror, plan, walk)
from tpu_air_torch.ops import decode_attention as tdec  # noqa: E402

jdec = importlib.import_module("tpu_air.ops.decode_attention")

SMS = 132            # an H100 SXM's SMs
FLOOR = tdec.MASK_FLOOR
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefix_masks(rng, b, L, lo, hi, all_pad=True):
    """Rows live from 0 to a length drawn in [lo, hi), one at full length
    and (all_pad) one all-pad row, as the W3 prompts' and the LM engine's
    masks are."""
    lens = rng.integers(lo, hi, b)
    lens[0] = L
    if all_pad:
        lens[-1] = 0
    return np.arange(L)[None] < lens[:, None]


def _masks(name, b, L, rng):
    if name == "prefix":
        return _prefix_masks(rng, b, L, max(1, L // 8), L + 1)
    if name == "lm_engine":          # [lm serve] (f): live keys 0..pos, one row at 0
        pos = rng.integers(L // 16, L, b)
        pos[0] = 0
        return np.arange(L)[None] <= pos[:, None]
    if name == "holes":              # live from mid-stage to mid-stage, holes inside
        m = np.zeros((b, L), bool)
        for i in range(b):
            a, z = sorted(rng.integers(0, L, 2))
            m[i, a:z + 1] = rng.random(z + 1 - a) < 0.7
        m[0] = False                 # an all-pad row
        return m
    if name == "one_stage":          # live keys in one stage only
        m = np.zeros((b, L), bool)
        m[:, min(L - 1, 2 * STAGE_POS + 3):min(L, 2 * STAGE_POS + 9)] = True
        return m
    if name == "random":
        return np.random.default_rng(L).random((b, L)) < 0.3
    return None                      # "none": no mask (the self step's bias)


# (b, h, d, L, kind) at the main paths' full shapes and chip_smoke's split cases
FULL_SHAPES = [(64, 12, 64, 512, "prefix"), (64, 12, 64, 129, "none"),       # W3 cross, self
               (16, 8, 128, 1024, "lm_engine"),                              # the LM engine
               (8, 12, 64, 512, "prefix"), (8, 12, 64, 33, "none"),          # W1 generate, serve
               (8, 12, 64, 65, "none"), (8, 12, 64, 4096, "prefix")]         # window engine, split
FULL_SHAPES += [(b, 12, 64, L, {"cross": "prefix", "self": "none"}.get(kind, kind))
                for b, L, kind in chip_smoke.SPLIT_CASES if not kind.startswith("int8")]


def _chunk(b, h, d, L, masked=True, dtype=torch.bfloat16):
    return tdec.plan_chunk(b, h, d, L, dtype, SMS, masked)


@pytest.mark.parametrize("b,h,d,L,kind", FULL_SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_plan_fits_and_clusters_divide_the_grid(b, h, d, L, kind, with_bias):
    """The layout fits 227 KB of shared memory, its cluster is at most 8
    blocks and divides the grid's chunk dimension, every chunk holds whole
    stages (or is the whole row), and a block's group of heads fills one
    warp load (4 of T5's heads of 64, 2 of the LM's of 128)."""
    chunk = _chunk(b, h, d, L, kind != "none")
    pl = plan(b, h, d, L, chunk, SMS, bias=with_bias, mask=kind != "none")
    assert pl["smem"] <= SMEM_LIMIT
    assert 1 <= pl["cluster"] <= MAX_CLUSTER and pl["grid"][2] % pl["cluster"] == 0
    assert chunk == L or chunk % STAGE_POS == 0
    assert (pl["cluster"] - 1) * chunk < L                    # never an empty chunk
    assert pl["group"] * d == 256 and h % pl["group"] == 0
    assert 1 <= pl["slots"] <= 8 and pl["unit_bytes"] % 128 == 0


@pytest.mark.parametrize("h,d", [(1, 16), (3, 16), (3, 128), (16, 128), (12, 64), (5, 64)])
def test_plan_groups_heads_that_fit_one_load(h, d):
    """A block reads the largest group of heads that divides h and whose
    slices of a position fit one warp load of 256 elements, and its plan
    fits shared memory with a bias and a mask."""
    pl = plan(4, h, d, 300, 32, SMS, bias=True, mask=True)
    g = pl["group"]
    assert h % g == 0 and g * d <= 256
    assert all(g2 * d > 256 or h % g2 for g2 in range(g + 1, h + 1))
    assert pl["smem"] <= SMEM_LIMIT


# the slab kinds beside bf16/f16: (slab, scale kind), per-position scales
# with a bias (the T5 self step's three aux rows)
SLABS = [("f32", None), ("int8", "pos"), ("int8", "chan")]
ELEM = {"f32": 4, "int8": 1}
SLAB_DTYPE = {"f32": torch.float32, "int8": torch.int8}


@pytest.mark.parametrize("b,h,d,L,kind", FULL_SHAPES)
@pytest.mark.parametrize("slab,scale", SLABS)
def test_plan_fits_every_slab_type(b, h, d, L, kind, slab, scale):
    """f32 and int8 slabs take the same plan at their own element size: a
    group of heads whose slices of a position fill at most one warp load of
    512 bytes (T5's heads of 64: 2 in f32, 6 in int8; the LM's of 128: 1 in
    f32), the split rule's chunk over those groups, at most 8 chunks, and
    the bias and per-position scale rows beside each unit within 227 KB."""
    masked = kind != "none"
    chunk = _chunk(b, h, d, L, masked, SLAB_DTYPE[slab])
    pos = scale == "pos"
    pl = plan(b, h, d, L, chunk, SMS, bias=not masked, mask=masked, elem=ELEM[slab],
              k_pos=pos, v_pos=pos)
    g = pl["group"]
    assert pl["smem"] <= SMEM_LIMIT and 1 <= pl["cluster"] <= MAX_CLUSTER
    assert chunk == L or chunk % STAGE_POS == 0
    assert (pl["cluster"] - 1) * chunk < L
    assert h % g == 0 and pl["span_bytes"] == g * d * ELEM[slab] <= 512
    assert all(g2 * d * ELEM[slab] > 512 or h % g2 for g2 in range(g + 1, h + 1))
    assert pl["aux_rows"] == int(not masked) + 2 * int(pos)
    assert 2 <= pl["slots"] or pl["slots"] == -(-chunk // STAGE_POS)
    if (h, d) == (12, 64):
        assert g == {"f32": 2, "int8": 6}[slab]


def test_int8_ring_keeps_the_bf16_bytes_in_flight():
    """At the W3 cross step (b 64, L 512, 12 heads of 64, key mask) the int8
    ring's slots an SM hold at least the bytes the bf16 ring's do: its
    group spans are 384 bytes against 512, and it takes more slots."""
    b, h, d, L = 64, 12, 64, 512

    def in_flight(dtype, elem):
        pl = plan(b, h, d, L, _chunk(b, h, d, L, True, dtype), SMS, mask=True, elem=elem)
        blocks = pl["grid"][0] * pl["grid"][1] * pl["grid"][2]
        per_sm = min(2, -(-blocks // SMS))
        return per_sm * WARPS * pl["slots"] * pl["unit_bytes"], pl

    int8_bytes, int8_pl = in_flight(torch.int8, 1)
    bf16_bytes, _ = in_flight(torch.bfloat16, 2)
    assert int8_pl["span_bytes"] == 384 and int8_pl["cluster"] == 2
    assert int8_bytes >= bf16_bytes


def _check_walk(L, nrank, live):
    blocks = walk(L, nrank, None if live is None else list(live))
    seen = np.zeros(L, int)
    row_any = live is not None and bool(live.any())
    for r, blk in blocks.items():
        own = set(block_positions(L, nrank, r))
        read = [p for w in range(WARPS) for _, rd in blk["units"][w] for p in rd]
        assert set(read) <= own                               # a block reads its own positions
        for p in read:
            seen[p] += 1
        if live is None or not row_any:
            assert sorted(read) == sorted(own)                # no mask / all-pad: everything
            continue
        live_own = [p for p in own if live[p]]
        if not live_own:
            assert read == [] and blk["hi"] <= blk["lo"]      # skipped: reads nothing
            continue
        assert min(read) == min(live_own) and max(read) == max(live_own)
        assert blk["drop"]                                    # masked keys between weigh 0
    if live is None or not row_any:
        assert (seen == 1).all()                              # an all-pad row reads all
    else:
        assert (seen[live] == 1).all()                        # every live key exactly once
        assert (seen <= 1).all()
    return blocks


@pytest.mark.parametrize("b,h,d,L,kind", FULL_SHAPES)
def test_walk_reads_every_live_key_once(b, h, d, L, kind):
    """At the full shapes, under the main paths' masks: each block reads
    only its own positions, from its first live key to its last; every
    live key is read exactly once; a block without one reads nothing when
    its row has one; an all-pad row, and a row without a mask, is read
    whole, once."""
    rng = np.random.default_rng(b * L)
    nrank = plan(b, h, d, L, _chunk(b, h, d, L, kind != "none"), SMS)["cluster"]
    masks = _masks(kind, b, L, rng)
    for row in range(b if masks is not None else 1):
        _check_walk(L, nrank, None if masks is None else masks[row])


@pytest.mark.parametrize("kind", ["holes", "one_stage", "random"])
@pytest.mark.parametrize("L", [1, 31, 32, 33, 63, 100, 257, 1000])
@pytest.mark.parametrize("nrank", [1, 2, 3, 5, 8])
def test_walk_rules_at_stage_edges(kind, L, nrank):
    """The same rules at lengths around the 32-position stages and 4-position
    units, cluster sizes 1 to 8 (as many as the row has stages), live
    ranges starting and ending mid-stage with holes, one live stage, and
    scattered keys."""
    nrank = min(nrank, -(-L // STAGE_POS))
    masks = _masks(kind, 4, L, np.random.default_rng(L + nrank))
    for row in masks:
        _check_walk(L, nrank, row)


def test_prefix_masks_share_a_row_evenly():
    """Stages dealt in turn give every block of a cluster the same share of
    a prefix mask's live keys, within one stage: at the LM engine's shape
    no block is left with a row's whole live range while the others idle."""
    b, h, d, L = 16, 8, 128, 1024
    nrank = plan(b, h, d, L, _chunk(b, h, d, L), SMS)["cluster"]
    masks = _masks("lm_engine", b, L, np.random.default_rng(44))
    for row in masks:
        blocks = walk(L, nrank, list(row))
        counts = [sum(len(rd) for w in range(WARPS) for _, rd in blk["units"][w])
                  for blk in blocks.values()]
        if row.sum() >= nrank * STAGE_POS:
            assert max(counts) - min(counts) <= STAGE_POS


@pytest.mark.parametrize("nrank", [1, 3, 8])
def test_copies_are_one_a_position_read(nrank):
    """A block issues one bulk copy an operand for each position it reads,
    none for a position outside its live range, and each warp's units stay
    within UNIT_POS positions of the stage it owns."""
    L = 1000
    live = _masks("holes", 4, L, np.random.default_rng(3))[2]
    for blk in walk(L, nrank, list(live)).values():
        read = [p for w in range(WARPS) for _, rd in blk["units"][w] for p in rd]
        assert copies(blk) == read and len(set(read)) == len(read)
        for w in range(WARPS):
            for u0, rd in blk["units"][w]:
                assert u0 % STAGE_POS == w * UNIT_POS and all(u0 <= p < u0 + UNIT_POS for p in rd)


# -- the kernel's arithmetic along the walk ---------------------------------


def _inputs(b, L, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, L, h, d)).astype(np.float32)
    v = rng.standard_normal((b, L, h, d)).astype(np.float32)
    bias = (rng.standard_normal((h, L)) + np.where(np.arange(L) <= 2 * L // 3, 0.0, -1e9))
    return q, k, v, bias.astype(np.float32), rng


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kind", ["prefix", "holes", "one_stage", "none"])
def test_mirror_matches_the_references(cluster, kind):
    """The mirror along the kernel's walk, in clusters of 1 to 8 blocks of 4
    stages (the last chunk short: L no multiple of a chunk), against the
    port's plain version, the JAX package's Pallas kernel in interpret mode
    and its reference: prefix masks with an all-pad row (mean(V)), live
    ranges with holes, one live stage, and the self step's bias with a
    causal row and no mask."""
    b, h, d = 3, 4, 16
    L, chunk, block_k = (160, 160, 32) if cluster == 1 else (64 * cluster - 24, 64, 8)
    assert -(-L // chunk) == cluster
    q, k, v, bias, rng = _inputs(b, L, h, d, cluster)
    mask = _masks(kind, b, L, rng)
    kw_np = {"bias": bias} if mask is None else {"kv_mask": mask.astype(np.float32)}
    kw_t = {n: _t(a) for n, a in kw_np.items()}
    tq, tk, tv = _t(q)[:, 0], _t(k.reshape(b, L, -1)), _t(v.reshape(b, L, -1))
    got = mirror(tq, tk, tv, **kw_t, chunk=chunk)
    want = tdec.decode_attention_reference(tq, tk, tv, **kw_t)
    kw_j = {n: jnp.asarray(a) for n, a in kw_np.items()}
    want_kernel = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        block_k=block_k, interpret=True, **kw_j)
    want_ref = jdec.decode_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               **kw_j)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel)[:, 0], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref)[:, 0], atol=ATOL, rtol=ATOL)
    if mask is not None and not mask[-1].any():          # the all-pad row: mean(V)
        np.testing.assert_allclose(got.numpy()[-1], v[-1].mean(0), atol=ATOL)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_mirror_on_bf16_slabs_matches_within_one_rounding(d):
    """On bf16 slabs the kernel computes in f32 from the rounded values and
    rounds the output once: the mirror at every head dim, 4 heads (a group
    of up to 512 elements), the LM engine's prefix mask, held to the plain
    version on the same bf16 inputs at the card's bf16 tolerance."""
    b, L, h = 4, 100, 4
    q, k, v, _, rng = _inputs(b, L, h, d, d)
    mask = torch.from_numpy(_masks("lm_engine", b, L, rng).astype(np.float32))
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q[:, 0], k.reshape(b, L, -1),
                                                     v.reshape(b, L, -1)))
    chunk = _chunk(b, h, d, L)
    got = mirror(tq, tk, tv, kv_mask=mask, chunk=chunk)
    want = tdec.decode_attention_reference(tq, tk, tv, kv_mask=mask)
    assert got.dtype == torch.bfloat16
    assert chip_smoke.scaled_err(got, want) < chip_smoke.TOL[torch.bfloat16]


def _int8(rng, b, L, h, d, scale):
    """int8 K/V and their f32 scales, per-position ``[b, L, h]`` or
    per-channel ``[b, 1, h*d]`` (flat; the JAX package's 4-D forms beside)."""
    k8 = rng.integers(-127, 128, (b, L, h, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, L, h, d)).astype(np.int8)
    shape4 = (b, L, h, 1) if scale == "pos" else (b, 1, h, d)
    ks = rng.uniform(0.001, 0.02, shape4).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, shape4).astype(np.float32)
    flat = (b, L, h) if scale == "pos" else (b, 1, h * d)
    return k8, v8, ks, vs, flat


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kind", ["prefix", "holes", "one_stage", "none"])
@pytest.mark.parametrize("slab,scale", SLABS)
def test_mirror_on_int8_and_f32_slabs_matches_the_references(cluster, kind, slab, scale):
    """The mirror at the f32 and int8 instances' own groups (6 heads of 64:
    2 a block in f32, all 6 in int8), in clusters of 1 to 8 blocks, against
    the port's plain version, the JAX package's Pallas kernel in interpret
    mode (int8 slabs with ``k_scale``/``v_scale``) and its reference: prefix
    masks with an all-pad row (mean(V)), live ranges with holes, one live
    stage, and the T5 self step's bias with a causal row and no mask (with
    per-position scales: three aux rows a unit)."""
    b, h, d = 2, 6, 64
    L, chunk, block_k = (96, 96, 32) if cluster == 1 else (64 * cluster - 24, 64, 8)
    assert -(-L // chunk) == cluster
    q, k, v, bias, rng = _inputs(b, L, h, d, 100 + cluster)
    mask = _masks(kind, b, L, rng)
    kw_np = {"bias": bias} if mask is None else {"kv_mask": mask.astype(np.float32)}
    kw_t = {n: _t(a) for n, a in kw_np.items()}
    kw_j = {n: jnp.asarray(a) for n, a in kw_np.items()}
    if slab == "int8":
        k, v, ks, vs, flat = _int8(rng, b, L, h, d, scale)
        kw_t.update(k_scale=_t(ks.reshape(flat)), v_scale=_t(vs.reshape(flat)))
        kw_j.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tq, tk, tv = _t(q)[:, 0], _t(k.reshape(b, L, -1)), _t(v.reshape(b, L, -1))
    got = mirror(tq, tk, tv, **kw_t, chunk=chunk)
    want = tdec.decode_attention_reference(tq, tk, tv, **kw_t)
    want_kernel = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        block_k=block_k, interpret=True, **kw_j)
    want_ref = jdec.decode_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               **kw_j)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel)[:, 0], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref)[:, 0], atol=ATOL, rtol=ATOL)
    if mask is not None and not mask[-1].any():          # the all-pad row: mean(V)
        v_deq = v[-1].astype(np.float32)
        if slab == "int8":
            v_deq = v_deq * vs[-1]
        np.testing.assert_allclose(got.numpy()[-1], v_deq.mean(0), atol=ATOL)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("scale", ["pos", "chan"])
def test_mirror_on_int8_slabs_under_a_bf16_query_matches_within_one_rounding(d, scale):
    """int8 slabs under a bf16 query (the bf16 int8 generation's calls): the
    kernel unpacks the int8 values exactly, computes in f32 and rounds the
    output once, so the mirror at every head dim (4 heads: groups of 4 up to
    d 128, one warp load of 512 bytes) holds to the plain version on the
    same inputs at the card's bf16 tolerance, with the LM engine's mask
    and a bias."""
    b, L, h = 4, 100, 4
    q, _, _, bias, rng = _inputs(b, L, h, d, d + 7)
    k, v, ks, vs, flat = _int8(rng, b, L, h, d, scale)
    mask = torch.from_numpy(_masks("lm_engine", b, L, rng).astype(np.float32))
    tq = _t(q[:, 0]).to(torch.bfloat16)
    tk, tv = _t(k.reshape(b, L, -1)), _t(v.reshape(b, L, -1))
    kw = {"kv_mask": mask, "bias": _t(bias), "k_scale": _t(ks.reshape(flat)),
          "v_scale": _t(vs.reshape(flat))}
    chunk = _chunk(b, h, d, L, True, torch.int8)
    got = mirror(tq, tk, tv, **kw, chunk=chunk)
    want = tdec.decode_attention_reference(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    assert chip_smoke.scaled_err(got, want) < chip_smoke.TOL[torch.bfloat16]


def test_mirror_merge_is_in_a_fixed_order():
    """The warps' and ranks' states merge in a fixed order, so the mirror,
    like the kernel, gives bitwise-equal outputs on a second run, and the
    output does not depend on the cluster size beyond summation order."""
    b, L, h, d = 2, 300, 2, 32
    q, k, v, _, rng = _inputs(b, L, h, d, 9)
    mask = _t(_masks("prefix", b, L, rng).astype(np.float32))
    tq, tk, tv = _t(q)[:, 0], _t(k.reshape(b, L, -1)), _t(v.reshape(b, L, -1))
    first = mirror(tq, tk, tv, kv_mask=mask, chunk=64)
    assert torch.equal(first, mirror(tq, tk, tv, kv_mask=mask, chunk=64))
    np.testing.assert_allclose(first.numpy(), mirror(tq, tk, tv, kv_mask=mask, chunk=L).numpy(),
                               atol=ATOL, rtol=ATOL)


# cuobjdump -sass excerpts of decode_ring_kernel instances (anonymous
# namespace, mangled names as the build prints them)
_RING = "_ZN52_GLOBAL__N__4c1d2e3f_19_decode_attention_cu_0a1b2c3d18decode_ring_kernelI{tys}Li{d}EEEvNS_10RingParamsE"
_TYPES = {("f32", "f32"): "ff", ("f32", "int8"): "fa", ("bf16", "bf16"): "13__nv_bfloat16S1_",
          ("bf16", "int8"): "13__nv_bfloat16a", ("f16", "f16"): "6__halfS1_",
          ("f16", "int8"): "6__halfa"}
_BODY = {"UBLKCP": "        /*0c40*/              @UP0 UBLKCP.S.G [UR8], [UR4], UR10 ;\n",
         "none": "        /*0010*/                   MOV R1, c[0x0][0x28] ;\n"}


def _ring_sass(body="UBLKCP", drop=None, extra=""):
    text = "\n\tcode for sm_90a\n"
    for pair, tys in _TYPES.items():
        for d in (16, 32, 64, 128):
            if (pair, d) != drop:
                text += (f"\t\tFunction : {_RING.format(tys=tys, d=d)}\n"
                         f"\t.headerflags\t@\"EF_CUDA_SM90\"\n{_BODY[body]}")
    return text + extra


def test_bulk_copy_check_on_canned_sass():
    """The build phase's count of bulk copies (UBLKCP) in ``cuobjdump -sass``
    output and its check: an instance of decode_ring_kernel for every query
    and slab type pair (f32, bf16 and f16 queries over slabs of their type
    or int8) and every head dim, each with the bulk copy and no spill; a
    missing instance, one compiled without the bulk copy, a spill, or a
    retired decode_kernel or decode_combine_kernel left in the library each
    fail."""
    counts = chip_smoke.bulk_copy_counts(_ring_sass())
    assert counts["decode_ring_kernel<bf16,bf16,64>"] == 1 and len(counts) == 24
    assert counts["decode_ring_kernel<f32,int8,16>"] == 1
    assert counts["decode_ring_kernel<f16,f16,128>"] == 1
    chip_smoke.check_bulk_copy_kernels("decode_attention", counts, {fn: 0 for fn in counts})
    with pytest.raises(AssertionError, match="spill"):
        chip_smoke.check_bulk_copy_kernels("decode_attention", counts,
                                           {"decode_ring_kernel<f32,int8,128>": 16})
    with pytest.raises(AssertionError, match="UBLKCP"):
        chip_smoke.check_bulk_copy_kernels(
            "decode_attention", chip_smoke.bulk_copy_counts(_ring_sass(body="none")), {})
    for drop in ((("f16", "f16"), 64), (("bf16", "int8"), 16), (("f32", "f32"), 128)):
        with pytest.raises(AssertionError, match="decode_ring_kernel"):
            chip_smoke.check_bulk_copy_kernels(
                "decode_attention", chip_smoke.bulk_copy_counts(_ring_sass(drop=drop)), {})
    old = ("\t\tFunction : _ZN52_GLOBAL__N__4c1d2e3f_19_decode_attention_cu_0a1b2c3d13decode_kernel"
           "IfaLi64EEEvPKT_PKT0_S6_PKfS8_S8_S8_PS2_Pfiiiii\n")
    with pytest.raises(AssertionError, match="retired"):
        chip_smoke.check_bulk_copy_kernels(
            "decode_attention", chip_smoke.bulk_copy_counts(_ring_sass(extra=old)), {})
    chip_smoke.check_bulk_copy_kernels("flash_attention", {}, {})   # no bulk-copy kernel there
