"""Card tests of the port's CUDA kernels against their plain versions.

They need an NVIDIA GPU with nvcc and skip elsewhere.  Run them on the card
with ``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the
repo's conftest imports the JAX package, which the card machine may lack).

Tolerances, on |kernel - plain| / max(1, |plain|): the kernels and the plain
versions both compute in f32 from the same inputs and differ only in
summation order (f32: 1e-4); a bf16 output is one rounding of that f32
value, up to 2^-7 of it apart (bf16: 2e-2); an f16 one up to 2^-10 (f16:
5e-3, where P and dS are rounded to f16 inside the kernels as well).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
HALF = [torch.bfloat16, torch.float16]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _err(got, want):
    want = want.float()
    return ((got.float() - want).abs() / want.abs().clamp(min=1.0)).max().item()


def _t(a, dev, dtype):
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("case", ["bias_h_mask", "bias_bh", "bias_1_causal",
                                  "mask_causal", "plain_ragged"])
def test_flash_kernel_matches_plain(dev, dtype, d, case):
    from tpu_air_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, flash_attention_with_lse)

    rng = np.random.default_rng(d)
    b, h = 3, 4
    lq, lk = (200, 200) if case == "plain_ragged" else (96, 160)
    if case in ("bias_1_causal", "mask_causal"):
        lk = lq
    q = _t(rng.standard_normal((b, h, lq, d)), dev, dtype)
    k = _t(rng.standard_normal((b, h, lk, d)), dev, dtype)
    v = _t(rng.standard_normal((b, h, lk, d)), dev, dtype)
    bias = mask = None
    causal = case.endswith("causal")
    if case in ("bias_h_mask", "mask_causal"):
        if case == "bias_h_mask":
            bias = _t(rng.standard_normal((1, h, lq, lk)), dev, torch.float32)
        m = (np.arange(lk)[None] < np.array([lk, lk - 37, 0])[:, None])
        mask = _t(m, dev, torch.float32)          # padded tails, one empty row
    elif case == "bias_bh":
        bias = _t(rng.standard_normal((b, h, lq, lk)), dev, torch.float32)
    elif case == "bias_1_causal":
        bias = _t(rng.standard_normal((1, 1, lq, lk)), dev, torch.float32)
    before = flash_attention.launches
    out, lse = flash_attention_with_lse(q, k, v, bias, kv_mask=mask, scale=1.0,
                                        causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    b3 = None
    if bias is not None:
        b3 = bias[0] if bias.shape[0] == 1 else bias.reshape(b * h, lq, lk)
    flat = [t.reshape(b * h, -1, d) for t in (q, k, v)]
    want, want_lse = flash_attention_reference(*flat, b3, mask, 1.0, causal)
    got = out.reshape(b * h, lq, d).float()
    assert torch.isfinite(got).all()
    err = _err(got, want)
    assert err < TOL[dtype], err
    lse = lse.reshape(b * h, lq)
    live = want_lse.abs() < 1e20            # rows with at least one valid key
    assert (lse[~live] <= -1e29).all()
    assert (lse[live] - want_lse[live]).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("L", [129, 512, 4096])
@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("case", ["bias", "mask", "int8_pos", "int8_chan", "one_chunk"])
def test_decode_kernel_matches_plain(dev, dtype, d, L, b, case):
    """With h = 3 the kernel splits L into chunks at every b here (b*h
    blocks cannot fill the card).  The key masks: with b = 1 one all-pad
    row (mean(V), every chunk read); else full, half, one-key and all-pad
    rows, whose masked tails are whole chunks that are skipped; "one_chunk"
    leaves live keys only inside one chunk (and an all-pad fourth row)."""
    from tpu_air_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference, plan_chunk)

    rng = np.random.default_rng(L + d)
    h = 3
    q = _t(rng.standard_normal((b, 1, h, d)), dev, dtype)
    kw = {}
    if case.startswith("int8"):
        k = _t(rng.integers(-127, 128, (b, L, h * d)), dev, torch.int8)
        v = _t(rng.integers(-127, 128, (b, L, h * d)), dev, torch.int8)
        shape = (b, L, h) if case == "int8_pos" else (b, 1, h * d)
        kw["k_scale"] = _t(rng.uniform(0.001, 0.02, shape), dev, torch.float32)
        kw["v_scale"] = _t(rng.uniform(0.001, 0.02, shape), dev, torch.float32)
        kw["bias"] = _t(rng.standard_normal((h, L)), dev, torch.float32)
    else:
        k = _t(rng.standard_normal((b, L, h * d)), dev, dtype)
        v = _t(rng.standard_normal((b, L, h * d)), dev, dtype)
    if case in ("mask", "int8_pos", "int8_chan"):
        lens = [0] if b == 1 else [L, L // 2, 1, 0, 7, L - 1, 3, L // 3][:b]
        m = np.arange(L)[None] < np.array(lens)[:, None]
        kw["kv_mask"] = _t(m, dev, torch.float32)   # one fully-masked row
    if case == "one_chunk":
        c = plan_chunk(b, h, d, L, dtype,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
        live = (L - 1) // c * c                     # the last chunk's first key
        m = np.zeros((b, L), bool)
        m[:, live:live + 3] = True
        m[3:4] = False
        kw["kv_mask"] = _t(m, dev, torch.float32)
    if case == "bias":
        causal = np.where(np.arange(L) <= L // 3, 0.0, -1e9)
        kw["bias"] = _t(rng.standard_normal((h, L)) + causal, dev, torch.float32)
    before = decode_attention.launches
    got = decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_reference(q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    err = _err(got, want)
    assert err < TOL[dtype], err


def _ring_mask(b, L, chunk):
    """Rows of a key mask at the decode kernel's edges: full; live keys
    starting and ending mid-stage with masked holes inside; a few live keys
    past the first chunk's length, mid-stage (one block of the row's
    cluster holds them, the others skip); all-pad; a ragged tail."""
    m = np.zeros((b, L), bool)
    m[0] = True
    m[1 % b, 37:min(L, 3 * chunk + 45)] = True
    m[1 % b, 41:43] = False
    if b > 2:
        m[2, min(L - 1, chunk + 5):min(L, chunk + 40)] = True
    if b > 4:
        m[4, :L - 11] = True
    return m                               # row 3: all-pad


# the decode kernel's instances: (query type, slab kind); int8 slabs with
# per-position scales under a bf16 query, per-channel under an f32 one
RING_KINDS = [(torch.bfloat16, "same"), (torch.float16, "same"), (torch.float32, "same"),
              (torch.bfloat16, "int8_pos"), (torch.float32, "int8_chan")]


def _ring_slabs(rng, b, L, h, d, dev, dtype, slab):
    """q, k, v and the scales of one decode call: slabs in q's type, or int8
    with both scales of one kind."""
    q = _t(rng.standard_normal((b, 1, h, d)), dev, dtype)
    if slab == "same":
        return (q, _t(rng.standard_normal((b, L, h * d)), dev, dtype),
                _t(rng.standard_normal((b, L, h * d)), dev, dtype), {})
    k = _t(rng.integers(-127, 128, (b, L, h * d)), dev, torch.int8)
    v = _t(rng.integers(-127, 128, (b, L, h * d)), dev, torch.int8)
    shape = (b, L, h) if slab == "int8_pos" else (b, 1, h * d)
    return q, k, v, {"k_scale": _t(rng.uniform(0.001, 0.02, shape), dev, torch.float32),
                     "v_scale": _t(rng.uniform(0.001, 0.02, shape), dev, torch.float32)}


@pytest.mark.parametrize("dtype,slab", RING_KINDS)
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("case", ["mask", "bias"])
def test_decode_ring_kernel_cluster_sizes(dev, monkeypatch, dtype, slab, cluster, case):
    """Every instance with L = 1000 (no multiple of a stage or a chunk) in
    clusters of 1 to 8 blocks, each block walking several ring stages:
    rows whose live range starts and ends mid-stage, holes inside it, live
    keys in one block's stage only, an all-pad row; and a bias with a causal
    row and no mask (every block reads its whole share)."""
    from tpu_air_torch.ops import decode_attention as tdec

    rng = np.random.default_rng(cluster)
    b, L, h, d = 5, 1000, 3, 64
    chunk = -(-(-(-L // cluster)) // tdec._STAGE_POS) * tdec._STAGE_POS
    assert -(-L // chunk) == cluster
    monkeypatch.setattr(tdec, "split_chunk", lambda *_: chunk)
    q, k, v, kw = _ring_slabs(rng, b, L, h, d, dev, dtype, slab)
    if case == "mask":
        kw["kv_mask"] = _t(_ring_mask(b, L, chunk), dev, torch.float32)
    else:
        causal = np.where(np.arange(L) <= 2 * L // 3, 0.0, -1e9)
        kw["bias"] = _t(rng.standard_normal((h, L)) + causal, dev, torch.float32)
    got = tdec.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = tdec.decode_attention_reference(q, k, v, **kw)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) < TOL[dtype]
    if case == "mask":                       # the all-pad row: mean(V), dequantized
        v3 = v[3].float().reshape(L, h, d)
        if slab != "same":
            v3 = v3 * kw["v_scale"][3].reshape(-1, h, 1 if slab == "int8_pos" else d)
        assert _err(got[3, 0], v3.mean(0)) < TOL[dtype]


@pytest.mark.parametrize("dtype,slab", RING_KINDS)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 3, 4, 5, 31, 32, 33, 95, 257, 1000])
def test_decode_ring_kernel_at_stage_edges(dev, dtype, slab, d, L):
    """Every instance and head dim at lengths around the ring's 32-position
    stages and 4-position units, the split rule's own chunks (b 6 x h 2:
    split wherever L allows), a key mask with the rows of ``_ring_mask``
    and a bias."""
    from tpu_air_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference, plan_chunk)

    rng = np.random.default_rng(L * d)
    b, h = 6, 2
    q, k, v, kw = _ring_slabs(rng, b, L, h, d, dev, dtype, slab)
    chunk = plan_chunk(b, h, d, L, k.dtype,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    kw.update(kv_mask=_t(_ring_mask(b, L, chunk), dev, torch.float32),
              bias=_t(rng.standard_normal((h, L)), dev, torch.float32))
    got = decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = decode_attention_reference(q, k, v, **kw)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype,slab", RING_KINDS)
def test_decode_ring_kernel_is_bitwise_deterministic(dev, dtype, slab):
    """The cluster merge runs in rank order: two calls on the same inputs
    are bitwise equal, at the LM engine shape (several chunks a row) and at
    the W3 cross step, for every instance."""
    from tpu_air_torch.ops.decode_attention import decode_attention

    rng = np.random.default_rng(7)
    for b, L, h, d in ((16, 1024, 8, 128), (64, 512, 12, 64)):
        q, k, v, kw = _ring_slabs(rng, b, L, h, d, dev, dtype, slab)
        pos = rng.integers(1, L, b)
        kw["kv_mask"] = _t((np.arange(L)[None] <= pos[:, None]).astype(np.float32), dev,
                           torch.float32)
        first = decode_attention(q, k, v, **kw)
        second = decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_decode_ring_entry_refuses_more_than_eight_chunks(dev):
    """A launch whose chunk would need more than 8 blocks a row (a cluster's
    portable limit) is refused by the C entry, and the wrapper raises, for
    every query and slab type: no instance has a merge kernel to fall back
    on."""
    from tpu_air_torch.ops import decode_attention as tdec

    b, L, h, d = 1, 9 * 32, 2, 64
    saved = tdec.split_chunk
    try:
        tdec.split_chunk = lambda *_: 32
        for dtype, slab in RING_KINDS:
            q, k, v, kw = _ring_slabs(np.random.default_rng(0), b, L, h, d, dev, dtype, slab)
            with pytest.raises(RuntimeError, match="cudaError"):
                tdec.decode_attention(q, k, v, **kw)
    finally:
        tdec.split_chunk = saved


def _edge_mask(L, dev):
    """Key mask of three batch rows: full, ragged, fully masked."""
    m = np.arange(L)[None] < np.array([L, max(1, L - 37), 0])[:, None]
    return _t(m, dev, torch.float32)


# lengths at every edge of the wgmma kernels' tiles: the backward's 64-row
# consumers and ring stages and 128-row work items, the forward's 64-row
# consumers, 128-row blocks and 128-key tiles
EDGE_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 200, 255, 257]
FWD_EDGE_LENGTHS = EDGE_LENGTHS


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", FWD_EDGE_LENGTHS)
def test_flash_kernel_matches_plain_at_tile_edges(dev, d, causal, L, dtype):
    """The bf16 and f16 tensor-core forward at lengths around its tile
    edges, with a ragged key mask and a fully masked row (whose output is
    the mean of V)."""
    from tpu_air_torch.ops.flash_attention import flash_attention_reference, flash_attention_with_lse

    rng = np.random.default_rng(L + d + 1000 * causal)
    b, h = 3, 2
    q, k, v = (_t(rng.standard_normal((b, L, h, d)), dev, dtype).transpose(1, 2)
               for _ in range(3))
    mask = _edge_mask(L, dev)
    out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask, scale=1.0, causal=causal)
    torch.cuda.synchronize()
    flat = [t.reshape(b * h, L, d) for t in (q, k, v)]
    want, want_lse = flash_attention_reference(*flat, None, mask, 1.0, causal)
    got = out.reshape(b * h, L, d)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) < TOL[dtype]
    lse = lse.reshape(b * h, L)
    live = want_lse.abs() < 1e20
    assert (lse[live] - want_lse[live]).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bias_lead", ["1", "H"])
@pytest.mark.parametrize("L", [63, 200, 257])
def test_flash_kernel_shared_bias_odd_batch(dev, d, bias_lead, L, dtype):
    """A bias the batch shares pairs the forward's two consumers over two
    batch elements of one head; an odd batch leaves the last pair's second
    consumer idle.  Against the plain version, causal or not, with a ragged
    key mask and a fully masked row (the last batch row, the unpaired one);
    L = 63 has rows off 16 bytes in the bias (lk % 4 != 0: cp.async, not
    TMA)."""
    from tpu_air_torch.ops.flash_attention import flash_attention_reference, flash_attention_with_lse

    rng = np.random.default_rng(L + d)
    b, h = 5, 3
    q, k, v = (_t(rng.standard_normal((b, L, h, d)), dev, dtype).transpose(1, 2)
               for _ in range(3))
    bias = _t(rng.standard_normal((1 if bias_lead == "1" else h, L, L)), dev, torch.float32)
    lens = np.array([L, max(1, L - 37), L // 2, 1, 0])
    mask = _t(np.arange(L)[None] < lens[:, None], dev, torch.float32)
    for causal in (False, True):
        out, lse = flash_attention_with_lse(q, k, v, bias[None], kv_mask=mask, scale=1.0,
                                            causal=causal)
        torch.cuda.synchronize()
        flat = [t.reshape(b * h, L, d) for t in (q, k, v)]
        want, want_lse = flash_attention_reference(*flat, bias, mask, 1.0, causal)
        got = out.reshape(b * h, L, d)
        assert torch.isfinite(got.float()).all()
        assert _err(got, want) < TOL[dtype]
        live = want_lse.abs() < 1e20
        assert (lse.reshape(b * h, L)[live] - want_lse[live]).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", EDGE_LENGTHS)
def test_flash_backward_kernels_match_plain_at_tile_edges(dev, d, causal, L, dtype):
    """The bf16 and f16 tensor-core dq and dk/dv kernels at lengths around
    their tile edges, with a ragged key mask and a fully masked row."""
    from tpu_air_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_with_lse)

    rng = np.random.default_rng(L + d + 1000 * causal)
    b, h = 3, 2
    q, k, v, do = (_t(rng.standard_normal((b, L, h, d)), dev, dtype).transpose(1, 2)
                   for _ in range(4))
    mask = _edge_mask(L, dev)
    out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask, causal=causal)
    glse = _t(rng.standard_normal((b, h, L)), dev, torch.float32)
    got = flash_attention_backward(q, k, v, mask, out, lse, do, glse, d ** -0.5, causal)
    torch.cuda.synchronize()

    def flat(x):
        return x.reshape(b * h, L, d)

    want = flash_attention_backward_reference(
        flat(q), flat(k), flat(v), mask, flat(out), lse.reshape(b * h, L), flat(do),
        glse.reshape(b * h, L), d ** -0.5, causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        assert _err(flat(g), w) < TOL[dtype]
        assert g[2].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq, lk", [(70, 133), (133, 70), (200, 1), (1, 200)])
def test_flash_backward_kernels_lq_ne_lk(dev, d, causal, lq, lk, dtype):
    """dq and dk/dv with queries and keys of other lengths, with a key mask
    and a fully masked row: against the plain backward; under causal
    masking the keys past lq, which no query sees, get dk = dv = 0."""
    from tpu_air_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_with_lse)

    rng = np.random.default_rng(lq + 3 * lk + d)
    b, h = 3, 2
    q, do = (_t(rng.standard_normal((b, lq, h, d)), dev, dtype).transpose(1, 2) for _ in range(2))
    k, v = (_t(rng.standard_normal((b, lk, h, d)), dev, dtype).transpose(1, 2) for _ in range(2))
    mask = _edge_mask(lk, dev)
    out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask, causal=causal)
    glse = _t(rng.standard_normal((b, h, lq)), dev, torch.float32)
    got = flash_attention_backward(q, k, v, mask, out, lse, do, glse, d ** -0.5, causal)
    torch.cuda.synchronize()
    want = flash_attention_backward_reference(
        q.reshape(b * h, lq, d), k.reshape(b * h, lk, d), v.reshape(b * h, lk, d), mask,
        out.reshape(b * h, lq, d), lse.reshape(b * h, lq), do.reshape(b * h, lq, d),
        glse.reshape(b * h, lq), d ** -0.5, causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        assert _err(g.reshape(w.shape), w) < TOL[dtype]
        assert g[2].abs().max().item() == 0.0
    if causal and lk > lq:
        assert got[1][:, :, lq:].abs().max().item() == 0.0 == got[2][:, :, lq:].abs().max().item()


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_are_bitwise_deterministic(dev, causal, dtype):
    """No atomics: two backward calls on the same inputs give bitwise-equal
    dq, dk and dv, at D 128 and 64 with a key mask and at the LM's B*H 8, L
    2048 (more work items than SMs)."""
    from tpu_air_torch.ops.flash_attention import flash_attention_backward, flash_attention_with_lse

    rng = np.random.default_rng(11 + causal)
    for b, h, L, d, masked in ((3, 2, 1000, 128, True), (3, 2, 1000, 64, True),
                               (1, 8, 2048, 128, False)):
        q, k, v, do = (_t(rng.standard_normal((b, L, h, d)), dev, dtype).transpose(1, 2)
                       for _ in range(4))
        mask = _edge_mask(L, dev) if masked else None
        out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask, causal=causal)
        first = flash_attention_backward(q, k, v, mask, out, lse, do, None, d ** -0.5, causal)
        second = flash_attention_backward(q, k, v, mask, out, lse, do, None, d ** -0.5, causal)
        torch.cuda.synchronize()
        for a, c in zip(first, second):
            assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("grad", ["dq", "dk_dv"])
def test_bf16_fully_masked_row_dk_dv_are_exactly_zero(dev, d, grad, dtype):
    """In bf16 and f16 the tensor-core backward kernels hard-zero masked scores: a
    fully masked batch row gets dq = 0 exactly, and its keys dk = dv = 0, as
    do the keys that a ragged row's mask hides, causal or not."""
    from tpu_air_torch.ops.flash_attention import flash_attention_backward, flash_attention_with_lse

    rng = np.random.default_rng(d)
    b, h, L = 3, 2, 200
    for causal in (False, True):
        q, k, v, do = (_t(rng.standard_normal((b, L, h, d)), dev, dtype).transpose(1, 2)
                       for _ in range(4))
        mask = _edge_mask(L, dev)
        out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask, causal=causal)
        dq, dk, dv = flash_attention_backward(q, k, v, mask, out, lse, do, None, d ** -0.5,
                                              causal)
        torch.cuda.synchronize()
        if grad == "dq":
            assert dq[2].abs().max().item() == 0.0
            assert dq[:2].abs().max().item() > 0.0
            continue
        for g in (dk, dv):
            assert g[2].abs().max().item() == 0.0
            assert g[1, :, L - 37:].abs().max().item() == 0.0


def test_bf16_rows_off_16_bytes_are_copied_then_run(dev):
    """A bf16 view whose rows do not start on 16-byte boundaries cannot feed
    the tensor-core kernels' TMA copies: the wrapper copies it to a
    contiguous tensor, and forward and backward agree with the aligned
    input's results."""
    from tpu_air_torch.ops.flash_attention import flash_attention

    b, h, L, d = 2, 3, 80, 64
    base = torch.randn(b * h * L * d + 3, device=dev).to(torch.bfloat16)
    q = base[3:].view(b, h, L, d)                   # 6 bytes off a 16-byte boundary
    qa = q.clone()
    k, v = (torch.randn(b, h, L, d, device=dev).to(torch.bfloat16) for _ in range(2))
    grads = []
    for x in (q, qa):
        leaves = [t.detach().requires_grad_() for t in (x, k, v)]
        out = flash_attention(*leaves, causal=True)
        out.float().square().sum().backward()
        grads.append((out, *(t.grad for t in leaves)))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention

    q = torch.zeros(2, 4, 8, 24, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q64 = torch.zeros(2, 4, 8, 16, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        flash_attention(q64, q64, q64)
    kd64 = torch.zeros(2, 9, 64, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        decode_attention(torch.zeros(2, 1, 4, 16, device=dev, dtype=torch.float64), kd64, kd64)
    qd = torch.zeros(2, 1, 4, 16, device=dev)
    kd = torch.zeros(2, 9, 64, device=dev)
    with pytest.raises(ValueError, match="int8"):
        decode_attention(qd, kd, kd, k_scale=torch.ones(2, 9, 4, device=dev),
                         v_scale=torch.ones(2, 9, 4, device=dev))
    off = torch.zeros(2 * 9 * 64 + 1, device=dev)[1:].view(2, 9, 64)  # 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(qd, off, kd)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(qd, kd, off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", ["plain", "mask", "ragged_mask"])
def test_flash_backward_kernels_match_plain(dev, dtype, d, causal, case):
    """dq and dk/dv kernels against flash_attention_backward_reference from
    the same saved (out, lse) and a nonzero lse cotangent; (b, h, L, d)
    views of [b, L, h, d] tensors as the model passes them; a masked case
    has a padded row and a fully masked row, whose gradients are exactly 0."""
    from tpu_air_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_with_lse)

    rng = np.random.default_rng(d + 7 * causal)
    b, h = 3, 2
    L = 200 if case == "ragged_mask" else 128

    def t(shape=(b, L, h, d)):
        return _t(rng.standard_normal(shape), dev, dtype).transpose(1, 2)

    q, k, v, do = t(), t(), t(), t()
    mask = None
    if case != "plain":
        m = np.arange(L)[None] < np.array([L, L - 37, 0])[:, None]
        mask = _t(m, dev, torch.float32)
    out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask, causal=causal)
    glse = _t(rng.standard_normal((b, h, L)), dev, torch.float32)
    before = (flash_attention_backward.dq_launches, flash_attention_backward.dkv_launches)
    got = flash_attention_backward(q, k, v, mask, out, lse, do, glse, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert (flash_attention_backward.dq_launches, flash_attention_backward.dkv_launches) == \
        (before[0] + 1, before[1] + 1)

    def flat(x):
        return x.reshape(b * h, L, d)

    want = flash_attention_backward_reference(
        flat(q), flat(k), flat(v), mask, flat(out), lse.reshape(b * h, L), flat(do),
        glse.reshape(b * h, L), d ** -0.5, causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == dtype
        assert torch.isfinite(g.float()).all()
        err = _err(flat(g), w)
        assert err < TOL[dtype], err
        if mask is not None:
            assert g[2].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_backward_kernels_match_plain_at_lm_shape(dev, dtype):
    """The long-context LM's shape (B*H 8, L 8192, D 128, causal).  Most of
    its gradients are far below 1, where the bound above would be absolute and
    as large as the values, so each tensor is held to ||kernel - plain|| /
    ||plain||: 1e-4 in f32; in bf16 1e-2, above the 2^-7 that one ulp of
    every element would give; in f16 2e-3, above its 2^-10."""
    from tpu_air_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_with_lse)

    h, L, d = 8, 8192, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(1, L, h, d, device=dev, generator=gen).to(dtype).transpose(1, 2)
                   for _ in range(4))
    out, lse = flash_attention_with_lse(q, k, v, causal=True)
    got = flash_attention_backward(q, k, v, None, out, lse, do, None, d ** -0.5, True)

    def flat(x):
        return x.reshape(h, L, d)

    want = flash_attention_backward_reference(flat(q), flat(k), flat(v), None, flat(out),
                                              lse.reshape(h, L), flat(do), None, d ** -0.5, True)
    for g, w in zip(got, want):
        w = w.float()
        rel = ((flat(g).float() - w).norm() / w.norm()).item()
        assert rel < {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype], rel


def test_flash_autograd_launches_both_backward_kernels(dev):
    """Autograd through flash attention on the card runs the forward kernel
    once and each backward kernel once; no plain version is involved."""
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward

    q, k, v = (torch.randn(2, 4, 96, 64, device=dev, requires_grad=True) for _ in range(3))
    counts = (flash_attention.launches, flash_attention_backward.dq_launches,
              flash_attention_backward.dkv_launches)
    flash_attention(q, k, v, causal=True).square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_backward.dq_launches,
            flash_attention_backward.dkv_launches) == tuple(c + 1 for c in counts)
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_backward_wrapper_rejects_what_the_kernels_do_not_take(dev):
    from tpu_air_torch.ops.flash_attention import flash_attention_backward

    def call(q, k=None, mask=None):
        k = q if k is None else k
        lse = torch.zeros(q.shape[:3], device=dev)
        return flash_attention_backward(q, k, k, mask, q, lse, q, None, 1.0, False)

    with pytest.raises(ValueError, match="head dim"):
        call(torch.zeros(2, 4, 8, 24, device=dev))
    with pytest.raises(TypeError):
        call(torch.zeros(2, 4, 8, 16, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="do not match"):
        call(torch.zeros(2, 4, 8, 16, device=dev), torch.zeros(2, 3, 8, 16, device=dev))
    with pytest.raises(ValueError, match="kv_mask"):
        call(torch.zeros(2, 4, 8, 16, device=dev), mask=torch.ones(2, 9, device=dev))


def test_batch_predictor_scores_in_a_leased_actor_on_the_card(dev, tmp_path):
    """W3 in small: one scoring actor leases the card, loads a JAX-format
    checkpoint in float16 on cuda:0 (from its lease), and generates the same
    outputs as the in-process predictor, through both inference kernels."""
    import pandas as pd

    import tpu_air_torch
    from tpu_air_torch.data import from_pandas
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.predict import BatchPredictor, T5GenerativePredictor
    from tpu_air_torch.train import Checkpoint

    class Probe(T5GenerativePredictor):
        def _predict_numpy(self, data, **kw):
            from tpu_air_torch.ops.decode_attention import decode_attention
            from tpu_air_torch.ops.flash_attention import flash_attention

            before = flash_attention.launches, decode_attention.launches
            out = super()._predict_numpy(data, **kw)
            return out.assign(device=str(self.model.device),
                              flash=flash_attention.launches - before[0],
                              decode=decode_attention.launches - before[1])

    class IdTokenizer:                  # random weights: decode to the ids themselves
        def batch_decode(self, seqs, skip_special_tokens=True):
            return [" ".join(map(str, row)) for row in seqs]

    cfg = T5Config.tiny(vocab_size=384)
    model = T5ForConditionalGeneration(cfg, device="cpu").init_weights(0)
    path = str(tmp_path / "ckpt")
    Checkpoint.from_model(model_config=cfg, params=model.state_dict(), format="jax", path=path)
    rng = np.random.default_rng(0)
    lens = np.array([16, 9, 0, 12])
    mask = (np.arange(16)[None] < lens[:, None]).astype(np.int64)
    df = pd.DataFrame({"input_ids": list(rng.integers(3, 384, (4, 16)) * mask),
                       "attention_mask": list(mask), "idx": range(4)})
    tpu_air_torch.init(num_cpus=2)
    try:
        out = BatchPredictor.from_checkpoint(
            Checkpoint.from_directory(path), Probe, tokenizer=IdTokenizer(),
            dtype="float16").predict(
            from_pandas(df), feature_columns=["input_ids", "attention_mask"],
            keep_columns=["idx"], batch_size=4, num_gpus_per_worker=1,
            max_new_tokens=6).to_pandas()
    finally:
        tpu_air_torch.shutdown()
    want = T5GenerativePredictor.from_checkpoint(
        Checkpoint.from_directory(path), dtype="float16", tokenizer=IdTokenizer()).predict(
        df[["input_ids", "attention_mask"]], max_new_tokens=6)
    assert set(out["device"]) == {"cuda:0"}
    assert (out["flash"] == cfg.num_layers).all() and (out["decode"] > 0).all()
    assert out.sort_values("idx")["generated_output"].tolist() == \
        want["generated_output"].tolist()


def test_tune_trials_train_on_the_leased_card(dev, tmp_path):
    """W2 in small: a 2-trial sweep over a tiny T5Trainer given no device.
    Each trial's actor leases the card, trains on cuda:0 (its lease) and
    launches the flash forward in its evaluation; it reports both from
    inside the actor."""
    import json
    import os

    import pandas as pd

    import tpu_air_torch
    from tpu_air_torch import tune
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.train import RunConfig, T5Trainer, TrainingArguments

    def probe_loop(config):
        from tpu_air_torch.device import resolve_device
        from tpu_air_torch.ops.flash_attention import flash_attention
        from tpu_air_torch.train import session
        from tpu_air_torch.train.t5_trainer import t5_train_loop

        before = flash_attention.launches
        try:
            t5_train_loop(config)
        finally:
            probe = {"device": str(resolve_device(config.get("_device"))),
                     "allocated": torch.cuda.max_memory_allocated(),
                     "flash": flash_attention.launches - before}
            with open(os.path.join(session.get_session().run_dir, "probe.json"), "w") as f:
                json.dump(probe, f)

    class ProbingT5Trainer(T5Trainer):
        def _training_fn(self):
            return probe_loop

    rng = np.random.default_rng(0)
    mask = (np.arange(32)[None] < rng.integers(8, 33, (4, 1))).astype(np.int64)
    rows = pd.DataFrame({"input_ids": list(rng.integers(2, 384, (4, 32)) * mask),
                         "attention_mask": list(mask),
                         "labels": list(rng.integers(2, 384, (4, 32)) * mask)})
    trainer = ProbingT5Trainer(
        model_config=T5Config.tiny(vocab_size=384),
        training_args=TrainingArguments(per_device_train_batch_size=2, num_train_epochs=2),
        datasets={"train": rows, "evaluation": rows},
        run_config=RunConfig(storage_path=str(tmp_path)))
    tpu_air_torch.init(num_cpus=2)
    try:
        grid = tune.Tuner(
            trainer, param_space={"trainer_init_config": {
                "learning_rate": tune.grid_search([1e-3, 1e-5])}},
            tune_config=tune.TuneConfig(metric="eval_loss", mode="min")).fit()
    finally:
        tpu_air_torch.shutdown()
    assert len(grid) == 2 and grid.num_errors == 0, grid.errors
    for r in grid:
        with open(os.path.join(r.path, "probe.json")) as f:
            probe = json.load(f)
        assert probe["device"] == "cuda:0" and probe["allocated"] > 0
        assert probe["flash"] > 0
        assert len(r.metrics_history) == 2


def test_segformer_predictor_on_the_card_matches_the_cpu(dev, tmp_path):
    """W7 in small: a tiny SegFormer's JAX-format checkpoint (batch-norm
    stats in its extras) loads onto cuda:0 by default; its masks equal the
    CPU predictor's except where an image's top two logits lie within 1e-4
    (f32 on both, TF32 off: the card and the CPU sum in other orders); and a
    train-mode step on the card moves the batch norm's running stats as it
    does on the CPU (1e-5)."""
    import pandas as pd

    from tpu_air_torch.models.segformer import SegformerConfig
    from tpu_air_torch.models.segformer.image_processor import _resize
    from tpu_air_torch.models.segformer.modeling import SegformerForSemanticSegmentation
    from tpu_air_torch.predict import SemanticSegmentationPredictor
    from tpu_air_torch.train import Checkpoint

    cfg = SegformerConfig.tiny()
    model = SegformerForSemanticSegmentation(cfg, device="cpu").init_weights(0)
    path = str(tmp_path / "ckpt")
    Checkpoint.from_model(model_config=cfg, params=model.state_dict(), format="jax", path=path)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
              for h, w in ((96, 128), (120, 100), (64, 64))]
    df = pd.DataFrame({"image": images})
    card = SemanticSegmentationPredictor.from_checkpoint(Checkpoint.from_directory(path))
    assert card.model.device == torch.device("cuda", 0)
    cpu = SemanticSegmentationPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                                        device="cpu")
    got = card.predict(df)["predicted_mask"]
    want = cpu.predict(df)["predicted_mask"]
    px = cpu.feature_extractor(images)["pixel_values"]
    with torch.no_grad():
        logits = cpu.model(torch.from_numpy(px)).numpy()
    for g, w, lg, im in zip(got, want, logits, images):
        assert g.shape == w.shape == im.shape[:2]
        up = np.sort(_resize(lg, *im.shape[:2], nearest=False), axis=-1)
        assert ((g == w) | (up[..., -1] - up[..., -2] < 1e-4)).all()
    x = torch.from_numpy(px)
    stats = []
    for m in (card.model, cpu.model):
        m.train()
        m(x.to(m.device))
        stats.append(m.decode_head.batch_norm.running_var.cpu())
    assert torch.allclose(stats[0], stats[1], atol=1e-5, rtol=0)


def _engine_streams(model, prompts, cfg):
    from tpu_air_torch.engine import T5Engine

    with T5Engine(model, cfg, name="card-engine") as engine:
        return engine.generate(prompts, timeout=120.0)


def test_t5_engine_streams_on_the_card_kernels_match_plain(dev, monkeypatch):
    """The T5 window engine on cuda:0 (tiny T5, f32, TF32 off): its thread
    launches both inference kernels; its streams equal those of the same
    engine with the plain versions in the model, and greedy decoding with
    the two entry points over the same window batches on the CPU."""
    from tpu_air_torch.engine import T5EngineConfig
    from tpu_air_torch.models.t5 import modeling
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.generate import generate
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_reference

    cfg = T5Config.tiny()
    model = modeling.T5ForConditionalGeneration(cfg, device=dev).init_weights(0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, int(n)).tolist() for n in rng.integers(3, 33, 5)]
    ecfg = T5EngineConfig(max_batch=2, max_input_len=32, max_new_tokens=8)
    before = flash_attention.launches, decode_attention.launches
    got = _engine_streams(model, prompts, ecfg)
    assert flash_attention.launches - before[0] == 3 * cfg.num_layers       # 3 windows
    assert decode_attention.launches > before[1]

    def plain_flash(q, k, v, bias=None, *, kv_mask=None, scale=None, causal=False):
        b, h, lq, d = q.shape
        flat = [x.reshape(b * h, x.shape[2], d) for x in (q, k, v)]
        out = flash_attention_reference(*flat, None if bias is None else bias[0], kv_mask,
                                        1.0, causal)[0]
        return out.reshape(b, h, lq, d)

    monkeypatch.setattr(modeling, "flash_attention", plain_flash)
    monkeypatch.setattr(modeling, "decode_attention", decode_attention_reference)
    before = flash_attention.launches, decode_attention.launches
    assert _engine_streams(model, prompts, ecfg) == got
    assert (flash_attention.launches, decode_attention.launches) == before
    monkeypatch.undo()

    cpu = modeling.T5ForConditionalGeneration(cfg, device="cpu").init_weights(0)
    want = []
    for w in range(0, len(prompts), 2):
        ids = np.full((2, 32), cfg.pad_token_id, np.int64)
        mask = np.zeros((2, 32), np.int64)
        for r, p in enumerate(prompts[w:w + 2]):
            ids[r, :len(p)], mask[r, :len(p)] = p, 1
        rows = generate(cpu, ids, mask, max_new_tokens=8, early_stop=False).tolist()
        for row in rows[:len(prompts[w:w + 2])]:
            eos = cfg.eos_token_id
            want.append(row[:row.index(eos) + 1] if eos in row else row)
    assert got == want


def test_int8_generate_on_the_card_matches_plain_and_the_cpu(dev, monkeypatch):
    """T5 generation with ``decode_cache_int8=True`` on cuda:0 (tiny T5,
    f32, TF32 off, ragged prompts and an all-pad row): the int8 decode
    launches run, and the greedy tokens equal those of the plain versions
    on the card and of the same weights on the CPU."""
    import dataclasses

    from tpu_air_torch.models.t5 import modeling
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.models.t5.generate import generate
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference

    cfg = dataclasses.replace(T5Config.tiny(), decode_cache_int8=True)
    model = modeling.T5ForConditionalGeneration(cfg, device=dev).init_weights(0)
    rng = np.random.default_rng(9)
    lens = np.array([24, 17, 9, 0])
    mask = (np.arange(24)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(2, cfg.vocab_size, (4, 24)) * mask
    before = decode_attention.launches
    got = generate(model, ids, mask, max_new_tokens=12, early_stop=False).cpu()
    assert decode_attention.launches - before == 2 * cfg.num_decoder_layers * 12
    monkeypatch.setattr(modeling, "decode_attention", decode_attention_reference)
    plain = generate(model, ids, mask, max_new_tokens=12, early_stop=False).cpu()
    monkeypatch.undo()
    cpu = modeling.T5ForConditionalGeneration(cfg, device="cpu").init_weights(0)
    want = generate(cpu, ids, mask, max_new_tokens=12, early_stop=False)
    assert torch.equal(got, plain) and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_decode_kernel_at_the_lm_engine_shape(dev, dtype):
    """The LM engine's 1-token step: b 16 slots over L 1024 keys, 8 heads of
    128, a per-row validity mask with rows at varied positions (one at 0, a
    free row), q scaled in its own type first as the model scales it."""
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference

    rng = np.random.default_rng(16)
    b, L, h, d = 16, 1024, 8, 128
    q = _t(rng.standard_normal((b, 1, h, d)), dev, dtype) * float(
        torch.tensor(d ** -0.5, dtype=dtype))
    k = _t(rng.standard_normal((b, L, h * d)), dev, dtype)
    v = _t(rng.standard_normal((b, L, h * d)), dev, dtype)
    pos = rng.integers(64, L, b)
    pos[0], pos[-1] = 0, L - 1
    mask = _t((np.arange(L)[None] <= pos[:, None]).astype(np.float32), dev, torch.float32)
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_reference(q, k, v, kv_mask=mask)
    assert torch.isfinite(got.float()).all()
    assert _err(got, want) < TOL[dtype]


def test_lm_paged_decode_step_on_the_card_matches_plain(dev, monkeypatch):
    """One paged decode step of a 2-layer LM (d_model 1024, 8 heads of 128,
    f32, TF32 off) through the kernel, against the same step with the plain
    version in the model, from the same pool: equal tokens, and K/V pools
    within the f32 tolerance.  Row 1 is free (null page, pos 0)."""
    from tpu_air_torch.models.lm import (LMConfig, CausalLM, init_paged_cache,
                                         make_lm_paged_decode_step_fn)
    from tpu_air_torch.models.lm import modeling
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference

    cfg = LMConfig(vocab_size=32000, d_model=1024, n_layers=2, n_heads=8, max_seq_len=1024)
    model = CausalLM(cfg, device=dev).init_weights(0)
    S, P, C, npg = 4, 40, 16, 8
    rng = np.random.default_rng(17)
    table = torch.from_numpy(rng.permutation(np.arange(1, P))[:S * npg].reshape(S, npg)).to(dev)
    table[1] = 0
    pos = torch.tensor([70, 0, 127, 5], device=dev)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, S)).to(dev)

    def run():
        cache = init_paged_cache(model, S, P, C, npg)
        g = torch.Generator(dev).manual_seed(3)
        for c in cache:
            c.cached_key.normal_(generator=g)
            c.cached_value.normal_(generator=g)
        step = make_lm_paged_decode_step_fn(model, C * npg)
        cache, nxt = step(cache, tok, pos, table)
        return nxt, cache

    before = decode_attention.launches
    got, cache = run()
    torch.cuda.synchronize()
    assert decode_attention.launches == before + cfg.n_layers
    monkeypatch.setattr(modeling, "decode_attention", decode_attention_reference)
    want, plain_cache = run()
    assert decode_attention.launches == before + cfg.n_layers
    assert torch.equal(got, want)
    for a, b in zip(cache, plain_cache):
        assert _err(a.cached_key, b.cached_key) < TOL[torch.float32]
        assert _err(a.cached_value, b.cached_value) < TOL[torch.float32]


def _lm_2layer(dev):
    from tpu_air_torch.models.lm import CausalLM, LMConfig

    cfg = LMConfig(vocab_size=32000, d_model=1024, n_layers=2, n_heads=8, max_seq_len=1024)
    return CausalLM(cfg, device=dev).init_weights(0)


def test_lm_adapter_paged_step_on_the_card_matches_plain(dev, monkeypatch):
    """One paged decode step of the 2-layer LM with the LoRA banks (rows 0
    and 2 on seeded tenants, row 1 free, row 3 on the zero adapter), f32,
    through the kernel and through the plain version from the same pool:
    equal tokens; the zero-adapter row's token is the base step's."""
    from tpu_air_torch.models.lm import init_paged_cache, make_lm_paged_decode_step_fn, modeling
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference

    model = _lm_2layer(dev)
    cfg = model.config
    S, P, C, npg = 4, 40, 16, 8
    rng = np.random.default_rng(19)
    table = torch.from_numpy(rng.permutation(np.arange(1, P))[:S * npg].reshape(S, npg)).to(dev)
    table[1] = 0
    pos = torch.tensor([70, 0, 127, 5], device=dev)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, S)).to(dev)
    bank_a = torch.zeros(3, cfg.d_model, 4, device=dev)
    bank_b = torch.zeros(3, 4, cfg.vocab_size, device=dev)
    bank_a[1:] = torch.from_numpy(rng.standard_normal((2, cfg.d_model, 4)) / 32).to(dev)
    bank_b[1:] = torch.from_numpy(rng.standard_normal((2, 4, cfg.vocab_size)) / 2).to(dev)
    ids = torch.tensor([1, 0, 2, 0], device=dev)

    def run(adapters):
        cache = init_paged_cache(model, S, P, C, npg)
        g = torch.Generator(dev).manual_seed(3)
        for c in cache:
            c.cached_key.normal_(generator=g)
            c.cached_value.normal_(generator=g)
        step = make_lm_paged_decode_step_fn(model, C * npg, adapters=adapters)
        banks = (bank_a, bank_b, ids) if adapters else ()
        return step(cache, tok, pos, table, *banks)[1]

    before = decode_attention.launches
    got, base = run(True), run(False)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2 * cfg.n_layers
    monkeypatch.setattr(modeling, "decode_attention", decode_attention_reference)
    assert torch.equal(got, run(True))
    assert decode_attention.launches == before + 2 * cfg.n_layers
    assert int(got[3]) == int(base[3])


def test_insert_kv_pages_into_a_card_pool_from_bf16_cpu_pages(dev):
    """A bf16 payload on the CPU written into a bf16 pool on the card (and
    into an f32 one, the lossless widening) reads back exactly; the other
    pages are untouched."""
    from tpu_air_torch.engine.dist import extract_kv_pages, insert_kv_pages
    from tpu_air_torch.models.lm.modeling import AttnCache

    g = torch.Generator().manual_seed(5)
    src = [AttnCache(torch.randn(9, 16, 1024, generator=g).bfloat16(),
                     torch.randn(9, 16, 1024, generator=g).bfloat16(), 0) for _ in range(2)]
    payload = extract_kv_pages(src, [2, 7, 4])
    assert payload["layer_1/attn"]["v"].dtype == torch.bfloat16
    for dt in (torch.bfloat16, torch.float32):
        dst = [AttnCache(torch.zeros(12, 16, 1024, dtype=dt, device=dev),
                         torch.zeros(12, 16, 1024, dtype=dt, device=dev), 0) for _ in range(2)]
        insert_kv_pages(dst, [11, 1, 5], payload)
        torch.cuda.synchronize()
        for s, d in zip(src, dst):
            assert torch.equal(d.cached_key[[11, 1, 5]].cpu(), s.cached_key[[2, 7, 4]].to(dt))
            assert torch.equal(d.cached_value[[11, 1, 5]].cpu(), s.cached_value[[2, 7, 4]].to(dt))
            assert not d.cached_key[[0, 2, 3, 4, 6, 7, 8, 9, 10]].any()


def test_swap_then_one_step_equals_a_fresh_models_step(dev):
    """An engine on the card swaps to new weights (another embedding, the
    tied head) between steps; its next tokens equal an engine built on a
    fresh model holding those weights, in f32 and in bf16."""
    from tpu_air_torch.engine import EngineConfig, InferenceEngine

    for dtype in (torch.float32, torch.bfloat16):
        model = _lm_2layer(dev).to(dtype)
        new = {k: v.clone() for k, v in model.state_dict().items()}
        new["embedding"] = torch.randn(new["embedding"].shape, generator=torch.Generator(
            dev).manual_seed(11), device=dev).mul_(0.02).to(dtype)
        fresh = _lm_2layer(dev).to(dtype)
        fresh.load_state_dict(new)
        prompts = [[5, 6, 7, 8, 9], list(range(100, 140))]
        cfg = EngineConfig(num_slots=2, slot_len=64, max_new_tokens=4, eos_token_id=None)
        engine = InferenceEngine(model, cfg, auto_start=False)
        engine.swap_params(new)
        got = engine.generate(prompts)
        assert got == InferenceEngine(fresh, cfg, auto_start=False).generate(prompts)


@pytest.mark.parametrize("dtype", HALF)
def test_profile_trace_records_the_flash_kernels_by_name(dev, dtype, tmp_path):
    """``profile_trace(device="cuda:0")`` around one flash forward and its
    backward writes a Chrome trace that names the forward, dq and dk/dv
    kernels, one launch each, and the launch counters agree."""
    import glob
    import json

    from tpu_air_torch.observability import profile_trace
    from tpu_air_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_with_lse)

    rng = np.random.default_rng(7)
    b, h, L, d = 2, 4, 512, 128
    q, k, v, do = (_t(rng.standard_normal((b, h, L, d)), dev, dtype) for _ in range(4))
    glse = torch.zeros(b, h, L, device=dev)
    out, lse = flash_attention_with_lse(q, k, v, causal=True)     # build and warm up
    flash_attention_backward(q, k, v, None, out, lse, do, glse, d ** -0.5, True)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    flash_attention_backward.dq_launches = flash_attention_backward.dkv_launches = 0
    with profile_trace(str(tmp_path), device="cuda:0"):
        out, lse = flash_attention_with_lse(q, k, v, causal=True)
        flash_attention_backward(q, k, v, None, out, lse, do, glse, d ** -0.5, True)
        torch.cuda.synchronize()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    counts = {kern: sum(kern in n for n in names)
              for kern in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                           "flash_bwd_dkv_wgmma_kernel")}
    assert counts == dict.fromkeys(counts, 1), names
    assert (flash_attention.launches, flash_attention_backward.dq_launches,
            flash_attention_backward.dkv_launches) == (1, 1, 1)


def test_borrow_return_migrates_streams_between_replicas_sharing_the_card(dev, tmp_path):
    """Two ``EngineDeployment`` replicas of ``num_chips=0.5`` share the card
    (bf16, the 2-layer LM); 8 streams decode through the proxy, and one
    replica goes back through the batch lane's return path
    (``shrink_target``, ``mark_borrowed``, ``borrow_return`` with a 5 s
    notice): the preemption watcher migrates its live streams into the other
    replica's process, and every stream's tokens equal those of an
    undisturbed engine on the same weights."""
    import json
    import socket
    import threading
    import time
    import urllib.request

    import tpu_air_torch
    from tpu_air_torch import serve
    from tpu_air_torch.engine import EngineConfig, InferenceEngine
    from tpu_air_torch.serve import EngineDeployment
    from tpu_air_torch.serve.proxy import route_control
    from tpu_air_torch.train import Checkpoint

    model = _lm_2layer(dev)
    path = str(tmp_path / "ckpt")
    Checkpoint.from_model(model_config=model.config,
                          params={k: v.cpu() for k, v in model.state_dict().items()}).to_directory(path)
    cfg = dict(num_slots=8, slot_len=512, page_len=16, max_new_tokens=160, eos_token_id=None)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 32000, int(n)).tolist() for n in rng.integers(16, 200, 8)]
    want = InferenceEngine(Checkpoint.from_directory(path).get_model(dtype="bfloat16"),
                           EngineConfig(**cfg), auto_start=False).generate(prompts)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    def post(payload, pin=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/lane", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     **({"x-tpu-air-replica": pin} if pin else {})})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read()), dict(resp.headers)

    progress = {}

    def streams():
        rids = []
        for i, p in enumerate(prompts):
            # an explicit budget journals the stream: one still queued on
            # the returned replica is replayed from its prompt
            out, headers = post({"action": "submit", "prompt": p,
                                 "max_new_tokens": cfg["max_new_tokens"]})
            progress[i] = [headers["x-tpu-air-replica"], []]
            rids.append(out["request_id"])
        done = [False] * len(rids)
        while not all(done):
            for i, rid in enumerate(rids):
                if not done[i]:
                    res, _ = post({"action": "poll", "request_id": rid,
                                   "cursor": len(progress[i][1])}, pin=progress[i][0])
                    progress[i][1] += res["tokens"]
                    done[i] = res["done"]
            time.sleep(0.01)

    tpu_air_torch.init(num_cpus=2)
    try:
        h = serve.run(EngineDeployment.options(name="lane", route_prefix="/lane",
                                               num_replicas=2, num_chips=0.5)
                      .bind(Checkpoint.from_directory(path), EngineConfig(**cfg),
                            dtype="bfloat16"), port=port)
        a, b = h._replicas
        for r in (a, b):
            tpu_air_torch.get(r.handle.remote("weights_probe", ([[5, 6, 7]], 2), {}))
        client = threading.Thread(target=streams, daemon=True)
        client.start()
        deadline = time.time() + 120
        while not (len(progress) == len(prompts) and any(
                len(t) >= 8 for pin, t in progress.values() if pin == a._actor_id)):
            assert time.time() < deadline and client.is_alive()
            time.sleep(0.005)
        assert any(pin == a._actor_id for pin, _ in progress.values())
        watcher = route_control("/lane")["watcher"]
        assert h.shrink_target() == 1
        watcher.mark_borrowed(a._actor_id)
        assert tpu_air_torch.get(a.handle.remote("borrow_return", (5.0,), {})) is True
        client.join(timeout=300)
        assert not client.is_alive()
        assert [progress[i][1] for i in range(len(prompts))] == want
        while h.live_replicas() != 1 and time.time() < deadline:
            time.sleep(0.05)
        st = watcher.stats()
        assert st["borrow_returns"] == 1 and st["migrations"] >= 1
        assert st["migration_fallbacks"] == 0 and h.live_replicas() == 1
        snap = tpu_air_torch.get(b.handle.remote("stats", (), {}))
        assert snap["device"] == "cuda:0" and snap["kernel_launches"]["decode_attention"] > 0
        assert snap["migrations"]["in"] == st["migrations"]
        assert snap["migrations"]["in_reprefill_chunks"] == 0
    finally:
        serve.shutdown()
        tpu_air_torch.shutdown()


def _put_card_bytes(root, oid, q):
    """In another process: a seeded bf16 tensor made on the card, its bytes
    put into the store (the arena, which holds them)."""
    from tpu_air_torch.core.object_store import ObjectStore

    g = torch.Generator(device="cuda").manual_seed(7)
    t = torch.randn(8, 16, 1024, generator=g, device="cuda", dtype=torch.bfloat16)
    ObjectStore(root).put(t.cpu().view(torch.uint8).numpy(), object_id=oid)
    q.put("done")


def test_card_tensor_bytes_cross_processes_through_the_arena(dev, tmp_path):
    """A CUDA tensor's bytes, put into the shared-memory arena by a spawned
    process, are read here zero-copy from the arena and, back on the card,
    equal the same seed's tensor bit for bit."""
    import multiprocessing
    import os

    from tpu_air_torch.core.object_store import ObjectStore, new_object_id

    store = ObjectStore(str(tmp_path / "store"), create=True)
    try:
        assert store._arena is not None
        ctx = multiprocessing.get_context("spawn")
        oid, q = new_object_id(), ctx.Queue()
        p = ctx.Process(target=_put_card_bytes, args=(store.root, oid, q))
        p.start()
        val = store.get(oid, timeout=120)
        assert q.get(timeout=60) == "done"
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
        assert store._arena.contains(oid) and not os.path.exists(os.path.join(store.root, oid))
        assert not val.flags["OWNDATA"] and store._arena.pins(oid) == 1
        got = torch.from_numpy(np.array(val)).to(dev).view(torch.bfloat16).view(8, 16, 1024)
        g = torch.Generator(device=dev).manual_seed(7)
        want = torch.randn(8, 16, 1024, generator=g, device=dev, dtype=torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    finally:
        store.destroy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sp", [2, 3, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_in_memory_matches_whole_sequence_kernels(dev, dtype, sp, causal):
    """Ring attention over sp ranks held in this process, through the flash
    kernels at L/sp, against one whole-sequence call of the same kernels:
    output and gradients to each tensor's norm, and the launches equal to
    the live hops (none for a masked hop)."""
    from tpu_air_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_with_lse)
    from tpu_air_torch.ops.ring_attention import live_hops, ring_attention_in_memory

    rng = np.random.default_rng(sp + 10 * causal)
    b, h, L, d = 2, 2, 384 * sp, 64
    q, k, v, do = (_t(rng.standard_normal((b, L, h, d)), dev, dtype).transpose(1, 2)
                   for _ in range(4))
    with torch.no_grad():
        out_w, lse_w = flash_attention_with_lse(q, k, v, causal=causal)
    want = (out_w, *flash_attention_backward(q, k, v, None, out_w, lse_w, do, None,
                                             d ** -0.5, causal))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = (flash_attention.launches, flash_attention_backward.dq_launches,
              flash_attention_backward.dkv_launches)
    outs = ring_attention_in_memory(*(list(x.chunk(sp, dim=2)) for x in leaves),
                                    causal=causal)
    torch.autograd.backward(outs, list(do.chunk(sp, dim=2)))
    torch.cuda.synchronize()
    after = (flash_attention.launches, flash_attention_backward.dq_launches,
             flash_attention_backward.dkv_launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [live_hops(sp, causal)] * 3
    got = (torch.cat(outs, dim=2), *(x.grad for x in leaves))
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}[dtype]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel < tol, (name, rel)


@pytest.mark.parametrize("tp", [2, 4])
def test_lm_tp_step_on_one_card_matches_the_single_card_step(dev, tp):
    """The LM's tensor-parallel train step with every shard on ``cuda:0``
    against the single-card step, f32, from the same weights: two steps'
    losses to 1e-5 relative, the step-1 gradients (shards put back
    together) to 1e-5 of each tensor's norm, and the flash forward, dq and
    dk/dv launched once a layer, shard and step."""
    from tpu_air_torch.models.lm import CausalLM, LMConfig
    from tpu_air_torch.models.lm.convert import tp_split_dims
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.parallel.mesh import worker_mesh
    from tpu_air_torch.parallel.sequence_parallel import make_sp_train_step, shift_targets
    from tpu_air_torch.parallel.sharding import logical_parameters, shard_module
    from tpu_air_torch.train.lm_trainer import make_lm_tp_train_step
    from tpu_air_torch.train.t5_trainer import TrainingArguments, _make_optimizer

    cfg = LMConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4, head_dim=64,
                   max_seq_len=512)
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 512, (2, 512))).to(dev)
    tgt = shift_targets(ids, cfg.pad_token_id)
    runs = {}
    for n in (1, tp):
        model = CausalLM(cfg, device=dev).init_weights(0)
        mesh = worker_mesh([dev] * n, n)
        shard_module(model, list(mesh.devices[0]), tp_split_dims(cfg, n))
        logical = logical_parameters(model)
        opt = _make_optimizer(TrainingArguments(learning_rate=1e-3), 2,
                              [(s, d) for _, s, d in logical])
        grads, adamw_step = [], opt.step

        def snapshot_then_step(logical=logical, adamw_step=adamw_step, grads=grads):
            grads.append({name: (s[0].grad if d is None else torch.cat([p.grad for p in s], d))
                          .clone() for name, s, d in logical})
            adamw_step()

        opt.step = snapshot_then_step
        step = make_sp_train_step(model, opt) if n == 1 else \
            make_lm_tp_train_step(model, opt, mesh)
        before = (flash_attention.launches, flash_attention_backward.dq_launches,
                  flash_attention_backward.dkv_launches)
        losses = [float(step(ids, tgt)) for _ in range(2)]
        after = (flash_attention.launches, flash_attention_backward.dq_launches,
                 flash_attention_backward.dkv_launches)
        assert [a - b for a, b in zip(after, before)] == [cfg.n_layers * n * 2] * 3
        runs[n] = losses, grads[0]
    (want_l, want_g), (got_l, got_g) = runs[1], runs[tp]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for name, w in want_g.items():
        rel = ((got_g[name] - w).norm() / w.norm()).item()
        assert rel < 1e-5, (name, rel)


def test_multihost_t5_fit_on_one_card_matches_one_host(dev, tmp_path):
    """``T5Trainer(ScalingConfig(num_workers=4, model_parallel=2))`` over 2
    emulated hosts x 4 slots, every slot on ``cuda:0`` (this process host 0,
    an agent process host 1, their gradients summed over gloo), against one
    host running the same dp 4 x tp 2 in process, at ``T5Config.tiny()`` in
    f32 from the same seed: losses to 1e-5 relative, the final parameters
    to 1e-5 of each tensor's norm, the flash forward launched on the card."""
    import os

    import pandas as pd

    import tpu_air_torch
    from tpu_air_torch.core import runtime as rt
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.ops.flash_attention import flash_attention
    from tpu_air_torch.parallel.distributed import spawn_local_cluster
    from tpu_air_torch.train import RunConfig, ScalingConfig, T5Trainer, TrainingArguments

    rng = np.random.default_rng(7)
    n, seq = 16, 32
    ids = rng.integers(3, 256, (n, seq)) * (np.arange(seq)[None] < rng.integers(4, seq, (n, 1)))
    labels = rng.integers(3, 256, (n, seq)) * (np.arange(seq)[None] < rng.integers(2, 12, (n, 1)))
    rows = pd.DataFrame({"input_ids": list(ids), "attention_mask": list((ids != 0).astype(int)),
                         "labels": list(labels)})

    def fit(name, **scaling):
        return T5Trainer(model_config=T5Config.tiny(),
                         training_args=TrainingArguments(learning_rate=1e-3, num_train_epochs=2,
                                                         per_device_train_batch_size=2, seed=3),
                         scaling_config=ScalingConfig(**scaling),
                         datasets={"train": rows, "evaluation": rows.iloc[:5]},
                         run_config=RunConfig(storage_path=str(tmp_path / name)),
                         device=dev).fit()

    saved = rt._runtime
    rt._runtime = None
    # one host: the fit's trial actor leases 8 slots, all on the card
    tpu_air_torch.init(num_cpus=1, num_chips=8)
    try:
        one = fit("one", num_chips_per_worker=8, model_parallel=2)
    finally:
        tpu_air_torch.shutdown()
    cluster = spawn_local_cluster(2, devices_per_process=4)
    try:
        tpu_air_torch.init(num_cpus=1)
        before = flash_attention.launches
        two = fit("two", num_workers=4, model_parallel=2)
        launched = flash_attention.launches - before
    finally:
        tpu_air_torch.shutdown()
        cluster.shutdown()
        rt._runtime = saved
    assert one.error is None and two.error is None, (one.error, two.error)
    assert launched > 0
    assert [m["mesh_num_hosts"] for m in two.metrics_history] == [2, 2]
    for got, want in zip(two.metrics_history, one.metrics_history):
        assert (got["mesh_data"], got["mesh_model"]) == (want["mesh_data"], want["mesh_model"])
        np.testing.assert_allclose([got["loss"], got["eval_loss"]],
                                   [want["loss"], want["eval_loss"]], rtol=1e-5)
    got_p, want_p = two.checkpoint.get_params(), one.checkpoint.get_params()
    for name, w in want_p.items():
        rel = ((got_p[name].float() - w.float()).norm() / w.float().norm()).item()
        assert rel < 1e-5, (name, rel)


def test_two_worker_actors_on_one_card_match_one_rank(dev, tmp_path):
    """``T5Trainer(ScalingConfig(num_workers=2))`` in a runtime of 2 chip
    slots on the one card: the fit's trial actor leases both and its two
    rank actors train on ``cuda:0`` over gloo, in f32 at
    ``T5Config.tiny()``; their two steps equal one rank's at the doubled
    per-device batch: losses to 1e-6 relative, parameters to 1e-6 in norm."""
    import pandas as pd

    import tpu_air_torch
    from tpu_air_torch.core import runtime as rt
    from tpu_air_torch.models.t5.config import T5Config
    from tpu_air_torch.train import RunConfig, ScalingConfig, T5Trainer, TrainingArguments

    rng = np.random.default_rng(11)
    n, seq = 8, 32
    ids = rng.integers(3, 256, (n, seq)) * (np.arange(seq)[None] < rng.integers(4, seq, (n, 1)))
    labels = rng.integers(3, 256, (n, seq)) * (np.arange(seq)[None] < rng.integers(2, 12, (n, 1)))
    rows = pd.DataFrame({"input_ids": list(ids), "attention_mask": list((ids != 0).astype(int)),
                         "labels": list(labels)})
    saved = rt._runtime
    rt._runtime = None
    tpu_air_torch.init(num_cpus=1, num_chips=2)
    try:
        runs = {}
        for workers in (2, 1):
            runs[workers] = T5Trainer(
                model_config=T5Config.tiny(),
                training_args=TrainingArguments(learning_rate=1e-4, num_train_epochs=2,
                                                per_device_train_batch_size=8 // workers,
                                                evaluation_strategy="no", seed=3),
                scaling_config=ScalingConfig(num_workers=workers),
                datasets={"train": rows},
                run_config=RunConfig(storage_path=str(tmp_path / f"w{workers}"))).fit()
        runtime = rt.get_runtime()
        assert runtime.avail["chip"] == 2.0 and sorted(runtime.free_chips) == [0, 1]
    finally:
        tpu_air_torch.shutdown()
        rt._runtime = saved
    two, one = runs[2], runs[1]
    assert two.error is None and one.error is None, (two.error, one.error)
    assert [m["mesh_data"] for m in two.metrics_history] == [2, 2]
    np.testing.assert_allclose([m["loss"] for m in two.metrics_history],
                               [m["loss"] for m in one.metrics_history], rtol=1e-6)
    got, want = two.checkpoint.get_params(), one.checkpoint.get_params()
    flat = lambda p: torch.cat([p[k].reshape(-1).double() for k in sorted(want)])  # noqa: E731
    assert ((flat(got) - flat(want)).norm() / flat(want).norm()).item() < 1e-6
