"""The port's attention ops on the CPU against the JAX package's.

The same inputs, made from a numpy seed, go through the JAX Pallas kernels
(interpret mode on the CPU), the JAX references and the port's plain
versions.  Everything is float32; the tolerances (2e-5) cover summation
order only.  On CPU tensors the port's wrappers take the plain versions, so
the kernel launch counters stay at 0.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import importlib  # noqa: E402

# tpu_air.ops re-exports the functions under the modules' names
jdec = importlib.import_module("tpu_air.ops.decode_attention")
jflash = importlib.import_module("tpu_air.ops.flash_attention")
from tpu_air_torch.ops import decode_attention as tdec  # noqa: E402
from tpu_air_torch.ops import flash_attention as tflash  # noqa: E402

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one torch thread, so these tests add little CPU load
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flash_inputs(bias_lead, seed=0, b=2, h=4, lq=64, lk=64, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b * h, lk, d)).astype(np.float32)
    v = rng.standard_normal((b * h, lk, d)).astype(np.float32)
    lead = {"1": 1, "H": h, "BH": b * h, None: 0}[bias_lead]
    bias = rng.standard_normal((lead, lq, lk)).astype(np.float32) if lead else None
    # padded tail on row 0, every key masked on row 1
    mask = (np.arange(lk)[None] < np.array([lk - 9, 0])[:, None]).astype(np.float32)
    return q, k, v, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("bias_lead", [None, "1", "H", "BH"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_matches_jax(bias_lead, with_mask, causal):
    q, k, v, bias, mask = _flash_inputs(bias_lead)
    if not with_mask:
        mask = None
    got, got_lse = tflash.flash_attention_reference(
        _t(q), _t(k), _t(v), _t(bias), _t(mask), 1.0, causal)
    # the Pallas kernel in interpret mode, 32-wide tiles (2 x 2 grid)
    want = jflash.flash_attention(_j(q), _j(k), _j(v), _j(bias), kv_mask=_j(mask),
                                  scale=1.0, causal=causal, block_q=32,
                                  block_k=32, interpret=True)
    addmask = None if mask is None else (1.0 - _j(mask)) * jflash._NEG_INF
    ref_out, ref_lse = jflash._reference_pair(_j(q), _j(k), _j(v), _j(bias),
                                              addmask, 1.0, causal)
    # Rows with at least one valid key agree with both JAX versions.  A row
    # whose every key is masked is padding: the port gives the mean of its
    # visible V; the JAX reference's exp(s - lse) weighs each key 1 there
    # (f32 cannot hold -1e30 + log Lk), and under causal the Pallas kernel's
    # answer depends on its tiles.
    live = np.ones(q.shape[0], bool) if mask is None else np.repeat(mask.max(1) > 0, 4)
    for name, ref in (("pallas", want), ("reference", ref_out)):
        np.testing.assert_allclose(got.numpy()[live], np.asarray(ref)[live],
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    np.testing.assert_allclose(got_lse.numpy()[live], np.asarray(ref_lse)[live],
                               atol=1e-4, rtol=ATOL)
    dead = ~live
    if dead.any():
        vd = v[dead].astype(np.float64)
        if causal:   # mean of V[0..i] for query i
            mean_v = np.cumsum(vd, 1) / np.arange(1, vd.shape[1] + 1)[None, :, None]
        else:
            mean_v = np.broadcast_to(vd.mean(1, keepdims=True), vd.shape)
            np.testing.assert_allclose(np.asarray(want)[dead], mean_v, atol=ATOL)
        np.testing.assert_allclose(got.numpy()[dead], mean_v, atol=ATOL)


def test_flash_wrapper_4d_and_scale_on_cpu():
    """The public wrapper on (B, H, L, D) CPU tensors, strided views as the
    model passes them, with the default 1/sqrt(D) scale."""
    q, k, v, bias, mask = _flash_inputs("H", seed=1)
    b, h, L, d = 2, 4, 64, 16
    as4 = lambda a: _t(a.reshape(b, h, L, d)).transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    before = tflash.flash_attention.launches
    out = tflash.flash_attention(as4(q), as4(k), as4(v), _t(bias)[None],
                                 kv_mask=_t(mask))
    assert tflash.flash_attention.launches == before == 0
    want = jflash.flash_attention(_j(q), _j(k), _j(v), _j(bias), kv_mask=_j(mask),
                                  interpret=True)
    np.testing.assert_allclose(out.reshape(b * h, L, d).numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)


def _dk_inputs(b=3, L=96, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, L, h, d)).astype(np.float32)
    v = rng.standard_normal((b, L, h, d)).astype(np.float32)
    bias = rng.standard_normal((h, L)).astype(np.float32)
    mask = (rng.integers(0, 2, (b, L)) | (np.arange(L) < 2)).astype(np.float32)
    return q, k, v, bias, mask


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_decode_reference_matches_jax(with_bias, with_mask):
    q, k, v, bias, mask = _dk_inputs()
    kw_t, kw_j = {}, {}
    if with_bias:
        kw_t["bias"], kw_j["bias"] = _t(bias), _j(bias)
    if with_mask:
        kw_t["kv_mask"], kw_j["kv_mask"] = _t(mask), _j(mask)
    b, L = k.shape[:2]
    # the port takes the flat [b, L, h*d] slab the model caches
    got = tdec.decode_attention_reference(_t(q), _t(k.reshape(b, L, -1)),
                                          _t(v.reshape(b, L, -1)), **kw_t)
    want_kernel = jdec.decode_attention(_j(q), _j(k), _j(v), block_k=32,
                                        interpret=True, **kw_j)
    want_ref = jdec.decode_attention_reference(_j(q), _j(k), _j(v), **kw_j)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kind", ["pos", "chan"])
def test_decode_reference_int8_matches_jax(kind):
    """int8 slabs with per-position or per-channel scales; the port takes
    them flat ([b, L, h] / [b, 1, h*d]), the JAX package 4-D."""
    b, L, h, d = 3, 96, 4, 16
    rng = np.random.default_rng(1)
    q, _, _, bias, mask = _dk_inputs()
    k8 = rng.integers(-127, 128, (b, L, h, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, L, h, d)).astype(np.int8)
    shape = (b, L, h, 1) if kind == "pos" else (b, 1, h, d)
    ks = rng.uniform(0.001, 0.02, shape).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, shape).astype(np.float32)
    flat_s = (b, L, h) if kind == "pos" else (b, 1, h * d)
    got = tdec.decode_attention_reference(
        _t(q), _t(k8.reshape(b, L, -1)), _t(v8.reshape(b, L, -1)), bias=_t(bias),
        kv_mask=_t(mask), k_scale=_t(ks.reshape(flat_s)), v_scale=_t(vs.reshape(flat_s)))
    kw = dict(bias=_j(bias), kv_mask=_j(mask), k_scale=_j(ks), v_scale=_j(vs))
    want_kernel = jdec.decode_attention(_j(q), _j(k8), _j(v8), block_k=32,
                                        interpret=True, **kw)
    want_ref = jdec.decode_attention_reference(_j(q), _j(k8), _j(v8), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL, rtol=ATOL)


def test_decode_fully_masked_row_is_mean_v():
    q, k, v, _, mask = _dk_inputs()
    mask[1] = 0.0
    b, L = k.shape[:2]
    got = tdec.decode_attention(_t(q), _t(k.reshape(b, L, -1)), _t(v.reshape(b, L, -1)),
                                kv_mask=_t(mask))
    want = jdec.decode_attention(_j(q), _j(k), _j(v), kv_mask=_j(mask), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy()[1, 0], v[1].mean(0), atol=ATOL)


# -- the decode kernel's split-K arithmetic ----------------------------------


def _split_decode_mirror(q, k, v, bias=None, kv_mask=None, k_scale=None, v_scale=None, *,
                         chunk):
    """What csrc/decode_attention.cu computes, step for step in torch: per
    (b, h) and chunk of ``chunk`` positions, the f32 softmax state (m, den,
    acc) over the chunk's range from its first live key to its last, masked
    keys inside it at weight 0; (-1e20, 0, 0), K/V unread, for a chunk
    without a live key in a row that has one; every position, each at the
    -1e20 floor, in a row without one.  Then the states merge.  q [b, h, d];
    k/v [b, L, h*d]; scales flat.  Returns the output and the number of
    (b, h, position) K/V reads."""
    b, h, d = q.shape
    L = k.shape[1]
    kf, vf = k.reshape(b, L, h, d).float(), v.reshape(b, L, h, d).float()
    qf = q.float()
    k_kind = tdec._scale_kind(k_scale, b, L, h, d, "k_scale")
    v_kind = tdec._scale_kind(v_scale, b, L, h, d, "v_scale")
    if k_kind == tdec._CHAN:
        qf = qf * k_scale.reshape(b, h, d)
    floor = tdec.MASK_FLOOR
    out, reads = torch.empty(b, h, d), 0
    for bi in range(b):
        live = None if kv_mask is None else kv_mask[bi] > 0
        drop = live is not None and bool(live.any())
        for hi in range(h):
            states = []
            for c0 in range(0, L, chunk):
                idx = torch.arange(c0, min(L, c0 + chunk))
                if drop:
                    first_last = idx[live[idx]]
                    if first_last.numel() == 0:          # skipped
                        states.append((floor, 0.0, torch.zeros(d)))
                        continue
                    idx = torch.arange(int(first_last[0]), int(first_last[-1]) + 1)
                reads += idx.numel()
                s = kf[bi, idx, hi] @ qf[bi, hi]
                if k_kind == tdec._POS:
                    s = s * k_scale[bi, idx, hi]
                if bias is not None:
                    s = s + bias[hi, idx]
                if live is not None:
                    s = s + torch.where(live[idx], 0.0, floor)
                    if drop:
                        s = torch.where(live[idx], s, float("-inf"))
                m = max(float(s.max()), floor)
                p = torch.exp(s - m)
                pv = p * v_scale[bi, idx, hi] if v_kind == tdec._POS else p
                states.append((m, float(p.sum()), pv @ vf[bi, idx, hi]))
            top = max(st[0] for st in states)
            w = [np.exp(np.float64(st[0] - top)) for st in states]
            den = sum(wi * st[1] for wi, st in zip(w, states))
            acc = sum(float(wi) * st[2] for wi, st in zip(w, states))
            o = acc / max(den, 1e-20)
            if v_kind == tdec._CHAN:
                o = o * v_scale.reshape(b, h, d)[bi, hi]
            out[bi, hi] = o
    return out.to(q.dtype), reads


@pytest.mark.parametrize("chunk", [16, 40, 64])
@pytest.mark.parametrize("case", ["splits", "masked_chunks", "all_pad", "one_chunk",
                                  "int8_pos", "int8_chan"])
def test_decode_split_mirror_matches_references(case, chunk):
    """The split-K merge and the masked-chunk skip, mirrored in torch,
    against the port's plain version and the JAX reference: several chunks
    (L = 100 is no multiple of any), padded rows whose tails are whole
    masked chunks, an all-pad row (mean(V), every chunk read), live keys in
    one chunk only, and both int8 scale kinds.  The mirror reads K/V only
    where the kernel does: the live range of each row, all of an all-pad
    row."""
    b, L, h, d = 4, 100, 3, 16
    rng = np.random.default_rng(chunk)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, L, h, d)).astype(np.float32)
    v = rng.standard_normal((b, L, h, d)).astype(np.float32)
    lens = np.array([L, 37, 1, 0 if case == "all_pad" else 70])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    kw = {"kv_mask": mask}
    if case == "splits":
        causal = np.where(np.arange(L) <= 60, 0.0, -1e9)
        kw = {"bias": (rng.standard_normal((h, L)) + causal).astype(np.float32)}
    elif case == "one_chunk":
        mask[:] = 0.0
        mask[:, chunk + 2:chunk + 5] = 1.0
    elif case.startswith("int8"):
        k = rng.integers(-127, 128, (b, L, h, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, L, h, d)).astype(np.int8)
        shape = (b, L, h, 1) if case == "int8_pos" else (b, 1, h, d)
        kw["k_scale"] = rng.uniform(0.001, 0.02, shape).astype(np.float32)
        kw["v_scale"] = rng.uniform(0.001, 0.02, shape).astype(np.float32)
    flat_s = (b, L, h) if case == "int8_pos" else (b, 1, h * d)
    kw_t = {n: _t(a.reshape(flat_s) if n.endswith("scale") else a) for n, a in kw.items()}
    tq, tk, tv = _t(q)[:, 0], _t(k.reshape(b, L, -1)), _t(v.reshape(b, L, -1))
    got, reads = _split_decode_mirror(tq, tk, tv, **kw_t, chunk=chunk)
    want = tdec.decode_attention_reference(tq, tk, tv, **kw_t)
    want_jax = jdec.decode_attention_reference(_j(q), _j(k), _j(v),
                                               **{n: _j(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax)[:, 0], atol=ATOL, rtol=ATOL)
    if case == "splits":
        assert reads == b * h * L
    elif case == "one_chunk":
        assert reads == b * h * 3
    else:
        needed = np.where(lens == 0, L, lens)       # an all-pad row reads every key
        assert reads == h * int(needed.sum())
    if case == "all_pad":
        np.testing.assert_allclose(got.numpy()[3], v[3].astype(np.float32).mean(0), atol=ATOL)


@pytest.mark.parametrize("b,h,L,chunks", [
    (64, 12, 512, 1), (64, 12, 129, 1),        # the W3 cross and self steps
    (48, 12, 512, 1), (32, 12, 512, 3),        # just over and under half a wave
    (8, 12, 4096, 8), (8, 12, 4133, 9), (1, 12, 4096, 32), (1, 12, 4133, 33),
    (5, 3, 129, 2), (1, 3, 4096, 32), (1, 12, 100, 1),
])
def test_decode_split_chunk(b, h, L, chunks):
    """The kernel splits L only while b*h blocks fill less than half a wave
    of six blocks on each of an H100's 132 SMs, up to that wave, into
    chunks of at least 128 positions, multiples of 64, and never into an
    empty chunk."""
    chunk = tdec.split_chunk(b, h, L, 132)
    assert -(-L // chunk) == chunks
    assert chunk == L or (chunk % 64 == 0 and chunk >= tdec._MIN_CHUNK)
    assert (chunks - 1) * chunk < L


def test_cpu_wrappers_take_plain_versions():
    """On CPU tensors the wrappers compute the plain versions and never
    count a kernel launch; a bad scale shape is rejected like the JAX op."""
    q, k, v, bias, mask = _dk_inputs()
    b, L = k.shape[:2]
    tdec.decode_attention.launches = 0
    tflash.flash_attention.launches = 0
    out = tdec.decode_attention(_t(q), _t(k.reshape(b, L, -1)), _t(v.reshape(b, L, -1)),
                                bias=_t(bias)[None, :, None, :], kv_mask=_t(mask))
    ref = tdec.decode_attention_reference(_t(q), _t(k), _t(v), bias=_t(bias),
                                          kv_mask=_t(mask))
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    fq, fk, fv, fb, fm = _flash_inputs("H")
    out, lse = tflash.flash_attention_with_lse(_t(fq), _t(fk), _t(fv), _t(fb),
                                               kv_mask=_t(fm), scale=1.0)
    ref, ref_lse = tflash.flash_attention_reference(_t(fq), _t(fk), _t(fv), _t(fb),
                                                    _t(fm), 1.0, False)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
    assert tdec.decode_attention.launches == 0
    assert tflash.flash_attention.launches == 0
    with pytest.raises(ValueError, match="neither per-position"):
        tdec.decode_attention(_t(q), _t(k), _t(v), k_scale=torch.ones(3, 2, 4, 16),
                              v_scale=torch.ones(3, 2, 4, 16))
    with pytest.raises(ValueError, match="qlen==1"):
        tdec.decode_attention(torch.zeros(3, 2, 4, 16), _t(k), _t(v))


# -- the backward ---------------------------------------------------------


def _bwd_inputs(seed=0, b=2, h=4, L=64, d=16):
    """q/k/v/do (B*H, L, D), an lse cotangent, and a key mask with a padded
    tail on batch row 0 and every key masked on batch row 1."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b * h, L, d)).astype(np.float32) for _ in range(4))
    glse = rng.standard_normal((b * h, L)).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([L - 9, 0])[:, None]).astype(np.float32)
    return q, k, v, do, glse, mask


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_reference_matches_pallas_bwd(with_mask, causal):
    """The port's plain backward against the JAX package's blockwise
    backward (both Pallas kernels, interpret mode, 32-wide tiles) from the
    same saved (out, lse), with a nonzero lse cotangent.  Rows whose every
    key is masked get exactly zero gradients in both."""
    q, k, v, do, glse, mask = _bwd_inputs()
    if not with_mask:
        mask = None
    scale = 0.25
    out, lse = tflash.flash_attention_reference(_t(q), _t(k), _t(v), None, _t(mask),
                                                scale, causal)
    got = tflash.flash_attention_backward_reference(
        _t(q), _t(k), _t(v), _t(mask), out, lse, _t(do), _t(glse), scale, causal)
    addmask = None if mask is None else (1.0 - _j(mask)) * jflash._NEG_INF
    want = jflash._pallas_bwd(_j(q), _j(k), _j(v), addmask, jnp.asarray(out.numpy()),
                              jnp.asarray(lse.numpy()), _j(do), _j(glse), scale, causal,
                              32, 32, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL,
                                   err_msg=name)
        if mask is not None:
            assert np.abs(g.numpy()[4:]).max() == 0.0, name   # batch row 1: all masked


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax_grad(with_mask, causal):
    """Autograd through the port's flash attention (both outputs used, so a
    nonzero lse cotangent) equals jax.grad of flash_attention_with_lse,
    (B, H, L, D) strided views as the model passes them."""
    q, k, v, _, w, mask = _bwd_inputs(seed=1)
    if not with_mask:
        mask = None
    b, h, L, d = 2, 4, 64, 16

    def as4(a):
        return _t(a.reshape(b, h, L, d)).transpose(1, 2).contiguous().transpose(1, 2)

    tq, tk, tv = (as4(a).requires_grad_() for a in (q, k, v))
    out, lse = tflash.flash_attention_with_lse(tq, tk, tv, kv_mask=_t(mask), causal=causal)
    ((out * 0.3).sum() + (lse * _t(w).reshape(b, h, L)).sum()).backward()

    def f(q, k, v):
        o, lse = jflash.flash_attention_with_lse(q, k, v, kv_mask=_j(mask), causal=causal,
                                                 block_q=32, block_k=32, interpret=True)
        return (o * 0.3).sum() + (lse * _j(w)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    for name, t, g in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.reshape(b * h, L, d).numpy(), np.asarray(g),
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    assert tflash.flash_attention.launches == 0
    assert tflash.flash_attention_backward.dq_launches == 0
    assert tflash.flash_attention_backward.dkv_launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_gets_zero_gradient(causal):
    """A query row whose every key is masked is padding: its forward output
    is the mean of V, but its gradient is exactly zero (the JAX package's
    custom VJP, tests/test_ops.py::test_fully_masked_row_grads_are_finite_
    and_small).  Autograd of the plain forward would give that row's keys a
    uniform, nonzero dv."""
    q, k, v, _, _, mask = _bwd_inputs(seed=2)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tflash.flash_attention(tq, tk, tv, kv_mask=_t(mask), causal=causal).sum().backward()
    for t in (tq, tk, tv):
        assert torch.isfinite(t.grad).all()
        assert t.grad[4:].abs().max().item() == 0.0      # batch row 1: all masked
        assert t.grad[:4].abs().max().item() > 0.0


def test_flash_bias_grads_recompute_through_reference():
    """With a bias the backward recomputes through the plain forward under
    autograd, as the JAX package's VJP does, and returns the bias gradient
    in the bias's own (batch-shared) shape; the key mask gets none."""
    q, k, v, bias, mask = _flash_inputs("H")
    mask[1] = 1.0                     # no fully masked row: both VJPs agree
    tq, tk, tv, tb = (_t(a).requires_grad_() for a in (q, k, v, bias))
    tflash.flash_attention(tq, tk, tv, tb, kv_mask=_t(mask), scale=1.0).sum().backward()

    def f(q, k, v, bias):
        return jflash.flash_attention(q, k, v, bias, kv_mask=_j(mask), scale=1.0,
                                      block_q=32, block_k=32, interpret=True).sum()

    want = jax.grad(f, argnums=(0, 1, 2, 3))(_j(q), _j(k), _j(v), _j(bias))
    for name, t, g in zip(("dq", "dk", "dv", "dbias"), (tq, tk, tv, tb), want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


# -- float16 (the reference's W3 load type) ----------------------------------
# Outputs in f16 from the same f16 inputs.  Both sides compute in f32; the
# Pallas kernels round p (and ds) to f16 before their products, the plain
# versions do not, and each output is one f16 rounding of its f32 value.
# Values here are O(1), where one f16 ulp is at most 2^-10 * 2 = 2e-3.
F16_TOL = 4e-3


def _f16(a):
    return None if a is None else a.astype(np.float16)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_f16_matches_pallas(causal):
    """The plain forward in f16 against the Pallas kernel in f16
    (interpret mode), bias and key mask with a fully masked row."""
    q, k, v, bias, mask = _flash_inputs("H", seed=3)
    got, lse = tflash.flash_attention_reference(_t(_f16(q)), _t(_f16(k)), _t(_f16(v)),
                                                _t(bias), _t(mask), 1.0, causal)
    assert got.dtype == torch.float16 and lse.dtype == torch.float32
    want = jflash.flash_attention(_j(_f16(q)), _j(_f16(k)), _j(_f16(v)), _j(bias),
                                  kv_mask=_j(mask), scale=1.0, causal=causal,
                                  block_q=32, block_k=32, interpret=True)
    assert want.dtype == jnp.float16
    live = np.repeat(mask.max(1) > 0, 4)
    np.testing.assert_allclose(got.float().numpy()[live],
                               np.asarray(want, np.float32)[live], atol=F16_TOL, rtol=F16_TOL)
    assert torch.isfinite(got.float()).all()      # the fully masked row: mean(V), finite


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_f16_matches_pallas_bwd(causal):
    """The plain backward in f16 against both Pallas backward kernels in f16
    (interpret mode) from the same saved (out, lse); the fully masked row's
    gradients are exactly zero in both."""
    q, k, v, do, glse, mask = _bwd_inputs(seed=4)
    q, k, v, do = (_f16(a) for a in (q, k, v, do))
    scale = 0.25
    out, lse = tflash.flash_attention_reference(_t(q), _t(k), _t(v), None, _t(mask),
                                                scale, causal)
    got = tflash.flash_attention_backward_reference(
        _t(q), _t(k), _t(v), _t(mask), out, lse, _t(do), _t(glse), scale, causal)
    addmask = (1.0 - _j(mask)) * jflash._NEG_INF
    want = jflash._pallas_bwd(_j(q), _j(k), _j(v), addmask, jnp.asarray(out.numpy()),
                              jnp.asarray(lse.numpy()), _j(do), _j(glse), scale, causal,
                              32, 32, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=F16_TOL, rtol=F16_TOL, err_msg=name)
        assert np.abs(g.float().numpy()[4:]).max() == 0.0, name


@pytest.mark.parametrize("with_mask", [False, True])
def test_decode_f16_matches_jax(with_mask):
    """The plain decode step in f16 against the Pallas kernel in f16
    (interpret mode), with the decode self step's bias."""
    q, k, v, bias, mask = _dk_inputs(seed=5)
    q, k, v = _f16(q), _f16(k), _f16(v)
    kw_t, kw_j = {"bias": _t(bias)}, {"bias": _j(bias)}
    if with_mask:
        mask[1] = 0.0                                  # an all-pad row
        kw_t["kv_mask"], kw_j["kv_mask"] = _t(mask), _j(mask)
    b, L = k.shape[:2]
    got = tdec.decode_attention_reference(_t(q), _t(k.reshape(b, L, -1)),
                                          _t(v.reshape(b, L, -1)), **kw_t)
    want = jdec.decode_attention(_j(q), _j(k), _j(v), block_k=32, interpret=True, **kw_j)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=F16_TOL, rtol=F16_TOL)
