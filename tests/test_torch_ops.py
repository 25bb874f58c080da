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
