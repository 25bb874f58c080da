"""Card tests of the port's CUDA kernels against their plain versions.

They need an NVIDIA GPU with nvcc and skip elsewhere.  Run them on the card
with ``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the
repo's conftest imports the JAX package, which the card machine may lack).

Tolerances, on |kernel - plain| / max(1, |plain|): the kernels and the plain
versions both compute in f32 from the same inputs and differ only in
summation order (f32: 1e-4); a bf16 output is one rounding of that f32
value, up to 2^-7 of it apart (bf16: 2e-2).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("L", [129, 512])
@pytest.mark.parametrize("case", ["bias", "mask", "int8_pos", "int8_chan"])
def test_decode_kernel_matches_plain(dev, dtype, d, L, case):
    from tpu_air_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    rng = np.random.default_rng(L + d)
    b, h = 5, 3
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
        m = np.arange(L)[None] < np.array([L, L // 2, 1, 0, 7])[:, None]
        kw["kv_mask"] = _t(m, dev, torch.float32)   # one fully-masked row
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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention

    q = torch.zeros(2, 4, 8, 24, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q16 = torch.zeros(2, 4, 8, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q16, q16, q16)
    qd = torch.zeros(2, 1, 4, 16, device=dev)
    kd = torch.zeros(2, 9, 64, device=dev)
    with pytest.raises(ValueError, match="int8"):
        decode_attention(qd, kd, kd, k_scale=torch.ones(2, 9, 4, device=dev),
                         v_scale=torch.ones(2, 9, 4, device=dev))
