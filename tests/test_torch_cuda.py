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
        decode_attention, decode_attention_reference, split_chunk)

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
        c = split_chunk(b, h, L, torch.cuda.get_device_properties(dev).multi_processor_count)
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


def _edge_mask(L, dev):
    """Key mask of three batch rows: full, ragged, fully masked."""
    m = np.arange(L)[None] < np.array([L, max(1, L - 37), 0])[:, None]
    return _t(m, dev, torch.float32)


# lengths at every edge of the tensor-core kernels' 64-row tiles (and the
# 32-row query tiles of the D=128 dk/dv kernel)
EDGE_LENGTHS = [1, 63, 64, 65, 129, 200]


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", EDGE_LENGTHS)
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
    the tensor-core kernels' cp.async copies: the wrapper copies it to a
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
