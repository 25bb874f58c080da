#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_air_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and ``nvcc``; it imports nothing of JAX or ``tpu_air``.

Phases, each fatal on failure:

1. build   — compile every kernel of ``tpu_air_torch/ops/csrc`` (one nvcc per
             source, started together) and print the card's name and power
             limit;
2. compare — each kernel against its plain PyTorch version on the card, at the
             main path's shapes and at edge cases (masked rows, causal,
             ragged lengths, int8 slabs), against a stated tolerance;
3. main    — FLAN-T5-base width (12+12 layers, d_model 768, 12 heads, vocab
             32128) in bf16 with weights from a numpy seed at T5's initializer
             scales: the ``T5GenerativePredictor`` generates greedily for 64
             prompts of 512 tokens (padded lengths, one all-pad row), 128 new
             tokens; every kernel's launch count is read around the first
             such run; then encode and decode-step times, and the decode
             step's device busy time from ``torch.profiler``;
4. parity  — the same model in f32 generates for a few prompts through the
             kernels and through the plain versions on the card; greedy
             tokens must agree;
5. timing  — device time (profiler) of each kernel, its plain version and
             one PyTorch library call (``scaled_dot_product_attention``) at
             the main path's shapes,
             beside the least time the card could take (bytes over 3.35 TB/s,
             flops over 989 TFLOP/s, the H100 SXM data-sheet peaks).

The line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12   # H100 SXM dense bf16 tensor cores
# Tolerances on |kernel - plain| / max(1, |plain|).  Both compute in f32 from
# the same inputs and differ in summation order (f32: 1e-4); a bf16 output is
# one rounding of that f32 value, up to 2^-7 of it apart (bf16: 2e-2).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SEED = 0
# main-path dials: W3 batch generation at the reference's max_new_tokens=128
BATCH, PROMPT_LEN, NEW_TOKENS = 64, 512, 128
SMALL_BATCH, RAGGED_LEN = 8, 200          # edge cases of the compare phase
PARITY_BATCH, PARITY_NEW = 4, 32
PREDICT_REPEATS = 3                       # timed predict runs (median reported)


def model_config():
    from tpu_air_torch.models.t5.config import T5Config

    cfg = T5Config.flan_t5_base()
    cfg.dropout_rate = 0.0
    return cfg


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Host time of one call without waiting for the device (launch cost)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def step_times_ms(fn, n: int):
    """Device-clock time of each of ``n`` back-to-back calls of ``fn``, gaps
    waiting for the host included (CUDA events between calls)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])


def device_busy(fn, steps: int):
    """Device time per call of ``fn`` summed over the kernels the profiler
    saw, and the heaviest kernels: [(name, ms per call, launches per call)]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return busy, [(e.key[:60], e.self_device_time_total / 1e3 / steps, e.count / steps)
                  for e in top]


def needed_keys(mask, L: int):
    """Keys each batch row needs: its valid keys, or all L for an all-pad row
    (whose output is the mean of V)."""
    keys = (mask > 0).sum(dim=1).cpu()
    return torch.where(keys == 0, torch.full_like(keys, L), keys)


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launches, as the profiler records them, summed and averaged over
    ``iters`` calls.  Unlike back-to-back event timing this does not read
    host dispatch into a small kernel's time."""
    return device_busy(fn, iters)[0]


def bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def scaled_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs() / want.abs().clamp(min=1.0)).max().item()


# -- phase 1 -----------------------------------------------------------------


def build() -> None:
    from tpu_air_torch.ops import _build

    names = _build.sources()
    t0 = time.perf_counter()
    _build.build(names)
    log(f"[build] {names} built for sm_90a in {time.perf_counter() - t0:.1f} s")


# -- phase 2 -----------------------------------------------------------------


def flash_inputs(rng, b, h, L, d, dtype, dev, bias=True, mask=True):
    def t(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    # the model's layout: [b, L, h, d] projections seen as (b, h, L, d) views
    q, k, v = (t((b, L, h, d)).transpose(1, 2) for _ in range(3))
    bias_t = t((1, h, L, L), torch.float32) if bias else None
    mask_t = None
    if mask:
        lens = rng.integers(L // 8, L + 1, b)
        lens[0], lens[-1] = L, 0                    # one full row, one all-pad
        mask_t = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(dev)
    return q, k, v, bias_t, mask_t


def flash_plain(q, k, v, bias, mask, causal=False):
    from tpu_air_torch.ops.flash_attention import flash_attention_reference

    b, h, lq, d = q.shape
    flat = [x.reshape(b * h, x.shape[2], d) for x in (q, k, v)]
    b3 = None if bias is None else bias[0]
    return flash_attention_reference(*flat, b3, mask, 1.0, causal)[0].reshape(b, h, lq, d)


def decode_inputs(rng, b, L, h, d, dtype, dev, kind):
    def t(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    q = t((b, 1, h, d))
    kw = {}
    if kind.startswith("int8"):
        k = torch.from_numpy(rng.integers(-127, 128, (b, L, h * d), dtype=np.int8)).to(dev)
        v = torch.from_numpy(rng.integers(-127, 128, (b, L, h * d), dtype=np.int8)).to(dev)
        shape = (b, L, h) if kind == "int8_pos" else (b, 1, h * d)
        kw["k_scale"] = torch.from_numpy(rng.uniform(1e-3, 2e-2, shape).astype(np.float32)).to(dev)
        kw["v_scale"] = torch.from_numpy(rng.uniform(1e-3, 2e-2, shape).astype(np.float32)).to(dev)
    else:
        k, v = t((b, L, h * d)), t((b, L, h * d))
    if kind in ("self", "int8_pos"):
        # the decode self step: position bias plus the causal row at -1e9
        pos = L // 2
        causal = np.where(np.arange(L) <= pos, 0.0, -1e9).astype(np.float32)
        kw["bias"] = (t((h, L), torch.float32) + torch.from_numpy(causal).to(dev)).contiguous()
    if kind in ("cross", "int8_chan"):
        lens = rng.integers(L // 8, L + 1, b)
        lens[0], lens[-1] = L, 0
        kw["kv_mask"] = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(dev)
    return q, k, v, kw


def compare(dev) -> dict:
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference
    from tpu_air_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(SEED)
    cfg = model_config()
    B, H, L, D, SB = BATCH, cfg.num_heads, PROMPT_LEN, cfg.d_kv, SMALL_BATCH
    errs = {}

    def check(name, got, want, dtype):
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"[compare] {name}: non-finite output")
        err, rel = max_err(got, want), scaled_err(got, want)
        log(f"[compare] {name}: max abs err {err:.3e}, scaled {rel:.3e} "
            f"(tol {TOL[dtype]:.0e})")
        if not rel < TOL[dtype]:
            raise AssertionError(f"[compare] {name}: {rel} >= {TOL[dtype]}")
        errs[name] = err

    # kernel 1 at the encoder shape: batch-shared bias, padded key mask with
    # a fully-masked row, scale 1.0; then no bias, causal, ragged L
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, bias, mask = flash_inputs(rng, B, H, L, D, dtype, dev)
        check(f"flash {tag} encoder bias+mask",
              flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0),
              flash_plain(q, k, v, bias, mask), dtype)
        q, k, v, _, mask = flash_inputs(rng, SB, H, L, D, dtype, dev, bias=False)
        check(f"flash {tag} B{SB} no bias", flash_attention(q, k, v, kv_mask=mask, scale=1.0),
              flash_plain(q, k, v, None, mask), dtype)
        q, k, v, bias, _ = flash_inputs(rng, SB, H, L, D, dtype, dev, mask=False)
        check(f"flash {tag} B{SB} causal",
              flash_attention(q, k, v, bias, scale=1.0, causal=True),
              flash_plain(q, k, v, bias, None, causal=True), dtype)
        q, k, v, bias, mask = flash_inputs(rng, SB, H, RAGGED_LEN, D, dtype, dev)
        check(f"flash {tag} B{SB} L{RAGGED_LEN} ragged bias+mask",
              flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0),
              flash_plain(q, k, v, bias, mask), dtype)

    # kernel 2 at the decode step shapes: self (L = 128 + 1, bias with the
    # causal row) and cross (L = 512, key mask), full-width and int8
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for kind, Lk in (("self", NEW_TOKENS + 1), ("cross", L),
                         ("int8_pos", NEW_TOKENS + 1), ("int8_chan", L)):
            q, k, v, kw = decode_inputs(rng, B, Lk, H, D, dtype, dev, kind)
            check(f"decode {tag} {kind}", decode_attention(q, k, v, **kw),
                  decode_attention_reference(q, k, v, **kw), dtype)
    return errs


# -- phases 3 and 4 ------------------------------------------------------------


def base_model(dtype: str, dev):
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration

    cfg = model_config()
    cfg.dtype = dtype
    return T5ForConditionalGeneration(cfg, device=dev).init_weights(SEED)


def prompts(n: int, L: int, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 4, L + 1, n)
    lens[0] = L
    lens[-1] = 0                                    # one all-pad row
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(2, vocab, (n, L)) * mask
    return ids, mask


def main_path(dev) -> dict:
    from tpu_air_torch.models.t5.generate import init_cache
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention
    from tpu_air_torch.predict.predictors import T5GenerativePredictor

    t0 = time.perf_counter()
    model = base_model("bfloat16", dev)
    cfg = model.config
    log(f"[main] {cfg.d_model} wide, {cfg.num_layers}+{cfg.num_decoder_layers} layers, bf16, "
        f"{sum(p.numel() for p in model.parameters())} "
        f"params from numpy seed {SEED}, built in {time.perf_counter() - t0:.1f} s")
    predictor = T5GenerativePredictor(model)
    n, L, new = BATCH, PROMPT_LEN, NEW_TOKENS
    ids, mask = prompts(n, L, cfg.vocab_size, SEED + 1)
    batch = {"input_ids": ids, "attention_mask": mask}
    predictor.predict(batch, max_new_tokens=2)      # warm-up at the same shapes

    flash_attention.launches = 0
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = predictor.predict(batch, max_new_tokens=new)
    walls = [time.perf_counter() - t0]
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    for _ in range(PREDICT_REPEATS - 1):         # more samples of the wall time
        t0 = time.perf_counter()
        again = predictor.predict(batch, max_new_tokens=new)
        walls.append(time.perf_counter() - t0)
        if list(again["generated_output"]) != list(out["generated_output"]):
            raise AssertionError("[main] greedy outputs changed between runs")
    wall = float(np.median(walls))

    rows = [np.array(s.split(), dtype=np.int64) for s in out["generated_output"]]
    toks = np.stack(rows)
    if toks.shape != (n, new):
        raise AssertionError(f"[main] generated {toks.shape}, expected {(n, new)}")
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("[main] token ids out of the vocabulary")
    if (toks[-1] != cfg.pad_token_id).any():
        raise AssertionError("[main] the all-pad row did not stay finished")
    emitted = 0
    for row in toks[:-1]:
        eos = np.flatnonzero(row == cfg.eos_token_id)
        emitted += int(eos[0]) + 1 if eos.size else new
    steps = launches["decode_attention"] // (2 * cfg.num_decoder_layers)
    log(f"[main] predict: {n} prompts x {L} tokens -> {new} new tokens, median of "
        f"{len(walls)} runs {wall:.3f} s (runs {', '.join(f'{w:.3f}' for w in walls)}), "
        f"{emitted / wall:.1f} generated tokens/s, {steps} decode steps")
    log(f"[main] launches: {launches} (expect flash = {cfg.num_layers} per generate, "
        f"decode = 2 x {cfg.num_decoder_layers} per step)")
    if launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"[main] flash launches {launches['flash_attention']}")
    if launches["decode_attention"] <= 0 or \
            launches["decode_attention"] != steps * 2 * cfg.num_decoder_layers:
        raise AssertionError(f"[main] decode launches {launches['decode_attention']}")

    # phase times through the model's own entry points (not counted above)
    tids = torch.from_numpy(ids).to(dev)
    tmask = torch.from_numpy(mask).to(dev)
    with torch.no_grad():
        enc_ms = time_ms(lambda: model.encode(tids, tmask), iters=5, warmup=1)
        enc = model.encode(tids, tmask)
        cache = init_cache(model, n, new + 1, enc, tmask)
        tok = torch.zeros(n, 1, dtype=torch.long, device=dev)
        model.decode(tok, cache=cache)                   # warm-up step
        steps_ms = step_times_ms(lambda: model.decode(tok, cache=cache), new - 1)
        step_ms, step_p90 = float(np.median(steps_ms)), float(np.percentile(steps_ms, 90))
        cache = init_cache(model, n, new + 1, enc, tmask)
        busy_ms, top = device_busy(lambda: model.decode(tok, cache=cache), steps=8)
    log(f"[main] encode {enc_ms:.3f} ms; decode step median {step_ms:.3f} ms, p90 "
        f"{step_p90:.3f} ms over {new - 1} steps (b={n}, cache L={new + 1}, "
        f"encoder L={L})")
    log(f"[main] decode step device busy {busy_ms:.3f} ms of {step_ms:.3f} ms "
        f"(median; idle share {1 - busy_ms / step_ms:.3f}); heaviest kernels per step: "
        + "; ".join(f"{k} {t:.3f} ms x{c:g}" for k, t, c in top))
    del model, predictor, cache, enc
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens_per_s": emitted / wall, "encode_ms": enc_ms,
            "decode_step_ms": step_ms, "decode_step_p90_ms": step_p90,
            "decode_step_device_busy_ms": busy_ms,
            "wall_s": wall, "wall_s_runs": walls, "steps": steps}


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain versions, on the card,
    for the duration (the port itself always launches the kernels there)."""
    from tpu_air_torch.models.t5 import modeling
    from tpu_air_torch.ops.decode_attention import decode_attention_reference

    def flash(q, k, v, bias=None, *, kv_mask=None, scale=None, causal=False):
        return flash_plain(q, k, v, bias, kv_mask, causal)

    saved = modeling.flash_attention, modeling.decode_attention
    modeling.flash_attention, modeling.decode_attention = flash, decode_attention_reference
    try:
        yield
    finally:
        modeling.flash_attention, modeling.decode_attention = saved


def kernel_vs_plain(model, ids, mask, dev):
    """Greedy tokens and encoder output through the kernels, then through the
    plain versions, on the card."""
    from tpu_air_torch.models.t5.generate import generate
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention

    tids, tmask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    out = {}
    for path in ("kernel", "plain"):
        ctx = plain_attention() if path == "plain" else contextlib.nullcontext()
        with ctx, torch.no_grad():
            before = flash_attention.launches, decode_attention.launches
            toks = generate(model, ids, mask, max_new_tokens=PARITY_NEW).cpu()
            enc = model.encode(tids, tmask)
            launched = (flash_attention.launches, decode_attention.launches) != before
        if launched != (path == "kernel"):
            raise AssertionError(f"[parity] the {path} path launched kernels: {launched}")
        out[path] = toks, enc
    live = torch.from_numpy(mask.sum(1) > 0).to(dev)
    enc_err = max_err(out["kernel"][1][live], out["plain"][1][live])
    return out["kernel"][0], out["plain"][0], enc_err


def parity(dev) -> dict:
    model = base_model("float32", dev)
    ids, mask = prompts(PARITY_BATCH, PROMPT_LEN, model.config.vocab_size, SEED + 2)
    kernel, plain, enc_err = kernel_vs_plain(model, ids, mask, dev)
    same = bool((kernel == plain).all())
    log(f"[parity] f32, {PARITY_BATCH} prompts x {PROMPT_LEN}, {PARITY_NEW} new tokens: "
        f"greedy tokens identical = {same}; encoder output max abs err {enc_err:.3e}")
    if not same:
        raise AssertionError(f"[parity] tokens differ:\n{kernel}\n{plain}")
    # f32 order differences over 12 layers; the encoder outputs are O(1)
    if not enc_err < 1e-4:
        raise AssertionError(f"[parity] encoder outputs differ by {enc_err}")
    del model
    torch.cuda.empty_cache()
    return {"tokens_identical": same, "encoder_max_abs_err": enc_err}


# -- phase 5 -----------------------------------------------------------------


def timing(dev, errs: dict, launches: dict) -> list:
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference
    from tpu_air_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(SEED + 3)
    dt = torch.bfloat16
    cfg = model_config()
    B, H, L, D = BATCH, cfg.num_heads, PROMPT_LEN, cfg.d_kv
    q, k, v, bias, mask = flash_inputs(rng, B, H, L, D, dt, dev)
    # library yardstick: one SDPA call with the same function as an additive
    # float mask (bias + key mask, built outside the timed region)
    lib_mask = (bias + ((1.0 - mask) * -1e30)[:, None, None, :]).to(dt)
    f_kernel = lambda: flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0)  # noqa: E731
    f_plain = lambda: flash_plain(q, k, v, bias, mask)  # noqa: E731
    f_lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=1.0)  # noqa: E731
    # Work this run's data needs: keys of a padded row past its length carry
    # weight 0 and need no bytes or flops (an all-pad row needs all of V for
    # its mean); the batch-shared bias is needed up to the longest row.
    keys = needed_keys(mask, L)
    nbytes = (2 * B * H * L * D * 2 + 2 * H * D * 2 * int(keys.sum())
              + H * L * int(keys.max()) * 4 + B * L * 4 + B * H * L * 4)
    flops = 4 * H * L * D * int(keys.sum())
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "tpu_air_torch/ops/csrc/flash_attention.cu",
        "replaces": "tpu_air/ops/flash_attention.py:59",
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash bf16 encoder bias+mask"], "tol": TOL[dt],
        "ms": device_ms(f_kernel, 10), "plain_ms": device_ms(f_plain, 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(f_lib, 10),
        "back_to_back_ms": time_ms(f_kernel, 10),
        "host_us_per_call": host_us(f_kernel, 10),
        "shape": f"B{B} H{H} L{L} D{D} bf16, bias [1,H,L,L] f32, key mask",
        "bytes": nbytes, "flops": flops,
    }
    del q, k, v, bias, mask, lib_mask
    torch.cuda.empty_cache()

    rows = {}
    for kind, Lk in (("cross", L), ("self", NEW_TOKENS + 1)):
        b, h, d = B, H, D
        q, k, v, kw = decode_inputs(rng, b, Lk, h, d, dt, dev, kind)
        q4 = q.transpose(1, 2)                                  # [b, h, 1, d]
        k4 = k.view(b, Lk, h, d).transpose(1, 2)
        v4 = v.view(b, Lk, h, d).transpose(1, 2)
        if kind == "cross":
            lib_mask = torch.where(kw["kv_mask"] > 0, 0.0, -1e20)[:, None, None, :].to(dt)
        else:
            lib_mask = kw["bias"][None, :, None, :].to(dt)
        f_kernel = lambda: decode_attention(q, k, v, **kw)  # noqa: E731
        f_plain = lambda: decode_attention_reference(q, k, v, **kw)  # noqa: E731
        f_lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=lib_mask, scale=1.0)  # noqa: E731
        if kind == "cross":
            keys = needed_keys(kw["kv_mask"], Lk)
            extra = b * Lk * 4                                  # the key mask
        else:   # keys after the query position carry weight 0
            keys = torch.full((b,), int((kw["bias"][0] > -1e8).sum()))
            extra = h * int(keys[0]) * 4                        # the bias row
        nbytes = 2 * h * d * 2 * int(keys.sum()) + 2 * b * h * d * 2 + extra
        flops = 4 * h * d * int(keys.sum())
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        rows[kind] = {
            "max_abs_err": errs[f"decode bf16 {kind}"], "tol": TOL[dt],
            "ms": device_ms(f_kernel, 200), "plain_ms": device_ms(f_plain, 50),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(f_lib, 200),
            "back_to_back_ms": time_ms(f_kernel, 200),
            "host_us_per_call": host_us(f_kernel),
            "shape": f"b{b} L{Lk} h{h} d{d} bf16, " + ("key mask" if kind == "cross"
                                                       else "bias [h,L] with causal row"),
            "bytes": nbytes, "flops": flops,
        }
    decode_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "tpu_air_torch/ops/csrc/decode_attention.cu",
        "replaces": "tpu_air/ops/decode_attention.py:61",
        "launches": launches["decode_attention"], **rows["cross"],
        "self_step": rows["self"],
    }
    for r in (flash_row, decode_row):   # aliases of ms and max_abs_err
        r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
    for r in (flash_row, decode_row, rows["self"]):
        log(f"[timing] {r.get('name', 'decode_attention self step')} {r['shape']}: kernel "
            f"{r['ms']:.4f} ms device time ({r['back_to_back_ms']:.4f} ms back to back, "
            f"host {r['host_us_per_call']:.1f} us/call), plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    return [flash_row, decode_row]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on the card",
              file=sys.stderr)
        return 2
    import tpu_air_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    build()
    errs = compare(dev)
    main_stats = main_path(dev)
    main_stats["parity"] = parity(dev)
    kernels = timing(dev, errs, main_stats["launches"])
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels, "main": main_stats}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
