#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_air_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and ``nvcc``; it imports nothing of JAX or ``tpu_air``.

Phases, each fatal on failure:

1. build    — compile every kernel of ``tpu_air_torch/ops/csrc`` (one nvcc per
              source, started together) and print, from ``ptxas -v``, each
              kernel's registers, shared memory and spills, and the card's
              name and power limit;
2. compare  — each T5 kernel against its plain PyTorch version on the card, at
              the generation path's shapes and at edge cases (masked rows,
              causal, ragged lengths, int8 slabs), against a stated tolerance;
3. main     — FLAN-T5-base width (12+12 layers, d_model 768, 12 heads, vocab
              32128) in bf16 with weights from a numpy seed at T5's initializer
              scales: the ``T5GenerativePredictor`` generates greedily for 64
              prompts of 512 tokens (padded lengths, one all-pad row), 128 new
              tokens; every kernel's launch count is read around the first
              such run; then encode and decode-step times, and the decode
              step's device busy time from ``torch.profiler``;
4. parity   — the same model in f32 generates for a few prompts through the
              kernels and through the plain versions on the card; greedy
              tokens must agree;
5. timing   — device time (profiler) of each T5 kernel, its plain version and
              one PyTorch library call (``scaled_dot_product_attention``) at
              the generation path's shapes, beside the least time the card
              could take (bytes over 3.35 TB/s, flops over 989 TFLOP/s, the
              H100 SXM data-sheet peaks);
6. backward — the flash backward kernels (dq, dk/dv) against
              ``flash_attention_backward_reference`` on the card: head dims
              16-128, causal or not, key masks with a fully masked row (whose
              gradients must be exactly 0), a nonzero lse cotangent, ragged L,
              f32 and bf16; then the LM training shape in f32 and bf16,
              where the forward is held against its plain version too and
              each tensor to its own norm (``NORM_TOL``);
7. lm       — ``LMTrainer.fit()`` on the 136M long-context LM (d_model 1024,
              8 layers, 8 heads of 128, vocab 32000; bf16, batch 1, 8192
              tokens, synthetic seeded tokens): one warm-up step, then
              measured steps; launches per step (8 forward, 8 dq, 8 dk/dv),
              each step's loss, step time, tokens/s and the step's device idle
              share;
8. lm parity — the same width in f32 at a cut depth and length: two train
              steps through the kernels and through the plain versions on the
              card from the same weights; losses and step-1 gradients agree;
9. lm timing — device time of the forward, dq and dk/dv kernels at the LM
              shape beside their bound, their plain versions and SDPA's
              forward and backward.

The counts of kernel launches are set to 0 just before each main path (T5
generation, LM training) and read just after it.
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
# At the LM shape most gradients and outputs are far below 1, where the
# max(1, |plain|) above would make TOL an absolute bound as large as the values
# themselves.  There each tensor is held to ||kernel - plain|| / ||plain||:
# f32 differs in summation order only (1e-4); each bf16 element is one
# rounding of the f32 one, at most one ulp apart, and one ulp is at most 2^-7
# of the element, so the ratio is at most 2^-7 = 7.8e-3 (1e-2).
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SEED = 0
# main-path dials: W3 batch generation at the reference's max_new_tokens=128
BATCH, PROMPT_LEN, NEW_TOKENS = 64, 512, 128
SMALL_BATCH, RAGGED_LEN = 8, 200          # edge cases of the compare phase
PARITY_BATCH, PARITY_NEW = 4, 32
PREDICT_REPEATS = 3                       # timed predict runs (median reported)
# LM dials: the 136M long-context LM of BASELINE.md, batch 1, 8192 tokens
LM_LEN, LM_STEPS = 8192, 4                # measured steps after one warm-up step
LM_PARITY_LAYERS, LM_PARITY_LEN = 2, 2048  # f32 parity: full width, cut depth/length
BWD_LEN, BWD_RAGGED_LEN = 128, 200        # edge cases of the backward compare


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


def norm_err(got, want) -> float:
    """||got - want|| / ||want||: the error on the tensor's own scale."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def _demangle(sym: str) -> str:
    """``flash_bwd_dq_kernel<bf16,128>`` from an Itanium-mangled kernel name
    (a template in an anonymous namespace, as the sources declare them)."""
    import re

    rest, name = sym[2:].lstrip("N"), ""
    while rest[:1].isdigit():                     # <length><identifier>...
        n = re.match(r"\d+", rest).group(0)
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    labels, named, rest = [], "?", rest[1:] if rest.startswith("I") else ""
    while rest and rest[0] != "E":                # template arguments up to their E
        if rest[0] == "L":                        # a constant: L<type><value>E
            m = re.match(r"L[a-z](\d+)E", rest)
            if m is None:
                break
            labels.append(m.group(1))
            rest = rest[m.end():]
        elif rest[0].isdigit():                   # a named type
            n = re.match(r"\d+", rest).group(0)
            ident = rest[len(n):len(n) + int(n)]
            labels.append({"__nv_bfloat16": "bf16"}.get(ident, ident))
            named = labels[-1]
            rest = rest[len(n) + int(n):]
        elif rest[0] == "S":                      # S<id>_: a named type repeated;
            m = re.match(r"S[0-9A-Z]*_", rest)    # the sources repeat only the last
            if m is None:
                break
            labels.append(named)
            rest = rest[m.end():]
        else:                                     # a builtin type
            labels.append({"f": "f32", "a": "int8"}.get(rest[0], rest[0]))
            rest = rest[1:]
    return f"{name}<{','.join(labels)}>"


def ptxas_usage(log: str) -> list:
    """[(kernel instantiation, registers, static smem bytes, spill store
    bytes)] from an ``nvcc -Xptxas -v`` report."""
    import re

    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            rows.append([_demangle(m.group(1)), 0, 0, 0])
        elif rows and (m := re.search(r"(\d+) bytes spill stores", line)):
            rows[-1][3] += int(m.group(1))
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1][1], rows[-1][2] = int(m.group(1)), int(smem.group(1)) if smem else 0
    return rows


# -- phase 1 -----------------------------------------------------------------


def build() -> None:
    from tpu_air_torch.ops import _build

    names = _build.sources()
    t0 = time.perf_counter()
    logs = _build.build(names)
    log(f"[build] {names} built for sm_90a in {time.perf_counter() - t0:.1f} s")
    for src, report in sorted(logs.items()):    # registers, static smem, spill stores
        log(f"[build] ptxas {src}.cu: " + "; ".join(
            f"{fn} {regs} regs {smem} B smem {spill} B spill"
            for fn, regs, smem, spill in ptxas_usage(report)))


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


# -- phase 6 -----------------------------------------------------------------


def lm_config(dtype: str = "bfloat16", n_layers: int = 8):
    from tpu_air_torch.models.lm import LMConfig

    return LMConfig(vocab_size=32000, d_model=1024, n_layers=n_layers, n_heads=8,
                    max_seq_len=LM_LEN, dtype=dtype)


def backward_inputs(rng, b, h, L, d, dtype, dev, mask=True, causal=False):
    """q, k, v, do as (b, h, L, d) views of [b, L, h, d] tensors; the
    forward's (out, lse); a nonzero lse cotangent; a key mask with one full,
    one padded and one fully masked row."""
    from tpu_air_torch.ops.flash_attention import flash_attention_with_lse

    def t(shape=(b, L, h, d), dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    q, k, v, do = (t().transpose(1, 2) for _ in range(4))
    mask_t = None
    if mask:
        lens = rng.integers(L // 8, L + 1, b)
        lens[0], lens[-1] = L, 0
        mask_t = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(dev)
    with torch.no_grad():
        out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask_t, causal=causal)
    return q, k, v, do, mask_t, out, lse, t((b, h, L), torch.float32)


def backward_plain(q, k, v, mask, out, lse, do, glse, scale, causal):
    from tpu_air_torch.ops.flash_attention import flash_attention_backward_reference

    b, h, L, d = q.shape

    def flat(x):
        return x.reshape(b * h, L, d)

    return flash_attention_backward_reference(
        flat(q), flat(k), flat(v), mask, flat(out), lse.reshape(b * h, L), flat(do),
        None if glse is None else glse.reshape(b * h, L), scale, causal)


def compare_backward(dev) -> dict:
    """Both backward kernels against the plain backward on the card, and the
    forward against the plain forward at the LM shape."""
    from tpu_air_torch.ops.flash_attention import (flash_attention_backward,
                                                   flash_attention_reference)

    rng = np.random.default_rng(SEED + 10)
    errs = {}

    def check(name, q, k, v, do, mask, out, lse, glse, causal, dtype, by_norm=False):
        """The scaled error against TOL, or with ``by_norm`` the error on each
        tensor's own norm against NORM_TOL."""
        scale = q.shape[-1] ** -0.5
        tol = (NORM_TOL if by_norm else TOL)[dtype]
        got = flash_attention_backward(q, k, v, mask, out, lse, do, glse, scale, causal)
        torch.cuda.synchronize()
        want = backward_plain(q, k, v, mask, out, lse, do, glse, scale, causal)
        b, h, L, d = q.shape
        worst = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            g = g.reshape(b * h, L, d)
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"[backward] {name} {g_name}: non-finite")
            if mask is not None:
                dead = (mask.sum(1) == 0).repeat_interleave(h)
                if dead.any() and g[dead].abs().max().item() != 0.0:
                    raise AssertionError(f"[backward] {name} {g_name}: a fully masked "
                                         "row has a nonzero gradient")
            rel = norm_err(g, w) if by_norm else scaled_err(g, w)
            if not rel < tol:
                raise AssertionError(f"[backward] {name} {g_name}: {rel} >= {tol}")
            w = w.float()
            # what a kernel that left the later half of the sequence at 0 would score
            half = (w[:, L // 2:].norm() / w.norm()).item()
            worst[g_name] = (max_err(g, w), rel, w.abs().max().item(), half)
        if by_norm:
            log(f"[backward] {name}: " + ", ".join(
                f"{n} max abs err {e:.2e} (plain max |x| {top:.3e}), ||err|| / ||plain|| "
                f"{r:.2e}, later half's share of ||plain|| {hf:.3f}"
                for n, (e, r, top, hf) in worst.items()) + f" (tol {tol:.0e})")
        else:
            log(f"[backward] {name}: max abs err " + ", ".join(
                f"{n} {e:.2e} (scaled {r:.2e})" for n, (e, r, _, _) in worst.items())
                + f" (tol {tol:.0e})")
        errs[name] = {n: e for n, (e, *_) in worst.items()}
        errs[name].update({f"{n}_rel": r for n, (_, r, *_) in worst.items()})

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for d in (16, 32, 64, 128):
            for causal in (False, True):
                for L, mask in ((BWD_LEN, False), (BWD_LEN, True), (BWD_RAGGED_LEN, True)):
                    args = backward_inputs(rng, 3, 2, L, d, dtype, dev, mask, causal)
                    check(f"{tag} d{d} L{L}{' causal' if causal else ''}"
                          f"{' mask' if mask else ''}", *args, causal, dtype)
    cfg = lm_config()
    h, d = cfg.n_heads, cfg.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, do, _, out, lse, _ = backward_inputs(rng, 1, h, LM_LEN, d, dtype, dev,
                                                      mask=False, causal=True)
        check(f"{tag} LM shape B1 H{h} L{LM_LEN} D{d} causal", q, k, v, do, None, out, lse,
              None, True, dtype, by_norm=True)
        want_out, want_lse = flash_attention_reference(
            *(x.reshape(h, LM_LEN, d) for x in (q, k, v)), None, None, d ** -0.5, True)
        got_out = out.reshape(h, LM_LEN, d)
        rel = norm_err(got_out, want_out)
        lse_err = (lse.reshape(h, LM_LEN) - want_lse).abs().max().item()
        errs[f"forward {tag} LM shape"] = max_err(got_out, want_out)
        errs[f"forward {tag} LM shape rel"] = rel
        log(f"[backward] {tag} forward at the LM shape: max abs err "
            f"{errs[f'forward {tag} LM shape']:.2e}, ||err|| / ||plain|| {rel:.2e} "
            f"(tol {NORM_TOL[dtype]:.0e}); lse {lse_err:.2e} (tol 1e-3)")
        if not (rel < NORM_TOL[dtype] and lse_err < 1e-3):
            raise AssertionError(f"[backward] {tag} forward at the LM shape: {rel}, "
                                 f"lse {lse_err}")
        del want_out, want_lse, got_out
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return errs


# -- phases 7 and 8 --------------------------------------------------------------


def lm_rows(n: int, L: int, seed: int) -> np.ndarray:
    """Periodic token rows with a per-row phase (examples/long_context_lm.py's
    synthetic corpus): next-token loss can fall within a few steps."""
    phase = np.random.default_rng(seed).integers(0, 17, (n, 1))
    return (2 + (np.arange(L)[None] + phase) % 17).astype(np.int32)


def lm_main_path(dev) -> dict:
    import pandas as pd
    import shutil
    import tempfile

    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.train import (CheckpointConfig, LMTrainer, RunConfig,
                                     TrainingArguments)

    cfg = lm_config()
    steps = 1 + LM_STEPS
    # one row, one step per epoch: each epoch's report is one step's loss and time
    rows = pd.DataFrame({"input_ids": list(lm_rows(1, LM_LEN, SEED + 20))})
    storage = tempfile.mkdtemp(prefix="chip_smoke-lm-")
    args = TrainingArguments(learning_rate=3e-4, per_device_train_batch_size=1,
                             num_train_epochs=steps, seed=SEED, evaluation_strategy="no")
    trainer = LMTrainer(model_config=cfg, training_args=args, datasets={"train": rows},
                        run_config=RunConfig(storage_path=storage,
                                             checkpoint_config=CheckpointConfig(num_to_keep=1)),
                        device=dev)
    flash_attention.launches = 0
    flash_attention_backward.dq_launches = 0
    flash_attention_backward.dkv_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.fit()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_bwd_dq": flash_attention_backward.dq_launches,
                "flash_attention_bwd_dkv": flash_attention_backward.dkv_launches}
    try:
        if result.error is not None:
            raise AssertionError(f"[lm] fit failed: {result.error}")
        hist = result.metrics_history
        if len(hist) != steps or any(m["steps"] != 1 for m in hist):
            raise AssertionError(f"[lm] expected {steps} one-step epochs: {hist}")
        ckpt_keys = len(result.checkpoint.get_params())
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    losses = [m["loss"] for m in hist]
    step_ms = [LM_LEN / m["train_tokens_per_sec"] * 1e3 for m in hist]
    per_step = {k: n / steps for k, n in launches.items()}
    log(f"[lm] LMTrainer.fit: {cfg.d_model} wide, {cfg.n_layers} layers, {cfg.n_heads} heads "
        f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, batch 1, "
        f"L={LM_LEN}, {steps} steps in {wall:.1f} s (checkpoint of {ckpt_keys} tensors "
        "each epoch)")
    log("[lm] loss per step: " + ", ".join(f"{x:.4f}" for x in losses))
    log("[lm] step ms (first is the warm-up): " + ", ".join(f"{x:.1f}" for x in step_ms))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[lm] non-finite loss: {losses}")
    log(f"[lm] launches: {launches} = {per_step} per step (expect {cfg.n_layers} each)")
    if any(n != cfg.n_layers for n in per_step.values()):
        raise AssertionError(f"[lm] launches per step {per_step}")
    med = float(np.median(step_ms[1:]))
    prof = lm_step_profile(dev, cfg)
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[lm] median step {med:.1f} ms over {LM_STEPS} steps = {LM_LEN / med * 1e3:.0f} "
        f"tokens/s; a profiled step: {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.4f}); heaviest kernels "
        "per step: " + "; ".join(f"{k[:60]} {t:.2f} ms x{c:g}" for k, (t, c) in top))
    per_launch = {}
    for name, kernel in (("flash_attention", "flash_fwd_kernel"),
                         ("flash_attention_bwd_dq", "flash_bwd_dq_kernel"),
                         ("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel")):
        hits = [(t, c) for k, (t, c) in prof["kernels"].items() if kernel in k]
        if sum(c for _, c in hits) != cfg.n_layers:
            raise AssertionError(f"[lm] the step profile holds {hits} of {kernel}")
        per_launch[name] = sum(t for t, _ in hits) / cfg.n_layers
    log("[lm] device ms per launch in the profiled step: "
        + ", ".join(f"{n} {t:.3f}" for n, t in per_launch.items()))
    return {"launches": launches, "launches_per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_ms_median": med, "tokens_per_s": LM_LEN / med * 1e3,
            "profiled_step_ms": prof["wall_ms"], "step_device_busy_ms": prof["busy_ms"],
            "idle_share": prof["idle_share"], "kernel_ms_per_launch": per_launch,
            "fit_wall_s": wall}


def lm_step_profile(dev, cfg, steps: int = 2) -> dict:
    """One train step (the step ``LMTrainer`` runs) under the profiler, on a
    fresh model; these launches are not counted.  Returns the step's wall
    time and device busy time over the same window, their idle share, and
    {kernel name: (device ms, launches)} per step."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.parallel.sequence_parallel import make_sp_train_step, shift_targets
    from tpu_air_torch.train.t5_trainer import TrainingArguments, _make_optimizer

    model = CausalLM(cfg, device=dev).init_weights(SEED)
    opt = _make_optimizer(TrainingArguments(learning_rate=3e-4), 4, model.parameters())
    step = make_sp_train_step(model, opt)
    ids = torch.from_numpy(lm_rows(1, LM_LEN, SEED + 21)).to(dev, torch.long)
    tgt = shift_targets(ids, cfg.pad_token_id)
    step(ids, tgt)                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids, tgt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    busy_ms = sum(t for t, _ in kernels.values())
    del model, opt, step
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels": kernels}


class _PlainFlash(torch.autograd.Function):
    """Causal attention through the plain forward and plain backward, on
    whatever device the tensors are on."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        from tpu_air_torch.ops.flash_attention import flash_attention_reference

        b, h, L, d = q.shape
        flat = [x.reshape(b * h, L, d) for x in (q, k, v)]
        out, lse = flash_attention_reference(*flat, None, None, scale, causal)
        ctx.save_for_backward(*flat, out, lse)
        ctx.scale, ctx.causal, ctx.shape = scale, causal, q.shape
        return out.reshape(b, h, L, d)

    @staticmethod
    def backward(ctx, do):
        from tpu_air_torch.ops.flash_attention import flash_attention_backward_reference

        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward_reference(q, k, v, None, out, lse,
                                                   do.reshape(out.shape), None,
                                                   ctx.scale, ctx.causal)
        return (*(g.reshape(ctx.shape) for g in grads), None, None)


@contextlib.contextmanager
def plain_lm_attention():
    """Route the LM's attention through the plain versions, on the card."""
    from tpu_air_torch.models.lm import modeling

    def flash(q, k, v, bias=None, *, kv_mask=None, scale=None, causal=False):
        return _PlainFlash.apply(q, k, v, scale, causal)

    saved = modeling.flash_attention
    modeling.flash_attention = flash
    try:
        yield
    finally:
        modeling.flash_attention = saved


def lm_parity(dev) -> dict:
    """Two f32 train steps through the kernels and through the plain versions
    from the same weights; the losses and the first step's gradients agree."""
    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.parallel.sequence_parallel import make_sp_train_step, shift_targets
    from tpu_air_torch.train.t5_trainer import TrainingArguments, _make_optimizer

    cfg = lm_config("float32", LM_PARITY_LAYERS)
    ids = torch.from_numpy(lm_rows(1, LM_PARITY_LEN, SEED + 22)).to(dev, torch.long)
    tgt = shift_targets(ids, cfg.pad_token_id)
    runs = {}
    for path in ("kernel", "plain"):
        model = CausalLM(cfg, device=dev).init_weights(SEED)
        opt = _make_optimizer(TrainingArguments(learning_rate=1e-3), 2, model.parameters())
        grads = []
        adamw_step = opt.step

        def snapshot_then_step():
            grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
            adamw_step()

        opt.step = snapshot_then_step
        step = make_sp_train_step(model, opt)
        ctx = plain_lm_attention() if path == "plain" else contextlib.nullcontext()
        before = (flash_attention.launches, flash_attention_backward.dq_launches,
                  flash_attention_backward.dkv_launches)
        with ctx:
            losses = [float(step(ids, tgt)) for _ in range(2)]
        launched = before != (flash_attention.launches, flash_attention_backward.dq_launches,
                              flash_attention_backward.dkv_launches)
        if launched != (path == "kernel"):
            raise AssertionError(f"[lm parity] the {path} path launched kernels: {launched}")
        runs[path] = losses, grads[0]
        del model, opt, step
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = runs["kernel"], runs["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    grad_rel = max((gk[n] - gp[n]).abs().max().item() / gp[n].abs().max().item() for n in gp)
    log(f"[lm parity] f32, {cfg.d_model} wide, depth cut to {cfg.n_layers} layers, L="
        f"{LM_PARITY_LEN}: losses kernel {lk} plain {lp} (max rel diff {loss_rel:.2e}); "
        f"step-1 gradients max |diff| / max |plain| over tensors {grad_rel:.2e}")
    # f32 on both paths, differing in summation order only: the losses to
    # 1e-5 relative; each gradient tensor to 1e-4 of its largest element
    if not (loss_rel < 1e-5 and grad_rel < 1e-4):
        raise AssertionError(f"[lm parity] loss rel {loss_rel}, grad rel {grad_rel}")
    return {"losses_kernel": lk, "losses_plain": lp, "loss_max_rel_diff": loss_rel,
            "grad_max_rel_diff": grad_rel}


# -- phase 9 -----------------------------------------------------------------


def lm_timing(dev, kernels: list, bwd_errs: dict, lm_stats: dict) -> list:
    """The three flash kernels at the LM training shape (B*H = 8, L = 8192,
    D = 128, causal, bf16), beside their bounds (flops over 989 TFLOP/s, the
    causal half counted), their plain versions and SDPA.  A kernel's time is
    its device time per launch in the main path's profiled step; the plain
    versions and SDPA, every call of which runs for 0.2 ms or more, are
    timed with CUDA events over back-to-back calls."""
    from tpu_air_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference)

    cfg = lm_config()
    h, L, d = cfg.n_heads, LM_LEN, cfg.head_dim
    scale = d ** -0.5
    rng = np.random.default_rng(SEED + 30)
    q, k, v, do, _, out, lse, _ = backward_inputs(rng, 1, h, L, d, torch.bfloat16, dev,
                                                  mask=False, causal=True)
    flat = [x.reshape(h, L, d) for x in (q, k, v)]
    pairs = h * L * (L + 1) // 2                   # live (query, key) pairs, causal
    elt = h * L * d * 2                            # one bf16 (B*H, L, D) operand
    lse_bytes = h * L * 4
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=scale)

    # CUDA events around separate kernel calls cross-check the profiled step
    per_launch = lm_stats["kernel_ms_per_launch"]
    fwd_ms = per_launch["flash_attention"]
    dq_ms = per_launch["flash_attention_bwd_dq"]
    dkv_ms = per_launch["flash_attention_bwd_dkv"]
    fwd_events_ms = time_ms(lambda: flash_attention(q, k, v, scale=scale, causal=True), 3, 1)
    bwd_events_ms = time_ms(lambda: flash_attention_backward(q, k, v, None, out, lse, do, None,
                                                             scale, True), 3, 1)
    plain_bwd_ms = time_ms(lambda: backward_plain(q, k, v, None, out, lse, do, None,
                                                  scale, True), 2, 1)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                                      retain_graph=True), 5, 2)
    lm_errs = bwd_errs[f"bf16 LM shape B1 H{h} L{L} D{d} causal"]
    shape = f"B*H {h} L{L} D{d} causal bf16"
    rows = {}
    # forward: reads q, k, v, writes out and lse; 2 products of 2*d flops per
    # live pair.  dq: reads q, k, v, do, lse, delta, writes dq; 3 products.
    # dk/dv: the same inputs, writes dk and dv; 4 products.
    for name, ms, plain_ms, lib_ms, nbytes, flops, err, rel in (
        ("flash_attention", fwd_ms,
         time_ms(lambda: flash_attention_reference(*flat, None, None, scale, True), 2, 1),
         time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                        scale=scale), 5, 2),
         4 * elt + lse_bytes, 4 * d * pairs, bwd_errs["forward bf16 LM shape"],
         bwd_errs["forward bf16 LM shape rel"]),
        ("flash_attention_bwd_dq", dq_ms, plain_bwd_ms, sdpa_bwd_ms,
         5 * elt + 2 * lse_bytes, 6 * d * pairs, lm_errs["dq"], lm_errs["dq_rel"]),
        ("flash_attention_bwd_dkv", dkv_ms, plain_bwd_ms, sdpa_bwd_ms,
         6 * elt + 2 * lse_bytes, 8 * d * pairs, max(lm_errs["dk"], lm_errs["dv"]),
         max(lm_errs["dk_rel"], lm_errs["dv_rel"])),
    ):
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                      "err_norm_over_plain_norm": rel, "norm_tol": NORM_TOL[torch.bfloat16],
                      "bytes": nbytes, "flops": flops, "shape": shape}
        log(f"[lm timing] {name} {shape}: kernel {ms:.3f} ms device time a launch, plain "
            f"{plain_ms:.3f} ms, SDPA {'forward' if name == 'flash_attention' else 'backward'} "
            f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}")
    log(f"[lm timing] by CUDA events: flash_attention {fwd_events_ms:.3f} ms, one "
        f"flash_attention_backward call (delta, dq, dk/dv) {bwd_events_ms:.3f} ms; the plain "
        f"backward computes dq, dk and dv in {plain_bwd_ms:.3f} ms, SDPA's in "
        f"{sdpa_bwd_ms:.3f} ms")
    launches = lm_stats["launches"]

    fwd = next(r for r in kernels if r["name"] == "flash_attention")
    fwd["launches_by_path"] = {"t5_generate": fwd["launches"],
                               "lm_train": launches["flash_attention"]}
    fwd["launches"] += launches["flash_attention"]
    fwd["lm_shape"] = {**rows["flash_attention"], "events_ms": fwd_events_ms}
    for name, line in (("flash_attention_bwd_dq", 368), ("flash_attention_bwd_dkv", 399)):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpu_air_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": f"tpu_air/ops/flash_attention.py:{line}",
            "launches": launches[name], **r,
            "plain": "the plain backward, dq, dk and dv together",
            "library": "SDPA backward, dq, dk and dv in one call",
            "backward_call_events_ms": bwd_events_ms,
            "kernel_ms": r["ms"], "max_err": r["max_abs_err"],
        })
    del q, k, v, do, out, lse, qs, ks, vs, sdpa_out
    torch.cuda.empty_cache()
    return kernels


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
    bwd_errs = compare_backward(dev)
    lm_stats = lm_main_path(dev)
    lm_stats["parity"] = lm_parity(dev)
    kernels = lm_timing(dev, kernels, bwd_errs, lm_stats)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels, "main": main_stats, "lm": lm_stats}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
