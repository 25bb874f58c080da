"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``tpu_air/ops/flash_attention.py``.  The kernel
(``csrc/flash_attention.cu``) replaces the Pallas forward kernel ``_kernel``
launched by ``_pallas_fwd``: blockwise online-softmax attention with f32
statistics and accumulation, returning the output in the input type and the
f32 logsumexp.

Broadcast-aware operands, as in the TPU kernel:

* ``bias``: additive scores with leading dim 1, H or B*H.  T5's relative
  position bias is per head and shared by the batch; the kernel indexes it
  as ``bh % H`` and never expands it over the batch in memory.
* ``kv_mask``: (B, Lk) key-padding mask, 1 = attend, applied inside the
  kernel as an additive -1e30 row.
* ``causal``: masking from indices; keys after the query get weight 0.

The key mask uses the finite -1e30, so a query row whose every visible key
is masked yields the mean of the visible V, finite.  (The TPU kernel gives
mean(V) too without ``causal``; with it, its result on such a row depends on
its tile sizes, and such a row is padding either way.)

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes :func:`flash_attention_reference`.  ``flash_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
_NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
# q, k, v, bias, mask, out, lse; (b, h, l) strides of q, k, v, out; batch,
# heads, lq, lk, d, dtype, bias_n, mask_b; scale; causal; stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _expand_bias(bias, bh, lq, lk):
    b0 = bias.shape[0]
    if b0 == bh:
        return bias
    if b0 == 1:
        return bias.expand(bh, lq, lk)
    return bias.unsqueeze(0).expand(bh // b0, b0, lq, lk).reshape(bh, lq, lk)


def flash_attention_reference(q, k, v, bias=None, kv_mask=None, scale=1.0,
                              causal=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the kernel's semantics, on (B*H, L, D).

    ``bias`` (1|H|B*H, Lq, Lk), ``kv_mask`` (B, Lk) with 1 = attend.
    Returns ``(out, lse)``: out in q's type, lse f32 (B*H, Lq).  The
    counterpart of ``_reference_pair`` in the JAX package."""
    bh, lq, _ = q.shape
    lk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + _expand_bias(bias, bh, lq, lk).float()
    if kv_mask is not None:
        add = (1.0 - kv_mask.float()) * NEG_INF
        s = s + add.repeat_interleave(bh // kv_mask.shape[0], dim=0)[:, None, :]
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    # softmax, not exp(s - lse): f32 cannot hold -1e30 + log(Lk), so on a
    # fully-masked row exp(s - lse) would weigh every key 1 and sum V
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    return out, lse


def _as_4d(q, k, v, bias):
    """Accept (B, H, L, D) or (B*H, L, D); return 4-D views and a 3-D bias
    of leading dim 1, H or B*H."""
    if q.dim() == 3:
        return q[:, None], k[:, None], v[:, None], bias, False
    b, h = q.shape[:2]
    if bias is not None:
        if bias.dim() != 4:
            raise ValueError("bias must be 4D when q/k/v are 4D")
        if bias.shape[0] == 1:
            bias = bias[0]                                  # (1|H, Lq, Lk)
        else:
            bias = bias.expand(b, h, *bias.shape[2:]).reshape(
                b * h, *bias.shape[2:])
    return q, k, v, bias, True


def _launch(q, k, v, bias, kv_mask, scale, causal):
    """q/k/v (B, H, L, D) CUDA views with D contiguous; bias 3-D or None."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous last dim")
    bias_n = 0
    if bias is not None:
        bias_n = bias.shape[0]
        if bias.shape[1:] != (lq, lk) or (b * h) % bias_n:
            raise ValueError(f"flash_attention: bias {tuple(bias.shape)} does not "
                             f"fit (B*H={b * h}, {lq}, {lk})")
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    mask_b = 0
    if kv_mask is not None:
        mask_b = kv_mask.shape[0]
        if kv_mask.shape != (mask_b, lk) or (b * h) % mask_b:
            raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)} "
                             f"does not fit (B, {lk})")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    # out is laid out (B, L, H, D) and returned as a (B, H, L, D) view, so the
    # model's [b, L, h*d] reshape afterwards costs no copy
    out = torch.empty(b, lq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
    fn = _build.kernel_fn(_NAME, _ARGTYPES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(kv_mask), ptr(out),
                ptr(lse), *strides, b, h, lq, lk, d, _DTYPES[q.dtype], bias_n,
                mask_b, float(scale), int(bool(causal)), stream)
    _build.check(_NAME, rc)
    flash_attention.launches += 1
    return out, lse


def _pair(q, k, v, bias, kv_mask, scale, causal):
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    q4, k4, v4, bias3, four = _as_4d(q, k, v, bias)
    if q.is_cuda:
        out, lse = _launch(q4, k4, v4, bias3, kv_mask, scale, causal)
    elif q.device.type == "cpu":
        b, h, lq, d = q4.shape
        flat = [t.reshape(b * h, t.shape[2], d) for t in (q4, k4, v4)]
        out, lse = flash_attention_reference(*flat, bias3, kv_mask, scale, causal)
        out = out.reshape(b, h, lq, d)
    else:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not four:
        out = out[:, 0]
    else:
        lse = lse.reshape(q.shape[0], q.shape[1], -1)
    return out, lse


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None, *,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, causal: bool = False):
    """Blockwise attention forward.

    q/k/v: (B*H, L, D) or (B, H, L, D), float32 or bfloat16, any strides with
    D contiguous.  bias: additive scores, leading dim 1, H or B*H (T5 passes
    its (1, H, Lq, Lk) position bias; it is not expanded over the batch).
    kv_mask: (B, Lk), 1 = attend.  scale defaults to 1/sqrt(D); T5 passes
    1.0.  Returns the output in q's type and layout."""
    return _pair(q, k, v, bias, kv_mask, scale, causal)[0]


def flash_attention_with_lse(q, k, v, bias=None, *, kv_mask=None, scale=None,
                             causal=False):
    """(out, logsumexp) variant; lse is f32 (B*H, Lq) or (B, H, Lq)."""
    return _pair(q, k, v, bias, kv_mask, scale, causal)


flash_attention.launches = 0
