"""Flash attention, forward and backward: hand-written CUDA kernels and their
plain versions.

Counterpart of ``tpu_air/ops/flash_attention.py``.  Three kernels:

* ``csrc/flash_attention.cu`` replaces the Pallas forward kernel ``_kernel``
  launched by ``_pallas_fwd``: blockwise online-softmax attention with f32
  statistics and accumulation, returning the output in the input type and
  the f32 logsumexp;
* ``csrc/flash_attention_bwd.cu`` replaces the Pallas backward kernels
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` launched by ``_pallas_bwd``:
  dq, and dk/dv, from the saved ``(out, lse)``.

In bf16 and f16 all three kernels run their products on Hopper's warpgroup
products (``wgmma``; 16-bit operands, f32 accumulation, the reference's
precision), fed by TMA from a ring of tiles that a producer warpgroup keeps
full: the forward streams K and V, dq streams K and V past 128 query rows,
dk/dv streams Q and dO past 128 keys.  In f32 all three run on the CUDA
cores.  TMA needs every (b, h, l) row of q, k, v and do to start on a
16-byte boundary: a 16-bit view that breaks that rule is first copied to a
contiguous tensor (:func:`_aligned`).
The model's projections never need the copy.

Both outputs of :func:`flash_attention_with_lse` are differentiable, through
one ``torch.autograd.Function`` (the counterpart of ``_flash_pair`` and its
custom VJP).  Without a bias the backward is blockwise: ``delta =
rowsum(do*out) - glse`` folds the logsumexp cotangent in, then the dq and
dk/dv kernels run (the plain :func:`flash_attention_backward_reference` on
the CPU).  With a bias it recomputes through
:func:`flash_attention_reference` under autograd and returns the dense
bias gradient, as the JAX package does.  The key mask gets no gradient.

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
its tile sizes, and such a row is padding either way.)  The backward defines
the gradient of such a row as exactly zero: masked scores are hard-zeroed
(``_bwd_p`` in the JAX package), so padding does not train.

Dispatch is by device: a CUDA tensor launches the kernels (or raises), a CPU
tensor takes the plain versions.  ``flash_attention.launches`` counts
forward launches, ``flash_attention_backward.dq_launches`` and
``.dkv_launches`` the backward kernels'.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_air_torch._exports import make_callable

from . import _build

NEG_INF = -1e30
_NAME = "flash_attention"
_BWD_NAME = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64, 128)
# q, k, v, bias, mask, out, lse; (b, h, l) strides of q, k, v, out; batch,
# heads, lq, lk, d, dtype, bias_n, mask_b; scale; causal; stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# q, k, v, do, lse, delta, mask, out0, out1; (b, h, l) strides of q, k, v,
# do, out0, out1; batch, heads, lq, lk, d, dtype, mask_b; scale; causal; stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 18
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _expand_bias(bias, bh, lq, lk):
    b0 = bias.shape[0]
    if b0 == bh:
        return bias
    if b0 == 1:
        return bias.expand(bh, lq, lk)
    return bias.unsqueeze(0).expand(bh // b0, b0, lq, lk).reshape(bh, lq, lk)


def _scores(q, k, bias, kv_mask, scale, causal):
    """f32 scores (B*H, Lq, Lk) with the additive bias and -1e30 key mask;
    causally hidden keys at -inf (weight exactly 0)."""
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
    return s


def flash_attention_reference(q, k, v, bias=None, kv_mask=None, scale=1.0,
                              causal=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the kernel's semantics, on (B*H, L, D).

    ``bias`` (1|H|B*H, Lq, Lk), ``kv_mask`` (B, Lk) with 1 = attend.
    Returns ``(out, lse)``: out in q's type, lse f32 (B*H, Lq).  The
    counterpart of ``_reference_pair`` in the JAX package."""
    s = _scores(q, k, bias, kv_mask, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    # softmax, not exp(s - lse): f32 cannot hold -1e30 + log(Lk), so on a
    # fully-masked row exp(s - lse) would weigh every key 1 and sum V
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    return out, lse


def flash_attention_backward_reference(q, k, v, kv_mask, out, lse, do, glse, scale,
                                       causal):
    """Plain PyTorch backward with the kernels' semantics, on (B*H, L, D).

    ``kv_mask`` (B, Lk) with 1 = attend or None; ``out``/``do`` (B*H, Lq, D);
    ``lse`` and ``glse`` (the logsumexp's cotangent, or None) (B*H, Lq).
    Returns ``(dq, dk, dv)`` in the input type.  The dense form of
    ``_pallas_bwd``: p = exp(s - lse) with masked scores (<= -5e29, the
    causal ones included) hard-zeroed, delta = rowsum(do*out) - glse,
    ds = p * (do v^T - delta)."""
    delta = (do.float() * out.float()).sum(-1)
    if glse is not None:
        delta = delta - glse.float()
    s = _scores(q, k, None, kv_mask, scale, causal)
    p = torch.where(s <= 0.5 * NEG_INF, torch.zeros_like(s), torch.exp(s - lse.float()[..., None]))
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, v.float()) - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _check_qkv(q, k, v, name):
    """q/k/v (B, H, L, D) CUDA views: one float type, a head dim the kernels
    take, matching shapes, one device, D contiguous."""
    b, h, _, d = q.shape
    lk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 q/k/v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {n} on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {n} needs a contiguous last dim")


def _rows_16b_aligned(t) -> bool:
    """True when every (b, h, l) row of the 4-D view ``t`` starts on a
    16-byte boundary: its data pointer and its first three strides are
    multiples of 16 bytes."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(t.stride(i) % step == 0 for i in range(3))


def _aligned(t):
    """``t``, or, for a 16-bit view whose rows TMA and the tensor-core
    kernels' 16-byte copies cannot read, a contiguous copy of it.
    (``contiguous()`` would return a contiguous view that starts off a
    16-byte boundary as it is.)"""
    if t.dtype == torch.float32 or _rows_16b_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_mask(kv_mask, bh, lk, q, name):
    if kv_mask is None:
        return None, 0
    mask_b = kv_mask.shape[0]
    if kv_mask.shape != (mask_b, lk) or bh % mask_b:
        raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} does not fit (B, {lk})")
    return kv_mask.to(device=q.device, dtype=torch.float32).contiguous(), mask_b


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, bias, kv_mask, scale, causal):
    """q/k/v (B, H, L, D) CUDA views with D contiguous; bias 3-D or None."""
    _check_qkv(q, k, v, "flash_attention")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bias_n = 0
    if bias is not None:
        bias_n = bias.shape[0]
        if bias.shape[1:] != (lq, lk) or (b * h) % bias_n:
            raise ValueError(f"flash_attention: bias {tuple(bias.shape)} does not "
                             f"fit (B*H={b * h}, {lq}, {lk})")
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    kv_mask, mask_b = _check_mask(kv_mask, b * h, lk, q, "flash_attention")
    # out is laid out (B, L, H, D) and returned as a (B, H, L, D) view, so the
    # model's [b, L, h*d] reshape afterwards costs no copy
    out = torch.empty(b, lq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
    fn = _build.kernel_fn(_NAME, f"{_NAME}_fwd", _ARGTYPES)

    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(kv_mask), _ptr(out),
                _ptr(lse), *strides, b, h, lq, lk, d, _DTYPES[q.dtype], bias_n,
                mask_b, float(scale), int(bool(causal)), stream)
    _build.check(_NAME, rc)
    flash_attention.launches += 1
    return out, lse


def _launch_bwd(entry, q, k, v, do, lse, delta, kv_mask, outs, scale, causal):
    """One backward kernel: ``entry`` of csrc/flash_attention_bwd.cu writing
    ``outs`` (dq, or dk and dv); all (B, H, L, D) CUDA views, D contiguous."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    kv_mask, mask_b = _check_mask(kv_mask, b * h, lk, q, "flash_attention_backward")
    fn = _build.kernel_fn(_BWD_NAME, entry, _BWD_ARGTYPES)
    tensors = (q, k, v, do, outs[0], outs[-1])
    strides = []
    for t in tensors:
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
                _ptr(kv_mask), _ptr(outs[0]), _ptr(outs[-1]), *strides, b, h, lq,
                lk, d, _DTYPES[q.dtype], mask_b, float(scale), int(bool(causal)),
                stream)
    _build.check(_BWD_NAME, rc)


def _grads_like(t, lk):
    """(B, H, lk, D) output laid out (B, L, H, D), as the forward's out."""
    b, h, _, d = t.shape
    return torch.empty(b, lk, h, d, dtype=t.dtype, device=t.device).transpose(1, 2)


def flash_attention_backward(q, k, v, kv_mask, out, lse, do, glse, scale, causal):
    """dq, dk, dv of flash attention without a bias, in the input type.

    q/k/v/out/do: (B, H, L, D) (any strides with D contiguous; ``do`` of
    other strides is copied, as is a 16-bit view whose rows are not 16-byte
    aligned) or (B*H, L, D); lse and glse (None = 0):
    (B, H, Lq) or (B*H, Lq).  On a CUDA tensor: delta = rowsum(do*out) -
    glse in plain torch, then the dq kernel and the dk/dv kernel; on a CPU
    tensor: :func:`flash_attention_backward_reference`."""
    q4, k4, v4, _, four = _as_4d(q, k, v, None)
    out4, do4 = (out, do) if four else (out[:, None], do[:, None])
    b, h, lq, d = q4.shape
    lk = k4.shape[2]
    if q.is_cuda:
        _check_qkv(q4, k4, v4, "flash_attention_backward")
        if do4.shape != q4.shape or out4.shape != q4.shape:
            raise ValueError(f"flash_attention_backward: do {tuple(do.shape)} / out "
                             f"{tuple(out.shape)} do not match q {tuple(q.shape)}")
        if do4.dtype != q4.dtype or do4.stride(3) != 1:
            do4 = do4.to(q4.dtype).contiguous()
        q4, k4, v4, do4 = (_aligned(t) for t in (q4, k4, v4, do4))
        delta = (do4.float() * out4.float()).sum(-1).reshape(b * h, lq)
        if glse is not None:
            delta = delta - glse.float().reshape(b * h, lq)
        delta = delta.contiguous()
        lse2 = lse.float().reshape(b * h, lq).contiguous()
        dq = _grads_like(q4, lq)
        dk, dv = _grads_like(k4, lk), _grads_like(v4, lk)
        _launch_bwd("flash_attention_bwd_dq", q4, k4, v4, do4, lse2, delta, kv_mask,
                    (dq,), scale, causal)
        flash_attention_backward.dq_launches += 1
        _launch_bwd("flash_attention_bwd_dkv", q4, k4, v4, do4, lse2, delta, kv_mask,
                    (dk, dv), scale, causal)
        flash_attention_backward.dkv_launches += 1
    elif q.device.type == "cpu":
        def flat(t):
            return t.reshape(b * h, t.shape[2], d)

        grads = flash_attention_backward_reference(
            flat(q4), flat(k4), flat(v4), kv_mask, flat(out4), lse.reshape(b * h, lq),
            flat(do4), None if glse is None else glse.reshape(b * h, lq), scale, causal)
        dq, dk, dv = (g.reshape(b, h, -1, d) for g in grads)
    else:
        raise ValueError(f"flash_attention_backward: no kernel for device {q.device}")
    if not four:
        return dq[:, 0], dk[:, 0], dv[:, 0]
    return dq, dk, dv


def _forward(q, k, v, bias, kv_mask, scale, causal):
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


class _FlashPair(torch.autograd.Function):
    """(out, lse) with the blockwise backward; the counterpart of
    ``_flash_pair`` and its custom VJP in the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, scale, causal):
        out, lse = _forward(q, k, v, bias, kv_mask, scale, causal)
        ctx.save_for_backward(q, k, v, bias, kv_mask, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, glse):
        q, k, v, bias, kv_mask, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        if bias is None:
            dq, dk, dv = flash_attention_backward(q, k, v, kv_mask, out, lse, do, glse,
                                                  ctx.scale, ctx.causal)
            return dq, dk, dv, None, None, None, None
        # the bias path (T5's relative-position bias): the bias gradient is
        # dense (H, Lq, Lk) anyway, so recompute through the reference
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
            q4, k4, v4, bias3, four = _as_4d(*leaves)
            b, h, lq, d = q4.shape
            flat = [t.reshape(b * h, t.shape[2], d) for t in (q4, k4, v4)]
            ref_out, ref_lse = flash_attention_reference(*flat, bias3, kv_mask,
                                                         ctx.scale, ctx.causal)
            outs, cots = [ref_out], [do.reshape(ref_out.shape)]
            if glse is not None:
                outs.append(ref_lse)
                cots.append(glse.reshape(ref_lse.shape))
            grads = torch.autograd.grad(outs, leaves, cots)
        return (*grads, None, None, None)


def _pair(q, k, v, bias, kv_mask, scale, causal):
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    wants_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    if wants_grad:
        return _FlashPair.apply(q, k, v, bias, kv_mask, scale, causal)
    return _forward(q, k, v, bias, kv_mask, scale, causal)


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None, *,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, causal: bool = False):
    """Blockwise attention, differentiable in q, k, v and bias.

    q/k/v: (B*H, L, D) or (B, H, L, D), float32, bfloat16 or float16, any
    strides with D contiguous (a 16-bit view whose rows are not 16-byte aligned is copied
    to contiguous first).  bias: additive scores, leading dim 1, H or B*H (T5 passes
    its (1, H, Lq, Lk) position bias; it is not expanded over the batch).
    kv_mask: (B, Lk), 1 = attend.  scale defaults to 1/sqrt(D); T5 passes
    1.0.  Returns the output in q's type and layout."""
    return _pair(q, k, v, bias, kv_mask, scale, causal)[0]


def flash_attention_with_lse(q, k, v, bias=None, *, kv_mask=None, scale=None,
                             causal=False):
    """(out, logsumexp) variant, differentiable in both; lse is f32
    (B*H, Lq) or (B, H, Lq)."""
    return _pair(q, k, v, bias, kv_mask, scale, causal)


flash_attention.launches = 0
flash_attention_backward.dq_launches = 0
flash_attention_backward.dkv_launches = 0


make_callable(__name__)   # the JAX package exports the function under this name
