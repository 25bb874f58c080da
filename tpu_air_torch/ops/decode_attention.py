"""Single-token decode attention over flat K/V cache slabs: a hand-written
CUDA kernel and its plain version.

Counterpart of ``tpu_air/ops/decode_attention.py``.  The kernel
(``csrc/decode_attention.cu``) replaces the Pallas ``_kernel`` launched by
``decode_attention`` there: one query token per batch row attends over a
cached ``[b, L, h*d]`` slab, with f32 scores and softmax.

Quantization contract: int8 slabs carry f32 scales that fold into the
arithmetic, per-channel ``[b, 1, h*d]`` into q and the output,
per-position ``[b, L, h]`` into the scores and the probabilities.  The
kernel never writes a dequantized slab; the bytes it reads for an int8
cache are the int8 bytes.

Masking contract: ``bias`` is an additive f32 ``[h, L]`` that already
carries any causal masking (the T5 decode step's position bias plus its
causal row); ``kv_mask`` ``[b, L]`` (1 = attend) adds a -1e20 floor, and
the running max is floored there too, so a row whose every key is masked
yields mean(V), finite.

The kernel reads each needed slab byte once in 16-byte loads, in one pass
with an online softmax, split over chunks of L when ``b*h`` alone cannot
fill the card (:func:`split_chunk`; the partial states are merged on the
card); with a key mask it skips the K/V bytes of every chunk whose keys are
all masked.  The slabs must start on a 16-byte boundary, as fresh
allocations do: the wrapper raises on one that does not and never copies
a slab.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes :func:`decode_attention_reference`.
``decode_attention.launches`` counts calls of the kernel (with its merge
step, when it splits L).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

MASK_FLOOR = -1e20
_NAME = "decode_attention"
_QTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64, 128)
_NONE, _POS, _CHAN = 0, 1, 2


def _scale_kind(s, b, L, h, d, name):
    if s is None:
        return _NONE
    if tuple(s.shape) in ((b, L, h, 1), (b, L, h)):
        return _POS
    if tuple(s.shape) in ((b, 1, h, d), (b, 1, h * d)):
        return _CHAN
    raise ValueError(f"{name} shape {tuple(s.shape)} is neither per-position "
                     f"[b,L,h,1] nor per-channel [b,1,h,d] (or their flat forms)")


def _bias_hl(bias):
    if bias is not None and bias.dim() == 4:               # [1, h, 1, L]
        bias = bias[0, :, 0, :]
    return bias


def decode_attention_reference(q, k, v, *, bias=None, kv_mask=None,
                               k_scale=None, v_scale=None):
    """Plain PyTorch version with the kernel's semantics: dequantize in f32,
    f32 scores and softmax.  q ``[b, 1, h, d]`` or ``[b, h, d]``; k/v
    ``[b, L, h*d]`` or ``[b, L, h, d]``.  Returns q's layout and type.  The
    counterpart of ``decode_attention_reference`` in the JAX package."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    b, h, d = q.shape
    L = k.shape[1]
    kf = k.reshape(b, L, h, d).float()
    vf = v.reshape(b, L, h, d).float()
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        kind = _scale_kind(s, b, L, h, d, name)
        if kind == _POS:
            s4 = s.reshape(b, L, h, 1).float()
        elif kind == _CHAN:
            s4 = s.reshape(b, 1, h, d).float()
        else:
            continue
        if name == "k_scale":
            kf = kf * s4
        else:
            vf = vf * s4
    s = torch.einsum("bhd,blhd->bhl", q.float(), kf)
    bias = _bias_hl(bias)
    if bias is not None:
        s = s + bias.float()[None]
    if kv_mask is not None:
        s = s + torch.where(kv_mask > 0, 0.0, MASK_FLOOR).float()[:, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhl,blhd->bhd", p, vf).to(q.dtype)
    return out[:, None] if squeeze else out


# q, k, v, bias, mask, k_scale, v_scale, out, workspace; b, L, h, d, q type,
# int8, k kind, v kind, chunk; stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# Split-K: the kernel runs one block of 128 threads per (b, h, chunk of L);
# an SM holds seven at its register count, and one wave of _BLOCKS_PER_SM
# an SM keeps enough bytes in flight to stream the slabs at the card's rate.
# A grid of b*h blocks that fills half that wave or more runs unsplit (the
# merge would cost more than the wave's tail: on an H100 the W3 cross step,
# 768 blocks, took longer split in two); a smaller one is split up to the
# wave, into chunks of no fewer than _MIN_CHUNK positions, a multiple of 64.
_BLOCKS_PER_SM = 6
_MIN_CHUNK = 128


def split_chunk(b: int, h: int, L: int, sm_count: int) -> int:
    """Positions each block of the decode kernel reads: ``L`` (one chunk)
    when ``b*h`` blocks fill half a wave of ``_BLOCKS_PER_SM`` an SM or
    more, else the chunk that brings the grid to a whole wave, at least
    ``_MIN_CHUNK`` and rounded up to a multiple of 64.  The kernel runs
    ``ceil(L / chunk)`` chunks per (b, h) and merges their partial softmax
    states."""
    want = _BLOCKS_PER_SM * sm_count
    if 2 * b * h >= want or L <= _MIN_CHUNK:
        return L
    splits = min(-(-want // (b * h)), -(-L // _MIN_CHUNK))
    chunk = -(-L // splits)
    return min(L, -(-chunk // 64) * 64)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k, v, bias, kv_mask, k_scale, v_scale):
    b, h, d = q.shape
    L = k.shape[1]
    if q.dtype not in _QTYPES:
        raise TypeError(f"decode_attention takes a float32, bfloat16 or float16 query, "
                        f"got {q.dtype}")
    kv_int8 = k.dtype == torch.int8
    if k.dtype != v.dtype or (not kv_int8 and k.dtype != q.dtype):
        raise TypeError(f"decode_attention: k/v must both be {q.dtype} or both "
                        f"int8, got {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in {_HEAD_DIMS}")
    if k.shape != (b, L, h * d) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} are not [b={b}, L, h*d={h * d}]")
    k_kind = _scale_kind(k_scale, b, L, h, d, "k_scale")
    v_kind = _scale_kind(v_scale, b, L, h, d, "v_scale")
    if kv_int8 != (k_kind != _NONE) or kv_int8 != (v_kind != _NONE):
        raise ValueError("decode_attention: int8 slabs need both scales, and "
                         "only int8 slabs take scales")
    flat_scale = {_POS: (b, L, h), _CHAN: (b, 1, h * d)}
    if kv_int8:
        k_scale = k_scale.reshape(flat_scale[k_kind])
        v_scale = v_scale.reshape(flat_scale[v_kind])
    if bias is not None and tuple(bias.shape) != (h, L):
        raise ValueError(f"decode_attention: bias {tuple(bias.shape)} is not [h, L]")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, L):
        raise ValueError(f"decode_attention: kv_mask {tuple(kv_mask.shape)} is not [b, L]")
    args = []
    for name, t, dt in (("q", q, None), ("k", k, None), ("v", v, None),
                        ("bias", bias, torch.float32),
                        ("kv_mask", kv_mask, torch.float32),
                        ("k_scale", k_scale, torch.float32),
                        ("v_scale", v_scale, torch.float32)):
        if t is None:
            args.append(None)
            continue
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if dt is not None and t.dtype != dt:
            raise TypeError(f"decode_attention: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if name in ("k", "v") and t.data_ptr() % 16:
            raise ValueError(f"decode_attention: the {name} slab must start on a 16-byte "
                             "boundary (the kernel reads it in 16-byte loads)")
        args.append(t.data_ptr())
    out = torch.empty(b, h, d, dtype=q.dtype, device=q.device)
    chunk = split_chunk(b, h, L, _sm_count(q.device.index))
    splits = -(-L // chunk)
    work = None
    if splits > 1:
        work = torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device=q.device)
    fn = _build.kernel_fn(_NAME, f"{_NAME}_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, out.data_ptr(), None if work is None else work.data_ptr(), b, L, h, d,
                _QTYPES[q.dtype], int(kv_int8), k_kind, v_kind, chunk, stream)
    _build.check(_NAME, rc)
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     bias: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-query-token attention over a cached K/V slab.

    q ``[b, 1, h, d]`` (or ``[b, h, d]``); k/v flat ``[b, L, h*d]`` (or
    ``[b, L, h, d]``), in q's type or int8; bias ``[h, L]`` (or
    ``[1, h, 1, L]``) f32; kv_mask ``[b, L]``; scales per-position
    ``[b, L, h]`` or per-channel ``[b, 1, h*d]`` f32.  Returns the context in
    q's layout and type.  On CUDA every operand must already be contiguous and
    f32 where stated: the decode loop prepares them once, not per step."""
    squeeze = q.dim() == 4
    if squeeze:
        if q.shape[1] != 1:
            raise ValueError(f"decode_attention wants qlen==1, got {tuple(q.shape)}")
        q = q[:, 0]
    bias = _bias_hl(bias)
    if q.is_cuda:
        b, L = k.shape[:2]
        q = q.contiguous()
        if q.data_ptr() % 16:        # a view off 16 bytes: the query is small, copy it
            q = q.clone()
        out = _launch(q, k.reshape(b, L, -1), v.reshape(b, L, -1), bias,
                      kv_mask, k_scale, v_scale)
    elif q.device.type == "cpu":
        out = decode_attention_reference(q, k, v, bias=bias, kv_mask=kv_mask,
                                         k_scale=k_scale, v_scale=v_scale)
    else:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return out[:, None] if squeeze else out


decode_attention.launches = 0
