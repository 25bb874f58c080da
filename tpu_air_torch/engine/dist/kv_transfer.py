"""KV-page extraction and insertion, the payload of a preemption migration,
the counterpart of ``tpu_air/engine/dist/kv_transfer.py``.

``migrate_out`` pulls a decoding stream's pages out of its engine's page
pools as CPU tensors keyed by the JAX package's layer paths
(``layer_{i}/attn``), and the destination engine writes them into freshly
allocated unshared pages of ITS pools.  Page-granular device-to-device
copies are the follow-up; this host round trip is the correctness path.

The payload crosses packages: its keys are the Flax cache's paths, and
:func:`validate_kv_payload` and :func:`insert_kv_pages` take numpy arrays as
well as tensors, so the JAX engine's payload (numpy, f32 or ``ml_dtypes``
bf16) lands in the port, and the port's (CPU tensors in the cache's type)
is read by any consumer that turns a tensor into numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from tpu_air_torch.faults import plan as _faults
from tpu_air_torch.models.lm.modeling import AttnCache


class KVTransferError(ValueError):
    """A shipped KV payload does not fit the destination cache: wrong page
    count, page shape, a missing layer, or a type the destination cannot
    hold losslessly.  Raised before any page is written, so a stream that
    cannot be inserted cleanly falls back to journal replay instead of
    decoding from corrupt pages."""


def _kv_layers(cache: Sequence[AttnCache]) -> Iterator[Tuple[str, AttnCache]]:
    """``(path, layer)`` for every layer, under the Flax cache's paths."""
    for i, layer in enumerate(cache):
        yield f"layer_{i}/attn", layer


def extract_kv_pages(cache: Sequence[AttnCache],
                     page_ids: Sequence[int]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Pages ``page_ids`` (in prompt order) of every layer's pools as CPU
    tensors in the cache's type: ``{layer_path: {"k": [n, page_len, h*d],
    "v": ...}}``."""
    if _faults.enabled():
        _faults.perturb("kv.transfer", key=str(len(page_ids)))
    out = {}
    with torch.no_grad():       # plain tensors: the payload leaves the engine
        for path, layer in _kv_layers(cache):
            ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                                  device=layer.cached_key.device)
            out[path] = {"k": layer.cached_key[ids].cpu(),
                         "v": layer.cached_value[ids].cpu()}
    return out


def _as_tensor(pages: Any) -> torch.Tensor:
    """A shipped page array as a CPU tensor: a tensor as it is, a numpy
    array over its bytes (``ml_dtypes`` bf16, which numpy cannot name, by
    its bit pattern)."""
    if isinstance(pages, torch.Tensor):
        return pages
    arr = np.require(pages, requirements=["C", "W"])   # torch takes no read-only array
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


_WIDENS = {torch.float16: (torch.float32, torch.float64),
           torch.bfloat16: (torch.float32, torch.float64),
           torch.float32: (torch.float64,)}


def _lossless_cast(src: torch.dtype, dst: torch.dtype) -> bool:
    """Can every value of ``src`` be represented in ``dst``?  The ``safe``
    casting rule over torch types: the type itself, a wider float
    (bf16 -> f32 is allowed; f32 -> bf16, f16 -> bf16 and bf16 -> f16 are
    not), and an integer numpy calls safe; anything else counts as lossy."""
    if src == dst or dst in _WIDENS.get(src, ()):
        return True
    if src.is_floating_point or dst.is_floating_point:
        return False
    try:
        return bool(np.can_cast(torch.empty(0, dtype=src).numpy().dtype,
                                torch.empty(0, dtype=dst).numpy().dtype, casting="safe"))
    except TypeError:
        return False


def validate_kv_payload(cache: Sequence[AttnCache], page_ids: Sequence[int],
                        payload: Dict[str, Dict[str, Any]]) -> None:
    """Check a shipped payload against the destination cache, raising
    :class:`KVTransferError` on any mismatch (a missing layer or k/v, a
    truncated page count, the page geometry, a lossy type) for every layer
    before anything is written."""
    n = len(page_ids)
    for path, layer in _kv_layers(cache):
        pages = payload.get(path)
        if pages is None:
            raise KVTransferError(f"kv payload missing layer {path!r} "
                                  f"(shipped layers: {sorted(payload)})")
        for name, dst in (("k", layer.cached_key), ("v", layer.cached_value)):
            if name not in pages:
                raise KVTransferError(f"kv payload at {path!r} missing {name!r} pages")
            arr = _as_tensor(pages[name])
            if arr.dim() != dst.dim() or arr.shape[0] != n:
                raise KVTransferError(
                    f"truncated kv payload at {path}/{name}: shipped shape "
                    f"{tuple(arr.shape)} for {n} destination page ids")
            if tuple(arr.shape[1:]) != tuple(dst.shape[1:]):
                raise KVTransferError(
                    f"kv page shape mismatch at {path}/{name}: payload pages are "
                    f"{tuple(arr.shape[1:])}, destination pool holds {tuple(dst.shape[1:])}")
            if not _lossless_cast(arr.dtype, dst.dtype):
                raise KVTransferError(
                    f"kv dtype mismatch at {path}/{name}: payload {arr.dtype} does not "
                    f"fit destination {dst.dtype} losslessly")


def insert_kv_pages(cache: List[AttnCache], page_ids: Sequence[int],
                    payload: Dict[str, Dict[str, Any]]) -> List[AttnCache]:
    """Write shipped pages into ``page_ids`` of this cache, in place (the
    engine owns its pools), and return the same list.  ``page_ids[i]``
    receives the payload's i-th page: both id lists are in prompt order,
    so the two engines' ids need not match.  Raises
    :class:`KVTransferError` before writing anything when the payload does
    not fit."""
    validate_kv_payload(cache, page_ids, payload)
    with torch.inference_mode():
        for path, layer in _kv_layers(cache):
            ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                                  device=layer.cached_key.device)
            for name, dst in (("k", layer.cached_key), ("v", layer.cached_value)):
                dst[ids] = _as_tensor(payload[path][name]).to(dst.device, dst.dtype)
    return cache


def payload_nbytes(payload: Dict[str, Dict[str, Any]]) -> int:
    """Total K+V bytes in a payload."""
    return sum(_as_tensor(arr).nbytes for layer in payload.values() for arr in layer.values())


def payload_pages(payload: Dict[str, Dict[str, Any]]) -> int:
    """Pages per layer in a payload."""
    first = next(iter(payload.values()), None)
    return int(first["k"].shape[0]) if first else 0
