"""Serialization for the port's object plane, copied from
``tpu_air/core/serialization.py``.

The reference stack serializes task args/returns with pickle5 + out-of-band
buffers so large numpy/Arrow payloads move without copies (Ray core_worker,
SURVEY.md §2B "plasma").  We reproduce that contract in pure Python: values are
cloudpickled with protocol 5, out-of-band ``PickleBuffer`` payloads are
concatenated after a small header, and deserialization can reconstruct the
buffers either as copies (bytes) or as zero-copy views over an ``mmap``.

Wire format::

    [u64 npickle][u32 nbuf][u64 len_0]...[u64 len_{nbuf-1}][pickle][buf_0]...

All integers little-endian.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, List, Tuple

import cloudpickle

_HDR = struct.Struct("<QI")
_LEN = struct.Struct("<Q")


def serialize(value: Any) -> List[memoryview | bytes]:
    """Serialize ``value`` into a list of chunks suitable for writev-style IO."""
    buffers: List[pickle.PickleBuffer] = []
    payload = cloudpickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    chunks: List[memoryview | bytes] = []
    raw = [b.raw() for b in buffers]
    header = bytearray(_HDR.pack(len(payload), len(raw)))
    for mv in raw:
        header += _LEN.pack(mv.nbytes)
    chunks.append(bytes(header))
    chunks.append(payload)
    chunks.extend(raw)
    return chunks


def serialized_nbytes(chunks: List[memoryview | bytes]) -> int:
    return sum(c.nbytes if isinstance(c, memoryview) else len(c) for c in chunks)


def deserialize(buf, zero_copy: bool = True) -> Any:
    """Deserialize from a buffer (bytes / memoryview / mmap).

    With ``zero_copy=True`` the out-of-band buffers are memoryview slices of
    ``buf`` — the caller must keep ``buf`` alive for the lifetime of the value
    (the object store pins the mmap on the value via a finalizer).
    """
    payload, pieces = _parse_wire(buf)
    oob = pieces if zero_copy else [p.tobytes() for p in pieces]
    return pickle.loads(payload, buffers=oob)


def _parse_wire(buf) -> Tuple[memoryview, List[memoryview]]:
    """Split a wire-format buffer into (pickle payload, oob piece views)."""
    mv = memoryview(buf)
    npickle, nbuf = _HDR.unpack_from(mv, 0)
    off = _HDR.size
    lens: List[int] = []
    for _ in range(nbuf):
        (n,) = _LEN.unpack_from(mv, off)
        lens.append(n)
        off += _LEN.size
    payload = mv[off : off + npickle]
    off += npickle
    pieces: List[memoryview] = []
    for n in lens:
        pieces.append(mv[off : off + n])
        off += n
    return payload, pieces


def dumps(value: Any) -> bytes:
    """One-shot contiguous serialization (control-plane messages)."""
    out = bytearray()
    for c in serialize(value):
        out += c
    return bytes(out)


def loads(data: bytes) -> Any:
    return deserialize(data, zero_copy=False)
