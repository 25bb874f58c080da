"""Read and write the JAX package's ``params.msgpack``, without flax.

The JAX package checkpoints a parameter tree with flax's
``serialization.msgpack_serialize``: msgpack maps with str keys whose leaves
are numpy arrays, each packed as msgpack extension type 1 around a nested
msgpack array ``[shape, dtype name, raw C-order bytes]``.  An array larger
than 2**30 bytes is split by flax into a map ``{"__msgpack_chunked_array__":
True, "shape": {"0": ...}, "chunks": {"0": array, ...}}`` of flat chunks.

This module reads and writes that subset of msgpack from the spec
(https://github.com/msgpack/msgpack/blob/master/spec.md): maps, arrays, str,
bin, ints, floats, nil, bool, and the ndarray (1) and numpy-scalar (3)
extension types.  It needs neither flax nor the ``msgpack`` package, which
the port's machines need not have.  Anything else raises ``ValueError``
naming what it could not read.

numpy has no bfloat16: a bfloat16 leaf is read as float32, exactly (a
bfloat16 is the high half of a float32).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
# flax splits a leaf above this many bytes into chunks
MAX_CHUNK_SIZE = 2 ** 30
_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
           "uint64", "float16", "float32", "float64")


class _Reader:
    def __init__(self, buf, bin_views: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.bin_views = bin_views  # bin as views of buf, not copies

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated input at byte {self.pos} (wanted {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        if t in (0xC4, 0xC5, 0xC6):
            raw = self.take(self.unpack((">B", ">H", ">I")[t - 0xC4]))
            return raw if self.bin_views else bytes(raw)
        if t in (0xD9, 0xDA, 0xDB):
            return self._str(self.unpack((">B", ">H", ">I")[t - 0xD9]))
        if t in (0xDC, 0xDD):
            return self._array(self.unpack((">H", ">I")[t - 0xDC]))
        if t in (0xDE, 0xDF):
            return self._map(self.unpack((">H", ">I")[t - 0xDE]))
        if 0xD4 <= t <= 0xD8:
            return self._ext(1 << (t - 0xD4))
        if t in (0xC7, 0xC8, 0xC9):
            return self._ext(self.unpack((">B", ">H", ">I")[t - 0xC7]))
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x} at byte {self.pos - 1}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"msgpack: extension type {code} is not a flax ndarray")


def _ndarray_from_bytes(data) -> np.ndarray:
    r = _Reader(data, bin_views=True)
    tpl = r.read()
    if not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("msgpack: a flax ndarray is not [shape, dtype, bytes]")
    shape, name, raw = tpl
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    if name not in _DTYPES:
        raise ValueError(f"msgpack: array dtype {name!r} is not one the port reads "
                         f"({', '.join(_DTYPES + ('bfloat16',))})")
    return np.frombuffer(raw, dtype=np.dtype(name).newbyteorder("<")).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(blob: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(blob)`` gives: nested
    dicts with numpy leaves (bfloat16 leaves as float32)."""
    r = _Reader(blob)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes after the tree")
    return _unchunk(tree)


# -- writer ----------------------------------------------------------------

def _head(out: List[bytes], n: int, fix: Tuple[int, int], wide: Tuple[int, ...]) -> None:
    """A length header: the fix form below ``fix[1]`` entries, else the
    8-, 16- or 32-bit form (``wide`` holds their type bytes; 0 = none)."""
    base, limit = fix
    if n < limit:
        out.append(bytes([base | n]))
        return
    for code, fmt, cap in zip(wide, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= cap:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(x: Any, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, (bool, np.bool_)):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        if 0 <= x <= 0x7F or -32 <= x < 0:
            out.append(struct.pack(">b" if x < 0 else ">B", x))
        elif x >= 0:
            out.append(b"\xcf" + struct.pack(">Q", x))
        else:
            out.append(b"\xd3" + struct.pack(">q", x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _head(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(x, (bytes, bytearray)):
        _head(out, len(x), (0, 0), (0xC4, 0xC5, 0xC6))
        out.append(bytes(x))
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), (0x90, 16), (0, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        _head(out, len(x), (0x80, 16), (0, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        if a.dtype.name not in _DTYPES:
            raise ValueError(f"msgpack: array dtype {a.dtype} is not one flax's reader takes here")
        inner: List[bytes] = []
        _pack([list(a.shape), a.dtype.name, a.astype(a.dtype.newbyteorder("<")).tobytes("C")],
              inner)
        data = b"".join(inner)
        _head(out, len(data), (0, 0), (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", _EXT_NPSCALAR if isinstance(x, np.generic)
                               else _EXT_NDARRAY))
        out.append(data)
    else:
        raise ValueError(f"msgpack: cannot write a {type(x).__name__}")


def _chunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        per = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {_CHUNKED: True,
                "shape": {str(i): int(s) for i, s in enumerate(tree.shape)},
                "chunks": {str(i): flat[j:j + per]
                           for i, j in enumerate(range(0, flat.size, per))}}
    return tree


def dumps(tree: Any) -> bytes:
    """Bytes that ``flax.serialization.msgpack_restore`` reads back as
    ``tree`` (nested str-keyed dicts with numpy leaves)."""
    out: List[bytes] = []
    _pack(_chunk(tree), out)
    return b"".join(out)
