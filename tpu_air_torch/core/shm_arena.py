"""Python wrapper over the port's C++ shared-memory arena store
(``tpu_air_torch/_native/store.cpp``), copied from
``tpu_air/core/shm_arena.py``.

The arena is one mmap'd file in the store directory shared by every process
on the host.  The C++ library owns layout, the atomic index, and the bump
allocator; this wrapper maps the same file and moves the payload bytes —
writes go straight into shared memory, reads come back as memoryview slices
of the mapping (zero-copy both ways).  The layout and the key (sha256 of
the object id) are the JAX package's, so either package's ``Arena`` reads
the other's ``__arena__`` file.
"""

from __future__ import annotations

import hashlib
import mmap
import os
from typing import List, Optional, Tuple


def _key(object_id: str) -> bytes:
    """Fixed 32-byte arena key for an arbitrary-length object id.  The C
    index stores exactly 32 key bytes; hashing (rather than truncating)
    keeps ids like '{trial_id}-report-{seq}' collision-free."""
    return hashlib.sha256(object_id.encode()).digest()


class Arena:
    """Handle to the shared arena for this process."""

    def __init__(self, path: str, create: bool = False,
                 capacity: Optional[int] = None, slots: int = 1 << 16):
        from tpu_air_torch import _native

        self._lib = _native.load_store_lib()
        self.path = path
        if create and not os.path.exists(path):
            capacity = capacity or int(
                os.environ.get("TPU_AIR_ARENA_BYTES", str(256 << 20))
            )
            rc = self._lib.arena_create(path.encode(), capacity, slots)
            if rc not in (0,) and not os.path.exists(path):
                raise OSError(f"arena_create failed: {rc}")
        if not os.path.exists(path):
            # fail fast: missing file means no arena for this store (ENOENT
            # is not the transient "creator still initializing" case)
            raise FileNotFoundError(path)
        # a concurrent creator may still be initializing (magic is written
        # last, release-ordered) — retry briefly before giving up
        import time

        self._h = -1
        for _ in range(50):
            self._h = self._lib.arena_open(path.encode())
            if self._h >= 0 or not os.path.exists(path):
                break
            time.sleep(0.01)
        if self._h < 0:
            raise OSError(f"arena_open({path}) failed: {self._h}")
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, os.path.getsize(path))
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)

    # -- write --------------------------------------------------------------
    def put_chunks(self, object_id: str, chunks: List) -> bool:
        """Write chunks for object_id into the arena. False = no space /
        duplicate (caller falls back to the file store)."""
        bid = _key(object_id)
        total = sum(c.nbytes if isinstance(c, memoryview) else len(c) for c in chunks)
        off = self._lib.arena_alloc(self._h, bid, total)
        if off < 0:
            return False
        pos = int(off)
        for c in chunks:
            b = bytes(c) if not isinstance(c, (bytes, bytearray, memoryview)) else c
            n = b.nbytes if isinstance(b, memoryview) else len(b)
            self._view[pos : pos + n] = b
            pos += n
        if self._lib.arena_seal(self._h, bid) != 0:
            return False
        return True

    # -- read ---------------------------------------------------------------
    def lookup(self, object_id: str) -> Optional[memoryview]:
        """Zero-copy view of a sealed object, or None.  UNPINNED — valid
        only while the object is not deleted (use for contains/peek)."""
        import ctypes

        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.arena_lookup(
            self._h, _key(object_id), ctypes.byref(off), ctypes.byref(size)
        )
        if rc != 1:
            return None
        # read-only: the store's immutability contract (objects are sealed;
        # readers must not be able to mutate shared memory)
        return self._view[off.value : off.value + size.value].toreadonly()

    def lookup_pin(self, object_id: str) -> Optional[Tuple[memoryview, int]]:
        """Zero-copy view + PIN: the bytes stay valid across deletes until
        ``unpin(object_id, offset)``.  Returns (view, offset) or None.  The
        ownership/ref-counting contract of the native core (plasma analog:
        reclamation waits for the last reader)."""
        import ctypes

        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.arena_lookup_pin(
            self._h, _key(object_id), ctypes.byref(off), ctypes.byref(size)
        )
        if rc != 1:
            return None
        view = self._view[off.value : off.value + size.value].toreadonly()
        return view, off.value

    def unpin(self, object_id: str, offset: int) -> None:
        """Release one pin.  Safe after close() (no-op on a dead handle)."""
        if self._h >= 0:
            self._lib.arena_unpin(self._h, _key(object_id), offset)

    def pins(self, object_id: str) -> int:
        return int(self._lib.arena_pins(self._h, _key(object_id)))

    def contains(self, object_id: str) -> bool:
        return self.lookup(object_id) is not None

    def delete(self, object_id: str) -> None:
        self._lib.arena_delete(self._h, _key(object_id))

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "capacity": int(self._lib.arena_capacity(self._h)),
            "used": int(self._lib.arena_used(self._h)),
            "live_objects": int(self._lib.arena_live_objects(self._h)),
            "sealed_bytes": int(self._lib.arena_sealed_bytes(self._h)),
            "free_bytes": int(self._lib.arena_free_bytes(self._h)),
            "leaked_bytes": int(self._lib.arena_leaked_bytes(self._h)),
        }

    def close(self) -> None:
        """Release the C-side mapping + handle.  The Python mmap backing any
        zero-copy views stays alive via refcounting (views → self._view →
        self._mm), so outstanding reads remain valid."""
        if self._h >= 0:
            self._lib.arena_close(self._h)
            self._h = -1


def open_arena(root: str, create: bool) -> Optional[Arena]:
    """Best-effort arena for a store directory; None when natives are
    unavailable (no compiler) — callers use the file store only."""
    path = os.path.join(root, "__arena__")
    try:
        return Arena(path, create=create)
    except Exception:  # noqa: BLE001 — any native failure degrades to the file store
        return None
