"""Host-side shared-memory object store of the port, copied from
``tpu_air/core/object_store.py``.

Objects are immutable, keyed by ``ObjectRef``, and shared between the
driver and its worker processes on one host through files in ``/dev/shm``
(tmpfs is shared memory): a writer serializes with out-of-band buffers
(serialization.py), writes to a temp file and atomically renames to seal;
readers ``mmap`` the sealed file and rebuild numpy payloads zero-copy over
the mapping.

The port's C++ shared-memory arena (``tpu_air_torch/_native/store.cpp``,
wrapped by shm_arena.py) is the preferred home of every object that fits,
as in the JAX package: one ``__arena__`` file in the store directory,
``TPU_AIR_ARENA_BYTES`` large (256 MiB by default).  The arena owns object
lifecycle in native code: zero-copy reads hold a cross-process PIN
refcount, ``delete`` parks pinned objects in a zombie state, and the last
unpin reclaims the block into a shared free list for reuse — the plasma
ownership contract.  The file store remains for objects that do not fit
(and spills them past ``TPU_AIR_STORE_BYTES``), and for a store whose
arena does not build (no compiler).  Store and spill directories carry
the prefix ``tpu_air_torch-``, so a port runtime and a JAX package runtime
in one process never share one.
"""

from __future__ import annotations

import mmap
import os
import secrets
import time
from typing import Any, Optional

from . import serialization
from tpu_air_torch.faults import plan as _faults


class ObjectRef:
    """Handle to an immutable object in the store.

    Mirrors the semantics of the reference's ``ray._raylet.ObjectRef`` (leaks
    into user code at Scaling_batch_inference.ipynb:cc-127): hashable, cheap to
    copy between processes, resolvable with ``tpu_air_torch.get``.
    """

    __slots__ = ("id",)

    def __init__(self, id: str):
        self.id = id

    def hex(self) -> str:
        return self.id

    def __repr__(self) -> str:
        return f"ObjectRef({self.id})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __reduce__(self):
        return (ObjectRef, (self.id,))


def new_object_id() -> str:
    return secrets.token_hex(16)


class ObjectStore:
    """File-per-object store rooted in shared memory.

    The store directory is created by the head process and shared (by path)
    with every worker; any process may put or get.  Sealing is atomic
    (``os.rename``), so a reader either sees a complete object or none.
    """

    def __init__(self, root: str, create: bool = False):
        self.root = root
        if create:
            os.makedirs(root, exist_ok=True)
        # C++ shared-memory arena (plasma analog): preferred home for objects
        # that fit; the file-per-object path remains for large objects,
        # arena-full fallback, and compiler-less environments.
        from . import shm_arena

        self._arena = shm_arena.open_arena(root, create)
        self._arena_retry_at = 0.0
        # Spilling (reference: "efficient memory usage, object spilling",
        # Introduction_to_Ray_AI_Runtime.ipynb:cc-3): the store root lives in
        # tmpfs (RAM); when file objects exceed TPU_AIR_STORE_BYTES, sealed
        # objects move to a DISK directory and restore transparently on get.
        # 0 (default) = unlimited, no scanning overhead on the hot path.
        self._file_budget = int(os.environ.get("TPU_AIR_STORE_BYTES", "0") or 0)
        # deterministic from root so every process of the session agrees; a
        # user-configured dir gets a per-session subdir so destroy() can
        # never wipe a concurrent session's spilled objects
        session_tag = os.path.basename(root.rstrip(os.sep))
        custom = os.environ.get("TPU_AIR_SPILL_DIR")
        self._spill_dir = (
            os.path.join(custom, session_tag) if custom
            else os.path.join("/var/tmp", f"tpu_air_torch-spill-{session_tag}")
        )

    # -- paths ------------------------------------------------------------
    def _path(self, object_id: str) -> str:
        return os.path.join(self.root, object_id)

    def _spill_path(self, object_id: str) -> str:
        return os.path.join(self._spill_dir, object_id)

    def _ensure_spill_dir(self) -> None:
        """Create the spill dir with an ``.owner`` marker naming the store
        root's absolute path, so the stale-session sweeper can check THAT
        path for liveness instead of guessing at default base dirs."""
        os.makedirs(self._spill_dir, exist_ok=True)
        marker = os.path.join(self._spill_dir, ".owner")
        # written unconditionally: a later session reusing the same spill-dir
        # name (same root basename, different base dir) must not inherit a
        # dead predecessor's marker — the sweeper would reap it as stale
        tmp = f"{marker}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(os.path.abspath(self.root))
                f.flush()
                os.fsync(f.fileno())  # airlint CS002: a torn marker reads
                # as a bogus root path and the sweeper reaps a live session
            os.rename(tmp, marker)
        except OSError:
            pass

    # -- spilling ----------------------------------------------------------
    def _scan_files(self):
        """(mtime, size, name) for sealed file objects under the root."""
        out = []
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    if e.name.startswith((".", "__")):
                        continue  # tmp files / __arena__
                    try:
                        st = e.stat()
                    except OSError:
                        continue
                    out.append((st.st_mtime, st.st_size, e.name))
        except OSError:
            pass
        return out

    def _spill_object(self, name: str) -> bool:
        """Move one sealed object root → spill dir (copy, seal, unlink).
        Concurrent readers stay safe: an already-open mmap survives the
        unlink, and get() falls back to the spill path on FileNotFound."""
        src, dst = self._path(name), self._spill_path(name)
        tmp = os.path.join(self._spill_dir, f".tmp-{name}-{os.getpid()}")
        try:
            import shutil

            shutil.copyfile(src, tmp)
            with open(tmp, "rb") as f:
                os.fsync(f.fileno())  # airlint CS002: copyfile leaves the
                # bytes in page cache; sealing before they are durable can
                # survive a power loss that the data does not — and the
                # source is unlinked right after
            os.chmod(tmp, 0o444)
            os.rename(tmp, dst)  # atomic seal in the spill dir
            os.chmod(src, 0o644)
            os.remove(src)
            return True
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False

    def _make_room(self, need: int) -> bool:
        """Spill oldest sealed objects until ``need`` bytes fit under the
        budget.  True when the new object can be written to the root."""
        if need > self._file_budget:
            # spilling residents can't help — don't evict the hot set for an
            # object that is going to disk regardless
            self._ensure_spill_dir()
            return False
        files = self._scan_files()
        usage = sum(s for _, s, _ in files)
        if usage + need <= self._file_budget:
            return True
        self._ensure_spill_dir()
        for _, size, name in sorted(files):
            if usage + need <= self._file_budget:
                break
            if self._spill_object(name):
                usage -= size
        return usage + need <= self._file_budget

    def spill_stats(self) -> dict:
        objs, total = 0, 0
        try:
            with os.scandir(self._spill_dir) as it:
                for e in it:
                    if e.name.startswith("."):
                        continue
                    try:
                        total += e.stat().st_size
                        objs += 1
                    except OSError:
                        pass
        except OSError:
            pass
        return {"spill_dir": self._spill_dir, "spilled_objects": objs,
                "spilled_bytes": total, "budget_bytes": self._file_budget}

    # -- write ------------------------------------------------------------
    def put(self, value: Any, object_id: Optional[str] = None) -> ObjectRef:
        object_id = object_id or new_object_id()
        if _faults.enabled():
            # the write-side twin of the get hook: every producer (weights
            # publish, batch chunks, journal snapshots) funnels through
            # here, so one site gives the chaos lane a handle on all of
            # them — found by airlint FI001's funnel-coverage audit
            _faults.perturb("object_store.put", key=object_id)
        self.put_serialized(serialization.serialize(value), object_id)
        return ObjectRef(object_id)

    def put_serialized(self, chunks, object_id: str) -> None:
        if self._arena is not None and self._arena.put_chunks(object_id, chunks):
            return
        target_root = self.root
        if self._file_budget:
            need = sum(
                c.nbytes if isinstance(c, memoryview) else len(c) for c in chunks
            )
            if not self._make_room(need):
                # even after spilling everything the new object busts the
                # tmpfs budget — write it straight to disk
                self._ensure_spill_dir()
                target_root = self._spill_dir
        tmp = os.path.join(target_root, f".tmp-{object_id}-{os.getpid()}")
        with open(tmp, "wb") as f:
            for c in chunks:
                f.write(c)
            f.flush()
            os.fsync(f.fileno())  # airlint CS002: the rename seal claims
            # crash atomicity for sealed objects — that claim is only true
            # once the bytes are durable, not just in page cache
        os.chmod(tmp, 0o444)  # immutability contract
        os.rename(tmp, os.path.join(target_root, object_id))

    def _maybe_reopen_arena(self) -> None:
        """Heal a failed arena open.  Writers put arena-resident objects with
        no file fallback, so a process whose first open failed (e.g. it raced
        the .so build) must be able to recover — otherwise its gets would
        block forever on objects that only exist in the arena."""
        if self._arena is not None:
            return
        now = time.monotonic()
        if now < self._arena_retry_at:
            return
        self._arena_retry_at = now + 0.5  # rate-limit
        if os.path.exists(os.path.join(self.root, "__arena__")):
            from . import shm_arena

            self._arena = shm_arena.open_arena(self.root, create=False)

    # -- read -------------------------------------------------------------
    def contains(self, object_id: str) -> bool:
        self._maybe_reopen_arena()
        if self._arena is not None and self._arena.contains(object_id):
            return True
        if os.path.exists(self._path(object_id)):
            return True
        return bool(self._file_budget) and os.path.exists(self._spill_path(object_id))

    def wait_for(self, object_id: str, timeout: Optional[float] = None) -> bool:
        """Block until the object is sealed. Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.0005
        while not self.contains(object_id):
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(delay)
            delay = min(delay * 2, 0.01)
        return True

    def get(self, object_id: str, timeout: Optional[float] = None) -> Any:
        if _faults.enabled():
            # "delay" stalls the fetch; "drop" raises the same TimeoutError a
            # real store timeout produces, so recovery paths see the true shape
            _faults.perturb("object_store.get", key=object_id)
        if not self.wait_for(object_id, timeout):
            raise TimeoutError(f"object {object_id} not available after {timeout}s")
        if self._arena is not None:
            pinned = self._arena.lookup_pin(object_id)
            if pinned is not None:
                return self._get_pinned(object_id, *pinned)
        # root first, spill-dir fallback; a concurrent _make_room may move
        # the object between ANY two syscalls here, so both the stat and the
        # open must tolerate disappearance and retry the other location
        fd = size = None
        for _ in range(3):
            for path in (self._path(object_id), self._spill_path(object_id)):
                try:
                    fd = os.open(path, os.O_RDONLY)
                    size = os.fstat(fd).st_size
                    break
                except FileNotFoundError:
                    continue
            if fd is not None:
                break
        if fd is None:
            raise TimeoutError(f"object {object_id} vanished mid-read")
        if size == 0:
            os.close(fd)
            return serialization.loads(serialization.dumps(None))
        try:
            m = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        # Zero-copy lifetime: out-of-band buffers come back as memoryview
        # slices of the mmap; any numpy array built over them holds a
        # reference chain (ndarray → memoryview → mmap), so the mapping stays
        # valid exactly as long as the value references it.
        return serialization.deserialize(m, zero_copy=True)

    def _get_pinned(self, object_id: str, view, offset: int) -> Any:
        """Deserialize an arena object under a read pin (native ownership:
        the C++ arena won't reclaim the bytes while the pin is held).

        The pin is released when the LAST out-of-band buffer holder dies
        (``serialization.deserialize_pinned``), not when the top-level value
        dies: a derived object that escapes its container — a Series pulled
        out of a DataFrame, an array extracted from a dict — keeps its
        holder alive through the buffer-protocol chain, so ``delete`` +
        block reuse can never invalidate memory anything still references.
        A value holding no views (nbuf == 0) unpins immediately.
        """
        import weakref

        try:
            value, holders = serialization.deserialize_pinned(view)
        except BaseException:  # unpin on ANY failure (even KeyboardInterrupt), then surface
            self._arena.unpin(object_id, offset)
            raise
        if not holders:
            self._arena.unpin(object_id, offset)
            return value
        import threading

        # finalizers run in whichever thread drops the last reference, so
        # the countdown must be atomic
        lock = threading.Lock()
        remaining = [len(holders)]
        unpin = self._arena.unpin

        def _release(lock=lock, remaining=remaining, unpin=unpin,
                     object_id=object_id, offset=offset):
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                unpin(object_id, offset)

        for h in holders:
            weakref.finalize(h, _release)
        return value

    def delete(self, object_id: str) -> None:
        if self._arena is not None:
            self._arena.delete(object_id)
        for path in (self._path(object_id), self._spill_path(object_id)):
            try:  # chmod best-effort: files are sealed 0o444
                os.chmod(path, 0o644)
            except OSError:
                pass
            try:  # remove regardless — a chmod failure must not skip it
                os.remove(path)
            except FileNotFoundError:
                pass

    def destroy(self) -> None:
        if self._arena is not None:
            self._arena.close()
            self._arena = None
        for d in (self.root, self._spill_dir):
            try:
                for name in os.listdir(d):
                    try:
                        os.chmod(os.path.join(d, name), 0o644)
                        os.remove(os.path.join(d, name))
                    except OSError:
                        pass
                os.rmdir(d)
            except OSError:
                pass
