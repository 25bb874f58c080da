"""Host-side shared-memory object store of the port, copied from
``tpu_air/core/object_store.py``.

Objects are immutable, keyed by ``ObjectRef``, and shared between the
driver and its worker processes on one host through files in ``/dev/shm``
(tmpfs is shared memory): a writer serializes with out-of-band buffers
(serialization.py), writes to a temp file and atomically renames to seal;
readers ``mmap`` the sealed file and rebuild numpy payloads zero-copy over
the mapping.

The port takes this file store only.  The JAX package's C++ arena
(``tpu_air/_native``) is a later item of the port (ROADMAP Queue 1 item
11); the port
neither imports nor loads it, and ``TPU_AIR_ARENA_BYTES``, the arena's
size, is refused rather than ignored.  Store and spill directories carry
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
        if os.environ.get("TPU_AIR_ARENA_BYTES"):
            raise NotImplementedError(
                "TPU_AIR_ARENA_BYTES sizes the C++ shared-memory arena, which the "
                "port has not ported (ROADMAP Queue 1 item 11: the native object arena); "
                "unset it to use the port's file store")
        self.root = root
        if create:
            os.makedirs(root, exist_ok=True)
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
                    if e.name.startswith("."):
                        continue  # tmp files
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

    # -- read -------------------------------------------------------------
    def contains(self, object_id: str) -> bool:
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

    def delete(self, object_id: str) -> None:
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
