"""The port's native (C++) runtime parts, copied from ``tpu_air/_native``:
the shared-memory object arena (``store.cpp``, loaded with :mod:`ctypes`)
and the GCS control-plane daemon (``gcs_server.cpp`` over ``gcs.proto``).

Both are built from these sources at first use into
``tpu_air_torch/_build/``, never next to the sources, and so is the
arena's concurrency hammer (``store_hammer.cc``) under AddressSanitizer and
ThreadSanitizer (:func:`build_store_hammer`):

* the arena library needs ``g++`` (``$CXX``) and pthreads;
* the daemon needs ``protoc``, the protobuf C++ headers and library as
  well (``pkg-config protobuf`` where it is known, else ``-lprotobuf``),
  and its client the Python ``google.protobuf`` runtime.

Each product's file name carries a hash of its sources, its flags and the
compiler's version (and, for the daemon, of the ``protoc`` version that
generated its C++), so an edited source is rebuilt and a stale library or
daemon, or one another toolchain built, is never loaded.  A build
compiles to a temporary name and renames; a file lock in the build
directory makes concurrent processes wait for one build instead of each
compiling.  Nothing here runs at import time.  Callers degrade as the JAX
package does: a store whose arena does not build uses its files, a runtime
whose daemon does not build runs without a GCS.

``gcs_pb2.py`` in ``tpu_air_torch/control/`` is generated from
``gcs.proto`` by :func:`generate_python_bindings` and committed.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
STORE_FLAGS = ("-std=c++17", "-g", "-O2", "-shared", "-fPIC")
GCS_FLAGS = ("-std=c++17", "-O2")
# where protobuf's headers are looked for when pkg-config does not name them
_INCLUDE_DIRS = ("/usr/include", "/usr/local/include")

_lock = threading.Lock()
_store_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's native arena and GCS daemon are "
                           "built from source at first use")
    return cxx


@functools.lru_cache(maxsize=None)
def _cxx_version() -> str:
    return _first_line([_cxx(), "--version"]) or ""


def _digest(sources, *extra: str) -> str:
    h = hashlib.sha256()
    for src in sources:
        with open(os.path.join(_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read() + b"\0")
    for e in extra:
        h.update(e.encode() + b"\0")
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _build_lock():
    """One build at a time, across threads and processes (xdist workers,
    a runtime's workers): the others wait, then find the product built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock:
        # a lock, never written: flock on a read-only descriptor
        fd = os.open(os.path.join(BUILD_DIR, ".native.lock"), os.O_RDONLY | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # closing releases the lock


def _compile(cmd: List[str], tmp: str, final: str, what: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{what} failed to build (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, final)


# -- the arena ---------------------------------------------------------------


def store_lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libtpu_air_torch_store-"
                                   f"{_digest(['store.cpp'], *STORE_FLAGS, _cxx_version())}.so")


def build_store() -> str:
    """Path of the arena library, compiled first if it is not built."""
    final = store_lib_path()
    if os.path.exists(final):
        return final
    with _build_lock():
        if not os.path.exists(final):
            tmp = f"{final}.{os.getpid()}.tmp"
            _compile([_cxx(), *STORE_FLAGS, os.path.join(_DIR, "store.cpp"), "-o", tmp,
                      "-lpthread"], tmp, final, "store.cpp")
    return final


def load_store_lib() -> ctypes.CDLL:
    """The arena library, typed (the JAX package's signatures)."""
    global _store_lib
    if _store_lib is not None:
        return _store_lib
    lib = ctypes.CDLL(build_store())
    lib.arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.arena_create.restype = ctypes.c_int
    lib.arena_open.argtypes = [ctypes.c_char_p]
    lib.arena_open.restype = ctypes.c_int
    lib.arena_close.argtypes = [ctypes.c_int]
    lib.arena_close.restype = ctypes.c_int
    lib.arena_alloc.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64]
    lib.arena_alloc.restype = ctypes.c_int64
    lib.arena_seal.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.arena_seal.restype = ctypes.c_int
    lib.arena_lookup.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.arena_lookup.restype = ctypes.c_int
    lib.arena_delete.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.arena_delete.restype = ctypes.c_int
    lib.arena_lookup_pin.argtypes = lib.arena_lookup.argtypes
    lib.arena_lookup_pin.restype = ctypes.c_int
    lib.arena_unpin.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64]
    lib.arena_unpin.restype = ctypes.c_int
    lib.arena_pins.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.arena_pins.restype = ctypes.c_int64
    for fn in ("arena_capacity", "arena_used", "arena_live_objects",
               "arena_sealed_bytes", "arena_free_bytes", "arena_leaked_bytes"):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_int]
        f.restype = ctypes.c_uint64
    _store_lib = lib
    return lib


# -- the store hammer under the sanitizers ------------------------------------

# the race-detection harness's builds (the JAX package's ``build.sh
# sanitizers``): AddressSanitizer for the cross-process protocol,
# ThreadSanitizer for the data races of one process's threads
SANITIZERS = {"asan": "-fsanitize=address", "tsan": "-fsanitize=thread"}
HAMMER_FLAGS = ("-std=c++17", "-g", "-O1", "-fno-omit-frame-pointer")


def store_hammer_path(sanitizer: str) -> str:
    flags = (*HAMMER_FLAGS, SANITIZERS[sanitizer])
    digest = _digest(["store.cpp", "store_hammer.cc"], *flags, _cxx_version())
    return os.path.join(BUILD_DIR, f"store_hammer_{sanitizer}-{digest}")


def build_store_hammer(sanitizer: str) -> str:
    """Path of ``store_hammer.cc`` linked with ``store.cpp`` under
    ``sanitizer`` (``"asan"`` or ``"tsan"``), compiled first if it is not
    built.  Run it as ``<path> threads|procs|dup <arena> <writers>
    <readers> <objects a writer>``; it exits 0 when every object was found
    sealed and byte-exact and the sanitizer reported nothing."""
    final = store_hammer_path(sanitizer)
    if os.path.exists(final):
        return final
    with _build_lock():
        if not os.path.exists(final):
            tmp = f"{final}.{os.getpid()}.tmp"
            _compile([_cxx(), *HAMMER_FLAGS, SANITIZERS[sanitizer],
                      os.path.join(_DIR, "store.cpp"), os.path.join(_DIR, "store_hammer.cc"),
                      "-o", tmp, "-lpthread"], tmp, final, f"store_hammer.cc ({sanitizer})")
    return final


# -- the GCS daemon ----------------------------------------------------------


def _first_line(cmd: List[str]) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    lines = (out.stdout or out.stderr).strip().splitlines()
    return lines[0] if lines else ""


@functools.lru_cache(maxsize=None)
def _protobuf_flags() -> tuple:
    """Compile and link flags for protobuf: pkg-config's, else -lprotobuf."""
    flags = _first_line(["pkg-config", "--cflags", "--libs", "protobuf"]) \
        if shutil.which("pkg-config") else None
    return tuple(flags.split()) if flags else ("-lprotobuf",)


def _protobuf_header() -> Optional[str]:
    dirs = [f[2:] for f in _protobuf_flags() if f.startswith("-I")] + list(_INCLUDE_DIRS)
    for d in dirs:
        path = os.path.join(d, "google", "protobuf", "message.h")
        if os.path.exists(path):
            return path
    return None


def toolchain() -> Dict[str, Optional[str]]:
    """What the native parts need, as found here: each tool's version line
    (the header's path) or None where it is missing."""
    try:
        cxx = _first_line([_cxx(), "--version"])
    except RuntimeError:
        cxx = None
    protoc = shutil.which("protoc")
    try:
        from google import protobuf as _pb

        py_pb = _pb.__version__
    except ImportError:
        py_pb = None
    return {"g++": cxx, "protoc": _first_line([protoc, "--version"]) if protoc else None,
            "protobuf_headers": _protobuf_header(), "python_protobuf": py_pb}


def gcs_missing(tools: Optional[Dict[str, Optional[str]]] = None) -> Optional[str]:
    """Why the GCS daemon cannot be built or driven here, or None."""
    tools = tools or toolchain()
    missing = [name for name, key in (("g++", "g++"), ("protoc", "protoc"),
                                      ("protobuf headers", "protobuf_headers"),
                                      ("Python protobuf", "python_protobuf"))
               if not tools[key]]
    return "no " + ", no ".join(missing) if missing else None


@functools.lru_cache(maxsize=None)
def gcs_binary_path() -> str:
    protoc = shutil.which("protoc")
    if not protoc:
        raise RuntimeError("protoc not found: the GCS daemon's C++ bindings are "
                           "generated from gcs.proto at build time")
    version = _first_line([protoc, "--version"]) or ""
    digest = _digest(["gcs.proto", "gcs_server.cpp"], *GCS_FLAGS, version, _cxx_version(),
                     *_protobuf_flags())
    return os.path.join(BUILD_DIR, f"tpu_air_torch_gcs-{digest}")


def build_gcs() -> str:
    """Path of the GCS daemon, built first if it is not: ``protoc`` writes
    the C++ bindings of ``gcs.proto`` into a temporary directory, and g++
    links them with ``gcs_server.cpp`` against protobuf."""
    final = gcs_binary_path()
    if os.path.exists(final):
        return final
    with _build_lock():
        if os.path.exists(final):
            return final
        missing = gcs_missing()
        if missing:
            raise RuntimeError(f"the GCS daemon cannot be built or driven here ({missing})")
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as gen:
            proc = subprocess.run([shutil.which("protoc"), f"--proto_path={_DIR}",
                                   f"--cpp_out={gen}", os.path.join(_DIR, "gcs.proto")],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"protoc failed on gcs.proto:\n{proc.stderr}")
            tmp = f"{final}.{os.getpid()}.tmp"
            _compile([_cxx(), *GCS_FLAGS, f"-I{gen}", "-o", tmp,
                      os.path.join(_DIR, "gcs_server.cpp"), os.path.join(gen, "gcs.pb.cc"),
                      *_protobuf_flags(), "-lpthread"], tmp, final, "gcs_server.cpp")
    return final


def generate_python_bindings(out_dir: str) -> str:
    """Generate ``gcs_pb2.py`` from ``gcs.proto`` into ``out_dir``; returns
    its path.  The proto is staged as ``tpu_air_torch/control/gcs.proto``,
    so the descriptor's file name is unique to the port (the JAX package
    registers ``gcs.proto``; one process loads both) and the message
    classes' module is ``tpu_air_torch.control.gcs_pb2``, where the file
    is committed."""
    protoc = shutil.which("protoc")
    if not protoc:
        raise RuntimeError("protoc not found")
    with tempfile.TemporaryDirectory() as stage:
        rel = os.path.join("tpu_air_torch", "control", "gcs.proto")
        os.makedirs(os.path.join(stage, os.path.dirname(rel)))
        shutil.copyfile(os.path.join(_DIR, "gcs.proto"), os.path.join(stage, rel))
        subprocess.run([protoc, f"--proto_path={stage}", f"--python_out={stage}", rel],
                       check=True, capture_output=True, timeout=120)
        out = os.path.join(out_dir, "gcs_pb2.py")
        shutil.copyfile(os.path.join(stage, "tpu_air_torch", "control", "gcs_pb2.py"), out)
    return out
