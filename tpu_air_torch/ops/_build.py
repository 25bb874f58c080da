"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface under ``tpu_air_torch/_build/`` and loaded
with :mod:`ctypes`.  The library's file name carries a hash of its source and
of the shared headers ``ops/csrc/*.cuh``, so an edited kernel or header is
rebuilt and a stale library is never loaded.  ``ptxas -v``
reports each kernel's registers, shared memory and spills; :func:`build`
returns that report for every source it compiled.  Nothing here
runs at import time: the CPU tests import every module of the port on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _lib_path(name: str) -> str:
    """The library's path: its name carries a hash of ``<name>.cu``, of every
    shared header ``csrc/*.cuh`` (in sorted order) and of the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, final) or None when
    the library is already built."""
    final = _lib_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, final


def _finish(name: str, started) -> str:
    proc, tmp, final = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, final)
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, all nvcc processes started together.
    Returns the compiler's output (the ``ptxas -v`` report) of each source
    compiled here; a source already built is absent."""
    names = list(names)
    with _lock:
        # airlint: disable=CC003 — nvcc runs under the lock on purpose: a
        # second thread that wants the same library waits for this build
        # instead of starting its own; nothing else takes the lock
        started = {n: _start(n) for n in names}
        logs, errors = {}, []
        for n, s in started.items():
            if s is None:
                continue
            try:
                logs[n] = _finish(n, s)
            except RuntimeError as e:  # collect every failure, then raise once
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def kernel_fn(name: str, entry: str, argtypes):
    """The C entry ``entry`` of ``csrc/<name>.cu``, typed: pointers and the
    stream as ``c_void_p`` (a plain int would be cut to 32 bits), returning
    the launch's ``cudaError_t``."""
    fn = getattr(load(name), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if rc != 0:
        fn = getattr(load(name), f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"({fn(rc).decode()})")
