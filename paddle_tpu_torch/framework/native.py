"""Loader of the port's host runtime (↔ paddle_tpu/framework/native.py).

The runtime pieces that must be native live in C++ with a plain C
interface, bound with ctypes: the collective watchdog's monitor thread
(`csrc/host/watchdog.cc`, used by `distributed.comm_watchdog`) and the
rendezvous store's server and client (`csrc/host/tcp_store.cc`, used by
`distributed.store`). Both are copies of the JAX package's `native/`
sources.

At first use the host C++ compiler (`$CXX`, else `g++`) builds the sources
into `paddle_tpu_torch/_build/host/` (gitignored), under a file name that
carries a hash of the sources and the flags, as `ops/_build.py` caches the
CUDA objects; an edited source never loads a stale build. A file lock
serializes the ranks of one host.

The reference's loader runs `make -C native` and returns None when the
build fails, and its consumers fall back to pure Python. This loader
raises instead, naming the compiler's output (ROADMAP, "Not mirrored on
purpose").
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["build", "load"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build" / "host"
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread"]

_lib = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (set CXX or install g++); "
                           "the port's host runtime is built from "
                           "paddle_tpu_torch/csrc/host at first use")
    return cxx


def _sources():
    return sorted(HOST_SRC.glob("*.cc"))


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpaddle_tpu_torch_host_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/host/*.cc into one shared library (a no-op when the
    library of these exact sources exists); returns its path. Raises
    RuntimeError carrying the compiler's output when the build fails."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # a sibling rank built it while this one waited
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            part = os.path.join(tmp, out.name)
            cmd = [_compiler(), *CXX_FLAGS, *map(str, _sources()), "-o", part]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"host runtime build failed:\n$ "
                                   f"{' '.join(cmd)}\n{proc.stdout}")
            os.replace(part, out)
    return out


def _declare(lib):
    # the rendezvous store (tcp_store.cc)
    lib.tcp_store_server_start.restype = ctypes.c_void_p
    lib.tcp_store_server_start.argtypes = [ctypes.c_int]
    lib.tcp_store_server_port.restype = ctypes.c_int
    lib.tcp_store_server_port.argtypes = [ctypes.c_void_p]
    lib.tcp_store_server_stop.argtypes = [ctypes.c_void_p]
    lib.tcp_store_connect.restype = ctypes.c_ssize_t
    lib.tcp_store_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.tcp_store_set.restype = ctypes.c_int
    lib.tcp_store_set.argtypes = [ctypes.c_ssize_t, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_long]
    for name in ("tcp_store_get", "tcp_store_tryget"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_ssize_t, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_long]
    lib.tcp_store_add.restype = ctypes.c_int
    lib.tcp_store_add.argtypes = [ctypes.c_ssize_t, ctypes.c_char_p,
                                  ctypes.c_longlong,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.tcp_store_wait.restype = ctypes.c_int
    lib.tcp_store_wait.argtypes = [ctypes.c_ssize_t, ctypes.c_char_p]
    lib.tcp_store_delete.restype = ctypes.c_int
    lib.tcp_store_delete.argtypes = [ctypes.c_ssize_t, ctypes.c_char_p]
    lib.tcp_store_close.argtypes = [ctypes.c_ssize_t]
    # the collective watchdog (watchdog.cc)
    lib.watchdog_create.restype = ctypes.c_void_p
    lib.watchdog_create.argtypes = [ctypes.c_long]
    lib.watchdog_destroy.argtypes = [ctypes.c_void_p]
    lib.watchdog_register.restype = ctypes.c_longlong
    lib.watchdog_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_long]
    lib.watchdog_complete.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.watchdog_timeout_count.restype = ctypes.c_longlong
    lib.watchdog_timeout_count.argtypes = [ctypes.c_void_p]
    lib.watchdog_drain_report.restype = ctypes.c_long
    lib.watchdog_drain_report.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_long]
    lib.watchdog_inflight.restype = ctypes.c_longlong
    lib.watchdog_inflight.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL:
    """The host runtime library, built on first call and loaded once per
    process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib
