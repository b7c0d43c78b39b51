"""Build and load the port's CUDA kernels.

Every `paddle_tpu_torch/csrc/*.cu` file is compiled by nvcc for Hopper
(`sm_90a`) into one shared library with a plain C interface, loaded with
ctypes. The sources include no PyTorch header, so a build takes seconds
rather than the minutes `torch.utils.cpp_extension.load` needs. Each source
compiles in its own nvcc process, all started together; one link step joins
them.

The library is built at first use, from the sources in the checkout only,
into `paddle_tpu_torch/_build/` (listed in .gitignore). Its file name
carries a hash of the sources and flags, so an edited kernel never loads a
stale build. Each object file is kept under a hash of the flags, its source
and the headers that source includes, so a build of an edited copy of the
sources (chip_smoke.py's planted faults) compiles only what the edit
touches, and `source_flags` may compile one source with flags of its own
(`-DPTT_ONLY_DTYPE` / `-DPTT_ONLY_WIDTH` of csrc/common.cuh: only the
instantiations one case launches).

Calling convention (see each .cu file): pointers and the stream are
`c_void_p` (the stream is `torch.cuda.current_stream().cuda_stream`), sizes
are `c_int`/`c_longlong`, stride lists a `c_longlong` array (`longlongs`),
and every entry point returns
`cudaGetLastError()`, which `check()` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

__all__ = ["DTYPE_CODES", "build_library", "check", "load_library",
           "longlongs", "open_library"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# element-type codes shared with csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}

_c_void_p, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float)
_c_ll_p = ctypes.POINTER(ctypes.c_longlong)

# argtypes of every C entry point, in the order of their declarations
_SIGNATURES = {
    # x, w, b, out, rstd, mean, rows, n, eps, x_dtype, w_dtype, kind, stream
    "ptt_norm_fwd": [_c_void_p] * 6 + [_c_ll, _c_int, _c_float, _c_int,
                                       _c_int, _c_int, _c_void_p],
    # q, kc, vc, tables, lengths, ws, arrivals, out, B, Hkv, g, D, ps, P,
    # ppc, scale, dtype, stream
    "ptt_paged_decode_attention": [_c_void_p] * 8 + [_c_int] * 7
    + [_c_float, _c_int, _c_void_p],
    # x, w, dy, rstd, mean, dx, rows, n, x_dtype, w_dtype, kind, route,
    # gsize, elems, per_cta, stream
    "ptt_norm_bwd_dx": [_c_void_p] * 6 + [_c_ll] + [_c_int] * 8
    + [_c_void_p],
    # q, kc, vc, k_scale, v_scale, tables, lengths, ws, arrivals, out, B,
    # Hkv, g, D, ps, P, ppc, scale, dtype, stream
    "ptt_paged_decode_attention_q8": [_c_void_p] * 10 + [_c_int] * 7
    + [_c_float, _c_int, _c_void_p],
    # q, kc, vc, lengths, ws, out, B, Hkv, g, D, s_max, chunk, scale, dtype,
    # stream
    "ptt_dense_decode_attention": [_c_void_p] * 6 + [_c_int] * 6
    + [_c_float, _c_int, _c_void_p],
    # q, k, v, kbias, out, lse, B, H, Hkv, Sq, Skv, D, strides[12], scale,
    # causal, dtype, stream
    "ptt_flash_fwd": [_c_void_p] * 6 + [_c_int] * 6
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # q, k, v, kbias, dout, lse, delta, dq, B, H, Hkv, Sq, Skv, D,
    # strides[12], scale, causal, dtype, stream
    "ptt_flash_bwd_dq": [_c_void_p] * 8 + [_c_int] * 6
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # q, k, v, kbias, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Skv, D,
    # strides[12], scale, causal, dtype, stream
    "ptt_flash_bwd_dkv": [_c_void_p] * 9 + [_c_int] * 6
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # q, k, v, idx, cls, out, lse, B, H, Hkv, Hm, n, Sq, Skv, D,
    # strides[12], scale, causal, dtype, stream
    "ptt_flashmask_fwd": [_c_void_p] * 7 + [_c_int] * 8
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # q, k, v, idx, cls, dout, lse, delta, dq, B, H, Hkv, Hm, n, Sq, Skv,
    # D, strides[12], scale, causal, dtype, stream
    "ptt_flashmask_bwd_dq": [_c_void_p] * 9 + [_c_int] * 8
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # q, k, v, idx, cls, dout, lse, delta, dk, dv, B, H, Hkv, Hm, n, Sq,
    # Skv, D, strides[12], scale, causal, dtype, stream
    "ptt_flashmask_bwd_dkv": [_c_void_p] * 10 + [_c_int] * 8
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # q, k, v, kinfo, qrange, krange, cls, out, lse, H, Hkv, Tq, Tk, D,
    # strides[12], scale, causal, dtype, stream
    "ptt_varlen_fwd": [_c_void_p] * 9 + [_c_int] * 5
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # kinfo, cls, Tq, Tk, causal, stream
    "ptt_varlen_tile_classes": [_c_void_p] * 2 + [_c_int] * 3 + [_c_void_p],
    # q, k, v, kinfo, qrange, krange, cls, dout, lse, delta, dq, H, Hkv, Tq,
    # Tk, D, strides[12], scale, causal, dtype, stream
    "ptt_varlen_bwd_dq": [_c_void_p] * 11 + [_c_int] * 5
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # q, k, v, kinfo, qrange, krange, cls, order, dout, lse, delta, dk, dv,
    # H, Hkv, Tq, Tk, D, strides[12], scale, causal, dtype, stream
    "ptt_varlen_bwd_dkv": [_c_void_p] * 13 + [_c_int] * 5
    + [_c_ll_p, _c_float, _c_int, _c_int, _c_void_p],
    # lhs, rhs, sizes, out, E, R, K, N, trans, dtype, stream
    "ptt_grouped_gemm": [_c_void_p] * 4 + [_c_int] * 6 + [_c_void_p],
    # x0, x1, x2, out0, out1, out2, n, h0, h1, h2, B, S, D, cos, sin,
    # table_b, interleaved, sin_sign, dtype, vec, hpt, chunks, bx, by, bz,
    # gx, gy, stream
    "ptt_rope": [_c_void_p] * 6 + [_c_int] * 7 + [_c_void_p] * 2
    + [_c_int, _c_int, _c_float, _c_int] + [_c_int] * 8 + [_c_void_p],
}

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG = ""  # nvcc's output of the build this process made, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's "
        "CUDA kernels are built from paddle_tpu_torch/csrc at first use")


def _sources(csrc):
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {csrc}")
    return srcs


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _object_name(src, extra=()) -> str:
    """`<stem>_<hash>.o`, the hash over the nvcc flags (with the source's
    `extra` ones), the source and every header of its directory that it
    includes, directly or not."""
    files, todo = set(), [pathlib.Path(src)]
    while todo:
        p = todo.pop()
        if p in files or not p.exists():
            continue
        files.add(p)
        todo += [p.parent / m for m in _INCLUDE.findall(p.read_text())]
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *extra]).encode())
    for p in sorted(files, key=lambda f: f.name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return f"{pathlib.Path(src).stem}_{h.hexdigest()[:16]}.o"


def _library_path(csrc, build_dir, source_flags=None) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
            h.update(" ".join((source_flags or {}).get(p.name, ())).encode())
    return build_dir / f"libpaddle_tpu_torch_{h.hexdigest()[:16]}.so"


def build_library(csrc=CSRC, build_dir=BUILD_DIR,
                  obj_dir=None, source_flags=None) -> pathlib.Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into one shared library in `build_dir`; returns its path. A no-op when
    the library for these exact sources already exists; a source whose
    object is already in `obj_dir` (default `build_dir/obj`) is not
    compiled again. `source_flags` {source file name: [nvcc flags]} adds
    flags to one source's compile. Raises RuntimeError carrying nvcc's
    output when a step fails."""
    global BUILD_LOG
    csrc, build_dir = pathlib.Path(csrc), pathlib.Path(build_dir)
    source_flags = source_flags or {}
    out = _library_path(csrc, build_dir, source_flags)
    if out.exists():
        return out
    obj_dir = pathlib.Path(obj_dir) if obj_dir else build_dir / "obj"
    build_dir.mkdir(parents=True, exist_ok=True)
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs, procs = [], []
        for src in _sources(csrc):
            extra = list(source_flags.get(src.name, ()))
            obj = obj_dir / _object_name(src, extra)
            objs.append(str(obj))
            if obj.exists():
                continue
            part = os.path.join(tmp, obj.name)
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", part]
            procs.append((cmd, part, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(cmd[-3])
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        for _, part, obj, _ in procs:
            os.replace(part, obj)
        tmp_lib = os.path.join(tmp, out.name)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp_lib, *objs]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp_lib, out)
    BUILD_LOG = "\n".join(logs)
    return out


def open_library(path) -> ctypes.CDLL:
    """A built library loaded with ctypes, with argtypes/restype declared
    for every entry point."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library of the checkout's sources, built on first call
    and loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = open_library(build_library())
        return _LIB


def longlongs(values):
    """A ctypes `long long` array holding `values` (kernel stride lists)."""
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error (its return value is
    `cudaGetLastError()` right after the launch)."""
    if err != 0:
        msg = load_library().ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
