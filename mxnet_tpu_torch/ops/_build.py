"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``mxnet_tpu_torch/_build/`` at first use, then
loaded with ``ctypes``. The library's file name carries a digest of the
source, the headers it includes from ``csrc/`` (``hopper.cuh``,
``bn_stats.cuh``, ``decode_combine.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing
is built when a module is imported.

Builds are serialized across processes by an exclusive ``flock`` on
``_build/build.lock`` (the kernel drops it when its holder exits, so a
killed build leaves no stale lock): ranks of a multi-process job that
need the same library wait for the first build and load its result.
Within a process a ``threading.Lock`` does the same.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["load", "build_all", "build_log", "SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attn_fwd", "flash_attn_fwd_tc", "flash_attn_fwd_tf32x3",
           "flash_attn_bwd", "flash_attn_bwd_tc", "flash_attn_bwd_tf32x3",
           "conv3x3_bn_stats", "conv3x3_bn_stats_tc",
           "conv3x3_bn_stats_tf32x3", "paged_decode_attn",
           "paged_decode_attn_int8", "kv_quantize_write", "s8_gemm",
           "s8_gemm_wgmma", "requant_int8", "state_fold")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise MXNetError("nvcc not found (looked on PATH and in CUDA_HOME or "
                     "/usr/local/cuda): the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _headers(path, seen=None):
    """The ``#include "..."`` files of ``path`` found beside it, and theirs,
    in first-seen order."""
    seen = [] if seen is None else seen
    for name in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / name.decode()
        if dep.exists() and dep not in seen:
            seen.append(dep)
            _headers(dep, seen)
    return seen


def _paths(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in _headers(src):
        h.update(dep.name.encode() + b"\0" + dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def _start(name):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temp path, final path, log path)."""
    src, lib = _paths(name)
    log = BUILD_DIR / f"{name}.log"
    if lib.exists():
        return None, None, lib, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, log


def _finish(name, proc, tmp, lib, log):
    if proc is not None:
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise MXNetError(f"nvcc failed to build {name}.cu "
                             f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def _file_lock():
    """The build directory's cross-process lock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names=SOURCES):
    """Build every named kernel library, one nvcc per source, all started
    together, and load them. Returns {name: CDLL}."""
    with _lock, _file_lock():
        todo = [n for n in names if n not in _libs]
        started = [(n, _start(n)) for n in todo]
        errors = []
        for n, job in started:  # wait for every nvcc, even after a failure
            try:
                _libs[n] = _finish(n, *job)
            except MXNetError as e:
                errors.append(e)
        if errors:
            raise errors[0]
        return {n: _libs[n] for n in names}


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all((name,))[name]


def build_log(name):
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the build of ``name`` in this checkout, or '' if none was kept."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""
