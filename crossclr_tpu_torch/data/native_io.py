"""ctypes bindings for the port's host-IO kernels (``data/csrc/host_io.cc``).

Counterpart of ``crossclr_tpu/data/native_io.py``.  Batch assembly for
contrastive training is host-bound: gathering shuffled rows out of a
memory-mapped feature store, and optionally converting fp32 → bf16, before
the host→device copy.  The C++ library does both on a persistent thread
pool, with the GIL released (ctypes), so the prefetch worker's gather runs
beside the training step.

The library is built with ``g++`` at first use into ``data/_build/``
(listed in ``.gitignore``), named by a hash of its source, the flags and
the target that ``-march=native`` resolves to on this host, under a file
lock (the pattern of ``ops/_build.py``).  **A failed build raises**: the
JAX module falls back to numpy silently, which here would hide the host
kernel on the main path.  The one numpy route kept is the reference's shape
rule: rows that are not one contiguous block each (1-D arrays, or views
strided inside a row) gather with ``src[idx]``.  :func:`gather_rows_plain`
is that plain version, for the tests.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

__all__ = ["f32_to_bf16", "gather_rows", "gather_rows_plain", "load_library"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "host_io.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-lpthread")
_VERSION = 5  # host_io.cc's crossclr_io_version()
_DEFAULT_THREADS = min(os.cpu_count() or 1, 16)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# {"path", "seconds", "built"} of the load, for chip_smoke.py's build phase
build_info: dict = {}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found (set CXX or put g++ on PATH): the host gather of "
            "crossclr_tpu_torch is built from data/csrc/host_io.cc at first use"
        )
    return cxx


def _native_target(cxx: str) -> bytes:
    """What ``-march=native`` means on this host (the ``-march=`` and
    ``-m`` flags that the compiler expands it to), so that a library built
    on one CPU is never loaded on another."""
    proc = subprocess.run(
        [cxx, "-march=native", "-###", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, timeout=60,
    )
    return " ".join(re.findall(r'"?(-march=\S+|-m[\w.-]+)"?', proc.stderr)).encode()


def _so_path(cxx: str) -> Path:
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _native_target(cxx)
    ).hexdigest()[:16]
    return _BUILD_DIR / f"host_io_{digest}.so"


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the host-IO library; cached per process.
    Raises if ``g++`` is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        cxx = _cxx()
        so = _so_path(cxx)
        built = False
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(_BUILD_DIR / ".build.lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)
                if not so.exists():  # another process may have built it
                    tmp = so.with_suffix(f".{os.getpid()}.tmp")
                    proc = subprocess.run(
                        [cxx, *CXX_FLAGS[:-2], str(_SOURCE), "-o", str(tmp),
                         *CXX_FLAGS[-2:]],
                        capture_output=True, text=True, timeout=300,
                    )
                    if proc.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        raise RuntimeError(
                            f"g++ failed to build {_SOURCE} (exit "
                            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
                        )
                    os.replace(tmp, so)  # a fresh inode: never truncated in place
                    built = True
        lib = ctypes.CDLL(str(so))
        lib.crossclr_io_version.restype = ctypes.c_int
        lib.crossclr_io_version.argtypes = []
        if lib.crossclr_io_version() != _VERSION:
            raise RuntimeError(
                f"{so} reports version {lib.crossclr_io_version()}, want {_VERSION}"
            )
        lib.crossclr_gather_rows.restype = None
        lib.crossclr_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.crossclr_f32_to_bf16.restype = None
        lib.crossclr_f32_to_bf16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                          built=built, compiler=cxx)
        _lib = lib
        return lib


def _check_out(src: np.ndarray, n: int, out: np.ndarray | None) -> None:
    if out is None:
        return
    want = (n, *src.shape[1:])
    if out.shape != want or out.dtype != src.dtype or not out.flags.c_contiguous:
        raise ValueError(
            f"out must be C-contiguous {want} {src.dtype}, got "
            f"{out.shape} {out.dtype} contiguous={out.flags.c_contiguous}"
        )


def gather_rows_plain(src: np.ndarray, idx: np.ndarray,
                      out: np.ndarray | None = None) -> np.ndarray:
    """``src[idx]`` as a contiguous array, by numpy on one thread: the plain
    version of :func:`gather_rows`, with the same ``out`` contract."""
    _check_out(src, np.shape(idx)[0], out)
    if out is None:
        return np.ascontiguousarray(src[idx])
    out[...] = src[idx]
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray, *,
                threads: int = _DEFAULT_THREADS,
                out: np.ndarray | None = None) -> np.ndarray:
    """``src[idx]`` as a contiguous array, copied by the native thread pool.

    ``src`` may be a ``np.memmap`` (rows are copied straight out of the
    mapped pages) of any dtype, ``[N, ...]``; the row stride may exceed the
    row (``HostShard``'s ``[p::P]`` views), but each row must be one
    contiguous block, else numpy gathers it.  ``out``: a preallocated
    C-contiguous destination of the result's shape and dtype (e.g. the
    numpy view of a pinned tensor); reused destinations skip the
    first-touch page faults of a fresh allocation.  Indices must lie in
    ``[0, N)``.
    """
    _check_out(src, np.shape(idx)[0], out)
    row_elems = int(np.prod(src.shape[1:])) if src.ndim > 1 else 0
    inner_contiguous = (
        src.ndim >= 2
        and src.strides[-1] == src.dtype.itemsize
        and all(src.strides[k] == src.strides[k + 1] * src.shape[k + 1]
                for k in range(1, src.ndim - 1))
    )
    if not inner_contiguous or row_elems == 0:
        return gather_rows_plain(src, idx, out)
    lib = load_library()
    idx64 = np.ascontiguousarray(idx, dtype=np.int64)
    if idx64.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx64.shape}")
    if idx64.size and (idx64.min() < 0 or idx64.max() >= src.shape[0]):
        raise IndexError(
            f"row indices must lie in [0, {src.shape[0]}), got "
            f"[{idx64.min()}, {idx64.max()}]"
        )
    if out is None:
        out = np.empty((idx64.shape[0], *src.shape[1:]), dtype=src.dtype)
    lib.crossclr_gather_rows(
        src.ctypes.data, out.ctypes.data,
        idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx64.shape[0], row_elems * src.dtype.itemsize, src.strides[0],
        int(threads),
    )
    return out


def f32_to_bf16(x: np.ndarray, *, threads: int = _DEFAULT_THREADS) -> np.ndarray:
    """fp32 → bf16 (round to nearest even, NaN kept quiet, as XLA and
    ml_dtypes round) as the raw ``uint16`` payload, the form the port's
    bf16 stores carry."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.uint16)
    load_library().crossclr_f32_to_bf16(x.ctypes.data, out.ctypes.data,
                                        x.size, int(threads))
    return out
