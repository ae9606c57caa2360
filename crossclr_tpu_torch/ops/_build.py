"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its
own into a shared library, loaded with :mod:`ctypes` (no PyTorch headers,
so a build takes seconds, and no ``ninja``).  The library is named by a
hash of its source and flags, so an edited kernel rebuilds, and it lands
in ``ops/_build/`` (listed in ``.gitignore``).  Concurrent builds, from
threads or processes, serialize on a file lock, after the precedent of
``native/.build.lock`` in the JAX package.

Nothing here runs at import time: the first launch of a kernel on a CUDA
tensor calls :func:`load_library`.  A failed build raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
# per source: {"path", "seconds", "built", "log"} of the last load
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of crossclr_tpu_torch are built from source at first use"
    )


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    with _lock:
        lib = _libraries.get(source)
        if lib is not None:
            return lib
        src = _CSRC / source
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = _BUILD_DIR / f"{src.stem}_{digest}.so"
        t0 = time.perf_counter()
        built, log = False, ""
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(_BUILD_DIR / ".build.lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)
                if not so.exists():  # another process may have built it
                    tmp = so.with_suffix(f".{os.getpid()}.tmp")
                    proc = subprocess.run(
                        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                        capture_output=True, text=True,
                    )
                    log = proc.stdout + proc.stderr
                    if proc.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        raise RuntimeError(
                            f"nvcc failed to build {src} "
                            f"(exit {proc.returncode}):\n{log}"
                        )
                    os.replace(tmp, so)
                    built = True
        lib = ctypes.CDLL(str(so))
        build_info[source] = {
            "path": str(so),
            "seconds": time.perf_counter() - t0,
            "built": built,
            "log": log,
        }
        _libraries[source] = lib
        return lib
