"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its
own into a shared library, loaded with :mod:`ctypes` (no PyTorch headers,
so a build takes seconds, and no ``ninja``).  The library is named by a
hash of its source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited kernel rebuilds, and it lands
in ``ops/_build/`` (listed in ``.gitignore``).  Concurrent builds, from
threads or processes, serialize on a file lock, after the precedent of
``native/.build.lock`` in the JAX package.

Nothing here runs at import time: the first launch of a kernel on a CUDA
tensor calls :func:`load_library`; :func:`load_libraries` builds several
sources at once, one ``nvcc`` process each, all started together.  A failed
build raises; nothing falls back.
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
# per source: {"path", "seconds", "built", "log"} of the last load; "log"
# is nvcc's output (ptxas' report) of the build, kept beside the library
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


def _so_path(source: str) -> Path:
    src = _CSRC / source
    # the shared headers count too: editing one rebuilds its includers
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return _BUILD_DIR / f"{src.stem}_{digest}.so"


def _log_path(source: str) -> Path:
    return _so_path(source).with_suffix(".log")


def load_libraries(sources) -> list[ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<source>`` for each source; every
    missing library compiles at the same time.  Cached per process."""
    sources = list(sources)
    with _lock:
        missing = [s for s in sources if s not in _libraries]
        t0 = time.perf_counter()
        logs = {s: ("", False) for s in missing}
        todo = [s for s in missing if not _so_path(s).exists()]
        if todo:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(_BUILD_DIR / ".build.lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)
                # another process may have built some while we waited
                todo = [s for s in todo if not _so_path(s).exists()]
                procs = {}
                for source in todo:
                    tmp = _so_path(source).with_suffix(f".{os.getpid()}.tmp")
                    procs[source] = (tmp, subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                         str(_CSRC / source)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True,
                    ))
                failed = []
                for source, (tmp, proc) in procs.items():
                    log = proc.communicate()[0]
                    if proc.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        failed.append(
                            f"nvcc failed to build {_CSRC / source} (exit "
                            f"{proc.returncode}):\n{log}"
                        )
                        continue
                    os.replace(tmp, _so_path(source))
                    _log_path(source).write_text(log)
                    logs[source] = (log, True)
                if failed:
                    raise RuntimeError("\n".join(failed))
        for source in missing:
            so = _so_path(source)
            _libraries[source] = ctypes.CDLL(str(so))
            log, built = logs[source]
            if not built and _log_path(source).exists():
                log = _log_path(source).read_text()  # the build's ptxas report
            build_info[source] = {
                "path": str(so),
                "seconds": time.perf_counter() - t0,
                "built": built,
                "log": log,
            }
        return [_libraries[s] for s in sources]


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    return load_libraries([source])[0]
