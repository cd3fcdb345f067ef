"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every `csrc/*.cu` file compiles into one shared library with a plain C
interface, at first use, into `meilisearch_tpu_torch/_build/`. The file
name carries a hash of the sources and the flags, so an edited source
builds anew and a finished build is reused by later processes. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_lock = threading.Lock()
_lib = None
_failure = None  # the first failed build, raised again at every later call
# what the last build printed (ptxas register and spill report) and took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.mst_chain_keys
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use. Raises
    RuntimeError when nvcc is missing or the build fails, then on every
    later call (a process does not build twice)."""
    global _lib, _failure
    with _lock:
        if _lib is not None:
            return _lib
        if _failure is not None:
            raise RuntimeError("the CUDA kernels failed to build") from _failure
        try:
            _lib = _bind(ctypes.CDLL(str(_build())))
        except Exception as err:
            _failure = err
            raise
        return _lib


def _build() -> Path:
    global build_log, build_seconds
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libmst_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{build_log[-4000:]}"
            )
        os.replace(tmp, out)  # atomic: either of two concurrent builds wins
    return out
