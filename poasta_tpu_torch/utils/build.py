"""Build and load the port's CUDA kernels.

Counterpart of ``poasta_tpu/utils/compile_cache.py``.  Every ``csrc/*.cu``
file is compiled by ``nvcc`` for ``sm_90a`` into one shared library with a
plain C interface, which ``ctypes`` loads.  The kernels build to
``build/poasta_tpu_torch/<source-hash>/`` beside the package (``build/``
is git-ignored) at first use, so a fresh checkout compiles once and a
changed source gets a fresh directory.  A compile or load error raises.

Nothing here runs at import: the CPU tests import every module on hosts
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "poasta_tpu_torch")
# --threads 0: nvcc runs its compile steps in parallel, one thread a core
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--threads", "0"]
LIB_NAME = "libpoasta_cuda.so"
# the first load can come from two threads at once (the serving loop scores
# the next batch on a worker thread while the main thread traces)
_LOAD_LOCK = threading.Lock()


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> dict:
    """Compile the kernels unless this source hash is already built.

    Returns ``{"lib": path, "seconds": compile time (0.0 when cached),
    "log": nvcc's output}``.
    """
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "nvcc.log")
    if os.path.exists(lib):
        with open(log_path) as fh:
            return {"lib": lib, "seconds": 0.0, "log": fh.read()}
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *sorted(glob.glob(os.path.join(CSRC, "*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log[-4000:]}")
    with open(log_path, "w") as fh:
        fh.write(log)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return {"lib": lib, "seconds": seconds, "log": log}


def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its C signatures.
    Thread-safe; later calls return the loaded library."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["lib"])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pi, pll = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
    lib.poasta_banded_plan.argtypes = [i, i, i, i, i, pi, pi, pi, pll, pi, pi,
                                      pi]
    lib.poasta_banded_plan.restype = i
    lib.poasta_banded_fill.argtypes = (
        [i] + [p] * 13 + [i] * 16 + [p, p, ll, p])
    lib.poasta_banded_fill.restype = i
    lib.poasta_fill_plan.argtypes = [i, i, i, pi, pi, pi, pll]
    lib.poasta_fill_plan.restype = i
    lib.poasta_fill_body.argtypes = [i, i, i, i, pi, pi, pi]
    lib.poasta_fill_body.restype = i
    lib.poasta_full_fill.argtypes = (
        [i] + [p] * 6 + [i] * 12 + [p, p, p, ll, p])
    lib.poasta_full_fill.restype = i
    lib.poasta_trace_plan.argtypes = [i, i, pi, pi, pi, pll, pi, pi]
    lib.poasta_trace_plan.restype = i
    lib.poasta_trace_fill.argtypes = [p] * 10 + [i] * 12 + [p, p, p, ll, p]
    lib.poasta_trace_fill.restype = i
    lib.poasta_decode_plan.argtypes = [i] * 2 + [pi] * 3
    lib.poasta_decode_plan.restype = i
    lib.poasta_trace_decode.argtypes = [p] * 6 + [i] * 6 + [p, p, p]
    lib.poasta_trace_decode.restype = i
    lib.poasta_seed_plan.argtypes = [i, i, pi, pi, pi, pll, pi, pi]
    lib.poasta_seed_plan.restype = i
    lib.poasta_seed_fill.argtypes = [p] * 11 + [i] * 12 + [p, p, ll, p]
    lib.poasta_seed_fill.restype = i
    lib.poasta_error_string.argtypes = [i]
    lib.poasta_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, code: int, what: str) -> None:
    """Raise on a nonzero CUDA error code from a C entry point."""
    if code != 0:
        msg = lib.poasta_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
