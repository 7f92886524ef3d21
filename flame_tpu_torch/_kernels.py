"""Build, load and count the hand-written CUDA kernels.

Both kernels (csrc/nltgv2_smoother.cu, csrc/raster.cu) are compiled with
nvcc for sm_90a into ONE shared library with a plain C interface, bound
with ctypes. The build runs at first use, into flame_tpu_torch/_build/,
named by a hash of the sources and flags, so a checkout builds its own
kernels and a changed source never loads a stale library. A missing nvcc
or a failed build raises with the compiler's output.

Each wrapper adds one to its entry of LAUNCHES per kernel launch; a run
reads the counts to show that its path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("nltgv2_smoother.cu", "raster.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset_launches().
LAUNCHES = {"nltgv2_smoother": 0, "raster_tiles": 0}

# Filled by load(): build seconds (0 when the library was already built)
# and the compiler's register/shared-memory report.
BUILD_INFO = {"seconds": 0.0, "ptxas": "", "library": ""}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of flame_tpu_torch cannot be built")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libflame_kernels_{h.hexdigest()[:16]}.so")


def _build(path: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC, s) for s in SOURCES]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["ptxas"] = res.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nltgv2_iterate.restype = I
        lib.nltgv2_iterate.argtypes = (
            [P] * 12          # xb/w1b/w2b in, xb/w1b/w2b out, x w1 w2, q1-3
            + [P] * 7         # nbr sdx sdy sal sbe sgn srcf
            + [P] * 3         # data weight vmask
            + [I, I] + [F] * 5 + [P])
        lib.raster_tiles.restype = I
        lib.raster_tiles.argtypes = [P, P, I, I, I, I, P]
        BUILD_INFO["library"] = path
        _lib = lib
        return lib


def check_cuda_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
