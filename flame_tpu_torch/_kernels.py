"""Build, load and count the hand-written CUDA kernels.

Each kernel source (csrc/nltgv2_smoother.cu, csrc/raster.cu,
csrc/halo_smoother.cu) is compiled
by its own nvcc process for sm_90a into a shared library with a plain C
interface, bound with ctypes; the processes start together, so the build
takes as long as the slowest source. The build runs at first use, into
flame_tpu_torch/_build/, each library named by a hash of its source and
the flags, so a checkout builds its own kernels and a changed source
never loads a stale library. A missing nvcc or a failed build raises
with the compiler's output.

The entries: nltgv2_smoother (K1, every smoother iteration in one
cooperative launch) with nltgv2_smoother_occupancy (its CTAs per SM, for
the wrapper's launch plan); raster_mesh (K2, one view's binning and tile
pass in one launch) and raster_mesh_batch (K2b, the same for B views, one
union binning per tile for all of them); halo_smoother (K3, one launch
for every partition and iteration, a thread-block cluster per partition)
with halo_smoother_occupancy (the clusters the card holds at once, for
the wrapper's launch plan), and the peer-buffer entries of K3's ring
across processes: halo_peer_alloc (cudaMalloc outside the caching
allocator, zeroed), halo_peer_handle (its CUDA IPC handle),
halo_peer_open / halo_peer_close (a neighbour's allocation mapped from its
handle) and halo_peer_free. Each returns its cudaError_t.

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
import types

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("nltgv2_smoother.cu", "raster.cu", "halo_smoother.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset_launches().
LAUNCHES = {"nltgv2_smoother": 0, "raster_mesh": 0, "raster_mesh_batch": 0,
            "halo_smoother": 0}

# Filled by load(): wall seconds of the parallel build (0 when every
# library was already built), the compiler's register/shared-memory
# report and the libraries loaded.
BUILD_INFO = {"seconds": 0.0, "ptxas": "", "libraries": []}

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


def _library_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _build(paths: dict):
    """nvcc for every source in paths at once; waits for all of them."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for source, path in paths.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
        procs.append((cmd, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, reports = [], []
    for cmd, tmp, path, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
        reports.append(err)
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["ptxas"] = "".join(reports)


def load() -> types.SimpleNamespace:
    """The kernels' C entry points, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        paths = {s: _library_path(s) for s in SOURCES}
        missing = {s: p for s, p in paths.items() if not os.path.exists(p)}
        if missing:
            _build(missing)
        smoother = ctypes.CDLL(paths["nltgv2_smoother.cu"])
        raster = ctypes.CDLL(paths["raster.cu"])
        halo = ctypes.CDLL(paths["halo_smoother.cu"])
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        smoother.nltgv2_smoother.restype = I
        smoother.nltgv2_smoother.argtypes = (
            [P] * 9           # xb w1b w2b x w1 w2 q1 q2 q3 in
            + [P] * 7         # nbr sdx sdy sal sbe sgn srcf
            + [P] * 3         # data weight vmask
            + [P] * 11        # x w1 w2 xb w1b w2b q1 q2 q3 out, scratch,
                              # barrier
            + [I] * 4         # V D n_iters vertices_per_warp
            + [F] * 5 + [P])  # step_x step_q theta x_min x_max, stream
        smoother.nltgv2_smoother_occupancy.restype = I
        smoother.nltgv2_smoother_occupancy.argtypes = [I, I, P]
        raster.raster_mesh.restype = I
        raster.raster_mesh.argtypes = [P, P, I, P, P, I, I, I, I, P]
        raster.raster_mesh_batch.restype = I
        raster.raster_mesh_batch.argtypes = [P, P, I, I, P, P, I, I, I, I, P]
        halo.halo_smoother.restype = I
        halo.halo_smoother.argtypes = (
            [P] * 9           # x w1 w2 xb w1b w2b (in/out), data weight vmask
            + [P] * 8         # nbr rowflag sdx sdy sal sbe sgn srcf
            + [P] * 5         # q1 q2 q3 (in/out), rx, flags
            + [P] * 4         # rx_lo flags_lo rx_hi flags_hi
            + [I] * 8         # n rb d reach n_iters epoch cluster vpw
            + [F] * 6 + [P])  # step_x ... data_factor, stream
        halo.halo_smoother_occupancy.restype = I
        halo.halo_smoother_occupancy.argtypes = [I, I, I, P]
        halo.halo_peer_alloc.restype = I
        halo.halo_peer_alloc.argtypes = [ctypes.c_size_t, P]
        for name in ("halo_peer_handle", "halo_peer_open"):
            getattr(halo, name).restype = I
            getattr(halo, name).argtypes = [P, P]
        for name in ("halo_peer_close", "halo_peer_free"):
            getattr(halo, name).restype = I
            getattr(halo, name).argtypes = [P]
        halo.halo_peer_handle_size.restype = I
        halo.halo_peer_handle_size.argtypes = []
        BUILD_INFO["libraries"] = list(paths.values())
        _lib = types.SimpleNamespace(
            nltgv2_smoother=smoother.nltgv2_smoother,
            nltgv2_smoother_occupancy=smoother.nltgv2_smoother_occupancy,
            raster_mesh=raster.raster_mesh,
            raster_mesh_batch=raster.raster_mesh_batch,
            halo_smoother=halo.halo_smoother,
            halo_smoother_occupancy=halo.halo_smoother_occupancy,
            **{k: getattr(halo, k) for k in (
                "halo_peer_alloc", "halo_peer_handle", "halo_peer_open",
                "halo_peer_close", "halo_peer_free",
                "halo_peer_handle_size")})
        return _lib


def check_cuda_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
