"""Host Delaunay triangulation through the native core.

A ctypes loader for the port's own copy of the JAX package's Delaunay
core, csrc/delaunay.cpp (incremental Bowyer-Watson with symbolic
jitter; its point location starts each walk from a grid of inserted
vertices, and its output is the JAX package's bit for bit). The library
is built with g++ into flame_tpu_torch/_build/, named by a hash of the
source, and a failed build raises: there is deliberately no scipy
fallback, whose triangle order differs and would break topology parity
with the JAX package. Output contract: triangles
(T, 3) with positive signed area in y-down pixel space, unique sorted
edges (E, 2), neighbours (T, 3), and the triangles the point-location
walks visited, summed over the points.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "delaunay.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib = None


class Triangulation(NamedTuple):
    triangles: np.ndarray  # (T, 3) int32
    edges: np.ndarray  # (E, 2) int32, unique, sorted (lo, hi)
    neighbors: np.ndarray  # (T, 3) int32, -1 where none
    walk_steps: int  # triangles the point-location walks visited, in all


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"_delaunay_{digest}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
                   SRC]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building the Delaunay core failed:\n"
                                   f"{' '.join(cmd)}\n{res.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.delaunay_triangulate_ex.restype = ctypes.c_int
        lib.delaunay_triangulate_ex.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ip, ip, ip, ip, ip,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the Delaunay library builds and loads (triangulate raises
    where it does not)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def triangulate(points: np.ndarray) -> Triangulation:
    """Delaunay-triangulate (N >= 3, 2) float points."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 2 or pts.shape[0] < 3:
        raise ValueError("need (N>=3, 2) points")
    lib = _load()
    n = pts.shape[0]
    tri_out = np.empty((2 * n + 8, 3), np.int32)
    neigh_out = np.empty((2 * n + 8, 3), np.int32)
    edge_out = np.empty((3 * n + 8, 2), np.int32)
    n_tri = ctypes.c_int(0)
    n_edge = ctypes.c_int(0)
    steps = ctypes.c_int64(0)
    ip = ctypes.POINTER(ctypes.c_int)
    rc = lib.delaunay_triangulate_ex(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        tri_out.ctypes.data_as(ip), ctypes.byref(n_tri),
        edge_out.ctypes.data_as(ip), ctypes.byref(n_edge),
        neigh_out.ctypes.data_as(ip), ctypes.byref(steps))
    if rc != 0:
        raise ValueError(f"delaunay_triangulate failed ({rc})")
    T, E = n_tri.value, n_edge.value
    e = np.sort(edge_out[:E], axis=1)
    if E:
        e = e[np.lexsort((e[:, 1], e[:, 0]))]
    return Triangulation(triangles=tri_out[:T].copy(),
                         edges=np.ascontiguousarray(e),
                         neighbors=neigh_out[:T].copy(),
                         walk_steps=steps.value)
