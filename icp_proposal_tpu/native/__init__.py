"""ctypes loader for the host-side C++ geometry kernels (point_tri.cpp).

Compiles the shared library on first use (g++ -O3 -march=native -fopenmp,
next to the source, rebuilt when the source is newer; the library is not
tracked by git, so each machine builds its own) and exposes numpy-level
entry points.  If no C++ toolchain is available, callers fall back to the
numpy implementations (``ops/surface_index._np_point_tri_dist2``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "point_tri.cpp")
_LIB = os.path.join(_DIR, "_libicp_native.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _compile() -> bool:
    # build under a per-process name, then rename: concurrent first uses
    # (test workers) never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
        _SRC, "-o", tmp,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # no g++ / hang
        print(f"[icp-native] compile unavailable: {e}", file=sys.stderr)
        return False
    if res.returncode != 0:
        # retry without -march=native (portability) before giving up
        cmd.remove("-march=native")
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            print(f"[icp-native] compile failed:\n{res.stderr}", file=sys.stderr)
            return False
    os.replace(tmp, _LIB)
    return True


def load():
    """Return the loaded library, or None when native is unavailable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        stale = (not os.path.exists(_LIB)
                 or os.path.getmtime(_LIB) < os.path.getmtime(_SRC))
        if stale and not _compile():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            print(f"[icp-native] load failed: {e}", file=sys.stderr)
            _load_failed = True
            return None
        lib.icp_shortlist_topk.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ]
        lib.icp_shortlist_topk.restype = None
        lib.icp_point_tri_d2.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.icp_point_tri_d2.restype = None
        _lib = lib
        return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def shortlist_topk(queries: np.ndarray, tri: np.ndarray, k: int):
    """Top-K nearest faces per query by exact point→triangle distance.

    queries [N,3], tri [F,3,3] → (idx [N,K] int32 ascending, d2 [N,K]).
    Returns None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    q = np.ascontiguousarray(queries, np.float64)
    t = np.ascontiguousarray(tri, np.float64)
    n, f = q.shape[0], t.shape[0]
    k = min(k, f)
    idx = np.empty((n, k), np.int32)
    d2 = np.empty((n, k), np.float64)
    lib.icp_shortlist_topk(
        _dptr(q), _dptr(t), n, f, k,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _dptr(d2),
    )
    return idx, d2


def point_tri_d2(queries: np.ndarray, tri: np.ndarray):
    """Full exact [N,F] squared-distance matrix; None if unavailable."""
    lib = load()
    if lib is None:
        return None
    q = np.ascontiguousarray(queries, np.float64)
    t = np.ascontiguousarray(tri, np.float64)
    n, f = q.shape[0], t.shape[0]
    out = np.empty((n, f), np.float64)
    lib.icp_point_tri_d2(_dptr(q), _dptr(t), n, f, _dptr(out))
    return out
