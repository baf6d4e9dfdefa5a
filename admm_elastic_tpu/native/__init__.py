"""Native (C++) host-side helpers, loaded via ctypes.

The reference's runtime is all C++; in this build the device compute
path is XLA, but init-time host work with irregular access patterns —
greedy graph coloring, adjacency construction, mesh file parsing — is
native C++ (admm_elastic_tpu/native/geomcore.cpp), with numpy fallbacks in
the callers when the shared library has not been built.

Build: ``make -C admm_elastic_tpu/native`` (or it is built on demand).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(__file__)
    so = os.path.join(here, "libgeomcore.so")
    if not os.path.exists(so):
        src = os.path.join(here, "geomcore.cpp")
        if os.path.exists(src):
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", so],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:
                return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.greedy_coloring.restype = ctypes.c_int
    lib.greedy_coloring.argtypes = [
        ctypes.POINTER(ctypes.c_int64),  # adj flat
        ctypes.POINTER(ctypes.c_int64),  # row starts (n+1)
        ctypes.c_int64,  # n
        ctypes.POINTER(ctypes.c_int32),  # out colors
    ]
    lib.greedy_aggregates.restype = ctypes.c_int
    lib.greedy_aggregates.argtypes = [
        ctypes.POINTER(ctypes.c_int64),  # adj flat
        ctypes.POINTER(ctypes.c_int64),  # row starts (n+1)
        ctypes.c_int64,  # n
        ctypes.c_int32,  # target cluster size
        ctypes.POINTER(ctypes.c_int32),  # out aggregate ids
    ]
    _LIB = lib
    return _LIB


def greedy_coloring_native(adj) -> np.ndarray:
    """Greedy graph coloring in C++; raises if the library is unavailable."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libgeomcore.so not available")
    n = len(adj)
    starts = np.zeros((n + 1,), dtype=np.int64)
    for i, a in enumerate(adj):
        starts[i + 1] = starts[i] + len(a)
    flat = np.concatenate(adj).astype(np.int64) if n and starts[-1] else np.zeros((0,), np.int64)
    out = np.zeros((n,), dtype=np.int32)
    rc = lib.greedy_coloring(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"greedy_coloring failed rc={rc}")
    return out


def greedy_aggregates_native(adj, target_size: int) -> np.ndarray:
    """Greedy BFS aggregation in C++; raises if the library is unavailable."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libgeomcore.so not available")
    n = len(adj)
    starts = np.zeros((n + 1,), dtype=np.int64)
    for i, a in enumerate(adj):
        starts[i + 1] = starts[i] + len(a)
    flat = np.concatenate(adj).astype(np.int64) if n and starts[-1] else np.zeros((0,), np.int64)
    out = np.zeros((n,), dtype=np.int32)
    rc = lib.greedy_aggregates(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        ctypes.c_int32(target_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"greedy_aggregates failed rc={rc}")
    return out
