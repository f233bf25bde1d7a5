"""ctypes bindings for the native meshkit library (see native/meshkit.cpp).

Builds the shared library on first use (g++ available per environment),
caches it next to the source, and degrades to None when compilation is
impossible — callers keep their NumPy fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _root() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


def get_lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_root(), "meshkit.cpp")
    so = os.path.join(_root(), "libmeshkit.so")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", so, src],
                check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        lib.meshkit_dedup_rows.restype = ctypes.c_int64
        lib.meshkit_assembly_map.restype = ctypes.c_int64
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def dedup_rows(keys: np.ndarray):
    """[M, d] int64 -> (first_index[N], inverse[M]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    M, d = keys.shape
    inverse = np.empty(M, dtype=np.int64)
    first = np.empty(M, dtype=np.int64)
    n = lib.meshkit_dedup_rows(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(M), ctypes.c_int32(d),
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return first[:n].copy(), inverse


def morton_codes(q: np.ndarray, bits: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.uint64)
    E, d = q.shape
    codes = np.empty(E, dtype=np.uint64)
    lib.meshkit_morton_codes(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(E), ctypes.c_int32(d), ctypes.c_int32(bits),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return codes


def assembly_map(elem_nodes: np.ndarray, n_nodes: int,
                 exclude_node: int | None, max_mult: int,
                 pad_value: int):
    lib = get_lib()
    if lib is None:
        return None
    en = np.ascontiguousarray(elem_nodes, dtype=np.int32)
    E, nn = en.shape
    idx = np.empty((n_nodes, max_mult), dtype=np.int64)
    counts = np.empty(n_nodes, dtype=np.int64)
    used = lib.meshkit_assembly_map(
        en.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(E), ctypes.c_int32(nn), ctypes.c_int64(n_nodes),
        ctypes.c_int64(-1 if exclude_node is None else exclude_node),
        ctypes.c_int64(max_mult), ctypes.c_int64(pad_value),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if used < 0:
        return None
    return idx[:, :used] if used > 0 else idx[:, :1], int(used)
