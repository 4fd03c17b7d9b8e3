"""Native (C++) host-runtime components, loaded via ctypes.

The device compute path is JAX/XLA; the host runtime around it — format
parsing and factorization setup, the parts the reference wrote in C — is
C++ here (``cgx/native/src/``), compiled on demand with ``g++ -O3`` into a
shared library cached next to the sources.  Every native entry point has a
pure-Python fallback, so the package works (slower) without a toolchain.

Use :func:`lib` to get the loaded library (or ``None``), and the typed
wrappers :func:`parse_legacy` / :func:`ic0_factor_native`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_SO = os.path.join(_DIR, "_cgx_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    srcs = [os.path.join(_SRC, f) for f in sorted(os.listdir(_SRC))
            if f.endswith(".cpp")]
    if not srcs:
        return False
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest:
        return True
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", "-o", _SO + ".tmp", *srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(_SO + ".tmp", _SO)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it first if needed."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        l = ctypes.CDLL(_SO)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        l.cgx_parse_legacy.restype = ctypes.c_void_p
        l.cgx_parse_legacy.argtypes = [ctypes.c_char_p]
        l.cgx_parsed_sizes.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
        l.cgx_parsed_copy.argtypes = [ctypes.c_void_p, i32p, i32p, f64p,
                                      f64p]
        l.cgx_parsed_free.argtypes = [ctypes.c_void_p]
        l.cgx_ic0_factor.restype = ctypes.c_int32
        l.cgx_ic0_factor.argtypes = [ctypes.c_int64, i32p, i32p, f64p, i32p,
                                     i64p]
        l.cgx_level_schedule.argtypes = [ctypes.c_int64, i32p, i32p, i32p]
        _lib = l
        return _lib


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def parse_legacy(path: str):
    """Native 4-line-format parse → ``(col_indices, row_ptr, a_values,
    b_values)`` host arrays, or ``None`` if the native lib is unavailable.
    """
    l = lib()
    if l is None:
        return None
    h = l.cgx_parse_legacy(path.encode())
    if not h:
        raise IOError(f"cgx_parse_legacy: cannot read or parse {path!r} "
                      "(I/O failure or non-numeric token)")
    try:
        nnz = ctypes.c_int64()
        nrp = ctypes.c_int64()
        nb = ctypes.c_int64()
        l.cgx_parsed_sizes(h, ctypes.byref(nnz), ctypes.byref(nrp),
                           ctypes.byref(nb))
        cols = np.empty(nnz.value, np.int32)
        rp = np.empty(nrp.value, np.int32)
        av = np.empty(nnz.value, np.float64)
        bv = np.empty(nb.value, np.float64)
        l.cgx_parsed_copy(
            h, cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            av.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            bv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return cols, rp, av, bv
    finally:
        l.cgx_parsed_free(h)


def ic0_factor_native(indptr, cols, tril_values):
    """In-place-style native IC(0) over a lower-triangular CSR pattern.

    Returns ``(l_values, levels)`` or ``None`` if the native lib is
    unavailable.  Raises ``np.linalg.LinAlgError`` on pivot breakdown
    (matching the Python path in :mod:`cgx.solve.ic0`).
    """
    l = lib()
    if l is None:
        return None
    indptr = _i32(indptr)
    cols = _i32(cols)
    vals = np.array(tril_values, dtype=np.float64, copy=True)
    n = len(indptr) - 1
    levels = np.zeros(n, np.int32)
    fail = ctypes.c_int64(-1)
    rc = l.cgx_ic0_factor(
        n, indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(fail))
    if rc != 0:
        raise np.linalg.LinAlgError(
            f"IC(0) breakdown at row {fail.value}: pivot <= 0")
    return vals, levels
