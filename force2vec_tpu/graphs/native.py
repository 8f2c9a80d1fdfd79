"""ctypes bindings for the native C++ graph loader (native/graphio.cpp).

Auto-builds ``libgraphio.so`` with g++ -O3 -fopenmp on first use (no
pybind11 in this image; plain C ABI + ctypes).  Falls back silently to the
numpy readers in graphs/io.py when no compiler is available — the native
path is a performance feature (com-Orkut-scale parsing), not a semantic
one, and both paths are tested for identical output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "graphio.cpp")
_SO = os.path.join(_NATIVE_DIR, "libgraphio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    # -march=native first (best parse rate on the build host); retry with
    # portable flags where the compiler rejects it.
    for march in ("-march=native", None):
        cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
               _SRC, "-o", _SO] + ([march] if march else [])
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=180)
            return True
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
    return False


def _so_path() -> Optional[str]:
    """A library built from the committed source, or None (no compiler, or
    the build failed): callers then use the numpy readers."""
    fresh = os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    if not fresh and not _build():
        return None
    return _SO


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so = _so_path()
        if so is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _build_failed = True
            return None
        lib.graphio_load_mtx.restype = ctypes.c_void_p
        lib.graphio_load_mtx.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
        lib.graphio_load_edgelist.restype = ctypes.c_void_p
        lib.graphio_load_edgelist.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.graphio_n.restype = ctypes.c_int64
        lib.graphio_n.argtypes = [ctypes.c_void_p]
        lib.graphio_nnz.restype = ctypes.c_int64
        lib.graphio_nnz.argtypes = [ctypes.c_void_p]
        lib.graphio_rowptr.restype = ctypes.POINTER(ctypes.c_int64)
        lib.graphio_rowptr.argtypes = [ctypes.c_void_p]
        lib.graphio_colids.restype = ctypes.POINTER(ctypes.c_int32)
        lib.graphio_colids.argtypes = [ctypes.c_void_p]
        lib.graphio_values.restype = ctypes.POINTER(ctypes.c_float)
        lib.graphio_values.argtypes = [ctypes.c_void_p]
        lib.graphio_free.restype = None
        lib.graphio_free.argtypes = [ctypes.c_void_p]
        lib.graphio_write_embd.restype = ctypes.c_int32
        lib.graphio_write_embd.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float32, ndim=2, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _extract(lib, handle) -> Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    try:
        n = lib.graphio_n(handle)
        nnz = lib.graphio_nnz(handle)
        rowptr = np.ctypeslib.as_array(lib.graphio_rowptr(handle), shape=(n + 1,)).copy()
        colids = np.ctypeslib.as_array(lib.graphio_colids(handle), shape=(nnz,)).copy()
        vptr = lib.graphio_values(handle)
        values = (
            np.ctypeslib.as_array(vptr, shape=(nnz,)).copy() if vptr else None
        )
        return int(n), rowptr, colids, values
    finally:
        lib.graphio_free(handle)


def load_mtx_native(path: str):
    """Native .mtx → (n, rowptr, colids, values|None), or None if the
    native library is unavailable or parsing failed."""
    lib = get_lib()
    if lib is None:
        return None
    has_vals = ctypes.c_int32(0)
    handle = lib.graphio_load_mtx(path.encode(), ctypes.byref(has_vals))
    if not handle:
        return None
    return _extract(lib, handle)


def write_embd_native(path: str, emb: np.ndarray) -> bool:
    """Native parallel text .embd writer. Returns False if the native
    library is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return False
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    return lib.graphio_write_embd(path.encode(), emb, emb.shape[0], emb.shape[1]) == 0


def load_edgelist_native(
    path: str, zero_based: bool = True, symmetrize: bool = True,
    drop_self_loops: bool = True,
):
    """Native edge list → (n, rowptr, colids, values|None), or None."""
    lib = get_lib()
    if lib is None:
        return None
    has_vals = ctypes.c_int32(0)
    handle = lib.graphio_load_edgelist(
        path.encode(), int(zero_based), int(symmetrize), int(drop_self_loops),
        ctypes.byref(has_vals),
    )
    if not handle:
        return None
    return _extract(lib, handle)
