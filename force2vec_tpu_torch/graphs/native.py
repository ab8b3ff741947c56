"""ctypes bindings for the native C++ graph loader (``native/graphio.cpp``).

The functions and return shapes of ``force2vec_tpu/graphs/native.py``.  The
library is built with ``g++ -O3 -fopenmp -shared -fPIC -std=c++17`` at first
use, from the port's own copy of the source, into ``native/build/`` under a
name keyed by a hash of the source and flags (as ``ops/_build.py`` keys the
CUDA kernels): an edited source is rebuilt, an unchanged one loaded as is.
No prebuilt binary is shipped.  Where no compiler works, every loader
returns None and ``graphs/io.py`` runs its numpy reader, which the tests
hold equal to this one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCE = NATIVE_DIR / "graphio.cpp"
BUILD_DIR = NATIVE_DIR / "build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgraphio_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the library unless it exists; its path, or None if g++ is
    missing or fails.  The build goes to a temporary directory and is
    renamed into place, so concurrent builds (pytest workers) never load a
    half-written library."""
    lib = library_path()
    if lib.exists():
        return lib
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            so = os.path.join(tmp, lib.name)
            subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", so],
                           check=True, capture_output=True, timeout=180)
            os.replace(so, lib)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so = build()
        try:
            lib = ctypes.CDLL(str(so)) if so is not None else None
        except OSError:
            lib = None
        if lib is None:
            _build_failed = True
            return None
        lib.graphio_load_mtx.restype = ctypes.c_void_p
        lib.graphio_load_mtx.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_int32)]
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
            np.ctypeslib.ndpointer(dtype=np.float32, ndim=2,
                                   flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _extract(lib, handle
             ) -> Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    try:
        n = lib.graphio_n(handle)
        nnz = lib.graphio_nnz(handle)
        rowptr = np.ctypeslib.as_array(lib.graphio_rowptr(handle),
                                       shape=(n + 1,)).copy()
        colids = (np.ctypeslib.as_array(lib.graphio_colids(handle),
                                        shape=(nnz,)).copy()
                  if nnz else np.zeros(0, np.int32))
        vptr = lib.graphio_values(handle)
        values = (np.ctypeslib.as_array(vptr, shape=(nnz,)).copy()
                  if vptr else None)
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
    handle = lib.graphio_load_mtx(os.fsencode(path), ctypes.byref(has_vals))
    if not handle:
        return None
    return _extract(lib, handle)


def write_embd_native(path: str, emb: np.ndarray) -> bool:
    """Native parallel text .embd writer.  False if the native library is
    unavailable or the write failed (the caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return False
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    if emb.ndim != 2:
        raise ValueError(f"embedding must be [n, d], got {emb.shape}")
    return lib.graphio_write_embd(os.fsencode(path), emb, emb.shape[0],
                                  emb.shape[1]) == 0


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
        os.fsencode(path), int(zero_based), int(symmetrize),
        int(drop_self_loops), ctypes.byref(has_vals),
    )
    if not handle:
        return None
    return _extract(lib, handle)
