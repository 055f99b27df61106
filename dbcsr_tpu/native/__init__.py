"""Native (C++) planner core with ctypes bindings.

The reference keeps its hot host-side index machinery in compiled code
(Fortran stack builder ``src/mm/dbcsr_mm_csr.F`` + C++ ``libsmm_acc``); the
equivalent here keeps device math in XLA/Pallas and compiles the
branchy host planning into ``stackbuild.cpp``. The library is built lazily
with g++ on first use and cached next to the source; every entry point has
a numpy fallback, selected by config ``use_native_planner`` (env
``DBCSR_USE_NATIVE_PLANNER``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "native_available",
    "stack_build",
    "inverse_map_native",
    "flatten_blocks",
    "store_layout_native",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "stackbuild.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_HERE, f"_stackbuild_{tag}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("DBCSR_USE_NATIVE_PLANNER", "1") in ("0", "false"):
            return None
        so = _build_path()
        try:
            if not os.path.exists(so):
                tmp = so + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", _SRC, "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None
        i64 = ctypes.c_int64
        p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.dbcsr_stack_count.restype = i64
        lib.dbcsr_stack_count.argtypes = [i64, p64, p64]
        lib.dbcsr_stack_build.restype = i64
        lib.dbcsr_stack_build.argtypes = [
            i64, i64, p64, p64, p64, p64, p64, p64, i64, p32, p64
        ]
        lib.dbcsr_inverse_map.restype = None
        lib.dbcsr_inverse_map.argtypes = [p64, i64, p32, i64, ctypes.c_int32]
        lib.dbcsr_store_layout.restype = i64
        lib.dbcsr_store_layout.argtypes = [
            i64, p64, p64, p64, p64, p64, i64, i64, i64, p64, p64, p32
        ]
        lib.dbcsr_flatten_f64.restype = None
        lib.dbcsr_flatten_f64.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), p64, p64, i64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.dbcsr_flatten_f32.restype = None
        lib.dbcsr_flatten_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), p64, p64, i64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def stack_build(
    kt: int,
    nt: int,
    a_indptr: np.ndarray,
    a_rows: np.ndarray,
    a_slots: np.ndarray,
    b_indptr: np.ndarray,
    b_cols: np.ndarray,
    b_slots: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Fused triple enumeration + sort + C-slot assignment.

    Inputs are A's tile pattern in CSC-by-k (rows = C tile rows) and B's in
    CSR-by-k (cols = C tile cols), slot arrays carrying tile-store slots.
    Returns (stack int32 [S,3] sorted by c_slot, c_keys int64 [n_c] sorted
    unique row-major C tile keys), or None if the native lib is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, dtype=np.int64)
    b_indptr = np.ascontiguousarray(b_indptr, dtype=np.int64)
    total = int(lib.dbcsr_stack_count(kt, a_indptr, b_indptr))
    stack = np.empty((max(total, 1), 3), dtype=np.int32)
    c_keys = np.empty(max(total, 1), dtype=np.int64)
    if total == 0:
        return stack[:0], c_keys[:0]
    n_c = int(
        lib.dbcsr_stack_build(
            kt, nt,
            a_indptr,
            np.ascontiguousarray(a_rows, dtype=np.int64),
            np.ascontiguousarray(a_slots, dtype=np.int64),
            b_indptr,
            np.ascontiguousarray(b_cols, dtype=np.int64),
            np.ascontiguousarray(b_slots, dtype=np.int64),
            total, stack.reshape(-1), c_keys,
        )
    )
    if n_c < 0:
        return None
    return stack[:total], c_keys[:n_c]


def store_layout_native(index, tile: int):
    """Native tile-store layout construction (one fused C pass; the numpy
    path runs several 10M-element arithmetic passes). Returns
    (tile_coords int32 [n,2], elem_dest int64 [nelems], ntr, ntc) or None."""
    lib = _load()
    if lib is None:
        return None
    ntr = -(-index.nfullrows // tile)
    ntc = -(-index.nfullcols // tile)
    if ntr * ntc > (1 << 24):  # grid scratch would dominate; numpy path
        return None
    nblks = index.nblks
    scratch = np.empty(max(ntr * ntc, 1), dtype=np.int64)
    elem_dest = np.empty(max(index.nelems, 1), dtype=np.int64)
    coords = np.empty((max(ntr * ntc, 1), 2), dtype=np.int32)
    n_tiles = int(
        lib.dbcsr_store_layout(
            nblks,
            np.ascontiguousarray(index.blk_rows, dtype=np.int64),
            np.ascontiguousarray(index.col_idx, dtype=np.int64),
            np.ascontiguousarray(index.row_offsets, dtype=np.int64),
            np.ascontiguousarray(index.col_offsets, dtype=np.int64),
            np.ascontiguousarray(index.blk_offset, dtype=np.int64),
            tile, ntr, ntc,
            scratch, elem_dest, coords.reshape(-1),
        )
    )
    return (
        coords[:n_tiles].copy(),
        elem_dest[: index.nelems],
        ntr,
        ntc,
    )


def inverse_map_native(
    map_: np.ndarray, out_len: int, fill: int
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(out_len, dtype=np.int32)
    lib.dbcsr_inverse_map(
        np.ascontiguousarray(map_, dtype=np.int64), len(map_), out,
        out_len, fill,
    )
    return out


def flatten_blocks(blocks, order: np.ndarray, dtype) -> Optional[np.ndarray]:
    """Concatenate ``blocks[order[i]].ravel()`` without a Python-level loop
    building temporaries (assembly fast path). Blocks must already have the
    target dtype and be C-contiguous for the native path to engage."""
    lib = _load()
    dtype = np.dtype(dtype)
    if lib is None or dtype not in (np.float64, np.float32) or not len(blocks):
        return None
    arrs = []
    for b in blocks:
        a = np.asarray(b)
        if a.dtype != dtype or not a.flags.c_contiguous:
            return None
        arrs.append(a)
    sizes = np.asarray([a.size for a in arrs], dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    total = int(sizes[order].sum())
    dst = np.empty(total, dtype=dtype)
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]
    )
    fn = lib.dbcsr_flatten_f64 if dtype == np.float64 else lib.dbcsr_flatten_f32
    fn(ptrs, sizes, order, len(arrs), dst)
    return dst
