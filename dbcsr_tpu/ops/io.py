"""Matrix I/O: binary checkpoint write/read and pretty printing.

Analog of ``src/ops/dbcsr_io.F``:

- ``binary_write`` / ``binary_read`` (reference ``dbcsr_binary_write/read``,
  ``src/ops/dbcsr_io.F:576-1077``): versioned snapshot with a 3-part layout —
  (1) header: magic/version string, matrix name, symmetry char, data type,
  block dimensions and block-size vectors; (2) index: nblks, data size,
  row_ptr / col_idx / blk_offset; (3) flat block data. The reference writes
  collectively via MPI-IO (``mp_file_*``); here a matrix's data lives in one
  flat device buffer, so the write is a single host serialization, and on a
  multi-host mesh each host holds the full (addressable) buffer via jax —
  process 0 writes.
- ``binary_read`` takes an optional target distribution and attaches it
  (the reference redistributes on read; distribution here is metadata plus
  engine-side packing, see ``transform.redistribute``).
- ``print_matrix`` / ``print_block_sum`` (reference ``dbcsr_print``,
  ``dbcsr_print_block_sum``, ``src/ops/dbcsr_io.F:58-64``).
"""
from __future__ import annotations

import json
import struct
import sys
from typing import Optional

import numpy as np

from ..block.bcsr import BCSRMatrix
from ..block.index import BCSRIndex
from ..core.errors import DbcsrError, dbcsr_assert

__all__ = [
    "binary_write",
    "binary_read",
    "print_matrix",
    "print_block_sum",
    "checksum",
    "get_info",
    "get_stored_coordinates",
    "verify_matrix",
]

_MAGIC = b"DBCSR_TPU_BIN"
_VERSION = 1


def _write_array(f, arr: np.ndarray) -> None:
    data = np.ascontiguousarray(arr)
    descr = np.lib.format.dtype_to_descr(data.dtype).encode()
    if len(descr) > 16:
        raise DbcsrError(
            f"dtype descriptor {descr!r} exceeds the 16-byte checkpoint "
            "field; refusing to write a corrupt snapshot"
        )
    f.write(struct.pack("<B", 0))
    f.write(struct.pack("<16s", descr))
    f.write(struct.pack("<q", data.size))
    f.write(data.tobytes())


def _read_array(f) -> np.ndarray:
    (_,) = struct.unpack("<B", f.read(1))
    (descr,) = struct.unpack("<16s", f.read(16))
    dtype = np.dtype(descr.rstrip(b"\x00").decode())
    (size,) = struct.unpack("<q", f.read(8))
    buf = f.read(size * dtype.itemsize)
    if len(buf) != size * dtype.itemsize:
        raise DbcsrError("truncated checkpoint file")
    return np.frombuffer(buf, dtype=dtype).copy()


def binary_write(m: BCSRMatrix, path: str) -> None:
    """Serialize a matrix snapshot (``dbcsr_binary_write`` analog,
    ``src/ops/dbcsr_io.F:576``). Versioned header + index + flat data."""
    header = {
        "version": _VERSION,
        "name": m.name,
        "sym": m.sym,
        "dtype": np.dtype(m.dtype).str,
        "nblkrows": m.nblkrows,
        "nblkcols": m.nblkcols,
        "nblks": m.nblks,
        "nelems": m.index.nelems,
    }
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<i", _VERSION))
        f.write(struct.pack("<q", len(hjson)))
        f.write(hjson)
        _write_array(f, m.index.row_block_sizes)
        _write_array(f, m.index.col_block_sizes)
        _write_array(f, m.index.row_ptr)
        _write_array(f, m.index.col_idx)
        _write_array(f, m.index.blk_offset)
        _write_array(f, m.flat_host())


def binary_read(path: str, *, dist=None, name: Optional[str] = None) -> BCSRMatrix:
    """Load a matrix snapshot (``dbcsr_binary_read`` analog,
    ``src/ops/dbcsr_io.F:860``); attaches ``dist`` if given (the reference
    redistributes into a caller-supplied distribution on read)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise DbcsrError(f"{path}: not a dbcsr_tpu checkpoint")
        (version,) = struct.unpack("<i", f.read(4))
        if version > _VERSION:
            raise DbcsrError(
                f"{path}: checkpoint version {version} newer than supported "
                f"{_VERSION}"
            )
        (hlen,) = struct.unpack("<q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        rbs = _read_array(f)
        cbs = _read_array(f)
        row_ptr = _read_array(f)
        col_idx = _read_array(f)
        blk_offset = _read_array(f)
        data = _read_array(f)
    idx = BCSRIndex(
        row_block_sizes=rbs.astype(np.int32),
        col_block_sizes=cbs.astype(np.int32),
        row_ptr=row_ptr.astype(np.int64),
        col_idx=col_idx.astype(np.int32),
        blk_offset=blk_offset.astype(np.int64),
    )
    dbcsr_assert(idx.nblks == header["nblks"], "index/header mismatch")
    dbcsr_assert(idx.nelems == header["nelems"], "data-size/header mismatch")
    dbcsr_assert(len(data) == header["nelems"], "data length mismatch")
    return BCSRMatrix.from_flat(
        idx,
        data.astype(np.dtype(header["dtype"])),
        name=name or header["name"],
        sym=header["sym"],
        dist=dist,
    )


def print_matrix(
    m: BCSRMatrix,
    file=None,
    *,
    max_blocks: int = 16,
    values: bool = True,
) -> None:
    """Human-readable dump (``dbcsr_print`` analog)."""
    f = file or sys.stdout
    occ = m.occupation()
    print(
        f"matrix {m.name!r}: {m.shape[0]}x{m.shape[1]} "
        f"({m.nblkrows}x{m.nblkcols} blocks), sym={m.sym}, "
        f"dtype={np.dtype(m.dtype).name}, nblks={m.nblks}, "
        f"occupation={occ:.4f}",
        file=f,
    )
    for n, (r, c, blk) in enumerate(m.iter_blocks()):
        if n >= max_blocks:
            print(f"  ... ({m.nblks - max_blocks} more blocks)", file=f)
            break
        if values:
            with np.printoptions(precision=4, suppress=True, threshold=64):
                print(f"  block ({r},{c}) {blk.shape[0]}x{blk.shape[1]}:\n"
                      f"{np.array2string(blk, prefix='    ')}", file=f)
        else:
            print(f"  block ({r},{c}) {blk.shape[0]}x{blk.shape[1]}", file=f)


def print_block_sum(m: BCSRMatrix, file=None) -> None:
    """Per-block element sums (``dbcsr_print_block_sum`` analog) — the
    reference's cheap fingerprint for debugging parallel layouts."""
    f = file or sys.stdout
    host = m.flat_host()
    off = m.index.blk_offset
    rows = m.index.blk_rows
    for b in range(m.nblks):
        s = host[int(off[b]):int(off[b + 1])].sum()
        print(f"  ({int(rows[b])},{int(m.index.col_idx[b])}) sum={s:.10g}", file=f)


def verify_matrix(m: BCSRMatrix) -> bool:
    """Consistency check (``dbcsr_verify_matrix``,
    ``src/dist/dbcsr_dist_util.F:56``): canonical index invariants, store
    geometry and the padding-zero invariant. Raises on violation."""
    idx = m.index
    dbcsr_assert(len(idx.row_ptr) == idx.nblkrows + 1, "row_ptr length")
    dbcsr_assert(int(idx.row_ptr[0]) == 0, "row_ptr[0] != 0")
    dbcsr_assert(int(idx.row_ptr[-1]) == idx.nblks, "row_ptr[-1] != nblks")
    dbcsr_assert((np.diff(idx.row_ptr) >= 0).all(), "row_ptr not monotone")
    for r in range(idx.nblkrows):
        lo, hi = int(idx.row_ptr[r]), int(idx.row_ptr[r + 1])
        cols = idx.col_idx[lo:hi]
        dbcsr_assert(
            (np.diff(cols) > 0).all() if len(cols) > 1 else True,
            f"row {r}: columns not strictly ascending",
        )
    if idx.nblks:
        dbcsr_assert(
            int(idx.col_idx.max()) < idx.nblkcols, "col index out of range"
        )
    bm, bn = idx.blk_shapes
    sizes = bm.astype(np.int64) * bn
    dbcsr_assert(
        np.array_equal(np.diff(idx.blk_offset), sizes), "blk_offset mismatch"
    )
    lay = m.layout
    dbcsr_assert(
        m.data.shape == (lay.n_tiles, m.tile, m.tile), "store shape mismatch"
    )
    from ..block.tileops import valid_mask

    vm = np.asarray(valid_mask(idx, m.tile)) > 0.5
    dbcsr_assert(
        bool(np.all(np.asarray(m.data)[~vm] == 0)),
        "padding-zero invariant violated",
    )
    return True


def get_info(m: BCSRMatrix) -> dict:
    """Matrix metadata snapshot (``dbcsr_get_info`` analog,
    ``src/dbcsr_api.F``)."""
    return {
        "name": m.name,
        "nfullrows": m.index.nfullrows,
        "nfullcols": m.index.nfullcols,
        "nblkrows": m.nblkrows,
        "nblkcols": m.nblkcols,
        "nblks": m.nblks,
        "nelems": m.index.nelems,
        "occupation": m.occupation(),
        "symmetry": m.sym,
        "dtype": np.dtype(m.dtype).name,
        "tile": m.tile,
        "n_tiles": m.layout.n_tiles,
        "distributed": m.dist is not None,
        "row_block_sizes": m.index.row_block_sizes,
        "col_block_sizes": m.index.col_block_sizes,
    }


def get_stored_coordinates(m: BCSRMatrix, row: int, col: int) -> Optional[int]:
    """Owning device id of block (row, col) under the matrix's distribution
    (``dbcsr_get_stored_coordinates``); None for local/replicated."""
    if m.dist is None:
        return None
    i = int(m.dist.row_dist[row])
    j = int(m.dist.col_dist[col])
    return i * m.dist.grid.npcol + j


def checksum(m: BCSRMatrix, *, pos: bool = False) -> float:
    """Matrix checksum (``dbcsr_checksum``, ``src/dist/dbcsr_dist_util.F:56``).

    ``pos=True`` matches the reference's position-dependent form
    (``pd_blk_cs``, ``src/dist/dbcsr_dist_util.F:552-577``): each element is
    weighted by ``log(|global_row * global_col|)`` with 1-based global
    element coordinates — invariant under re-blocking of identical logical
    content, so values are comparable to reference checksums."""
    host = m.flat_host()
    if not pos:
        return float((np.abs(host).astype(np.float64) ** 2).sum())
    idx = m.index
    _, bn = idx.blk_shapes
    b_of = idx.elem_to_blk
    off_in_blk = np.arange(host.size, dtype=np.int64) - idx.blk_offset[b_of]
    ncols = bn[b_of].astype(np.int64)
    gr = idx.row_offsets[idx.blk_rows[b_of]] + off_in_blk // ncols + 1
    gc = idx.col_offsets[idx.col_idx[b_of]] + off_in_blk % ncols + 1
    w = np.log(np.abs(gr.astype(np.float64) * gc.astype(np.float64)))
    return float((host.real.astype(np.float64) * w).sum())
