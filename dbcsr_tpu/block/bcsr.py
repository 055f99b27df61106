"""The central matrix type: host block index + device TILE STORE.

Redesign of ``dbcsr_type`` (``src/core/dbcsr_types.F:362-461``):

- the CSR-of-blocks index lives on the host (numpy, see ``index.py``);
- the device data is the matrix's own **tile store** — ``[n_tiles, T, T]``
  holding the dense content of every T×T tile that overlaps a stored block,
  exactly 0 everywhere no block covers (the *padding-zero invariant*; see
  ``store.py`` for why: element-granular device gathers are far slower
  than tile-granular ones, so the at-rest layout must already BE the
  layout the matrix products consume);
- the reference's element-contiguous ``data_area`` layout survives host-side
  only, as the interchange format for assembly, I/O and block access
  (``flat_host``/``with_flat``).

Symmetry (``N``/``S``/``A``/``H`` as in ``dbcsr_types.F:468-474``) stores
only the upper block triangle (i <= j); consumers desymmetrize on demand.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.errors import dbcsr_assert
from .index import BCSRIndex, build_index
from .store import StoreLayout, store_layout

__all__ = ["BCSRMatrix", "BCSRBuilder", "SYM_NONE", "SYM_SYMMETRIC", "SYM_ANTISYMMETRIC", "SYM_HERMITIAN", "default_tile"]

SYM_NONE = "N"
SYM_SYMMETRIC = "S"
SYM_ANTISYMMETRIC = "A"
SYM_HERMITIAN = "H"
_SYMS = (SYM_NONE, SYM_SYMMETRIC, SYM_ANTISYMMETRIC, SYM_HERMITIAN)


def default_tile() -> int:
    from ..core.config import get_config

    return get_config().tile_size


def emulate_complex(dtype) -> bool:
    """True when ``dtype`` is complex and the device backend cannot hold
    complex arrays (or when tests force it): the matrix then stores
    SPLIT re/im real tile stores and every device op runs as real
    arithmetic — this library's form of the reference's z/c type classes
    (``src/data/dbcsr.fypp:15-28``) on such backends."""
    if not np.issubdtype(np.dtype(dtype), np.complexfloating):
        return False
    from ..core.machine import backend_supports_complex

    return not backend_supports_complex()


def _real_dtype(cdtype) -> np.dtype:
    return np.zeros(0, dtype=cdtype).real.dtype


@dataclass(frozen=True)
class BCSRMatrix:
    name: str
    index: BCSRIndex
    data: jax.Array  # tile store [n_tiles, T, T]; padding positions == 0
    sym: str = SYM_NONE
    dist: Optional[object] = None  # dist.Distribution, None = local/replicated
    #: imaginary tile store for SPLIT-COMPLEX emulation (backends that
    #: reject complex arrays); None = real or native-complex storage
    data_im: Optional[jax.Array] = None
    #: logical complex dtype name when emulated (e.g. "complex128")
    cdtype: Optional[str] = None

    def __post_init__(self):
        dbcsr_assert(self.sym in _SYMS, f"bad symmetry {self.sym!r}")
        dbcsr_assert(
            self.data.ndim == 3 and self.data.shape[1] == self.data.shape[2],
            f"data must be a [n_tiles, T, T] tile store, got {self.data.shape}",
        )
        if self.data_im is not None:
            dbcsr_assert(
                self.data_im.shape == self.data.shape
                and self.cdtype is not None,
                "split-complex store: data_im must mirror data",
            )

    # -- split-complex emulation ------------------------------------------
    @property
    def is_complex_emulated(self) -> bool:
        return self.data_im is not None

    def parts(self) -> Tuple["BCSRMatrix", "BCSRMatrix"]:
        """(re, im) as plain REAL matrices sharing this index — the unit the
        emulated ops are composed from. Symmetry carries over per part: for
        'H' the real part is 'S' and the imaginary part is 'A'."""
        dbcsr_assert(self.is_complex_emulated, "not an emulated matrix")
        if self.sym == SYM_HERMITIAN:
            sym_re, sym_im = SYM_SYMMETRIC, SYM_ANTISYMMETRIC
        else:
            sym_re = sym_im = self.sym
        re = replace(
            self, data=self.data, data_im=None, cdtype=None, sym=sym_re,
            name=f"{self.name}.re",
        )
        im = replace(
            self, data=self.data_im, data_im=None, cdtype=None, sym=sym_im,
            name=f"{self.name}.im",
        )
        return re, im

    @staticmethod
    def combine(
        re: "BCSRMatrix", im: "BCSRMatrix", cdtype, *,
        name: str = "matrix", sym: str = SYM_NONE,
    ) -> "BCSRMatrix":
        """Pack two aligned REAL matrices back into one emulated matrix."""
        dbcsr_assert(
            re.data.shape == im.data.shape, "combine: part stores differ"
        )
        return replace(
            re, data_im=im.data, cdtype=np.dtype(cdtype).name, name=name,
            sym=sym,
        )

    # -- layout -------------------------------------------------------------
    @property
    def tile(self) -> int:
        return int(self.data.shape[1])

    @property
    def layout(self) -> StoreLayout:
        return store_layout(self.index, self.tile)

    # -- shape / structure ------------------------------------------------
    @property
    def dtype(self):
        if self.data_im is not None:
            return np.dtype(self.cdtype)
        return self.data.dtype

    @property
    def nblkrows(self) -> int:
        return self.index.nblkrows

    @property
    def nblkcols(self) -> int:
        return self.index.nblkcols

    @property
    def nblks(self) -> int:
        return self.index.nblks

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.index.nfullrows, self.index.nfullcols)

    @property
    def row_block_sizes(self) -> np.ndarray:
        return self.index.row_block_sizes

    @property
    def col_block_sizes(self) -> np.ndarray:
        return self.index.col_block_sizes

    def occupation(self) -> float:
        """Fraction of nonzero elements (``dbcsr_get_occupation``)."""
        full = self.index.nfullrows * self.index.nfullcols
        if full == 0:
            return 0.0
        if self.sym == SYM_NONE:
            stored = self.index.nelems
        else:
            bm, bn = self.index.blk_shapes
            diag = self.index.blk_rows == self.index.col_idx
            sizes = bm.astype(np.int64) * bn
            stored = int(2 * sizes.sum() - sizes[diag].sum())
        return stored / full

    def with_data(self, data: jax.Array) -> "BCSRMatrix":
        dbcsr_assert(data.shape == self.data.shape, "store shape mismatch")
        dbcsr_assert(
            self.data_im is None,
            "with_data on a split-complex matrix: replace via with_flat or "
            "BCSRMatrix.combine",
        )
        return replace(self, data=data)

    def with_flat(self, flat) -> "BCSRMatrix":
        """Replace data from host-side flat block data (reference layout)."""
        flat = np.asarray(flat).reshape(-1)
        dbcsr_assert(len(flat) == self.index.nelems, "flat size mismatch")
        if emulate_complex(flat.dtype):
            new = BCSRMatrix.from_flat(
                self.index, flat, name=self.name, sym=self.sym,
                dist=self.dist, tile=self.tile,
            )
            return new
        return replace(
            self, data=jnp.asarray(self.layout.store_from_flat(flat)),
            data_im=None, cdtype=None,
        )

    def astype(self, dtype) -> "BCSRMatrix":
        dtype = np.dtype(dtype)
        if self.data_im is not None:
            if np.issubdtype(dtype, np.complexfloating):
                rt = _real_dtype(dtype)
                return replace(
                    self, data=self.data.astype(rt),
                    data_im=self.data_im.astype(rt), cdtype=dtype.name,
                )
            # drop the imaginary part (numpy casting semantics)
            return replace(
                self, data=self.data.astype(dtype), data_im=None, cdtype=None
            )
        if emulate_complex(dtype):
            rt = _real_dtype(dtype)
            return replace(
                self, data=self.data.real.astype(rt),
                data_im=jnp.zeros_like(self.data, dtype=rt),
                cdtype=dtype.name,
            )
        return replace(self, data=self.data.astype(dtype))

    # -- host access (block granularity) ------------------------------------
    def flat_host(self) -> np.ndarray:
        """Flat block data on host (the reference's ``data_area`` layout:
        block b occupies ``flat[blk_offset[b]:blk_offset[b+1]]`` row-major).
        One device fetch + numpy gather."""
        if self.data_im is not None:
            re = self.layout.flat_from_store(np.asarray(self.data))
            im = self.layout.flat_from_store(np.asarray(self.data_im))
            return (re + 1j * im).astype(self.cdtype)
        return self.layout.flat_from_store(np.asarray(self.data))

    def get_block(self, row: int, col: int) -> Optional[np.ndarray]:
        """Fetch one block to host; handles symmetric reflection; None if
        absent (``dbcsr_get_block_p`` analog)."""
        tr = False
        if self.sym != SYM_NONE and row > col:
            row, col, tr = col, row, True
        b = self.index.block_id(row, col)
        if b < 0:
            return None
        o0, o1 = int(self.index.blk_offset[b]), int(self.index.blk_offset[b + 1])
        bm = int(self.index.row_block_sizes[row])
        bn = int(self.index.col_block_sizes[col])
        dest = self.layout.elem_dest[o0:o1]
        flat = np.asarray(self.data).reshape(-1)[dest]
        if self.data_im is not None:
            flat = (
                flat + 1j * np.asarray(self.data_im).reshape(-1)[dest]
            ).astype(self.cdtype)
        blk = flat.reshape(bm, bn)
        if tr:
            blk = blk.T
            if self.sym == SYM_ANTISYMMETRIC:
                blk = -blk
            elif self.sym == SYM_HERMITIAN:
                blk = np.conj(blk)
        return blk

    def iter_blocks(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield (row, col, block) over stored blocks
        (``dbcsr_iterator_*`` analog; data fetched to host in one transfer)."""
        host = self.flat_host()
        bm_all, bn_all = self.index.blk_shapes
        rows = self.index.blk_rows
        for b in range(self.nblks):
            o0, o1 = int(self.index.blk_offset[b]), int(self.index.blk_offset[b + 1])
            yield int(rows[b]), int(self.index.col_idx[b]), host[o0:o1].reshape(
                int(bm_all[b]), int(bn_all[b])
            )

    # -- conversions ------------------------------------------------------
    def to_dense(self) -> jax.Array:
        """Full dense matrix (symmetry expanded). Tile-granular device
        scatter — runs at HBM bandwidth. Split-complex matrices combine on
        the host (numpy result) since the device cannot hold complex."""
        if self.data_im is not None:
            re, im = self.parts()
            out = np.asarray(re.to_dense()) + 1j * np.asarray(im.to_dense())
            return out.astype(self.cdtype)
        lay = self.layout
        t = self.tile
        grid = jnp.zeros(
            (lay.ntr * lay.ntc, t, t), dtype=self.dtype
        )
        if lay.n_tiles:
            grid = grid.at[jnp.asarray(lay.tile_keys())].set(self.data)
        dense = (
            grid.reshape(lay.ntr, lay.ntc, t, t)
            .transpose(0, 2, 1, 3)
            .reshape(lay.ntr * t, lay.ntc * t)
        )
        out = dense[: self.index.nfullrows, : self.index.nfullcols]
        if self.sym != SYM_NONE:
            lower = jnp.tril(jnp.ones(out.shape, dtype=bool), k=-1)
            refl = out.T
            if self.sym == SYM_ANTISYMMETRIC:
                refl = -refl
            elif self.sym == SYM_HERMITIAN:
                refl = jnp.conj(refl)
            out = jnp.where(lower, refl, out)
        return out

    @staticmethod
    def from_dense(
        dense,
        row_block_sizes,
        col_block_sizes,
        *,
        name: str = "from_dense",
        keep_zero_blocks: bool = False,
        tol: float = 0.0,
        dist=None,
    ) -> "BCSRMatrix":
        """Blocked sparsification of a dense matrix (host-side; test/setup
        utility, analog of the conversion helpers in
        ``src/ops/dbcsr_test_methods.F``)."""
        dense_np = np.asarray(dense)
        rbs = np.asarray(row_block_sizes, dtype=np.int32)
        cbs = np.asarray(col_block_sizes, dtype=np.int32)
        ro = np.concatenate([[0], np.cumsum(rbs)])
        co = np.concatenate([[0], np.cumsum(cbs)])
        dbcsr_assert(dense_np.shape == (ro[-1], co[-1]), "shape mismatch")
        rows: List[int] = []
        cols: List[int] = []
        blocks: List[np.ndarray] = []
        for i in range(len(rbs)):
            for j in range(len(cbs)):
                blk = dense_np[ro[i]:ro[i + 1], co[j]:co[j + 1]]
                if keep_zero_blocks or np.linalg.norm(blk) > tol:
                    rows.append(i)
                    cols.append(j)
                    blocks.append(blk)
        return BCSRMatrix.from_blocks(
            rows, cols, blocks, rbs, cbs, name=name, dist=dist,
            dtype=dense_np.dtype,
        )

    @staticmethod
    def from_flat(
        index: BCSRIndex,
        flat: np.ndarray,
        *,
        name: str = "matrix",
        sym: str = SYM_NONE,
        dist=None,
        tile: Optional[int] = None,
    ) -> "BCSRMatrix":
        """Construct from a canonical index + host flat block data."""
        t = tile or default_tile()
        lay = store_layout(index, t)
        flat = np.asarray(flat).reshape(-1)
        if emulate_complex(flat.dtype):
            rt = _real_dtype(flat.dtype)
            return BCSRMatrix(
                name=name, index=index,
                data=jnp.asarray(
                    lay.store_from_flat(np.ascontiguousarray(flat.real, dtype=rt))
                ),
                data_im=jnp.asarray(
                    lay.store_from_flat(np.ascontiguousarray(flat.imag, dtype=rt))
                ),
                cdtype=np.dtype(flat.dtype).name,
                sym=sym, dist=dist,
            )
        store = lay.store_from_flat(flat)
        return BCSRMatrix(
            name=name, index=index, data=jnp.asarray(store), sym=sym, dist=dist
        )

    @staticmethod
    def from_blocks(
        rows,
        cols,
        blocks,
        row_block_sizes,
        col_block_sizes,
        *,
        name: str = "matrix",
        sym: str = SYM_NONE,
        dist=None,
        dtype=None,
        tile: Optional[int] = None,
    ) -> "BCSRMatrix":
        """Construct from COO block lists (fast path around the builder)."""
        rbs = np.asarray(row_block_sizes, dtype=np.int32)
        cbs = np.asarray(col_block_sizes, dtype=np.int32)
        idx, order = build_index(np.asarray(rows), np.asarray(cols), rbs, cbs)
        if dtype is None:
            dtype = blocks[0].dtype if blocks else np.float32
        if idx.nblks:
            from ..native import flatten_blocks

            flat = flatten_blocks(blocks, order, dtype)
            if flat is None:
                flat = np.concatenate(
                    [np.asarray(blocks[int(o)], dtype=dtype).ravel() for o in order]
                )
        else:
            flat = np.zeros((0,), dtype=dtype)
        return BCSRMatrix.from_flat(
            idx, flat, name=name, sym=sym, dist=dist, tile=tile
        )

    @staticmethod
    def empty(
        row_block_sizes,
        col_block_sizes,
        *,
        name: str = "empty",
        dtype=jnp.float32,
        sym: str = SYM_NONE,
        dist=None,
        tile: Optional[int] = None,
    ) -> "BCSRMatrix":
        return BCSRMatrix.from_blocks(
            [], [], [], row_block_sizes, col_block_sizes,
            name=name, sym=sym, dist=dist, dtype=dtype, tile=tile,
        )


class BCSRBuilder:
    """Mutable assembly buffer → immutable matrix at ``finalize``.

    Analog of the reference's per-thread work matrices + ``dbcsr_finalize``
    (``src/work/dbcsr_work_operations.F:101-958``): ``put_block`` appends or
    accumulates (``sum=True`` adds into an existing staged block, matching
    ``dbcsr_put_block``'s summation semantics); ``finalize`` sorts, merges
    duplicates and produces the canonical index + device tile store.
    """

    def __init__(
        self,
        row_block_sizes,
        col_block_sizes,
        *,
        name: str = "matrix",
        dtype=np.float32,
        sym: str = SYM_NONE,
        dist=None,
        tile: Optional[int] = None,
    ):
        self.row_block_sizes = np.asarray(row_block_sizes, dtype=np.int32)
        self.col_block_sizes = np.asarray(col_block_sizes, dtype=np.int32)
        self.name = name
        self.dtype = np.dtype(dtype)
        self.sym = sym
        self.dist = dist
        self.tile = tile
        self._blocks: Dict[Tuple[int, int], np.ndarray] = {}

    def put_block(self, row: int, col: int, block, *, sum: bool = False) -> None:
        if self.sym != SYM_NONE and row > col:
            raise ValueError(
                "symmetric builders store the upper block triangle (i <= j)"
            )
        bm = int(self.row_block_sizes[row])
        bn = int(self.col_block_sizes[col])
        blk = np.asarray(block, dtype=self.dtype).reshape(bm, bn)
        key = (row, col)
        if sum and key in self._blocks:
            self._blocks[key] = self._blocks[key] + blk
        else:
            self._blocks[key] = blk

    def reserve_block(self, row: int, col: int) -> None:
        """Reserve a zero block (``dbcsr_reserve_block2d`` analog)."""
        if (row, col) not in self._blocks:
            self.put_block(
                row,
                col,
                np.zeros(
                    (self.row_block_sizes[row], self.col_block_sizes[col]),
                    dtype=self.dtype,
                ),
            )

    def reserve_blocks(self, rows, cols) -> None:
        """Reserve many zero blocks (``dbcsr_reserve_blocks``)."""
        for r, c in zip(rows, cols):
            self.reserve_block(int(r), int(c))

    def reserve_all_blocks(self) -> None:
        """Reserve the full dense block grid (``dbcsr_reserve_all_blocks``)."""
        for r in range(len(self.row_block_sizes)):
            lo = r if self.sym != SYM_NONE else 0
            for c in range(lo, len(self.col_block_sizes)):
                self.reserve_block(r, c)

    def reserve_diag_blocks(self) -> None:
        """Reserve the diagonal blocks (``dbcsr_reserve_diag_blocks``)."""
        n = min(len(self.row_block_sizes), len(self.col_block_sizes))
        for r in range(n):
            self.reserve_block(r, r)

    def finalize(self) -> BCSRMatrix:
        keys = list(self._blocks.keys())
        rows = [k[0] for k in keys]
        cols = [k[1] for k in keys]
        blocks = [self._blocks[k] for k in keys]
        return BCSRMatrix.from_blocks(
            rows, cols, blocks, self.row_block_sizes, self.col_block_sizes,
            name=self.name, sym=self.sym, dist=self.dist, dtype=self.dtype,
            tile=self.tile,
        )
