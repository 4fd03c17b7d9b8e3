"""Sparse matrix containers as JAX pytrees.

Re-design of the reference's single unified container
``struct __mv_sparse`` (reference ``mv_ops.h:17-23``), which overloads one
struct as either a CSR matrix (all fields set) or a dense vector
(``nnz == size``, index arrays NULL — ``mv_ops.c:23-37``).  Here vectors are
plain ``jax.Array``s and matrices are typed, immutable pytree dataclasses
with static (hashable) shape metadata so they trace cleanly under ``jit`` /
``shard_map`` / ``lax.while_loop``.

Formats:

* :class:`COOMatrix` — triplet form; simplest correct SpMV via segment-sum.
* :class:`CSRMatrix` — compressed rows (the reference's format); carries a
  cached ``row_indices`` array so the XLA SpMV path needs no per-call
  ``searchsorted`` over ``indptr``.
* :class:`BSRMatrix` — block CSR with dense ``(bs, bs)`` blocks (one small
  dense contraction per block).
* :class:`ELLMatrix` — row-padded ELLPACK; a fixed row width gives static
  shapes (gather + multiply + row-sum, no segment ids).
* :class:`DIAMatrix` — diagonal/stencil storage with *static* offsets; SpMV
  lowers to shifted elementwise FMAs that XLA fully fuses (the
  speed-of-light path for Poisson-type stencil operators).

All index arrays are ``int32``.  All containers
are registered with :func:`jax.tree_util.register_dataclass`: array fields
are pytree leaves, shape/offsets/blocksize are static aux data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "BSRMatrix",
    "ELLMatrix",
    "DIAMatrix",
    "csr_from_scipy",
    "coo_from_scipy",
    "bsr_from_csr",
    "ell_from_csr",
    "dia_from_csr",
    "pick_format",
    "auto_format",
]


def _as_i32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.int32)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class COOMatrix:
    """Coordinate-format sparse matrix (sorted by row, then column)."""

    values: jnp.ndarray        # (nnz,) float
    row_indices: jnp.ndarray   # (nnz,) int32
    col_indices: jnp.ndarray   # (nnz,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype) -> "COOMatrix":
        return COOMatrix(self.values.astype(dtype), self.row_indices,
                         self.col_indices, self.shape)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CSRMatrix:
    """Compressed-sparse-row matrix.

    ``row_indices`` is the expanded COO row id per nonzero; it is derived
    from ``indptr`` at construction and cached so the XLA segment-sum SpMV
    (see :mod:`cgx.ops.spmv`) costs no index recomputation inside the CG
    ``while_loop`` hot path.
    """

    values: jnp.ndarray        # (nnz,) float
    col_indices: jnp.ndarray   # (nnz,) int32
    indptr: jnp.ndarray        # (n_rows + 1,) int32
    row_indices: jnp.ndarray   # (nnz,) int32 — cached expansion of indptr
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype) -> "CSRMatrix":
        return CSRMatrix(self.values.astype(dtype), self.col_indices,
                         self.indptr, self.row_indices, self.shape)

    @classmethod
    def from_arrays(cls, values, col_indices, indptr, shape) -> "CSRMatrix":
        """Build from host or device arrays; expands row ids eagerly."""
        indptr_np = np.asarray(indptr)
        counts = np.diff(indptr_np).astype(np.int64)
        row_indices = np.repeat(
            np.arange(len(counts), dtype=np.int32), counts)
        return cls(
            values=jnp.asarray(values),
            col_indices=_as_i32(col_indices),
            indptr=_as_i32(indptr_np),
            row_indices=jnp.asarray(row_indices),
            shape=(int(shape[0]), int(shape[1])),
        )

    def diagonal(self) -> jnp.ndarray:
        """Main diagonal as a dense vector (missing entries are 0)."""
        n = self.shape[0]
        on_diag = self.row_indices == self.col_indices
        return jax.ops.segment_sum(
            jnp.where(on_diag, self.values, jnp.zeros_like(self.values)),
            self.row_indices, num_segments=n, indices_are_sorted=True)

    def to_coo(self) -> COOMatrix:
        return COOMatrix(self.values, self.row_indices, self.col_indices,
                         self.shape)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BSRMatrix:
    """Block-CSR matrix with dense ``(bs, bs)`` blocks.

    The SpMV is a batched
    ``(bs, bs) @ (bs,)`` (SpMM: ``(bs, bs) @ (bs, k)``) contraction plus a
    block-row segment-sum.
    """

    values: jnp.ndarray        # (nnzb, bs, bs) float
    col_indices: jnp.ndarray   # (nnzb,) int32 — block-column ids
    indptr: jnp.ndarray        # (n_block_rows + 1,) int32
    row_indices: jnp.ndarray   # (nnzb,) int32 — cached block-row ids
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    blocksize: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nnzb(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype) -> "BSRMatrix":
        return BSRMatrix(self.values.astype(dtype), self.col_indices,
                         self.indptr, self.row_indices, self.shape,
                         self.blocksize)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ELLMatrix:
    """Row-padded ELLPACK matrix.

    Every row stores exactly ``width`` (value, column) pairs; short rows are
    padded with ``value = 0`` and an in-range dummy column, so gathers stay
    in-bounds and padding contributes nothing.  With static ``(n, width)``
    shapes SpMV is gather → multiply → row-sum with no data-dependent
    shapes.
    """

    values: jnp.ndarray        # (n_rows, width) float
    col_indices: jnp.ndarray   # (n_rows, width) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype) -> "ELLMatrix":
        return ELLMatrix(self.values.astype(dtype), self.col_indices,
                         self.shape)

    def diagonal(self) -> jnp.ndarray:
        # Padding slots point at the row itself with value 0: no effect.
        rows = jnp.arange(self.shape[0], dtype=self.col_indices.dtype)
        return jnp.sum(jnp.where(self.col_indices == rows[:, None],
                                 self.values, 0), axis=1)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DIAMatrix:
    """Diagonal (stencil) storage with static offsets.

    Row-aligned convention: ``data[k, i] = A[i, i + offsets[k]]`` (zero where
    the target column falls outside the matrix).  With offsets static, SpMV
    unrolls into ``len(offsets)`` shifted multiply-adds that XLA fuses into a
    single pass over HBM — the speed-of-light format for Poisson stencils.

    ``grid``: optional static ``(nx, ny, nz)`` metadata for operators
    discretized on a 3-D grid (2-D: ``nz = 1``-style collapse is up to
    the caller).  Generators set it; :mod:`cgx.sparse.grid` uses it to
    decompose *arbitrary* banded offset sets into ``(dx, dy, dz)`` taps
    (without it only the exact 7-point pattern is auto-detected).
    """

    data: jnp.ndarray          # (n_diags, n_rows) float
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    grid: Optional[Tuple[int, int, int]] = dataclasses.field(
        default=None, metadata=dict(static=True))

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DIAMatrix":
        return DIAMatrix(self.data.astype(dtype), self.offsets, self.shape,
                         self.grid)

    def diagonal(self) -> jnp.ndarray:
        k = self.offsets.index(0)
        return self.data[k]


# ---------------------------------------------------------------------------
# Conversions (host-side, NumPy/SciPy — these run once at setup time, never
# inside the solver hot path).
# ---------------------------------------------------------------------------

def csr_from_scipy(a) -> CSRMatrix:
    """Build a :class:`CSRMatrix` from a ``scipy.sparse`` matrix."""
    a = a.tocsr()
    a.sort_indices()
    return CSRMatrix.from_arrays(a.data, a.indices, a.indptr, a.shape)


def coo_from_scipy(a) -> COOMatrix:
    a = a.tocoo()
    order = np.lexsort((a.col, a.row))
    return COOMatrix(
        values=jnp.asarray(a.data[order]),
        row_indices=_as_i32(a.row[order]),
        col_indices=_as_i32(a.col[order]),
        shape=(int(a.shape[0]), int(a.shape[1])),
    )


def _csr_host_arrays(a: CSRMatrix):
    return (np.asarray(a.values), np.asarray(a.col_indices),
            np.asarray(a.indptr))


def bsr_from_csr(a: CSRMatrix, blocksize: int) -> BSRMatrix:
    """Convert CSR → BSR (host-side; pads n to a blocksize multiple)."""
    import scipy.sparse as sp
    vals, cols, indptr = _csr_host_arrays(a)
    n, m = a.shape
    bs = blocksize
    n_pad = (-n) % bs
    m_pad = (-m) % bs
    s = sp.csr_matrix((vals, cols, indptr), shape=(n, m))
    if n_pad or m_pad:
        s = sp.csr_matrix(
            sp.vstack([
                sp.hstack([s, sp.csr_matrix((n, m_pad), dtype=s.dtype)]),
                sp.csr_matrix((n_pad, m + m_pad), dtype=s.dtype),
            ]))
    b = sp.bsr_matrix(s, blocksize=(bs, bs))
    b.sort_indices()
    counts = np.diff(b.indptr).astype(np.int64)
    row_indices = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    return BSRMatrix(
        values=jnp.asarray(b.data),
        col_indices=_as_i32(b.indices),
        indptr=_as_i32(b.indptr),
        row_indices=jnp.asarray(row_indices),
        shape=(n + n_pad, m + m_pad),
        blocksize=bs,
    )


def ell_from_csr(a: CSRMatrix, width: int | None = None,
                 width_multiple: int = 1) -> ELLMatrix:
    """Convert CSR → padded ELLPACK (host-side).

    ``width`` defaults to the max row length, rounded up to
    ``width_multiple``.
    Padding entries get ``value = 0`` and column = the row's own index
    (always in range for square matrices), so gathers stay in-bounds.
    """
    vals, cols, indptr = _csr_host_arrays(a)
    n = a.shape[0]
    counts = np.diff(indptr)
    natural = int(counts.max()) if n else 0
    w = natural if width is None else int(width)
    if w < natural:
        raise ValueError(f"ELL width {w} < max row length {natural}")
    w = max(1, -(-w // width_multiple) * width_multiple)
    ell_vals = np.zeros((n, w), dtype=vals.dtype)
    ell_cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
    # Scatter each row's entries into its padded slots.
    offs = np.concatenate([np.arange(c) for c in counts]) if len(vals) else \
        np.zeros(0, dtype=np.int64)
    rows = np.repeat(np.arange(n), counts)
    ell_vals[rows, offs] = vals
    ell_cols[rows, offs] = cols.astype(np.int32)
    return ELLMatrix(values=jnp.asarray(ell_vals),
                     col_indices=jnp.asarray(ell_cols),
                     shape=a.shape)


def dia_from_csr(a: CSRMatrix) -> DIAMatrix:
    """Convert CSR → row-aligned DIA (host-side).

    Suitable when the matrix has few populated diagonals (stencils); raises
    if more than 64 distinct offsets are present.
    """
    vals, cols, indptr = _csr_host_arrays(a)
    n, m = a.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    offs = cols.astype(np.int64) - rows
    uniq = np.unique(offs)
    if len(uniq) > 64:
        raise ValueError(
            f"matrix has {len(uniq)} populated diagonals; DIA is meant for "
            "stencil-like operators (<= 64)")
    data = np.zeros((len(uniq), n), dtype=vals.dtype)
    diag_idx = np.searchsorted(uniq, offs)
    data[diag_idx, rows] = vals
    return DIAMatrix(data=jnp.asarray(data),
                     offsets=tuple(int(o) for o in uniq),
                     shape=(n, m))


def pick_format(a, *, ell_waste_max: float = 1.5) -> str:
    """Storage decision for a general CSR operator, without building it:
    ``"ell"`` when padding every row to the 8-rounded maximum degree stores
    at most ``ell_waste_max`` slots per nonzero (static-shape gathers, no
    segment reduce), else ``"csr"``.

    ``a`` needs only ``.indptr`` / ``.shape`` / ``.nnz`` (cgx CSRMatrix or
    scipy).
    """
    deg = np.diff(np.asarray(a.indptr))
    w = -(-int(deg.max()) // 8) * 8
    waste = float(w * a.shape[0]) / max(int(np.asarray(a.nnz)), 1)
    return "ell" if waste <= ell_waste_max else "csr"


def auto_format(a, *, ell_waste_max: float = 1.5):
    """``(operator, fmt)``: ``a`` converted per :func:`pick_format`."""
    if pick_format(a, ell_waste_max=ell_waste_max) == "ell":
        return ell_from_csr(a, width_multiple=8), "ell"
    return a, "csr"
