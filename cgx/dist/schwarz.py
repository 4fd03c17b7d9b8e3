"""Shard-local IC(0) preconditioning: one-level additive Schwarz.

The reference has no preconditioning and no distribution (SURVEY.md §2.2);
the north star asks for both.  The distributed IC(0) combines
two design decisions:

* **Block (Schwarz) truncation.**  Each shard factors only its own
  diagonal block ``A_s = A[rows_s, rows_s]`` — the classic one-level
  additive-Schwarz / block-incomplete-Cholesky preconditioner
  ``M⁻¹ = diag(L₁L₁ᵀ, …, L_SL_Sᵀ)⁻¹``.  Principal submatrices of an SPD
  matrix are SPD, so each block factors; the apply needs ZERO cross-chip
  traffic (the psum'd ``rᵀz`` dots in the CG loop are unchanged).
* **Gather-free sweep apply.**  The triangular solves use the Neumann
  (Jacobi–Richardson) sweep form of :class:`cgx.solve.ic0.IC0SweepPrecond`
  with the strict triangles held as banded DIA — every sweep is a few
  statically-shifted FMAs, no gathers, no level schedule.

Setup runs host-side once per partition: each local block is rebuilt from
the :class:`~cgx.dist.partition.Partition`'s own stacked arrays (no access
to the global matrix needed), factored with :func:`cgx.solve.ic0.ic0_factor`,
and the strict triangles are re-laid out on a shard-uniform offset union so
the data stacks onto the ``"rows"`` mesh axis like every other operand.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cgx.dist.partition import Partition
from cgx.sparse.types import DIAMatrix

__all__ = ["IC0SweepBlocks", "ic0_sweep_blocks", "sweep_apply"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class IC0SweepBlocks:
    """Stacked per-shard IC(0) factors in banded (DIA) form.

    Array leaves carry a leading shard axis (like :class:`Partition`) and
    shard onto the row mesh with a ``P("rows")`` pytree-prefix spec.  The
    offset tuples are the union over shards, so every shard traces the
    same static shapes.
    """

    lower_data: jnp.ndarray    # (S, n_low, rl) — strict lower of L, DIA
    upper_data: jnp.ndarray    # (S, n_up, rl)  — its transpose, DIA
    inv_diag: jnp.ndarray      # (S, rl) — 1 / diag(L); 1 on padding rows
    lower_offsets: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))
    upper_offsets: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))


def _local_block_csr(part: Partition, s: int):
    """Shard ``s``'s diagonal block as host COO (rows, cols, vals), rl×rl.

    Entries whose column leaves the block are dropped — that IS the
    Schwarz truncation.  Padding rows/empty rows come back empty and get
    a unit diagonal in :func:`ic0_sweep_blocks`.
    """
    rl = part.rows_local
    if part.kind == "dia":
        data = np.asarray(part.dia_data[s])          # (rl, nd)
        rows, cols, vals = [], [], []
        for k, off in enumerate(part.dia_offsets):
            i = np.arange(rl, dtype=np.int64)
            j = i + off
            ok = (j >= 0) & (j < rl) & (data[:, k] != 0)
            rows.append(i[ok]); cols.append(j[ok]); vals.append(data[ok, k])
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))
    vals = np.asarray(part.ell_values[s])            # (rl, w)
    cols = np.asarray(part.ell_cols[s]).astype(np.int64)
    if part.mode == "halo":
        loc = cols - part.halo_lo                    # extended-local → local
    else:
        loc = cols - s * rl                          # global → local
    i = np.broadcast_to(np.arange(rl, dtype=np.int64)[:, None], cols.shape)
    ok = (loc >= 0) & (loc < rl) & (vals != 0)
    return i[ok], loc[ok], vals[ok]


def _dia_rows(rows, cols, vals, offsets, rl, dtype):
    """COO → row-aligned DIA data ``(len(offsets), rl)`` on given offsets."""
    data = np.zeros((max(len(offsets), 1), rl), dtype=dtype)
    if len(rows):
        off = cols - rows
        k = np.searchsorted(np.asarray(offsets, dtype=np.int64), off)
        data[k, rows] = vals
    return data


def ic0_sweep_blocks(part: Partition) -> IC0SweepBlocks:
    """Factor every shard's diagonal block with IC(0) (host-side setup).

    Raises ``numpy.linalg.LinAlgError`` on IC(0) breakdown (possible for
    general SPD blocks; guaranteed-safe for M-matrices like the Poisson
    operators).  Each block's factor must be banded (≤ 64 populated
    diagonals) — true whenever the operator itself is stencil/banded.
    """
    import scipy.sparse as sp

    from cgx.solve.ic0 import ic0_factor_shifted

    rl = part.rows_local
    dtype = np.dtype(
        (part.dia_data if part.kind == "dia" else part.ell_values).dtype)

    factors = []                 # per shard: (d, strict-lower csr)
    low_offsets: set = set()
    for s in range(part.n_shards):
        rows, cols, vals = _local_block_csr(part, s)
        a_s = sp.csr_matrix(
            (np.asarray(vals, np.float64), (rows, cols)), shape=(rl, rl))
        d = a_s.diagonal()
        fix = np.where(d == 0)[0]            # padding / empty rows → identity
        if len(fix):
            a_s = a_s + sp.csr_matrix(
                (np.ones(len(fix)), (fix, fix)), shape=(rl, rl))
        a_s.sort_indices()
        lv, lc, lp, _shift = ic0_factor_shifted(SimpleNamespace(
            values=a_s.data, col_indices=a_s.indices, indptr=a_s.indptr,
            shape=(rl, rl)))
        ell = sp.csr_matrix((lv, lc, lp), shape=(rl, rl))
        ls = sp.tril(ell, k=-1).tocoo()
        if ls.nnz:
            low_offsets.update(
                np.unique(ls.col.astype(np.int64) - ls.row).tolist())
        factors.append((ell.diagonal(), ls))

    # Shard-uniform static offset sets (empty triangles keep a zero band so
    # the DIA kernels always see >= 1 offset).
    lo = tuple(sorted(low_offsets)) if low_offsets else (-1,)
    if len(lo) > 64:
        raise ValueError(
            f"local IC(0) factor has {len(lo)} populated diagonals; the "
            "sweep form needs banded blocks (<= 64)")
    up = tuple(-o for o in reversed(lo))

    lower = np.zeros((part.n_shards, len(lo), rl), dtype=dtype)
    upper = np.zeros((part.n_shards, len(up), rl), dtype=dtype)
    inv_d = np.ones((part.n_shards, rl), dtype=dtype)
    for s, (d, ls) in enumerate(factors):
        inv_d[s] = 1.0 / d
        r, c, v = ls.row.astype(np.int64), ls.col.astype(np.int64), ls.data
        lower[s] = _dia_rows(r, c, v, lo, rl, dtype)
        upper[s] = _dia_rows(c, r, v, up, rl, dtype)
    return IC0SweepBlocks(
        lower_data=jnp.asarray(lower), upper_data=jnp.asarray(upper),
        inv_diag=jnp.asarray(inv_d), lower_offsets=lo, upper_offsets=up)


def sweep_apply(blocks: IC0SweepBlocks, nsweeps: int, r: jnp.ndarray,
                shard_index: int = 0) -> jnp.ndarray:
    """Apply one shard's block ``(L Lᵀ)⁻¹`` to ``r`` by Neumann sweeps.

    ``blocks`` leaves may carry a leading shard axis of size 1 (inside
    ``shard_map``) or S (host-side reference use with ``shard_index``).
    Mirrors :meth:`cgx.solve.ic0.IC0SweepPrecond.apply` — truncated sweeps
    stay SPD, ``nsweeps >= n_levels - 1`` is exact per block.
    """
    ld = blocks.lower_data[shard_index]
    ud = blocks.upper_data[shard_index]
    inv_d = blocks.inv_diag[shard_index].astype(r.dtype)
    rl = inv_d.shape[0]
    lower = DIAMatrix(ld.astype(r.dtype), blocks.lower_offsets, (rl, rl))
    upper = DIAMatrix(ud.astype(r.dtype), blocks.upper_offsets, (rl, rl))

    from cgx.ops.spmv import spmv

    y = inv_d * r
    for _ in range(nsweeps):
        y = inv_d * (r - spmv(lower, y))
    z = inv_d * y
    for _ in range(nsweeps):
        z = inv_d * (y - spmv(upper, z))
    return z
