"""IC(0) — incomplete Cholesky (zero fill) preconditioner.

Part of the north-star capability set ("Jacobi/IC(0) preconditioner path",
BASELINE.json; the reference itself has no preconditioning — plain CG only,
``cg.c:88-141``).  Sparse triangular solves are the hard case for a
data-parallel device (SURVEY.md §7 "hard parts": sequential row
dependencies fight the SIMD model), so this module splits the work:

* **Setup (host, once):** numeric IC(0) factorization over CSR, then *level
  scheduling* — rows are grouped into dependency levels; all rows in a level
  solve simultaneously.  The level structure is padded to static ``(levels,
  width, row_nnz)`` shapes so the device pass is one ``fori_loop`` with no
  data-dependent shapes.
* **Apply (device, per CG iteration):** ``z = L⁻ᵀ L⁻¹ r`` as two level-sweep
  loops of gather → FMA → scatter, all static shapes, fused by XLA.

For operators whose level count approaches n (long dependency chains) the
sweep is latency-bound; prefer :class:`cgx.solve.precond.
BlockJacobiPrecond` or :class:`PolynomialPrecond` there — the solver accepts
any of them interchangeably.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ic0_factor", "ic0_factor_shifted", "IC0Precond",
           "IC0SweepPrecond"]


def _tril_pattern(a):
    """Lower-triangular (diag-inclusive) CSR pattern of ``a``, vectorized.

    Entries are (row, col)-sorted here — the factorization and level
    scheduler rely on ascending columns with the diagonal last in each
    row, and ``CSRMatrix.from_arrays`` does not guarantee sorted input.
    """
    vals = np.asarray(a.values, dtype=np.float64)
    cols = np.asarray(a.col_indices).astype(np.int64)
    indptr = np.asarray(a.indptr).astype(np.int64)
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    keep = cols <= rows
    l_vals = vals[keep]
    l_cols = cols[keep].astype(np.int32)
    counts = np.bincount(rows[keep], minlength=n)
    l_indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(counts, out=l_indptr[1:])
    return l_vals, l_cols, l_indptr


def ic0_factor(a, use_native: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numeric IC(0) of a CSR SPD matrix (host side).

    Returns host CSR arrays ``(l_values, l_cols, l_indptr)`` of the lower
    factor L (diagonal included, same pattern as ``tril(A)``) with
    ``A ≈ L Lᵀ``.  Raises if a pivot goes non-positive (matrix not H-matrix
    enough for IC(0) — standard failure mode; use a shifted retry upstream).

    Dispatches to the C++ engine (``cgx/native/src/ic0.cpp``) when built;
    the Python loop below is the reference semantics and the fallback.
    """
    l_vals, l_cols, l_indptr = _tril_pattern(a)
    n = a.shape[0]

    if use_native:
        from cgx.native import ic0_factor_native
        native = ic0_factor_native(l_indptr, l_cols, l_vals)
        if native is not None:
            return native[0], l_cols, l_indptr

    # Pure-Python up-looking factorization (row entries sorted, diag last).
    col_pos = [dict() for _ in range(n)]   # col -> position within row
    starts = l_indptr[:-1]
    for i in range(n):
        for t in range(starts[i], l_indptr[i + 1]):
            col_pos[i][int(l_cols[t])] = t - starts[i]

    for i in range(n):
        s, e = starts[i], l_indptr[i + 1]
        ci = l_cols[s:e]
        vi = l_vals[s:e]
        for t in range(len(ci)):
            j = int(ci[t])
            acc = vi[t]
            pj = col_pos[j]
            js = starts[j]
            vj = l_vals[js:l_indptr[j + 1]]
            for tt in range(t):
                p = pj.get(int(ci[tt]))
                if p is not None:
                    acc -= vi[tt] * vj[p]
            if j < i:
                vi[t] = acc / vj[-1]       # L[j,j] is row j's last entry
            else:                          # j == i → pivot
                if acc <= 0.0:
                    raise np.linalg.LinAlgError(
                        f"IC(0) breakdown at row {i}: pivot {acc:.3e} <= 0")
                vi[t] = np.sqrt(acc)

    return l_vals, l_cols, l_indptr


def ic0_factor_shifted(a, use_native: bool = True,
                       shifts=(0.0, 1e-3, 1e-2, 1e-1, 1.0)):
    """IC(0) with Manteuffel-style diagonal-shifted retries.

    IC(0) can break down (non-positive pivot) on SPD matrices that are
    not H-matrices.  The standard remedy: factor ``A + α·diag(A)``
    instead — still SPD, still the same sparsity pattern, and for the
    smallest α that succeeds the factor remains an effective
    preconditioner for ``A``.  Tries ``shifts`` in order (``0.0`` first,
    so well-behaved matrices keep the exact reference factor) and
    returns ``(l_values, l_cols, l_indptr, alpha)``.

    Raises ``numpy.linalg.LinAlgError`` only if every shift fails.
    """
    from types import SimpleNamespace

    vals = np.asarray(a.values, dtype=np.float64)
    cols = np.asarray(a.col_indices).astype(np.int64)
    indptr = np.asarray(a.indptr).astype(np.int64)
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    on_diag = cols == rows
    last_err = None
    for alpha in shifts:
        v = vals if alpha == 0.0 else np.where(
            on_diag, vals * (1.0 + alpha), vals)
        try:
            lv, lc, lp = ic0_factor(
                SimpleNamespace(values=v, col_indices=cols, indptr=indptr,
                                shape=a.shape),
                use_native=use_native)
            return lv, lc, lp, float(alpha)
        except np.linalg.LinAlgError as exc:
            last_err = exc
    raise np.linalg.LinAlgError(
        f"IC(0) breakdown persists through diagonal shifts {shifts}: "
        f"{last_err}")


def _level_schedule(cols: np.ndarray, indptr: np.ndarray, n: int,
                    use_native: bool = True) -> np.ndarray:
    """Dependency level per row of a lower-triangular CSR factor.

    Dispatches to the C++ sweep (``cgx_level_schedule``) when built — the
    Python loop below is O(n) interpreter time and dominates setup at
    ~1 M rows otherwise.
    """
    if use_native and n:
        from cgx.native import lib, _i32
        l = lib()
        if l is not None:
            import ctypes
            ip = _i32(indptr)
            cc = _i32(cols)
            levels = np.zeros(n, np.int32)
            i32p = ctypes.POINTER(ctypes.c_int32)
            l.cgx_level_schedule(n, ip.ctypes.data_as(i32p),
                                 cc.ctypes.data_as(i32p),
                                 levels.ctypes.data_as(i32p))
            return levels.astype(np.int64)
    level = np.zeros(n, dtype=np.int64)
    for i in range(n):
        deps = cols[indptr[i]:indptr[i + 1] - 1]   # off-diagonal cols (< i)
        if len(deps):
            level[i] = level[deps].max() + 1
    return level


def _pack_levels(vals, cols, indptr, diag, level, n):
    """Pad a triangular factor into static (levels, width, row_nnz) arrays.

    Row slot padding points at the dummy index ``n`` (an extra scratch slot
    in the solve vector); entry padding has value 0, so neither contributes.
    Fully vectorized (the round-1 per-row Python loop dominated setup at
    ~1 M rows — ROADMAP #11): three scatter assignments.
    """
    if not n:
        z = np.zeros((0, 0), np.int32)
        return z, z.reshape(0, 0, 1), np.zeros((0, 0, 1), vals.dtype), \
            np.zeros((0, 0), vals.dtype)
    level = np.asarray(level, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n_levels = int(level.max()) + 1
    counts = np.bincount(level, minlength=n_levels)
    width = int(counts.max())
    row_nnz_arr = np.diff(indptr) - 1
    rn = max(int(row_nnz_arr.max()), 1)

    # Slot of each row within its level (stable: ascending row id).
    order = np.argsort(level, kind="stable")
    starts_lvl = np.zeros(n_levels, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts_lvl[1:])
    slot = np.empty(n, dtype=np.int64)
    slot[order] = np.arange(n, dtype=np.int64) - starts_lvl[level[order]]

    lvl_rows = np.full((n_levels, width), n, dtype=np.int32)
    lvl_rows[level, slot] = np.arange(n, dtype=np.int32)
    lvl_inv_diag = np.zeros((n_levels, width), dtype=vals.dtype)
    lvl_inv_diag[level, slot] = 1.0 / diag

    # Entry scatter: every entry except each row's last (the diagonal).
    t = np.arange(indptr[-1], dtype=np.int64)
    row_of_t = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = t < indptr[row_of_t + 1] - 1
    tk, rk = t[keep], row_of_t[keep]
    pos = tk - indptr[rk]
    lvl_cols = np.full((n_levels, width, rn), n, dtype=np.int32)
    lvl_vals = np.zeros((n_levels, width, rn), dtype=vals.dtype)
    lvl_cols[level[rk], slot[rk], pos] = cols[tk]
    lvl_vals[level[rk], slot[rk], pos] = vals[tk]
    return lvl_rows, lvl_cols, lvl_vals, lvl_inv_diag


def _level_solve(rows, cols_, vals_, inv_diag, r: jnp.ndarray) -> jnp.ndarray:
    """Solve ``T y = r`` for a level-packed triangular factor (on device)."""
    n = r.shape[0]
    y0 = jnp.zeros((n + 1,), r.dtype)          # slot n = padding scratch
    r_ext = jnp.concatenate([r, jnp.zeros((1,), r.dtype)])

    def body(l, y):
        rw = jax.lax.dynamic_index_in_dim(rows, l, keepdims=False)
        cl = jax.lax.dynamic_index_in_dim(cols_, l, keepdims=False)
        vl = jax.lax.dynamic_index_in_dim(vals_, l, keepdims=False)
        dl = jax.lax.dynamic_index_in_dim(inv_diag, l, keepdims=False)
        s = jnp.sum(vl * y[cl], axis=1)
        return y.at[rw].set((r_ext[rw] - s) * dl)

    y = jax.lax.fori_loop(0, rows.shape[0], body, y0)
    return y[:n]


def greedy_coloring(cols: np.ndarray, indptr: np.ndarray,
                    n: int) -> np.ndarray:
    """Greedy graph coloring of the matrix adjacency (symmetric pattern
    assumed); returns a color id per row.

    Used by the ``"multicolor"`` ordering: after permuting same-colored
    rows together, no two adjacent rows share a color, so the IC(0)
    factor of the permuted matrix has at most ``n_colors`` dependency
    levels — each triangular sweep becomes a handful of wide, fully
    parallel steps instead of O(grid-diameter) narrow ones.  (The factor
    itself changes — multicolor IC(0) is a *different, slightly weaker*
    preconditioner than natural-order IC(0); the trade is standard.)
    """
    color = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        neigh = color[cols[indptr[i]:indptr[i + 1]]]
        used = set(int(c) for c in neigh if c >= 0)
        c = 0
        while c in used:
            c += 1
        color[i] = c
    return color


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class IC0Precond:
    """``M⁻¹ r = L⁻ᵀ (L⁻¹ r)`` with level-scheduled on-device sweeps."""

    # Forward (L) level packing.
    f_rows: jnp.ndarray
    f_cols: jnp.ndarray
    f_vals: jnp.ndarray
    f_inv_diag: jnp.ndarray
    # Backward (Lᵀ) level packing.
    b_rows: jnp.ndarray
    b_cols: jnp.ndarray
    b_vals: jnp.ndarray
    b_inv_diag: jnp.ndarray
    n: int = dataclasses.field(metadata=dict(static=True))
    n_levels: int = dataclasses.field(metadata=dict(static=True))
    # Row permutation (multicolor ordering); None = natural order.
    perm: object = dataclasses.field(default=None,
                                     metadata=dict(static=False))

    @classmethod
    def from_matrix(cls, a, dtype=None, ordering: str = "natural",
                    gather_budget: int | None = None) -> "IC0Precond":
        """Factor + level-schedule a :class:`~cgx.sparse.types.CSRMatrix`.

        ``ordering``: ``"natural"`` (reference IC(0) trajectory; level
        count grows with the grid diameter) or ``"multicolor"`` (greedy
        coloring permutation first — level count ≈ chromatic number, e.g.
        2 for red-black Poisson grids; a slightly weaker preconditioner
        that trades a few extra CG iterations for far fewer sequential
        sweep steps — the better regime when the sweep is
        latency-bound, SURVEY.md §7 'hard parts').

        ``gather_budget``: when set, refuse (``ValueError``) a factor
        whose level-packed apply would issue more than this many padded
        gathers per preconditioner application (both sweeps) — a cap for
        callers that bound the apply's cost.  ``None`` (default): no
        cap.
        """
        import scipy.sparse as sp

        n = a.shape[0]
        perm = None
        if ordering == "multicolor":
            cols_a = np.asarray(a.col_indices).astype(np.int64)
            indptr_a = np.asarray(a.indptr).astype(np.int64)
            color = greedy_coloring(cols_a, indptr_a, n)
            perm = np.argsort(color, kind="stable").astype(np.int32)
            vals_a = np.asarray(a.values)
            m = sp.csr_matrix((vals_a, cols_a, indptr_a), shape=a.shape)
            mp = m[perm][:, perm].tocsr()
            mp.sort_indices()
            from cgx.sparse.types import csr_from_scipy
            a = csr_from_scipy(mp)
        elif ordering != "natural":
            raise ValueError(f"unknown ordering {ordering!r}")

        lv, lc, lp, _shift = ic0_factor_shifted(a)
        dtype = dtype or np.asarray(a.values).dtype
        diag = lv[lp[1:] - 1]                   # row-sorted: diag is last

        lev_f = _level_schedule(lc, lp, n)
        if gather_budget is not None and n:
            nl = int(lev_f.max()) + 1
            width = int(np.bincount(lev_f, minlength=nl).max())
            rn = max(int((np.diff(lp) - 1).max()), 1)
            padded = 2 * nl * width * rn     # both triangular sweeps
            if padded > gather_budget:
                raise ValueError(
                    f"exact IC(0) apply would issue {padded:.1e} padded "
                    f"gathers per application (levels={nl}, width={width}, "
                    f"row_nnz={rn}) > gather_budget={gather_budget:.1e}. "
                    "Use IC0SweepPrecond (banded factors), "
                    "BlockJacobiPrecond, or a larger budget.")
        packed_f = _pack_levels(lv.astype(dtype), lc, lp, diag.astype(dtype),
                                lev_f, n)

        # Lᵀ is upper triangular; reverse the row order so it becomes lower
        # triangular in the permuted numbering and reuse the same machinery.
        lt = sp.csr_matrix((lv, lc, lp), shape=(n, n)).T.tocsr()
        rev = np.arange(n - 1, -1, -1)
        ltp = lt[rev][:, rev].tocsr()
        ltp.sort_indices()
        diag_b = ltp.data[ltp.indptr[1:] - 1]
        lev_b = _level_schedule(ltp.indices, ltp.indptr, n)
        br, bc, bv, bd = _pack_levels(
            ltp.data.astype(dtype), ltp.indices.astype(np.int32), ltp.indptr,
            diag_b.astype(dtype), lev_b, n)
        # Map permuted row/col ids back to original numbering (pad slot n
        # stays n).
        unperm = np.where(br == n, n, (n - 1) - br).astype(np.int32)
        uncol = np.where(bc == n, n, (n - 1) - bc).astype(np.int32)

        perm_pair = None
        if perm is not None:
            inv = np.empty(n, np.int32)
            inv[perm] = np.arange(n, dtype=np.int32)
            perm_pair = (jnp.asarray(perm), jnp.asarray(inv))
        return cls(
            f_rows=jnp.asarray(packed_f[0]), f_cols=jnp.asarray(packed_f[1]),
            f_vals=jnp.asarray(packed_f[2]),
            f_inv_diag=jnp.asarray(packed_f[3]),
            b_rows=jnp.asarray(unperm), b_cols=jnp.asarray(uncol),
            b_vals=jnp.asarray(bv), b_inv_diag=jnp.asarray(bd),
            n=n, n_levels=int(packed_f[0].shape[0]), perm=perm_pair)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        if self.perm is not None:
            r = r[self.perm[0]]                # into permuted numbering
        y = _level_solve(self.f_rows, self.f_cols, self.f_vals,
                         self.f_inv_diag, r)
        z = _level_solve(self.b_rows, self.b_cols, self.b_vals,
                         self.b_inv_diag, y)
        if self.perm is not None:
            z = z[self.perm[1]]                # back to original numbering
        return z


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class IC0SweepPrecond:
    """IC(0) with a gather-free, sweep-based apply.

    The level-scheduled apply of :class:`IC0Precond` is gather/scatter
    bound and sequential over levels.  This variant keeps the SAME IC(0) factor but applies the triangular
    solves as truncated Neumann (Jacobi–Richardson) sweeps with the
    strict triangles held as banded **DIA** operators, so every sweep is
    a shifted-add SpMV — no gathers anywhere:

        L⁻¹ r  ≈ y_k,   y_{j+1} = D̂⁻¹ (r − Lₛ y_j),   y_0 = D̂⁻¹ r
        L⁻ᵀ y  ≈ z_k,   likewise with Us = Lₛᵀ

    Because ``D̂⁻¹Lₛ`` is strictly triangular (nilpotent, index =
    dependency-level count), the series TERMINATES: ``nsweeps ≥
    n_levels − 1`` reproduces the exact IC(0) apply.  For any smaller
    ``nsweeps`` the operator equals ``Aᵀ·A`` for an invertible ``A``
    (the truncated series of ``L⁻¹``), hence symmetric positive
    definite — always CG-safe, just a weaker preconditioner.

    Requires the factor to be banded (≤ 64 populated diagonals) — true
    for grid/stencil operators, where IC(0)'s pattern equals the lower
    triangle of A's.
    """

    lower: object           # DIAMatrix — strict lower triangle of L
    upper: object           # DIAMatrix — its transpose (strict upper)
    inv_diag: jnp.ndarray   # 1 / diag(L)
    nsweeps: int = dataclasses.field(metadata=dict(static=True))
    n_levels: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_matrix(cls, a, nsweeps: int = 3, dtype=None
                    ) -> "IC0SweepPrecond":
        """Factor a banded CSR SPD matrix; raises ``ValueError`` when the
        factor is not banded (use :class:`IC0Precond` there)."""
        import scipy.sparse as sp

        from cgx.sparse.types import csr_from_scipy, dia_from_csr

        lv, lc, lp, _shift = ic0_factor_shifted(a)
        n = a.shape[0]
        dtype = dtype or np.asarray(a.values).dtype
        ell = sp.csr_matrix((lv, lc, lp), shape=(n, n))
        d = ell.diagonal()
        ls = sp.tril(ell, k=-1).tocsr()
        ls.sort_indices()
        try:
            lower = dia_from_csr(csr_from_scipy(
                sp.csr_matrix(ls, dtype=dtype)))
            upper = dia_from_csr(csr_from_scipy(
                sp.csr_matrix(ls.T.tocsr(), dtype=dtype)))
        except ValueError as exc:
            raise ValueError(
                "IC0SweepPrecond needs a banded factor (<= 64 populated "
                "diagonals); use IC0Precond for general sparsity"
            ) from exc
        lev = _level_schedule(lc, lp, n)
        return cls(lower=lower, upper=upper,
                   inv_diag=jnp.asarray(1.0 / d, dtype),
                   nsweeps=int(nsweeps), n_levels=int(lev.max()) + 1)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        from cgx.ops.spmv import spmv

        inv_d = self.inv_diag.astype(r.dtype)
        y = inv_d * r
        for _ in range(self.nsweeps):
            y = inv_d * (r - spmv(self.lower, y))
        z = inv_d * y
        for _ in range(self.nsweeps):
            z = inv_d * (y - spmv(self.upper, z))
        return z
