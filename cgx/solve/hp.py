"""High-accuracy CG: df64 solves for the reference's fp64 envelope.

The reference runs ``double`` end-to-end (``mv_ops.h:19-21``, the CG loop
``cg.c:88-141``); on κ ≈ 10¹⁰ SPD systems (bcsstk-class shell stiffness)
fp32 CG demonstrably cannot reach a TRUE relative residual of 1e-6 — the
fp32 recurrence stalls near ``eps₃₂·κ``.  This module closes the accuracy
gap with double-word fp32 arithmetic
(:mod:`cgx.ops.df64`, ~2⁻⁴⁸ effective precision) in two forms:

* :func:`df64_cg_solve` — the WHOLE Krylov iteration in df64 over a
  fixed-width ELL operator.  ELL's static ``(n, width)`` shape is what
  makes this possible: the row reduction is a pairwise tree fold of
  elementwise double-word adds (no ``segment_sum``, which cannot thread
  error terms through its internal adds).  This is the bit-faithful
  analogue of the reference's fp64 solve.
* :func:`ir_df64_solve` — production path: fp32 (P)CG inner solves (any
  cgx preconditioner — IC(0), Jacobi, block-Jacobi) wrapped in a df64
  outer iterative-refinement loop.  The iterate and the true residual
  live in df64; each outer cycle contracts the TRUE residual by the inner
  solve's achieved reduction, so accuracy is set by df64 while speed is
  set by fp32.  Per Higham/Carson mixed-precision IR analysis the
  contraction per cycle is the inner relative residual — independent of κ
  — as long as the residual is computed accurately, which is exactly what
  the df64 SpMV provides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cgx.ops.df64 import (DF64, df, df_add, df_axpy, df_div, df_dot,
                          df_from_f64, df_mul, df_neg, df_sub, df_to_f64,
                          two_prod, quick_two_sum, _fold_axis)

__all__ = ["DF64ELL", "df64_ell_from_csr", "df64_ell_spmv",
           "df64_ell_spmm", "HPCGResult", "df64_cg_solve",
           "ir_df64_solve", "make_ir_df64_solver",
           "make_ir_df64_solver_multi"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DF64ELL:
    """Row-padded ELL matrix with df64 values (``vhi + vlo`` exact split
    of the host fp64 data — the operator itself is NOT fp32-rounded, so
    solves target the true system, not a perturbed one)."""

    vhi: jnp.ndarray          # (n, width) fp32
    vlo: jnp.ndarray          # (n, width) fp32
    col_indices: jnp.ndarray  # (n, width) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def width(self) -> int:
        return self.vhi.shape[1]

    def diagonal_df(self) -> DF64:
        """df64 matrix diagonal (for Jacobi scaling in the df64 loop)."""
        n = self.shape[0]
        rows = jnp.arange(n, dtype=jnp.int32)[:, None]
        mask = self.col_indices == rows
        return DF64(jnp.sum(jnp.where(mask, self.vhi, 0.0), axis=1),
                    jnp.sum(jnp.where(mask, self.vlo, 0.0), axis=1))


def df64_ell_from_csr(a, width_multiple: int = 8) -> DF64ELL:
    """Build a :class:`DF64ELL` from host fp64 CSR data
    (:class:`cgx.sparse.types.CSRMatrix` or ``scipy.sparse``)."""
    import scipy.sparse as sp

    if hasattr(a, "indptr") and hasattr(a, "col_indices"):
        a = sp.csr_matrix((np.asarray(a.values, np.float64),
                           np.asarray(a.col_indices),
                           np.asarray(a.indptr)), shape=a.shape)
    a = sp.csr_matrix(a).astype(np.float64)
    n = a.shape[0]
    counts = np.diff(a.indptr)
    w = max(1, -(-int(counts.max()) // width_multiple) * width_multiple)
    vals64 = np.zeros((n, w), np.float64)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
    offs = (np.concatenate([np.arange(c) for c in counts])
            if a.nnz else np.zeros(0, np.int64))
    rows = np.repeat(np.arange(n), counts)
    vals64[rows, offs] = a.data
    cols[rows, offs] = a.indices.astype(np.int32)
    vhi = vals64.astype(np.float32)
    vlo = (vals64 - vhi.astype(np.float64)).astype(np.float32)
    return DF64ELL(vhi=jnp.asarray(vhi), vlo=jnp.asarray(vlo),
                   col_indices=jnp.asarray(cols), shape=a.shape)


def df64_ell_spmv(a: DF64ELL, x: DF64) -> DF64:
    """``y = A·x`` entirely in df64: error-free per-element products,
    pairwise double-word tree reduction along the (static) ELL width."""
    xh = x.hi[a.col_indices]           # (n, w) gathers
    xl = x.lo[a.col_indices]
    p, e = two_prod(a.vhi, xh)
    e = e + (a.vhi * xl + a.vlo * xh + a.vlo * xl)
    p, e = quick_two_sum(p, e)
    return _fold_axis(DF64(p, e), axis=1)


def df64_ell_spmm(a: DF64ELL, x: DF64) -> DF64:
    """Batched ``Y = A·X`` in df64 for an ``(n, k)`` df64 block (the
    multi-RHS true-residual operator — one gather pass serves every
    column)."""
    xh = x.hi[a.col_indices]           # (n, w, k)
    xl = x.lo[a.col_indices]
    vh = a.vhi[:, :, None]
    vl = a.vlo[:, :, None]
    p, e = two_prod(vh, xh)
    e = e + (vh * xl + vl * xh + vl * xl)
    p, e = quick_two_sum(p, e)
    return _fold_axis(DF64(p, e), axis=1)


from functools import partial


@partial(jax.jit, static_argnames=("tol", "maxiter"))
def _ir_inner(a_, m_, r_unit, *, tol, maxiter):
    """One fp32 inner (P)CG solve — module-level jit, operator and
    preconditioner as traced pytree arguments (not baked-in constants)."""
    from cgx.solve.cg import cg_solve as _cg

    res = _cg(a_, r_unit, tol=tol, maxiter=maxiter, preconditioner=m_,
              restarts=0)
    return res.x, res.iterations


@jax.jit
def _ir_true_residual(a_hp, b_df, x):
    """TRUE df64 residual b − A·x (operator/RHS as traced arguments)."""
    return df_sub(b_df, df64_ell_spmv(a_hp, x))


@jax.jit
def _ir_true_residual_multi(a_hp, b_df, x):
    """Batched TRUE df64 residual B − A·X for an (n, k) df64 block."""
    return df_sub(b_df, df64_ell_spmm(a_hp, x))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HPCGResult:
    """df64 solver output.  ``x`` is the double-word iterate; fetch the
    fp64 view on host with :func:`cgx.ops.df64.df_to_f64`."""

    x: DF64
    iterations: jnp.ndarray
    residual_norm_sq: jnp.ndarray   # fp32 hi word of the df64 ‖r‖²
    converged: jnp.ndarray

    @property
    def residual_norm(self):
        return jnp.sqrt(self.residual_norm_sq)


def df64_cg_solve(a: DF64ELL, b, x0: Optional[DF64] = None, *,
                  tol: float = 1e-6, atol: float = 0.0,
                  maxiter: int = 10_000,
                  jacobi: bool = False) -> HPCGResult:
    """(P)CG with every vector, product, and reduction in df64.

    ``b``: host fp64 array or :class:`DF64`.  ``jacobi=True`` applies the
    df64 diagonal scaling ``z = D⁻¹r`` inside the loop (κ-reduction the
    same way the fp32 path gets it, without leaving extended precision).
    Semantics mirror :func:`cgx.solve.cg.cg_solve`: exits on
    ``‖r‖² ≤ max(tol²·‖b‖², atol²)`` (df64 recurrence norms) or maxiter.
    """
    b_df = b if isinstance(b, DF64) else df_from_f64(b)
    n = b_df.hi.shape[0]

    inv_diag = None
    if jacobi:
        d = a.diagonal_df()
        one = df(jnp.ones_like(d.hi))
        inv_diag = df_div(one, d)  # elementwise: df_div is shape-generic

    def apply_m(r):
        return df_mul(inv_diag, r) if jacobi else r

    if x0 is None:
        x = DF64(jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))
        r = b_df
    else:
        x = x0
        r = df_sub(b_df, df64_ell_spmv(a, x))
    z = apply_m(r)
    p = z
    rz = df_dot(r, z)
    rr = df_dot(r, r).hi

    bb = df_dot(b_df, b_df).hi
    tol_sq = jnp.maximum(jnp.float32(tol) ** 2 * bb, jnp.float32(atol) ** 2)

    def cond(c):
        x, r, z, p, rz, rr, k = c
        return jnp.logical_and(k < maxiter, rr > tol_sq)

    def body(c):
        x, r, z, p, rz, rr, k = c
        q = df64_ell_spmv(a, p)
        alpha = df_div(rz, df_dot(p, q))
        x = df_axpy(alpha, p, x)
        r = df_axpy(df_neg(alpha), q, r)
        z = apply_m(r)
        rz_new = df_dot(r, z)
        beta = df_div(rz_new, rz)
        p = df_axpy(beta, p, z)
        return x, r, z, p, rz_new, df_dot(r, r).hi, k + 1

    x, r, z, p, rz, rr, k = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, rr, jnp.zeros((), jnp.int32)))
    return HPCGResult(x=x, iterations=k, residual_norm_sq=rr,
                      converged=rr <= tol_sq)


def make_ir_df64_solver(a, *, tol: float = 1e-6, atol: float = 0.0,
                        inner_tol: float = 1e-2, inner_maxiter: int = 2000,
                        max_outer: int = 40, preconditioner=None,
                        inner_format: str = "ell",
                        inner_chunk: Optional[int] = None,
                        verbose: bool = False):
    """Factory for fp32 (P)CG inner solves inside a df64 iterative-
    refinement outer loop — reaches TRUE relres ≤ tol on κ ≈ 10¹⁰ systems
    at fp32 speed.  Returns ``solve(b, x0=None) -> (HPCGResult, info)``.

    The host-side operator builds (the df64 ELL split and the fp32 inner
    operator) are paid ONCE here; each ``solve(b)`` call reuses them (plus
    the compile cache).

    Args:
      a: host fp64 CSR (:class:`~cgx.sparse.types.CSRMatrix` or scipy).
      preconditioner: any cgx preconditioner for the fp32 inner solves
        (IC(0) is the measured winner on the bcsstk class).
      inner_format: fp32 operator storage for the inner solves —
        ``"ell"`` (default — static-shape gathers), ``"csr"``, or
        ``"auto"`` (:func:`cgx.sparse.types.pick_format`: ELL unless its
        row padding wastes too many slots).
      inner_tol: residual reduction per inner solve == the per-cycle
        contraction of the TRUE residual (κ-independent given the df64
        residual — Higham/Carson).
      inner_chunk: run each inner solve in chunks of this many iterations
        through :mod:`cgx.utils.checkpoint` (the state is host-visible
        between chunks); trajectory-identical to one monolithic inner.

    Returns ``(HPCGResult, info)``; ``info["outer"]`` is the cycle count,
    ``info["relres"]`` the final TRUE df64 relative residual, and
    ``iterations`` on the result counts total INNER iterations.
    """
    from cgx.sparse.types import csr_from_scipy, ell_from_csr, pick_format

    a_sp = _host_csr(a)
    if inner_format == "auto":
        inner_format = pick_format(a_sp)
        if verbose:
            print(f"[ir_df64] inner_format auto → {inner_format}")
    if inner_format not in ("ell", "csr"):
        raise ValueError(f"unknown inner_format {inner_format!r} "
                         "(ell / csr / auto)")

    a_hp = df64_ell_from_csr(a_sp)
    a32 = csr_from_scipy(a_sp.astype(np.float32))
    if inner_format == "ell":
        a32 = ell_from_csr(a32, width_multiple=8)

    if inner_chunk is not None:
        from cgx.utils.checkpoint import make_checkpointed_solver
        _chunked = make_checkpointed_solver(
            a32, tol=float(inner_tol), maxiter=int(inner_maxiter),
            preconditioner=preconditioner, chunk=int(inner_chunk),
            restarts=0)

        def inner(r_unit):
            res = _chunked(r_unit)
            return res.x, res.iterations
    else:
        def inner(r_unit):
            return _ir_inner(a32, preconditioner, r_unit,
                             tol=float(inner_tol),
                             maxiter=int(inner_maxiter))

    return _ir_df64_loop(a_hp, inner, a_sp.shape[0], tol=tol, atol=atol,
                         max_outer=max_outer, verbose=verbose)


def _host_csr(a):
    """Host fp64 ``scipy.sparse.csr_matrix`` of a cgx CSR or scipy matrix."""
    import scipy.sparse as sp

    if hasattr(a, "indptr") and hasattr(a, "col_indices"):
        return sp.csr_matrix((np.asarray(a.values, np.float64),
                              np.asarray(a.col_indices),
                              np.asarray(a.indptr)), shape=a.shape)
    return sp.csr_matrix(a).astype(np.float64)


def _ir_df64_loop(a_hp: DF64ELL, inner, n: int, *, tol, atol, max_outer,
                  verbose):
    """The refinement driver: returns ``solve(b, x0=None) -> (HPCGResult, info)``.  ``x0`` (a
    :class:`DF64` iterate — e.g. a preempted solve's ``res.x``) resumes
    refinement from that point: the outer is restartable for free
    because the iterate is its ONLY state (SURVEY §5.c/d)."""

    def solve(b, x0: Optional[DF64] = None):
        b_df = df_from_f64(np.asarray(b, np.float64))
        bb = float(df_dot(b_df, b_df).hi)
        tol_sq = max(tol * tol * bb, atol * atol)

        if x0 is None:
            x = DF64(jnp.zeros((n,), jnp.float32),
                     jnp.zeros((n,), jnp.float32))
            r = b_df
            rr = bb
        else:
            x = x0
            r = _ir_true_residual(a_hp, b_df, x)
            rr = float(df_dot(r, r).hi)
        total = 0
        outer = 0
        strikes = 0
        while rr > tol_sq and outer < max_outer and strikes < 2:
            s = float(np.sqrt(rr))
            r_unit = (r.hi / np.float32(s)) + (r.lo / np.float32(s))
            d_unit, k_in = inner(r_unit)
            x = df_add(x, df(d_unit * np.float32(s)))
            r = _ir_true_residual(a_hp, b_df, x)
            rr_new = float(df_dot(r, r).hi)
            strikes = 0 if rr_new < rr else strikes + 1
            rr = rr_new
            total += int(k_in)
            outer += 1
            if verbose:
                print(f"[ir_df64] cycle {outer}: true relres "
                      f"{np.sqrt(rr_new / bb):.3e} (+{int(k_in)} inner)")

        res = HPCGResult(x=x, iterations=jnp.int32(total),
                         residual_norm_sq=jnp.float32(rr),
                         converged=jnp.asarray(rr <= tol_sq))
        info = dict(outer=outer, relres=float(np.sqrt(rr / bb)),
                    inner_iterations=total)
        return res, info

    return solve


def make_ir_df64_solver_multi(a, *, tol: float = 1e-6,
                              atol: float = 0.0,
                              inner_tol: float = 1e-2,
                              inner_maxiter: int = 2000,
                              max_outer: int = 40,
                              jacobi: bool = True,
                              verbose: bool = False):
    """Multi-RHS factory: df64 true-residual refinement over BATCHED fp32
    inners — a family of right-hand sides reaches TRUE relres ≤ tol with
    one :func:`cgx.solve.block.cg_solve_multi` ELL solve per cycle (the
    operator stream shared by all columns) and one batched df64 ELL SpMM
    per cycle.

    Returns ``solve(B, x0=None) -> (HPCGResult, info)`` with ``B``: host
    fp64 ``(n, k)``; ``x`` on the result is a df64 ``(n, k)`` block, scalar
    fields carry a ``(k,)`` batch axis.  Columns refine together until ALL
    reach tol (finished columns get zero-scaled unit residuals, so their
    inner work freezes).
    """
    from cgx.solve.precond import JacobiPrecond
    from cgx.sparse.types import csr_from_scipy, ell_from_csr

    a_sp = _host_csr(a)
    a_hp = df64_ell_from_csr(a_sp)
    a32 = ell_from_csr(csr_from_scipy(a_sp.astype(np.float32)),
                       width_multiple=8)
    m = JacobiPrecond.from_matrix(a32) if jacobi else None
    n = a_hp.shape[0]

    def inner(r_unit):
        """(n, k) fp32 unit residuals → (correction block, iter count)."""
        x, its = _ir_inner_multi(a32, m, r_unit, tol=float(inner_tol),
                                 maxiter=int(inner_maxiter))
        return x, int(np.asarray(its).max())

    def solve(B, x0: Optional[DF64] = None):
        B = np.asarray(B, np.float64)
        if B.ndim != 2:
            raise ValueError(f"expected (n, k) RHS block, got {B.shape}")
        k = B.shape[1]
        b_df = df_from_f64(B)
        bb = np.einsum("nk,nk->k", B, B)           # exact enough in f64
        tol_sq = np.maximum(tol * tol * bb, atol * atol)

        if x0 is None:
            x = DF64(jnp.zeros((n, k), jnp.float32),
                     jnp.zeros((n, k), jnp.float32))
            r = b_df
            rr = bb.copy()
        else:
            # Resume refinement from a prior iterate (elastic recovery —
            # the iterate is the outer's only state).
            x = x0
            r = _ir_true_residual_multi(a_hp, b_df, x)
            rr = df64_col_norm_sq(r)
        total = 0
        outer = 0
        strikes = 0
        while (rr > tol_sq).any() and outer < max_outer and strikes < 2:
            active = rr > tol_sq
            s = np.sqrt(np.where(active, rr, 1.0))
            inv_s = jnp.asarray(
                np.where(active, 1.0 / s, 0.0), jnp.float32)
            r_unit = (r.hi * inv_s[None, :]) + (r.lo * inv_s[None, :])
            d_unit, k_in = inner(r_unit)
            x = df_add(x, df(d_unit * jnp.asarray(s, jnp.float32)[None]))
            r = _ir_true_residual_multi(a_hp, b_df, x)
            rr_new = df64_col_norm_sq(r)
            worse = (rr_new >= rr)[active].all() if active.any() else True
            strikes = strikes + 1 if worse else 0
            rr = rr_new
            total += int(k_in)
            outer += 1
            if verbose:
                print(f"[ir_df64_multi] cycle {outer}: true relres "
                      f"{np.sqrt(np.maximum(rr, 0) / bb)}")

        conv = rr <= tol_sq
        res = HPCGResult(x=x, iterations=jnp.int32(total),
                         residual_norm_sq=jnp.asarray(rr, jnp.float32),
                         converged=jnp.asarray(conv))
        info = dict(outer=outer,
                    relres=np.sqrt(np.maximum(rr, 0.0) / bb).tolist(),
                    inner_iterations=total)
        return res, info

    return solve


@partial(jax.jit, static_argnames=("tol", "maxiter"))
def _ir_inner_multi(a_, m_, r_unit, *, tol, maxiter):
    """Batched fp32 inner solves for an (n, k) block of unit residuals."""
    from cgx.solve.block import cg_solve_multi

    res = cg_solve_multi(a_, r_unit, tol=tol, maxiter=maxiter,
                         preconditioner=m_, restarts=0)
    return res.x, res.iterations


@jax.jit
def _df64_col_norm_sq_dev(r_hi, r_lo):
    s = _fold_axis(df_mul(DF64(r_hi, r_lo), DF64(r_hi, r_lo)), axis=0)
    return s.hi, s.lo


def df64_col_norm_sq(r: DF64) -> np.ndarray:
    """Per-column df64 ‖r‖² of an (n, k) df64 block → host fp64 (k,)
    (pairwise double-word fold down the row axis)."""
    hi, lo = _df64_col_norm_sq_dev(r.hi, r.lo)
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def ir_df64_solve(a, b, *, tol: float = 1e-6, atol: float = 0.0,
                  inner_tol: float = 1e-2, inner_maxiter: int = 2000,
                  max_outer: int = 40, preconditioner=None,
                  inner_format: str = "ell",
                  inner_chunk: Optional[int] = None,
                  verbose: bool = False):
    """One-shot form of :func:`make_ir_df64_solver` (see its docstring)."""
    return make_ir_df64_solver(
        a, tol=tol, atol=atol, inner_tol=inner_tol,
        inner_maxiter=inner_maxiter, max_outer=max_outer,
        preconditioner=preconditioner, inner_format=inner_format,
        inner_chunk=inner_chunk, verbose=verbose)(b)
