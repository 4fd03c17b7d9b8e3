"""Solver parity against SciPy's float64 CG across every operator format,
every preconditioner and both float widths.

One small SPD system per operator kind; each cgx container and each
preconditioner is built from the same float64 host matrix, and
:func:`cgx.auto_solve` (single RHS), :func:`cgx.cg_solve_multi` and
:func:`cgx.block_cg_solve` (a block of RHS) are held to the solution that
:func:`scipy.sparse.linalg.cg` computes in float64 with the same
preconditioner.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import cgx
from cgx.io.poisson import poisson3d_dia27
from cgx.sparse.grid import stencil_to_dia
from cgx.sparse.stencil import (poisson2d_stencil, poisson3d_27point,
                                poisson3d_stencil)
from cgx.sparse.types import (bsr_from_csr, coo_from_scipy, csr_from_scipy,
                              ell_from_csr)

OPERATORS = ["stencil2d", "stencil3d", "stencil27", "dia_var", "csr", "ell",
             "coo", "bsr"]
PRECONDS = ["none", "jacobi", "block_jacobi", "poly", "ic0", "ic0_sweep"]
DTYPES = ["float32", "float64"]


def _dia_to_scipy(d):
    """Row-aligned DIA (``data[k, i] = A[i, i+off]``) → scipy CSR."""
    data = np.asarray(d.data, np.float64)
    n = d.shape[0]
    rows, cols, vals = [], [], []
    for k, off in enumerate(d.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(data[k, i])
    a = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    a.eliminate_zeros()
    a.sort_indices()
    return a


def _banded_spd(n=96, seed=0):
    """Banded SPD CSR with variable coefficients (5 diagonals; banded so
    the sweep-form IC(0) applies)."""
    rng = np.random.default_rng(seed)
    off1 = -rng.uniform(0.2, 1.0, n - 1)
    off7 = -rng.uniform(0.2, 1.0, n - 7)
    a = sp.diags([off7, off1, np.zeros(n), off1, off7], [-7, -1, 0, 1, 7],
                 shape=(n, n), format="csr")
    diag = np.asarray(abs(a).sum(axis=1)).ravel() + 0.3
    a = (a + sp.diags(diag)).tocsr()
    a.sort_indices()
    return a


@functools.lru_cache(maxsize=None)
def _system(kind):
    """(float64 host CSR, builder dtype -> cgx operator)."""
    if kind == "stencil2d":
        s = poisson2d_stencil(9, 8)
        return _dia_to_scipy(stencil_to_dia(s, np.float64)), (
            lambda dt: dataclass_with_dtype(s, dt))
    if kind == "stencil3d":
        s = poisson3d_stencil(5, 4, 6)
        return _dia_to_scipy(stencil_to_dia(s, np.float64)), (
            lambda dt: dataclass_with_dtype(s, dt))
    if kind == "stencil27":
        s = poisson3d_27point(4, 5, 4)
        return _dia_to_scipy(stencil_to_dia(s, np.float64)), (
            lambda dt: dataclass_with_dtype(s, dt))
    if kind == "dia_var":
        d = poisson3d_dia27(4, 4, 5, variable=True, seed=3,
                            dtype=np.float64)
        return _dia_to_scipy(d), (lambda dt: d.astype(dt))
    a = _banded_spd()
    csr = csr_from_scipy(a)
    build = {
        "csr": lambda dt: csr.astype(dt),
        "ell": lambda dt: ell_from_csr(csr).astype(dt),
        "coo": lambda dt: coo_from_scipy(a).astype(dt),
        "bsr": lambda dt: bsr_from_csr(csr, 4).astype(dt),
    }[kind]
    return a, build


def dataclass_with_dtype(s, dt):
    import dataclasses
    return dataclasses.replace(s, dtype_name=jnp.dtype(dt).name)


def _precond(kind, a_sp, op, dt):
    """The cgx preconditioner and the same operator as a float64 SciPy
    LinearOperator (``None`` for no preconditioner)."""
    if kind == "none":
        return None, None
    csr = csr_from_scipy(a_sp.astype(dt))
    if kind == "jacobi":
        m = cgx.JacobiPrecond(inv_diag=jnp.asarray(1.0 / a_sp.diagonal(), dt))
    elif kind == "block_jacobi":
        m = cgx.BlockJacobiPrecond.from_matrix(csr, 4)
    elif kind == "poly":
        m = cgx.PolynomialPrecond(
            op, jnp.asarray(1.0 / a_sp.diagonal(), dt), steps=3)
    elif kind == "ic0":
        m = cgx.IC0Precond.from_matrix(csr)
    else:
        m = cgx.IC0SweepPrecond.from_matrix(csr, nsweeps=2)
    n = a_sp.shape[0]
    m64 = m if dt == "float64" else _precond_f64(kind, a_sp)
    lin = spla.LinearOperator(
        (n, n), dtype=np.float64,
        matvec=lambda r: np.asarray(m64.apply(jnp.asarray(r, jnp.float64))))
    return m, lin


def _precond_f64(kind, a_sp):
    m, _ = _precond(kind, a_sp, sp_matvec(a_sp), "float64")
    return m


def sp_matvec(a_sp):
    return lambda x: jnp.asarray(a_sp @ np.asarray(x, np.float64))


def _scipy_solution(a_sp, b, lin, rtol=1e-13):
    """(x, iterations) of SciPy's float64 PCG to ``‖r‖ ≤ rtol·‖b‖``."""
    its = []
    x, info = spla.cg(a_sp, b, rtol=rtol, atol=0.0, maxiter=5000, M=lin,
                      callback=lambda xk: its.append(1))
    assert info == 0
    return x, len(its)


# fp64: both solvers reach the tolerance on the same system, so the
# iterates agree far below it; fp32: tol 1e-6 on systems with κ ≲ 1e3.
TOL = {"float32": 1e-6, "float64": 1e-11}
ERR = {"float32": 2e-4, "float64": 1e-8}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("op_kind", OPERATORS)
def test_auto_solve_matches_scipy(op_kind, precond, dtype):
    a_sp, build = _system(op_kind)
    n = a_sp.shape[0]
    op = build(dtype)
    m, lin = _precond(precond, a_sp, op, dtype)
    b64 = np.random.default_rng(11).standard_normal(n)
    x_ref, _ = _scipy_solution(a_sp, b64, None)

    # PolynomialPrecond closes over its matvec and is not a pytree: the
    # preconditioner rides in the closure.
    solve = jax.jit(lambda op, b: cgx.auto_solve(
        op, b, tol=TOL[dtype], maxiter=4 * n, preconditioner=m))
    res = solve(op, jnp.asarray(b64, dtype))
    assert bool(res.converged)
    x = np.asarray(res.x, np.float64)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert err <= ERR[dtype], err
    if dtype == "float64":
        # Same preconditioned recurrence and stopping rule: the same
        # iteration count up to rounding at the threshold.
        _, its = _scipy_solution(a_sp, b64, lin, rtol=TOL[dtype])
        assert abs(int(res.iterations) - its) <= 2, (int(res.iterations),
                                                      its)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("solver", ["multi", "block"])
@pytest.mark.parametrize("op_kind", OPERATORS)
def test_multi_rhs_matches_scipy(op_kind, solver, k):
    a_sp, build = _system(op_kind)
    n = a_sp.shape[0]
    op = build("float64")
    B = np.random.default_rng(12).standard_normal((n, k))
    fn = {"multi": cgx.cg_solve_multi, "block": cgx.block_cg_solve}[solver]
    res = jax.jit(lambda op, B: fn(op, B, tol=1e-11, maxiter=4 * n))(
        op, jnp.asarray(B))
    assert bool(np.all(np.asarray(res.converged)))
    X = np.asarray(res.x)
    assert X.shape == (n, k)
    for j in range(k):
        x_ref, _ = _scipy_solution(a_sp, B[:, j], None)
        err = np.linalg.norm(X[:, j] - x_ref) / np.linalg.norm(x_ref)
        assert err <= 1e-8, (j, err)


def test_auto_solve_routes_a_block_to_cg_solve_multi():
    """A 2-D right-hand side takes the batched path: per-column results
    equal independent single-RHS solves."""
    a_sp, build = _system("csr")
    op = build("float64")
    B = np.random.default_rng(13).standard_normal((a_sp.shape[0], 3))
    res = cgx.auto_solve(op, jnp.asarray(B), tol=1e-10)
    assert res.x.shape == B.shape and res.iterations.shape == (3,)
    for j in range(3):
        one = cgx.auto_solve(op, jnp.asarray(B[:, j]), tol=1e-10)
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(one.x), rtol=1e-12)
    with pytest.raises(ValueError):
        cgx.auto_solve(op, jnp.asarray(B), track_history=True)
