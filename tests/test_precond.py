"""Preconditioner tests: IC(0) correctness + PCG iteration-count wins.

SURVEY.md §4.2: PCG (Jacobi, IC(0)) iteration counts strictly below
unpreconditioned CG on the same SPD fixtures.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cgx.io.poisson import poisson2d
from cgx.solve.cg import cg_solve
from cgx.solve.ic0 import IC0Precond, ic0_factor
from cgx.solve.precond import (BlockJacobiPrecond, JacobiPrecond,
                               PolynomialPrecond)
from cgx.sparse.types import csr_from_scipy

from conftest import random_spd_csr


def test_ic0_factor_exact_on_full_cholesky(rng):
    """On a dense-pattern SPD matrix IC(0) == exact Cholesky."""
    import scipy.sparse as sp
    n = 12
    m = rng.standard_normal((n, n))
    a_dense = m @ m.T + n * np.eye(n)
    a = csr_from_scipy(sp.csr_matrix(a_dense))
    lv, lc, lp = ic0_factor(a)
    l = sp.csr_matrix((lv, lc, lp), shape=(n, n)).toarray()
    np.testing.assert_allclose(l, np.linalg.cholesky(a_dense), rtol=1e-10)


def test_ic0_apply_matches_dense_solve(rng):
    """apply(r) == L^-T L^-1 r computed densely from the same factor."""
    import scipy.sparse as sp
    a = poisson2d(7, 9)
    n = a.shape[0]
    lv, lc, lp = ic0_factor(a)
    l = sp.csr_matrix((lv, lc, lp), shape=(n, n)).toarray()
    m = IC0Precond.from_matrix(a)
    r = rng.standard_normal(n)
    z = np.asarray(m.apply(jnp.asarray(r)))
    z_ref = np.linalg.solve(l.T, np.linalg.solve(l, r))
    np.testing.assert_allclose(z, z_ref, rtol=1e-10, atol=1e-12)


def test_ic0_levels_are_coarse_on_poisson():
    """Level scheduling finds real parallelism: #levels << n on a stencil."""
    a = poisson2d(16, 16)
    m = IC0Precond.from_matrix(a)
    assert m.n_levels <= 16 + 16  # wavefront count, not n=256


@pytest.mark.parametrize("make_precond", [
    lambda a: JacobiPrecond.from_matrix(a),
    lambda a: BlockJacobiPrecond.from_matrix(a, 8),
    lambda a: IC0Precond.from_matrix(a),
    lambda a: PolynomialPrecond.from_matrix(a, steps=3),
])
def test_pcg_converges_and_beats_plain_cg(make_precond, rng):
    s = random_spd_csr(120, 0.06, rng)
    # Worsen conditioning so preconditioning has something to do.
    d = np.linspace(1.0, 40.0, 120)
    s = (s.multiply(np.outer(d, d))).tocsr()
    a = csr_from_scipy(s)
    b = rng.standard_normal(120)

    plain = cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=2000)
    pre = cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=2000,
                   preconditioner=make_precond(a))
    assert bool(pre.converged)
    assert int(pre.iterations) < int(plain.iterations)
    x = np.asarray(pre.x)
    assert np.linalg.norm(b - s @ x) <= 1e-8 * np.linalg.norm(b)


def test_ic0_pcg_on_poisson_beats_jacobi(rng):
    a = poisson2d(24, 24)
    b = rng.standard_normal(576)
    jac = cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=2000,
                   preconditioner=JacobiPrecond.from_matrix(a))
    ic0 = cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=2000,
                   preconditioner=IC0Precond.from_matrix(a))
    assert bool(ic0.converged)
    assert int(ic0.iterations) < int(jac.iterations)


def test_ic0_breakdown_raises():
    """A matrix that defeats IC(0) raises rather than returning garbage."""
    import scipy.sparse as sp
    # Indefinite leading structure: A SPD overall is required; feed a
    # non-SPD matrix and expect the pivot check to fire.
    a_dense = np.array([[1.0, 2.0], [2.0, 1.0]])
    a = csr_from_scipy(sp.csr_matrix(a_dense))
    with pytest.raises(np.linalg.LinAlgError):
        ic0_factor(a)


def test_ic0_gather_budget_guard(rng):
    """An explicit gather budget refuses a larger level-packed apply with
    an actionable ValueError naming the alternatives; the default (no
    budget) builds."""
    a = csr_from_scipy(random_spd_csr(64, density=0.1, rng=rng))
    with pytest.raises(ValueError, match="IC0SweepPrecond"):
        IC0Precond.from_matrix(a, gather_budget=10)
    m = IC0Precond.from_matrix(a, dtype=np.float32)     # default: no cap
    r = jnp.asarray(rng.standard_normal(64), jnp.float32)
    assert np.all(np.isfinite(np.asarray(m.apply(r))))


def test_ic0_guard_bench_row_records_clean_error(rng):
    """The SuiteSparse bench records a guarded ic0 row as a clean error
    line instead of failing the sweep."""
    import scipy.sparse as sp

    from cgx.bench.suitesparse import bench_matrix

    n = 96
    a_sp = sp.diags([-1.0, 2.2, -1.0], [-1, 0, 1], shape=(n, n),
                    format="csr", dtype=np.float64)
    a = csr_from_scipy(a_sp)
    import cgx.bench.suitesparse as mod
    import cgx as cgx_mod
    orig = cgx_mod.IC0Precond.from_matrix
    try:
        cgx_mod.IC0Precond.from_matrix = staticmethod(
            lambda m, dtype=None, **kw: orig(m, dtype=dtype,
                                             gather_budget=10))
        rows = bench_matrix("tiny", a, True, tol=1e-6, maxiter=200,
                            reps=1, fmt="csr", preconds="ic0")
    finally:
        cgx_mod.IC0Precond.from_matrix = orig
    (row,) = rows
    assert "error" in row and "IC(0) guard" in row["error"]
    assert "IC0SweepPrecond" in row["error"]


def test_ic0_multicolor_ordering(rng):
    """Multicolor IC(0): level count collapses to ~chromatic number while
    staying an effective SPD preconditioner (VERDICT r1 #6)."""
    import cgx
    from cgx.io.poisson import poisson2d
    from cgx.solve.cg import cg_solve

    a = poisson2d(24, 24)
    n = 576
    b = jnp.asarray(rng.standard_normal(n))

    nat = cgx.IC0Precond.from_matrix(a)
    mc = cgx.IC0Precond.from_matrix(a, ordering="multicolor")
    # 2D 5-point grid is 2-colorable: levels collapse from O(grid) to 2.
    assert mc.n_levels <= 4 < nat.n_levels

    plain = cg_solve(a, b, tol=1e-10, maxiter=2000)
    res_n = cg_solve(a, b, tol=1e-10, maxiter=2000, preconditioner=nat)
    res_m = cg_solve(a, b, tol=1e-10, maxiter=2000, preconditioner=mc)
    assert bool(res_m.converged)
    # Still a real preconditioner (beats plain CG), though weaker than
    # natural-order IC(0) — the standard multicolor trade.
    assert int(res_m.iterations) < int(plain.iterations)
    assert int(res_m.iterations) <= 2 * int(res_n.iterations)
    np.testing.assert_allclose(np.asarray(res_m.x), np.asarray(plain.x),
                               rtol=1e-8, atol=1e-10)


def test_ic0_sweep_exact_at_level_count(rng):
    """nsweeps >= n_levels - 1 terminates the Neumann series: the sweep
    apply equals the exact level-scheduled apply."""
    from cgx.io.poisson import poisson2d
    from cgx.solve.ic0 import IC0SweepPrecond

    a = poisson2d(10, 9)
    exact = IC0Precond.from_matrix(a)
    sweep = IC0SweepPrecond.from_matrix(a, nsweeps=exact.n_levels)
    assert sweep.n_levels == exact.n_levels
    r = jnp.asarray(rng.standard_normal(a.shape[0]))
    np.testing.assert_allclose(np.asarray(sweep.apply(r)),
                               np.asarray(exact.apply(r)),
                               rtol=1e-10, atol=1e-12)


def test_ic0_sweep_pcg_between_jacobi_and_exact(rng):
    """Truncated sweeps give a CG-safe SPD preconditioner whose iteration
    count sits between Jacobi and exact IC(0)."""
    import cgx
    from cgx.io.poisson import poisson2d
    from cgx.solve.ic0 import IC0SweepPrecond

    a = poisson2d(24, 24)
    n = a.shape[0]
    b = jnp.asarray(rng.standard_normal(n))
    it_jac = int(cgx.cg_solve(
        a, b, tol=1e-8, maxiter=2000,
        preconditioner=cgx.JacobiPrecond.from_matrix(a)).iterations)
    it_exact = int(cgx.cg_solve(
        a, b, tol=1e-8, maxiter=2000,
        preconditioner=IC0Precond.from_matrix(a)).iterations)
    res = cgx.cg_solve(a, b, tol=1e-8, maxiter=2000,
                       preconditioner=IC0SweepPrecond.from_matrix(
                           a, nsweeps=3))
    assert bool(res.converged)
    it_sweep = int(res.iterations)
    assert it_exact <= it_sweep <= it_jac
    assert it_sweep < it_jac          # strictly better than Jacobi


def test_ic0_sweep_rejects_unbanded():
    from cgx.solve.ic0 import IC0SweepPrecond
    from cgx.sparse.types import csr_from_scipy

    s = random_spd_csr(128, 0.2)
    with pytest.raises(ValueError, match="banded"):
        IC0SweepPrecond.from_matrix(csr_from_scipy(s))


def _kershaw_block_csr(nblocks=8):
    """Block-diagonal stack of Kershaw's 4x4 SPD matrix — the classic
    example where IC(0) breaks down (pivot < 0 at row 3) despite SPD-ness."""
    import scipy.sparse as sp
    K = np.array([[3., -2, 0, 2], [-2, 3, -2, 0],
                  [0, -2, 3, -2], [2, 0, -2, 3]])
    assert np.linalg.eigvalsh(K).min() > 0
    from cgx.sparse.types import csr_from_scipy
    m = sp.csr_matrix(sp.block_diag([K] * nblocks))
    m.eliminate_zeros()                    # keep K's true sparsity pattern
    return csr_from_scipy(m)


def test_ic0_shifted_recovers_kershaw_breakdown():
    from cgx.solve.ic0 import ic0_factor, ic0_factor_shifted
    a = _kershaw_block_csr()
    with pytest.raises(np.linalg.LinAlgError):
        ic0_factor(a)
    lv, lc, lp, alpha = ic0_factor_shifted(a)
    assert alpha > 0                       # a shift was needed
    assert np.isfinite(lv).all()


def test_ic0_precond_survives_breakdown_matrix(rng):
    """from_matrix auto-shifts on breakdown; PCG still converges and the
    shifted factor still beats plain CG's iteration count."""
    import cgx
    a = _kershaw_block_csr()
    n = a.shape[0]
    b = jnp.asarray(rng.standard_normal(n))
    m = IC0Precond.from_matrix(a)          # would raise without the shift
    res = cgx.cg_solve(a, b, tol=1e-10, maxiter=500, preconditioner=m)
    assert bool(res.converged)
    plain = cgx.cg_solve(a, b, tol=1e-10, maxiter=500)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(plain.x),
                               rtol=1e-7, atol=1e-9)


def test_ic0_sweep_survives_breakdown_matrix(rng):
    import cgx
    from cgx.solve.ic0 import IC0SweepPrecond
    a = _kershaw_block_csr()
    n = a.shape[0]
    b = jnp.asarray(rng.standard_normal(n))
    m = IC0SweepPrecond.from_matrix(a, nsweeps=3)
    res = cgx.cg_solve(a, b, tol=1e-10, maxiter=500, preconditioner=m)
    assert bool(res.converged)
