"""df64 (double-word fp32) high-accuracy solver tests (SURVEY.md §7 hard
part 4; reference anchor: fp64 throughout, ``mv_ops.h:19-21``).

The acceptance bar: a κ ≈ 10⁹⁺ SPD system where plain fp32 CG provably
CANNOT reach a true relative residual of 1e-6 — and the df64 paths can.
All checks are against numpy float64 ground truth.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from cgx.ops.df64 import (DF64, df, df_add, df_div, df_dot, df_from_f64,
                          df_mul, df_sum, df_to_f64, two_prod, two_sum)
from cgx.solve.hp import (df64_cg_solve, df64_ell_from_csr, df64_ell_spmv,
                          ir_df64_solve)


def _ill_conditioned_spd(n=96, kappa=1e9, seed=0):
    """Tridiagonal SPD with an exactly log-spaced diagonal: κ ≈ kappa."""
    rng = np.random.default_rng(seed)
    d = np.logspace(0, np.log10(kappa), n)
    off = 0.1 * np.sqrt(d[:-1] * d[1:])      # keeps it SPD (diag dominant-ish)
    a = sp.diags([off, d, off], [-1, 0, 1], format="csr").astype(np.float64)
    b = rng.standard_normal(n)
    return a, b


def test_two_sum_exact():
    a = np.float32(1.0)
    b = np.float32(1e-8)
    s, e = two_sum(jnp.float32(a), jnp.float32(b))
    assert float(s) == 1.0
    # The error term recovers exactly what fp32 addition dropped.
    assert float(np.float64(s) + np.float64(e)) == np.float64(a) + np.float64(b)


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = two_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_df_dot_beats_fp32():
    """Adversarial cancellation: df64 dot ~1e-14 relative, fp32 ~1e-7."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4096) * np.logspace(0, 6, 4096)
    y = rng.standard_normal(4096)
    exact = float(np.dot(x, y))
    xd, yd = df_from_f64(x), df_from_f64(y)
    got = float(np.float64(df_dot(xd, yd).hi) + np.float64(df_dot(xd, yd).lo))
    rel_df = abs(got - exact) / abs(exact)
    rel_32 = abs(float(jnp.vdot(jnp.asarray(x, jnp.float32),
                                jnp.asarray(y, jnp.float32))) - exact) \
        / abs(exact)
    assert rel_df < 1e-11
    assert rel_df < rel_32 * 1e-3


def test_df_div_accuracy():
    x = df_from_f64(np.array([np.pi]))
    y = df_from_f64(np.array([np.e]))
    q = df_div(x, y)
    assert abs(df_to_f64(q)[0] - np.pi / np.e) < 1e-13


def test_df64_ell_spmv_matches_f64():
    a, _ = _ill_conditioned_spd(200, 1e8)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(200)
    ahp = df64_ell_from_csr(a)
    y = df_to_f64(df64_ell_spmv(ahp, df_from_f64(x)))
    y_ref = a @ x
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)


def _clustered_spectrum_spd(n=96, kappa=3e7, seed=0, n_small=4):
    """Dense SPD with a rotation-hidden CLUSTERED spectrum: a few tiny
    eigenvalues (κ = kappa) and the rest in [0.5, 1].  CG converges in
    ~#clusters iterations — in ANY precision — but the attainable TRUE
    residual separates them: fp32's floor is ~eps₃₂·‖A‖‖x‖/‖b‖ ≫ 1e-6,
    df64's is ~2⁻⁴⁸·(same) ≪ 1e-6.  The near-constant diagonal keeps
    Jacobi from hiding the conditioning.  (A log-SPACED spectrum is the
    wrong fixture here: even fp64 scipy CG needs ≫ n iterations on it —
    rounding destroys finite termination at √κ rates in every precision.)
    """
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([(1.0 / kappa) * (1 + 1e-3 * np.arange(n_small)),
                        np.linspace(0.5, 1.0, n - n_small)])
    a = (q * d) @ q.T
    a = (a + a.T) / 2
    b = rng.standard_normal(n)
    return sp.csr_matrix(a), b


def test_fp32_cg_cannot_but_df64_can():
    """The headline property: true relres 1e-6 at κ ≈ 3e7 with a
    rotation-hidden clustered spectrum — fp32's attainable accuracy
    fails it, df64 reaches it, at comparable iteration counts."""
    from cgx.solve.cg import cg_solve
    from cgx.sparse.types import csr_from_scipy

    a, b = _clustered_spectrum_spd(96, 3e7)
    bn = np.linalg.norm(b)

    a32 = csr_from_scipy(sp.csr_matrix(a).astype(np.float32))
    r32 = cg_solve(a32, jnp.asarray(b, jnp.float32), tol=1e-8,
                   maxiter=3000)
    true32 = np.linalg.norm(b - a @ np.asarray(r32.x, np.float64)) / bn
    assert true32 > 1e-6          # fp32 provably stalls above the target

    ahp = df64_ell_from_csr(a)
    res = df64_cg_solve(ahp, b, tol=1e-8, maxiter=3000)
    x64 = df_to_f64(res.x)
    true_df = np.linalg.norm(b - a @ x64) / bn
    assert bool(res.converged)
    assert true_df <= 1e-6
    assert int(res.iterations) < 500    # clustered → fast in df64 too


def test_df64_cg_matches_f64_cg_trajectory():
    """Well-conditioned sanity: df64 CG ≈ numpy fp64 CG (iterations and
    solution)."""
    a, b = _ill_conditioned_spd(80, 1e3, seed=5)
    ahp = df64_ell_from_csr(a)
    res = df64_cg_solve(ahp, b, tol=1e-10, maxiter=500)
    x64 = df_to_f64(res.x)
    x_ref = sp.linalg.spsolve(a.tocsc(), b)
    assert np.linalg.norm(b - a @ x64) / np.linalg.norm(b) <= 1e-10
    np.testing.assert_allclose(x64, x_ref, rtol=1e-6)


def test_ir_df64_reaches_true_tol():
    """IR with fp32 CG inner + df64 outer: true relres ≤ 1e-6 at
    κ ≈ 3e7 with a rotation-hidden clustered spectrum, in a handful of
    cycles."""
    a, b = _clustered_spectrum_spd(96, 3e7, seed=7)
    res, info = ir_df64_solve(a, b, tol=1e-6, inner_tol=1e-2,
                              inner_maxiter=3000)
    x64 = df_to_f64(res.x)
    true_rel = np.linalg.norm(b - a @ x64) / np.linalg.norm(b)
    assert bool(res.converged)
    assert true_rel <= 1.5e-6
    assert info["outer"] <= 20


def test_ir_df64_on_bcsstk_standin_small():
    """The target conditioning class (shell stiffness, log-normal
    scaling) at CPU scale: IC(0) inner + df64 outer."""
    import cgx
    from cgx.io.suitesparse import standin

    a = standin("bcsstk17", scale=0.04)
    n = a.shape[0]
    rng = np.random.default_rng(11)
    b = rng.standard_normal(n)
    av = sp.csr_matrix((np.asarray(a.values), np.asarray(a.col_indices),
                        np.asarray(a.indptr)), shape=a.shape)
    m = cgx.JacobiPrecond(
        inv_diag=jnp.asarray(1.0 / av.diagonal(), jnp.float32))
    res, info = ir_df64_solve(av, b, tol=1e-6, inner_tol=1e-2,
                              inner_maxiter=5000, preconditioner=m)
    true_rel = np.linalg.norm(b - av @ df_to_f64(res.x)) / np.linalg.norm(b)
    assert true_rel <= 1.5e-6, (true_rel, info)


def test_make_ir_df64_solver_reuses_build(rng):
    """The factory form: one operator build, repeated right-hand sides
    (the one-shot form rebuilds the df64 ELL split per call)."""
    from cgx.solve.hp import make_ir_df64_solver

    a, _ = _ill_conditioned_spd(n=200, kappa=1e6)
    solve = make_ir_df64_solver(a, tol=1e-8, inner_tol=1e-2,
                                inner_maxiter=2000)
    for i in range(2):
        b = rng.standard_normal(200)
        res, info = solve(b)
        assert bool(res.converged)
        assert info["relres"] <= 1e-8


def test_ir_df64_multi_rhs_reaches_true_tol():
    """Multi-RHS df64 refinement: a block of right-hand sides reaches TRUE
    relres ≤ tol per column through batched ELL inners (one shared
    operator stream) and batched df64 true residuals."""
    from cgx.solve.hp import make_ir_df64_solver_multi
    from conftest import random_spd_csr

    n, k = 300, 3
    a = random_spd_csr(n, 0.03, np.random.default_rng(3))
    d = sp.diags(np.logspace(0, 4, n))
    a = (d @ a @ d).tocsr()
    B = np.random.default_rng(5).standard_normal((n, k))
    solve = make_ir_df64_solver_multi(a, tol=1e-6, inner_tol=1e-2,
                                      inner_maxiter=2000)
    res, info = solve(B)
    assert bool(np.asarray(res.converged).all()), info
    X = df_to_f64(res.x)
    for j in range(k):
        rel = np.linalg.norm(B[:, j] - a @ X[:, j]) \
            / np.linalg.norm(B[:, j])
        assert rel <= 1.5e-6, (j, rel, info)


def test_df64_ell_spmm_matches_f64():
    """Batched df64 SpMM (one gather pass for all columns) matches fp64
    ground truth per column."""
    from cgx.solve.hp import df64_ell_spmm

    a, _ = _ill_conditioned_spd(200, 1e8)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((200, 3))
    ahp = df64_ell_from_csr(a)
    Y = df_to_f64(df64_ell_spmm(ahp, df_from_f64(X)))
    np.testing.assert_allclose(Y, a @ X, rtol=1e-12, atol=1e-12)


def test_df64_col_norm_sq_exact():
    from cgx.solve.hp import df64_col_norm_sq

    rng = np.random.default_rng(7)
    X = rng.standard_normal((512, 4)) * np.logspace(0, 5, 512)[:, None]
    got = df64_col_norm_sq(df_from_f64(X))
    ref = np.einsum("nk,nk->k", X, X)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_ir_df64_resume_from_iterate():
    """SURVEY §5.c elastic recovery, df64 form: a refinement preempted
    after a few cycles resumes from its iterate (x0=res.x) and finishes
    in fewer outer cycles than from scratch, to the same TRUE accuracy."""
    import cgx
    from cgx.solve.hp import make_ir_df64_solver
    from conftest import random_spd_csr

    n = 300
    a = random_spd_csr(n, 0.03, np.random.default_rng(3))
    d = sp.diags(np.logspace(0, 5, n))
    a = (d @ a @ d).tocsr()
    b = np.random.default_rng(5).standard_normal(n)
    m = cgx.JacobiPrecond(
        inv_diag=jnp.asarray(1.0 / a.diagonal(), jnp.float32))
    solver = make_ir_df64_solver(a, tol=1e-8, inner_tol=1e-2,
                                 inner_maxiter=2000, preconditioner=m,
                                 inner_format="ell")
    full, info_full = solver(b)
    assert bool(full.converged)

    # "Preemption": cap the outer cycles, snapshot the iterate, resume.
    partial_solver = make_ir_df64_solver(
        a, tol=1e-8, inner_tol=1e-2, inner_maxiter=2000,
        preconditioner=m, inner_format="ell",
        max_outer=max(1, info_full["outer"] // 2))
    part, info_part = partial_solver(b)
    res, info_res = solver(b, x0=part.x)
    assert bool(res.converged)
    assert info_res["outer"] < info_full["outer"] or info_full["outer"] <= 1
    true_rel = np.linalg.norm(b - a @ df_to_f64(res.x)) / np.linalg.norm(b)
    assert true_rel <= 1.5e-8


def test_ir_df64_multi_resume_from_iterate():
    """Multi-RHS df64 resume: the block outer picks up from a prior
    df64 iterate block."""
    from cgx.solve.hp import make_ir_df64_solver_multi
    from conftest import random_spd_csr

    n, k = 300, 2
    a = random_spd_csr(n, 0.03, np.random.default_rng(3))
    d = sp.diags(np.logspace(0, 4, n))
    a = (d @ a @ d).tocsr()
    B = np.random.default_rng(9).standard_normal((n, k))
    solver = make_ir_df64_solver_multi(a, tol=1e-8, inner_tol=1e-2,
                                       inner_maxiter=2000)
    full, info_full = solver(B)
    assert bool(np.asarray(full.converged).all())
    part_solver = make_ir_df64_solver_multi(
        a, tol=1e-8, inner_tol=1e-2, inner_maxiter=2000,
        max_outer=max(1, info_full["outer"] // 2))
    part, _ = part_solver(B)
    res, info_res = solver(B, x0=part.x)
    assert bool(np.asarray(res.converged).all())
    assert info_res["outer"] < info_full["outer"] or info_full["outer"] <= 1
