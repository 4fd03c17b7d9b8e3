"""Solver tests: CG/PCG correctness, convergence, trajectory parity.

Mirrors SURVEY.md §4's plan: SPD fixtures (2D Poisson per north-star config
1), comparison against a NumPy reference CG in fp64, preconditioned variants
strictly reducing iteration counts, and property tests on random SPD
matrices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cgx.io.poisson import poisson2d, poisson2d_dia, poisson3d
from cgx.solve.cg import cg_solve
from cgx.solve.precond import BlockJacobiPrecond, JacobiPrecond
from cgx.sparse.types import csr_from_scipy, ell_from_csr, bsr_from_csr
from cgx.ops.spmv import spmv

from conftest import random_spd_csr


def numpy_cg(a_csr_scipy, b, maxiter, tol=0.0):
    """Textbook Hestenes–Stiefel CG in float64 NumPy (ground truth).

    Matches the reference algorithm's trajectory (cg.c:88-141): x0 = 0,
    r0 = b, p0 = r0; identical update formulas (the reference's redundant
    recomputation of rᵀr does not change values).
    """
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = r @ r
    bb = b @ b
    history = [rs]
    k = 0
    while k < maxiter and rs > tol * tol * bb:
        q = a_csr_scipy @ p
        alpha = rs / (p @ q)
        x = x + alpha * p
        r = r - alpha * q
        rs_new = r @ r
        p = r + (rs_new / rs) * p
        rs = rs_new
        history.append(rs)
        k += 1
    return x, np.array(history), k


def test_cg_converges_poisson2d_64x64():
    """North-star config 1: 2D 5-point Poisson 64×64, fp64, tol 1e-6."""
    a = poisson2d(64, 64)
    n = a.shape[0]
    rng = np.random.default_rng(7)
    x_true = rng.standard_normal(n)
    b = np.asarray(spmv(a, jnp.asarray(x_true)))

    res = cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=2000)
    assert bool(res.converged)
    x = np.asarray(res.x)
    # True residual matches the recurrence residual.
    true_res = np.linalg.norm(b - np.asarray(spmv(a, jnp.asarray(x))))
    assert true_res <= 1e-9 * np.linalg.norm(b)
    np.testing.assert_allclose(x, x_true, rtol=1e-7, atol=1e-7)


def test_cg_trajectory_matches_numpy_reference():
    """Residual history matches a NumPy CG step-for-step in fp64."""
    a = poisson2d(16, 16)
    n = a.shape[0]
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n)

    import scipy.sparse as sp
    s = sp.csr_matrix((np.asarray(a.values), np.asarray(a.col_indices),
                       np.asarray(a.indptr)), shape=a.shape)
    x_np, hist_np, k_np = numpy_cg(s, b, maxiter=40)

    res = cg_solve(a, jnp.asarray(b), tol=0.0, maxiter=40,
                   track_history=True)
    assert int(res.iterations) == 40 == k_np
    hist = np.asarray(res.history)[:41]
    np.testing.assert_allclose(hist, hist_np, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-10,
                               atol=1e-12)


def test_cg_all_formats_agree():
    """CSR / ELL / BSR / DIA operators produce the same solution."""
    a_csr = poisson2d(12, 12)
    n = a_csr.shape[0]
    b = np.cos(np.arange(n) * 0.37)
    sol = {}
    mats = {
        "csr": a_csr,
        "ell": ell_from_csr(a_csr),
        "dia": poisson2d_dia(12, 12),
    }
    for name, a in mats.items():
        res = cg_solve(a, jnp.asarray(b), tol=1e-12, maxiter=1000)
        assert bool(res.converged), name
        sol[name] = np.asarray(res.x)
    a_bsr = bsr_from_csr(a_csr, blocksize=8)
    bp = np.zeros(a_bsr.shape[0])
    bp[:n] = b
    res = cg_solve(a_bsr, jnp.asarray(bp), tol=1e-12, maxiter=1000)
    sol["bsr"] = np.asarray(res.x)[:n]
    for name in ("ell", "dia", "bsr"):
        np.testing.assert_allclose(sol[name], sol["csr"], rtol=1e-8,
                                   atol=1e-10)


def test_jacobi_pcg_reduces_iterations(rng):
    """PCG on an ill-scaled SPD matrix needs strictly fewer iterations."""
    import scipy.sparse as sp
    n = 200
    s = random_spd_csr(n, 0.05, rng)
    scale = sp.diags(np.logspace(0, 4, n))
    s = (scale @ s @ scale).tocsr()  # badly scaled, still SPD
    a = csr_from_scipy(s)
    b = rng.standard_normal(n)

    plain = cg_solve(a, jnp.asarray(b), tol=1e-8, maxiter=5000)
    pcg = cg_solve(a, jnp.asarray(b), tol=1e-8, maxiter=5000,
                   preconditioner=JacobiPrecond.from_matrix(a))
    assert bool(pcg.converged)
    assert int(pcg.iterations) < int(plain.iterations)
    x = np.asarray(pcg.x)
    assert np.linalg.norm(b - s @ x) <= 1e-6 * np.linalg.norm(b)


def test_block_jacobi_beats_jacobi_on_block_structure(rng):
    a_csr = poisson2d(20, 20)
    b = rng.standard_normal(400)
    jac = cg_solve(a_csr, jnp.asarray(b), tol=1e-9, maxiter=2000,
                   preconditioner=JacobiPrecond.from_matrix(a_csr))
    bj = cg_solve(a_csr, jnp.asarray(b), tol=1e-9, maxiter=2000,
                  preconditioner=BlockJacobiPrecond.from_matrix(
                      a_csr, blocksize=20))
    assert bool(bj.converged)
    assert int(bj.iterations) <= int(jac.iterations)
    x = np.asarray(bj.x)
    r = b - np.asarray(spmv(a_csr, jnp.asarray(x)))
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b)


def test_cg_zero_rhs_returns_zero():
    a = poisson2d(8, 8)
    res = cg_solve(a, jnp.zeros(64), tol=1e-6)
    assert int(res.iterations) == 0
    np.testing.assert_array_equal(np.asarray(res.x), 0.0)


def test_cg_with_x0():
    a = poisson2d(10, 10)
    n = 100
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n)
    x_star = np.asarray(cg_solve(a, jnp.asarray(b), tol=1e-12).x)
    # Warm start at the solution: should take 0 iterations.
    res = cg_solve(a, jnp.asarray(b), x0=jnp.asarray(x_star), tol=1e-6)
    assert int(res.iterations) == 0


def test_cg_under_jit_and_maxiter_cap():
    a = poisson2d(16, 16)
    b = jnp.ones(256)

    @jax.jit
    def solve(a, b):
        return cg_solve(a, b, tol=1e-10, maxiter=5)

    res = solve(a, b)
    assert int(res.iterations) == 5
    assert not bool(res.converged)


def test_cg_anorm_error_monotone(rng):
    """Property: CG's A-norm error decreases monotonically."""
    n = 60
    s = random_spd_csr(n, 0.1, rng)
    a = csr_from_scipy(s)
    b = rng.standard_normal(n)
    x_star = np.linalg.solve(s.toarray(), b)

    errs = []
    for k in range(1, 12):
        x = np.asarray(cg_solve(a, jnp.asarray(b), tol=0.0, maxiter=k).x)
        e = x - x_star
        errs.append(float(e @ (s @ e)))
    assert all(e2 <= e1 * (1 + 1e-10) for e1, e2 in zip(errs, errs[1:]))


def test_cg_finite_termination(rng):
    """Property: exact-arithmetic proxy — tiny SPD system solved in <= n."""
    n = 24
    s = random_spd_csr(n, 0.3, rng)
    a = csr_from_scipy(s)
    b = rng.standard_normal(n)
    res = cg_solve(a, jnp.asarray(b), tol=1e-13, maxiter=n + 5)
    x = np.asarray(res.x)
    assert np.linalg.norm(b - s @ x) <= 1e-10 * np.linalg.norm(b)


def test_cg_3d_poisson_small():
    """North-star config 2 (downscaled): 3D 7-point Poisson."""
    a = poisson3d(12, 12, 12)
    n = a.shape[0]
    b = np.ones(n)
    res = cg_solve(a, jnp.asarray(b), tol=1e-8)
    assert bool(res.converged)
    x = np.asarray(res.x)
    r = b - np.asarray(spmv(a, jnp.asarray(x)))
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b)


def test_single_reduction_cg_matches_standard(rng):
    import cgx
    from cgx.io.poisson import poisson2d
    a = poisson2d(16, 16)
    b = jnp.asarray(rng.standard_normal(256))
    ref = cgx.cg_solve(a, b, tol=1e-9, maxiter=1000)
    res = cgx.cg_solve_single_reduction(a, b, tol=1e-9, maxiter=1000)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 3
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-9)


def test_single_reduction_cg_preconditioned(rng):
    import cgx
    from cgx.io.poisson import poisson2d
    a = poisson2d(20, 20)
    b = jnp.asarray(rng.standard_normal(400))
    m = cgx.JacobiPrecond.from_matrix(a)
    ref = cgx.cg_solve(a, b, tol=1e-9, maxiter=1000, preconditioner=m)
    res = cgx.cg_solve_single_reduction(a, b, tol=1e-9, maxiter=1000,
                                        preconditioner=m)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 3


def test_single_reduction_cg_sharded_one_psum_per_iter(rng):
    """HLO check: the sharded single-reduction loop body has ONE all-reduce."""
    import jax, cgx, re
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from cgx.dist.halo import local_matvec
    from cgx.dist.partition import partition_dia, pad_vector
    from cgx.dist.solve import make_row_mesh, operator_specs
    from cgx.io.poisson import poisson2d_dia

    mesh = make_row_mesh(8)
    a = poisson2d_dia(16, 16)
    part = partition_dia(a, 8)
    b = pad_vector(jnp.ones(256), part.n_padded)
    specs = operator_specs(part)

    def local_solve_sr(a_loc, b_loc):
        mv = partial(local_matvec, a_loc, axis_name="rows")
        return cgx.cg_solve_single_reduction(
            mv, b_loc, tol=1e-8, maxiter=600, axis_name="rows").x

    def local_solve_std(a_loc, b_loc):
        mv = partial(local_matvec, a_loc, axis_name="rows")
        return cgx.cg_solve(mv, b_loc, tol=1e-8, maxiter=600,
                            axis_name="rows").x

    def n_allreduce(fn):
        g = jax.shard_map(fn, mesh=mesh, in_specs=(specs, P("rows")),
                          out_specs=P("rows"))
        hlo = jax.jit(g).lower(part, b).compile().as_text()
        return hlo.count("all-reduce("), g

    n_sr, f = n_allreduce(local_solve_sr)
    n_std, _ = n_allreduce(local_solve_std)
    # Standard CG: 2 dependent all-reduces per iteration; single-reduction:
    # 1 fused one.  Compare whole-module counts (init included in both).
    assert n_sr < n_std, f"single-reduction {n_sr} !< standard {n_std}"

    # And it solves correctly.
    x = np.asarray(jax.jit(f)(part, b))[:256]
    from cgx.ops.spmv import spmv
    from cgx.io.poisson import poisson2d
    r = np.ones(256) - np.asarray(spmv(poisson2d(16, 16),
                                       jnp.asarray(x, jnp.float64)))
    assert np.linalg.norm(r) <= 1e-6 * 16


def test_cg_solve_multi(rng):
    from cgx.solve.block import cg_solve_multi
    from cgx.io.poisson import poisson2d
    import cgx
    a = poisson2d(12, 12)
    n, k = 144, 5
    b = jnp.asarray(rng.standard_normal((n, k)))
    res = cg_solve_multi(a, b, tol=1e-10, maxiter=1000,
                         preconditioner=cgx.JacobiPrecond.from_matrix(a))
    assert res.x.shape == (n, k)
    assert res.converged.shape == (k,)
    assert bool(res.converged.all())
    for j in range(k):
        ref = cgx.cg_solve(a, b[:, j], tol=1e-10, maxiter=1000,
                           preconditioner=cgx.JacobiPrecond.from_matrix(a))
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(ref.x), rtol=1e-9, atol=1e-11)


def test_block_cg_matches_per_column_cg(rng):
    """True block CG (shared Krylov space) reaches the same solutions as
    independent per-column CG on an SPD operator."""
    from cgx.solve.block import block_cg_solve
    from cgx.io.poisson import poisson2d
    import cgx
    a = poisson2d(12, 12)
    n, k = 144, 4
    b = jnp.asarray(rng.standard_normal((n, k)))
    res = block_cg_solve(a, b, tol=1e-9, maxiter=500)
    assert res.x.shape == (n, k)
    assert bool(res.converged.all())
    for j in range(k):
        ref = cgx.cg_solve(a, b[:, j], tol=1e-12, maxiter=1000)
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(ref.x), rtol=1e-6, atol=1e-8)


def test_block_cg_fewer_iterations_than_single(rng):
    """The k-dimensional search space must pay off: block CG on k
    clustered RHS converges in strictly fewer iterations than
    single-RHS CG on any one of them (spectral deflation effect)."""
    from cgx.solve.block import block_cg_solve
    from cgx.io.poisson import poisson2d
    import cgx
    a = poisson2d(24, 24)
    n, k = 576, 8
    base = rng.standard_normal(n)
    b = np.stack([base + 0.05 * rng.standard_normal(n)
                  for _ in range(k)], axis=1)
    b = jnp.asarray(b)
    res = block_cg_solve(a, b, tol=1e-8, maxiter=2000)
    assert bool(res.converged.all())
    single = cgx.cg_solve(a, b[:, 0], tol=1e-8, maxiter=2000)
    assert int(res.iterations[0]) < int(single.iterations)


def test_block_cg_preconditioned(rng):
    from cgx.solve.block import block_cg_solve
    from cgx.io.poisson import poisson2d
    import cgx
    a = poisson2d(16, 16)
    n, k = 256, 3
    b = jnp.asarray(rng.standard_normal((n, k)))
    m = cgx.JacobiPrecond.from_matrix(a)
    plain = block_cg_solve(a, b, tol=1e-9, maxiter=500)
    pre = block_cg_solve(a, b, tol=1e-9, maxiter=500, preconditioner=m)
    assert bool(pre.converged.all())
    assert int(pre.iterations[0]) <= int(plain.iterations[0])
    np.testing.assert_allclose(np.asarray(pre.x), np.asarray(plain.x),
                               rtol=1e-6, atol=1e-8)


def test_block_cg_under_jit(rng):
    from cgx.solve.block import block_cg_solve
    from cgx.io.poisson import poisson2d
    a = poisson2d(10, 10)
    b = jnp.asarray(rng.standard_normal((100, 2)))
    res = jax.jit(lambda bb: block_cg_solve(a, bb, tol=1e-8,
                                            maxiter=300))(b)
    assert bool(res.converged.all())


def test_solve_clean_under_debug_nans(rng):
    """Sanitizer gate (SURVEY.md §5.b): the whole solve path is NaN-free
    under jax_debug_nans (which would raise on any NaN intermediate)."""
    from cgx.io.poisson import poisson2d
    import cgx
    a = poisson2d(10, 10)
    b = jnp.asarray(rng.standard_normal(100))
    with jax.debug_nans(True):
        res = cg_solve(a, b, tol=1e-8, maxiter=500,
                       preconditioner=cgx.JacobiPrecond.from_matrix(a))
        jax.block_until_ready(res.x)
    assert bool(res.converged)


def test_auto_solve_routes_and_matches(rng):
    """auto_solve matches cg_solve on stored and matrix-free operators."""
    import cgx
    from cgx.io.poisson import poisson2d
    from cgx.sparse.stencil import poisson3d_stencil
    a = poisson2d(11, 13)
    b = jnp.asarray(rng.standard_normal(143))
    ref = cgx.cg_solve(a, b, tol=1e-10, maxiter=500)
    res = cgx.auto_solve(a, b, tol=1e-10, maxiter=500)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)

    s = poisson3d_stencil(8, 8, 8)
    b2 = jnp.asarray(rng.standard_normal(512), jnp.float32)
    res2 = cgx.auto_solve(s, b2, tol=1e-5, maxiter=500)
    assert bool(res2.converged)


def test_cg_bf16_solve(rng):
    """bf16 path: converges at loose tolerance (serving-grade precision)."""
    import cgx
    from cgx.io.poisson import poisson2d_dia
    a = poisson2d_dia(16, 16).astype(jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(256), jnp.bfloat16)
    res = cgx.cg_solve(a, b, tol=3e-2, maxiter=500)
    assert bool(res.converged)
    x = np.asarray(res.x, dtype=np.float64)
    from cgx.io.poisson import poisson2d
    from cgx.ops.spmv import spmv
    r = np.asarray(b, np.float64) - np.asarray(
        spmv(poisson2d(16, 16), jnp.asarray(x)))
    assert np.linalg.norm(r) <= 0.1 * np.linalg.norm(np.asarray(b, np.float64))


def test_chebyshev_solver(rng):
    """Chebyshev: converges with estimated bounds; zero reductions/iter
    (HLO-checked on the sharded variant is future work; here numerics)."""
    from cgx.solve.chebyshev import chebyshev_solve, estimate_bounds
    from cgx.io.poisson import poisson2d
    a = poisson2d(16, 16)
    b = jnp.asarray(rng.standard_normal(256))
    lmin, lmax = estimate_bounds(a, 256, iters=50)
    assert 0 < float(lmin) < 0.074          # below true lambda_min
    assert float(lmax) > 7.9                # above true lambda_max
    res = chebyshev_solve(a, b, lmin, lmax, tol=1e-8, maxiter=5000)
    assert bool(res.converged)
    r = np.asarray(b) - np.asarray(spmv(a, res.x))
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(np.asarray(b))


def test_chebyshev_preconditioned(rng):
    import cgx
    from cgx.solve.chebyshev import chebyshev_solve
    from cgx.io.poisson import poisson2d
    import scipy.sparse as sp
    n = 256
    s_mat = poisson2d(16, 16)
    # Jacobi-preconditioned spectrum of D^-1 A for Poisson is A/4.
    m = cgx.JacobiPrecond.from_matrix(s_mat)
    res = chebyshev_solve(s_mat, jnp.ones(n), 0.074 / 4, 8.0 / 4,
                          tol=1e-8, maxiter=5000, preconditioner=m)
    assert bool(res.converged)


def test_chebyshev_degenerate_point_spectrum(rng):
    """lam_min == lam_max (A = c*I) must not divide by zero (ADVICE r1):
    the first step is exact and the solve converges without NaNs."""
    from cgx.solve.chebyshev import chebyshev_solve
    n = 64
    c = 3.0
    b = jnp.asarray(rng.standard_normal(n))
    res = chebyshev_solve(lambda v: c * v, b, c, c, tol=1e-10, maxiter=50)
    assert bool(res.converged)
    assert np.all(np.isfinite(np.asarray(res.x)))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(b) / c,
                               rtol=1e-12)


def test_pipelined_cg_matches_standard(rng):
    """Ghysels–Vanroose pipelined CG: same trajectory as CG up to the
    documented pipelined rounding drift (a few extra iterations)."""
    import cgx
    from cgx.io.poisson import poisson2d
    a = poisson2d(16, 16)
    b = jnp.asarray(rng.standard_normal(256))
    ref = cgx.cg_solve(a, b, tol=1e-9, maxiter=1000)
    res = cgx.cg_solve_pipelined(a, b, tol=1e-9, maxiter=1000)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 5
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-6, atol=1e-8)


def test_pipelined_cg_preconditioned_and_x0(rng):
    import cgx
    from cgx.io.poisson import poisson2d
    a = poisson2d(20, 20)
    b = jnp.asarray(rng.standard_normal(400))
    m = cgx.JacobiPrecond.from_matrix(a)
    x0 = jnp.asarray(rng.standard_normal(400)) * 0.1
    ref = cgx.cg_solve(a, b, x0, tol=1e-9, maxiter=1000, preconditioner=m)
    res = cgx.cg_solve_pipelined(a, b, x0, tol=1e-9, maxiter=1000,
                                 preconditioner=m)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 5
    r = np.asarray(b) - np.asarray(spmv(a, res.x))
    assert np.linalg.norm(r) <= 1.1e-9 * np.linalg.norm(np.asarray(b))


def test_pipelined_cg_adaptive_replacement_extends_fp32_envelope(rng):
    """van der Vorst–Ye adaptive replacement (ROADMAP #13): at 128²
    Poisson / fp32 / tol=1e-6 (κ ≈ 1.3·10⁴) the periodic form stalls at
    the fp32 floor (converged=False via the stagnation guard) while the
    adaptive form converges at ≈ standard CG's iteration count — and its
    TRUE residual is strictly better than standard CG's (replacement
    keeps the recurrence honest while it still converges)."""
    import cgx
    from cgx.io.poisson import poisson2d
    side = 128
    n = side * side
    a = poisson2d(side, side, dtype=np.float32)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)

    ref = cgx.cg_solve(a, b, tol=1e-6, maxiter=5000)
    per = cgx.cg_solve_pipelined(a, b, tol=1e-6, maxiter=5000)
    ada = cgx.cg_solve_pipelined(a, b, tol=1e-6, maxiter=5000,
                                 adaptive_replace=True)
    assert bool(ref.converged)
    assert not bool(per.converged)      # the documented periodic plateau
    assert bool(ada.converged)
    # Near-CG iteration count (measured +0.6% at this size; allow slack).
    assert int(ada.iterations) <= int(ref.iterations) * 1.25

    bn = np.linalg.norm(np.asarray(b))

    def true_rel(x):
        return float(np.linalg.norm(
            np.asarray(b) - np.asarray(spmv(a, x)))) / bn

    assert true_rel(ada.x) < true_rel(ref.x)


def test_pipelined_cg_adaptive_fp64_matches_cg(rng):
    """fp64: drift never reaches the √ε threshold on a well-conditioned
    system — adaptive replacement must be a no-op (CG trajectory)."""
    import cgx
    from cgx.io.poisson import poisson2d
    a = poisson2d(16, 16)
    b = jnp.asarray(rng.standard_normal(256))
    ref = cgx.cg_solve(a, b, tol=1e-9, maxiter=1000)
    res = cgx.cg_solve_pipelined(a, b, tol=1e-9, maxiter=1000,
                                 adaptive_replace=True)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 5
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-6, atol=1e-8)


def test_pipelined_cg_sharded_one_psum_overlappable(rng):
    """Sharded pipelined CG: ONE all-reduce per iteration, and the loop
    body's matvec does not depend on it (the overlap structure)."""
    import jax, cgx
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from cgx.dist.halo import local_matvec
    from cgx.dist.partition import partition_dia, pad_vector
    from cgx.dist.solve import make_row_mesh, operator_specs
    from cgx.io.poisson import poisson2d_dia

    mesh = make_row_mesh(8)
    a = poisson2d_dia(16, 16)
    part = partition_dia(a, 8)
    b = pad_vector(jnp.ones(256), part.n_padded)
    specs = operator_specs(part)

    def local_solve(a_loc, b_loc):
        mv = partial(local_matvec, a_loc, axis_name="rows")
        return cgx.cg_solve_pipelined(mv, b_loc, tol=1e-8, maxiter=600,
                                      axis_name="rows").x

    # Structural check with replacement off (the replacement branch adds
    # its own refresh all-reduce to the module, which would confound the
    # whole-module count; the steady-state body is what matters).
    def local_solve_norep(a_loc, b_loc):
        mv = partial(local_matvec, a_loc, axis_name="rows")
        return cgx.cg_solve_pipelined(mv, b_loc, tol=1e-8, maxiter=600,
                                      axis_name="rows", replace_every=0).x

    hlo = jax.jit(jax.shard_map(
        local_solve_norep, mesh=mesh, in_specs=(specs, P("rows")),
        out_specs=P("rows"))).lower(part, b).compile().as_text()

    def std(a_loc, b_loc):
        mv = partial(local_matvec, a_loc, axis_name="rows")
        return cgx.cg_solve(mv, b_loc, tol=1e-8, maxiter=600,
                            axis_name="rows").x
    hlo_std = jax.jit(jax.shard_map(
        std, mesh=mesh, in_specs=(specs, P("rows")),
        out_specs=P("rows"))).lower(part, b).compile().as_text()
    assert hlo.count("all-reduce(") < hlo_std.count("all-reduce(")

    g = jax.shard_map(local_solve, mesh=mesh, in_specs=(specs, P("rows")),
                      out_specs=P("rows"))

    x = np.asarray(jax.jit(g)(part, b))[:256]
    from cgx.io.poisson import poisson2d
    r = np.ones(256) - np.asarray(spmv(poisson2d(16, 16),
                                       jnp.asarray(x, jnp.float64)))
    assert np.linalg.norm(r) <= 1e-6 * 16


def test_dist_cg_solve_method_pipelined(rng):
    """dist_cg_solve(method="pipelined") end-to-end on the virtual mesh."""
    from cgx.dist.partition import partition_dia
    from cgx.dist.solve import dist_cg_solve, make_row_mesh
    from cgx.io.poisson import poisson2d_dia
    import cgx

    mesh = make_row_mesh(8)
    a = poisson2d_dia(16, 16)
    part = partition_dia(a, 8)
    b = jnp.asarray(rng.standard_normal(256))
    res = dist_cg_solve(part, b, mesh, tol=1e-8, maxiter=600,
                        preconditioner="jacobi", method="pipelined")
    assert bool(res.converged)
    ref = cgx.cg_solve(a, b, tol=1e-8, maxiter=600,
                       preconditioner=cgx.JacobiPrecond.from_matrix(a))
    assert abs(int(res.iterations) - int(ref.iterations)) <= 5
    # Adaptive replacement composes with the sharded path (fp64 here, so
    # it is a behavioral no-op — trajectory still matches CG).
    ada = dist_cg_solve(part, b, mesh, tol=1e-8, maxiter=600,
                        preconditioner="jacobi", method="pipelined",
                        adaptive_replace=True)
    assert bool(ada.converged)
    assert abs(int(ada.iterations) - int(ref.iterations)) <= 5


def test_analytic_bounds_exact_2d_3d():
    """Closed-form extreme eigenvalues match dense eigvalsh exactly
    (tensor-product Dirichlet stencils — VERDICT r2 #8)."""
    import math
    import scipy.sparse as sp

    from cgx.io.poisson import poisson2d, poisson3d_dia
    from cgx.solve.chebyshev import analytic_bounds
    from cgx.sparse.stencil import Stencil2D, Stencil3D

    # 2-D 5-point (stencil object)
    s2 = Stencil2D(nx=9, ny=7, c_center=4.0, c_x=-1.0, c_y=-1.0)
    lo, hi = analytic_bounds(s2)
    ax = sp.diags([-np.ones(8), 2 * np.ones(9), -np.ones(8)],
                  [-1, 0, 1]).toarray()
    ay = sp.diags([-np.ones(6), 2 * np.ones(7), -np.ones(6)],
                  [-1, 0, 1]).toarray()
    a = np.kron(ax, np.eye(7)) + np.kron(np.eye(9), ay)
    ev = np.linalg.eigvalsh(a)
    np.testing.assert_allclose([lo, hi], [ev[0], ev[-1]], rtol=1e-12)

    # anisotropic 3-D 7-point (stencil object)
    s3 = Stencil3D(nx=5, ny=4, nz=6, c_center=2 * (3.0 + 1.0 + 0.25),
                   c_x=-3.0, c_y=-1.0, c_z=-0.25)
    lo, hi = analytic_bounds(s3)
    exp_lo = s3.c_center - 2 * (3.0 * math.cos(math.pi / 6)
                                + 1.0 * math.cos(math.pi / 5)
                                + 0.25 * math.cos(math.pi / 7))
    exp_hi = s3.c_center + 2 * (3.0 * math.cos(math.pi / 6)
                                + 1.0 * math.cos(math.pi / 5)
                                + 0.25 * math.cos(math.pi / 7))
    np.testing.assert_allclose([lo, hi], [exp_lo, exp_hi], rtol=1e-12)

    # constant-coefficient DIA Poisson (what the CLI passes)
    d3 = poisson3d_dia(6, 5, 4, dtype=np.float32)
    lo, hi = analytic_bounds(d3)
    exp_lo = 6.0 - 2 * (math.cos(math.pi / 7) + math.cos(math.pi / 6)
                        + math.cos(math.pi / 5))
    exp_hi = 6.0 + 2 * (math.cos(math.pi / 7) + math.cos(math.pi / 6)
                        + math.cos(math.pi / 5))
    np.testing.assert_allclose([lo, hi], [exp_lo, exp_hi], rtol=1e-6)

    # (poisson2d returns CSR — no analytic form by design)
    assert analytic_bounds(poisson2d(8, 8)) is None


def test_analytic_bounds_rejects_nonstencil(rng):
    """Variable coefficients / general CSR → None (fall back to power
    iteration)."""
    from conftest import random_spd_csr
    from cgx.solve.chebyshev import analytic_bounds
    from cgx.sparse.types import csr_from_scipy

    a = csr_from_scipy(random_spd_csr(40, 0.1, rng))
    assert analytic_bounds(a) is None

    import cgx
    from cgx.io.poisson import poisson3d_dia
    import dataclasses
    d = poisson3d_dia(5, 4, 3, dtype=np.float32)
    data = np.asarray(d.data).copy()
    data[3, 7] *= 1.5          # perturb a main-diagonal entry -> variable
    d_var = dataclasses.replace(d, data=jnp.asarray(data))
    assert analytic_bounds(d_var) is None


def test_chebyshev_with_analytic_bounds(rng):
    """Chebyshev with the closed-form bounds converges — no power
    iteration spent — and beats the estimated-bounds iteration count."""
    from cgx.io.poisson import poisson2d
    from cgx.solve.chebyshev import (analytic_bounds, chebyshev_solve,
                                     estimate_bounds)

    from cgx.sparse.stencil import Stencil2D
    a = Stencil2D(nx=16, ny=16, c_center=4.0, c_x=-1.0, c_y=-1.0,
                  dtype_name="float64")
    b = jnp.asarray(rng.standard_normal(256))
    lo, hi = analytic_bounds(a)
    res = chebyshev_solve(a, b, lo, hi, tol=1e-8, maxiter=5000)
    assert bool(res.converged)
    r = np.asarray(b) - np.asarray(spmv(a, res.x))
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(np.asarray(b))

    lmin, lmax = estimate_bounds(a, 256, iters=50, dtype=b.dtype)
    res_est = chebyshev_solve(a, b, lmin, lmax, tol=1e-8, maxiter=5000)
    # exact bounds -> tighter interval -> no more iterations than the
    # deliberately-widened estimate
    assert int(res.iterations) <= int(res_est.iterations)


def test_estimate_bounds_respects_dtype(rng):
    """estimate_bounds draws its start vector in the operand dtype
    (VERDICT r2 weak #6)."""
    from cgx.io.poisson import poisson2d
    from cgx.solve.chebyshev import estimate_bounds

    a = poisson2d(8, 8)
    lmin, lmax = estimate_bounds(
        lambda v: spmv(a, v.astype(jnp.float32)).astype(v.dtype),
        64, dtype=jnp.bfloat16)
    assert lmin.dtype == jnp.bfloat16 and lmax.dtype == jnp.bfloat16
    from cgx.io.poisson import poisson3d_dia
    a32 = poisson3d_dia(4, 4, 4, dtype=np.float32)
    lmin32, lmax32 = estimate_bounds(a32, 64, dtype=jnp.float32)
    assert lmin32.dtype == jnp.float32


# -- convergence is judged on the true residual ------------------------------

def _true_rel(a, b, x):
    import scipy.sparse as sp
    a_sp = sp.csr_matrix((np.asarray(a.values, np.float64),
                          np.asarray(a.col_indices), np.asarray(a.indptr)),
                         shape=a.shape)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - a_sp @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def _fp32_poisson(side, seed=0):
    a = poisson2d(side, side, dtype=np.float32)
    b = jnp.asarray(np.random.default_rng(seed).standard_normal(side * side),
                    jnp.float32)
    return a, b


def _solvers():
    import cgx
    from cgx.solve.chebyshev import analytic_bounds, chebyshev_solve

    def cheb(a, b, tol):
        from cgx.sparse.stencil import poisson2d_stencil
        lo, hi = analytic_bounds(poisson2d_stencil(128, 128))
        return chebyshev_solve(a, b, lo, hi, tol=tol, maxiter=20000)

    return {
        "cg": lambda a, b, tol: cg_solve(a, b, tol=tol, maxiter=5000),
        "single_reduction": lambda a, b, tol: cgx.cg_solve_single_reduction(
            a, b, tol=tol, maxiter=5000),
        "pipelined": lambda a, b, tol: cgx.cg_solve_pipelined(
            a, b, tol=tol, maxiter=5000, adaptive_replace=True),
        "chebyshev": cheb,
        "multi": lambda a, b, tol: cgx.cg_solve_multi(
            a, jnp.stack([b, -b], axis=1), tol=tol, maxiter=5000),
        "block": lambda a, b, tol: cgx.block_cg_solve(
            a, jnp.stack([b, b[::-1]], axis=1), tol=tol, maxiter=5000),
    }


@pytest.mark.parametrize("name", ["cg", "single_reduction", "pipelined",
                                  "chebyshev", "multi", "block"])
def test_fp32_solvers_report_true_residual(name):
    """128² Poisson in fp32 at tol 1e-6: the recurrence alone ends ~10x
    off the true residual; every solver reports the true residual and
    claims convergence only within TRUE_SLACK of the tolerance."""
    from cgx.solve.cg import TRUE_SLACK
    a, b = _fp32_poisson(128)
    tol = 1e-6
    res = _solvers()[name](a, b, tol)
    x = np.asarray(res.x)
    bs = np.asarray(b)
    if name == "multi":
        bs = np.stack([bs, -bs], axis=1)
    elif name == "block":
        bs = np.stack([bs, bs[::-1]], axis=1)
    cols = range(x.shape[1]) if x.ndim == 2 else [None]
    for j, conv, rn in zip(cols, np.atleast_1d(np.asarray(res.converged)),
                           np.atleast_1d(np.asarray(res.residual_norm))):
        xj, bj = (x, bs) if j is None else (x[:, j], bs[:, j])
        true = _true_rel(a, bj, xj)
        reported = float(rn) / float(np.linalg.norm(bj))
        np.testing.assert_allclose(reported, true, rtol=0.2)
        assert bool(conv), name
        assert true <= TRUE_SLACK * tol


def test_restarts_close_the_fp32_drift():
    """The first pass ends with the true residual ~7x above tol on 64²;
    restarting from it reaches the tolerance itself in a few extra
    iterations, and restarts=0 keeps the single pass, reported honestly."""
    a, b = _fp32_poisson(64)
    once = cg_solve(a, b, tol=1e-6, maxiter=2000, restarts=0)
    settled = cg_solve(a, b, tol=1e-6, maxiter=2000)
    t_once = _true_rel(a, b, once.x)
    t_settled = _true_rel(a, b, settled.x)
    assert t_once > 3e-6                       # the recurrence drifted
    np.testing.assert_allclose(
        float(once.residual_norm) / float(jnp.linalg.norm(b)), t_once,
        rtol=0.05)
    assert t_settled <= 1e-6 * 1.05
    assert 0 < int(settled.iterations) - int(once.iterations) <= 20
    assert bool(once.converged) and bool(settled.converged)


def test_stalled_fp32_solve_reports_not_converged():
    """An fp32 iterate that stalls well above tol (thermal2 stand-in,
    Jacobi) is reported as not converged, with its true residual, where
    the recurrence alone would claim the tolerance."""
    import cgx
    from cgx.io.suitesparse import standin
    a64 = standin("thermal2", seed=0, scale=0.01)
    a = a64.astype(jnp.float32)
    b = jnp.asarray(np.random.default_rng(1).standard_normal(a.shape[0]),
                    jnp.float32)
    m = cgx.JacobiPrecond.from_matrix(a)
    once = cg_solve(a, b, tol=1e-6, maxiter=20000, preconditioner=m,
                    restarts=0)
    res = cg_solve(a, b, tol=1e-6, maxiter=20000, preconditioner=m)
    true = _true_rel(a64, b, res.x)
    assert _true_rel(a64, b, once.x) > 10e-6
    assert not bool(res.converged)
    np.testing.assert_allclose(
        float(res.residual_norm) / float(jnp.linalg.norm(b)), true,
        rtol=0.2)


def test_settle_is_a_noop_when_the_recurrence_is_honest(rng):
    """fp64: the true residual meets tol at the first exit, so no restart
    runs and the trajectory is plain CG's."""
    a = poisson2d(24, 24)
    b = jnp.asarray(rng.standard_normal(576))
    ref = cg_solve(a, b, tol=1e-9, maxiter=1000, restarts=0)
    res = cg_solve(a, b, tol=1e-9, maxiter=1000)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
