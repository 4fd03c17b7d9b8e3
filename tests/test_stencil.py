"""Matrix-free stencil operator tests: parity with the stored CSR Poisson."""
import jax
import jax.numpy as jnp
import numpy as np

from cgx.io.poisson import poisson2d, poisson3d
from cgx.ops.spmv import spmm, spmv
from cgx.solve.cg import cg_solve
from cgx.solve.precond import JacobiPrecond
from cgx.sparse.stencil import poisson2d_stencil, poisson3d_stencil


def test_stencil2d_matches_csr(rng):
    nx, ny = 13, 9
    s = poisson2d_stencil(nx, ny)
    a = poisson2d(nx, ny)
    x = jnp.asarray(rng.standard_normal(nx * ny))
    np.testing.assert_allclose(np.asarray(spmv(s, x)),
                               np.asarray(spmv(a, x)), rtol=1e-12)


def test_stencil3d_matches_csr(rng):
    nx, ny, nz = 5, 7, 6
    s = poisson3d_stencil(nx, ny, nz)
    a = poisson3d(nx, ny, nz)
    x = jnp.asarray(rng.standard_normal(nx * ny * nz))
    np.testing.assert_allclose(np.asarray(spmv(s, x)),
                               np.asarray(spmv(a, x)), rtol=1e-12)


def test_stencil_spmm(rng):
    s = poisson2d_stencil(8, 6)
    a = poisson2d(8, 6)
    x = jnp.asarray(rng.standard_normal((48, 4)))
    np.testing.assert_allclose(np.asarray(spmm(s, x)),
                               np.asarray(spmm(a, x)), rtol=1e-12)


def test_cg_on_stencil_matches_cg_on_csr(rng):
    nx, ny, nz = 8, 9, 7
    n = nx * ny * nz
    s = poisson3d_stencil(nx, ny, nz)
    a = poisson3d(nx, ny, nz)
    b = jnp.asarray(rng.standard_normal(n))
    m = JacobiPrecond.from_matrix(s)
    res_s = cg_solve(s, b, tol=1e-10, maxiter=2000, preconditioner=m)
    res_a = cg_solve(a, b, tol=1e-10, maxiter=2000,
                     preconditioner=JacobiPrecond.from_matrix(a))
    assert bool(res_s.converged)
    assert int(res_s.iterations) == int(res_a.iterations)
    np.testing.assert_allclose(np.asarray(res_s.x), np.asarray(res_a.x),
                               rtol=1e-8, atol=1e-10)


def test_stencil_is_jit_static(rng):
    """Stencil fields are static aux data — jit caches across same shapes."""
    s = poisson2d_stencil(6, 6)
    f = jax.jit(lambda s, x: spmv(s, x))
    x = jnp.asarray(rng.standard_normal(36))
    np.testing.assert_allclose(np.asarray(f(s, x)), np.asarray(spmv(s, x)),
                               rtol=1e-12)


