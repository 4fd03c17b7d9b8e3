"""Row-sharded solver matrix: every method × preconditioner × partition
layout on 4 and 8 virtual devices, held to the float64 solution and, for
CG with a shard-exact preconditioner, to the single-device trajectory."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import cgx
from cgx.dist.partition import partition_csr, partition_dia, unpad_vector
from cgx.dist.solve import dist_cg_solve, make_row_mesh
from cgx.io.poisson import poisson2d, poisson3d_dia

METHODS = ["cg", "single_reduction", "pipelined", "chebyshev"]
PRECONDS = ["none", "jacobi", "block_jacobi", "poly", "ic0_sweep"]
LAYOUTS = ["dia", "csr_halo", "csr_allgather"]


@functools.lru_cache(maxsize=None)
def _system(layout):
    """(operator, float64 scipy matrix): 256 rows, so 4 and 8 shards hold
    whole 8-row Jacobi blocks."""
    if layout == "dia":
        a = poisson3d_dia(8, 8, 4, dtype=np.float64)
        data = np.asarray(a.data)
        n = a.shape[0]
        a_sp = sp.dia_matrix(
            (np.stack([np.roll(data[k], off)
                       for k, off in enumerate(a.offsets)]), a.offsets),
            shape=(n, n)).tocsr()
        return a, a_sp
    a = poisson2d(16, 16, dtype=np.float64)
    a_sp = sp.csr_matrix((np.asarray(a.values), np.asarray(a.col_indices),
                          np.asarray(a.indptr)), shape=a.shape)
    return a, a_sp


def _partition(layout, n_shards):
    a, _ = _system(layout)
    if layout == "dia":
        return partition_dia(a, n_shards)
    return partition_csr(a, n_shards, mode=layout.split("_")[1])


def _single_device_precond(kind, a, a_sp):
    if kind == "none":
        return None
    if kind == "jacobi":
        return cgx.JacobiPrecond(inv_diag=jnp.asarray(1.0 / a_sp.diagonal()))
    return cgx.PolynomialPrecond(a, jnp.asarray(1.0 / a_sp.diagonal()),
                                 steps=3)


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("method", METHODS)
def test_dist_solve_matrix(method, precond, layout, n_dev):
    a, a_sp = _system(layout)
    n = a_sp.shape[0]
    b = np.random.default_rng(21).standard_normal(n)
    x_ref = spla.spsolve(a_sp.tocsc(), b)

    res = dist_cg_solve(_partition(layout, n_dev), jnp.asarray(b),
                        make_row_mesh(n_dev), tol=1e-10, maxiter=4000,
                        preconditioner=precond, blocksize=8, method=method)
    assert bool(res.converged)
    x = unpad_vector(np.asarray(res.x), n)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert err <= 1e-7, err

    if method == "cg" and precond in ("none", "jacobi", "poly"):
        # Shard-exact preconditioners: the sharded iteration is the
        # single-device one up to reduction order.
        one = cgx.cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=4000,
                           preconditioner=_single_device_precond(
                               precond, a, a_sp))
        assert abs(int(res.iterations) - int(one.iterations)) <= 1
