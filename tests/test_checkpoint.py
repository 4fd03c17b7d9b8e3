"""Checkpoint / resume tests (SURVEY.md §5.c/d)."""
import os

import jax.numpy as jnp
import numpy as np

from cgx.io.poisson import poisson2d
from cgx.solve.cg import cg_chunk, cg_init, cg_solve
from cgx.solve.precond import JacobiPrecond
from cgx.utils.checkpoint import (cg_solve_checkpointed, load_state,
                                  save_state)


def test_chunked_matches_monolithic(rng):
    a = poisson2d(12, 12)
    b = jnp.asarray(rng.standard_normal(144))
    ref = cg_solve(a, b, tol=0.0, maxiter=40)

    state = cg_init(a, b)
    for _ in range(4):
        state = cg_chunk(a, state, 10)
    assert int(state.k) == 40
    np.testing.assert_allclose(np.asarray(state.x), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-14)


def test_snapshot_roundtrip(tmp_path, rng):
    a = poisson2d(10, 10)
    b = jnp.asarray(rng.standard_normal(100))
    state = cg_chunk(a, cg_init(a, b), 7)
    p = str(tmp_path / "snap.npz")
    save_state(p, state)
    state2 = load_state(p)
    for f in ("x", "r", "z", "p"):
        np.testing.assert_array_equal(np.asarray(getattr(state, f)),
                                      np.asarray(getattr(state2, f)))
    assert int(state2.k) == 7


def test_resume_after_preemption_identical_trajectory(tmp_path, rng):
    """Kill-and-relaunch: resumed solve == uninterrupted solve."""
    a = poisson2d(14, 14)
    n = 196
    b = jnp.asarray(rng.standard_normal(n))
    m = JacobiPrecond.from_matrix(a)

    ref = cg_solve_checkpointed(a, b, tol=1e-10, maxiter=400,
                                preconditioner=m, chunk=25)

    ckpt = str(tmp_path / "cg.npz")
    seen = []

    class Preempt(Exception):
        pass

    def killer(state):
        seen.append(int(state.k))
        if len(seen) == 2:
            raise Preempt

    try:
        cg_solve_checkpointed(a, b, tol=1e-10, maxiter=400,
                              preconditioner=m, chunk=25,
                              checkpoint_path=ckpt, on_chunk=killer)
        assert False, "should have been preempted"
    except Preempt:
        pass
    assert os.path.exists(ckpt)

    res = cg_solve_checkpointed(a, b, tol=1e-10, maxiter=400,
                                preconditioner=m, chunk=25,
                                checkpoint_path=ckpt)
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-12, atol=1e-14)


def test_chunk_respects_maxiter(rng):
    a = poisson2d(8, 8)
    b = jnp.asarray(rng.standard_normal(64))
    res = cg_solve_checkpointed(a, b, tol=0.0, maxiter=33, chunk=10)
    assert int(res.iterations) == 33


def test_chunk_early_exit_on_tol(rng):
    a = poisson2d(8, 8)
    b = jnp.asarray(rng.standard_normal(64))
    state = cg_init(a, b)
    state = cg_chunk(a, state, 1000, b=b, tol=1e-10)
    ref = cg_solve(a, b, tol=1e-10, maxiter=1000)
    assert int(state.k) == int(ref.iterations)


def test_checkpointed_accepts_callable_matvec(rng):
    """`a` may be a matvec closure (not a JAX type): it must be closed
    over, not traced (ADVICE r1 TypeError at the first chunk)."""
    from conftest import random_spd_csr
    from cgx.sparse.types import csr_from_scipy
    from cgx.ops.spmv import spmv
    from cgx.utils.checkpoint import cg_solve_checkpointed
    import cgx

    a = csr_from_scipy(random_spd_csr(60, 0.1, rng))
    b = jnp.asarray(rng.standard_normal(60))
    res = cg_solve_checkpointed(lambda v: spmv(a, v), b, tol=1e-10,
                                chunk=7, maxiter=200)
    ref = cgx.cg_solve(a, b, tol=1e-10, maxiter=200)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)


import pytest




def _resume_operator(kind):
    from cgx.io.poisson import poisson3d_dia
    from cgx.sparse.stencil import poisson2d_stencil, poisson3d_stencil
    from cgx.sparse.types import ell_from_csr

    if kind == "stencil2d":
        return poisson2d_stencil(11, 9)
    if kind == "stencil3d":
        return poisson3d_stencil(6, 5, 4)
    if kind == "dia":
        return poisson3d_dia(6, 5, 4)
    if kind == "csr":
        return poisson2d(11, 9)
    return ell_from_csr(poisson2d(11, 9))


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("kind", ["stencil2d", "stencil3d", "dia", "csr",
                                  "ell"])
def test_resume_from_snapshot_bit_identical(tmp_path, kind, jacobi):
    """Stop a checkpointed solve at half its iterations, resume from the
    snapshot in a new solver: the final iterate and iteration count equal
    the uninterrupted run's exactly, on every operator kind."""
    from cgx.utils.checkpoint import make_checkpointed_solver

    a = _resume_operator(kind)
    n = a.shape[0]
    b = jnp.asarray(np.random.default_rng(8).standard_normal(n))
    m = JacobiPrecond.from_matrix(a) if jacobi else None
    full = cg_solve_checkpointed(a, b, tol=1e-10, preconditioner=m,
                                 chunk=10)
    k = int(full.iterations)
    assert bool(full.converged) and k > 20
    path = str(tmp_path / "state.npz")
    stopped = make_checkpointed_solver(
        a, tol=1e-10, maxiter=(k // 20) * 10, preconditioner=m,
        chunk=10)(b, checkpoint_path=path)
    assert int(stopped.iterations) == (k // 20) * 10
    resumed = make_checkpointed_solver(
        a, tol=1e-10, preconditioner=m, chunk=10)(b, checkpoint_path=path)
    assert int(resumed.iterations) == k
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(full.x))


def test_checkpointed_solve_settles_like_cg_solve(tmp_path):
    """fp32 64² Poisson: the recurrence alone ends ~7x off the true
    residual; the chunked solve restarts from it as cg_solve does (same
    iteration count), reports the true residual, and a resume from a
    snapshot taken mid-solve ends on the same iterate."""
    a = poisson2d(64, 64, dtype=np.float32)
    b = jnp.asarray(np.random.default_rng(3).standard_normal(4096),
                    jnp.float32)
    ref = cg_solve(a, b, tol=1e-6, maxiter=2000)
    once = cg_solve(a, b, tol=1e-6, maxiter=2000, restarts=0)
    res = cg_solve_checkpointed(a, b, tol=1e-6, maxiter=2000, chunk=50)
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations) > int(once.iterations)
    true = np.linalg.norm(np.asarray(b, np.float64) - np.asarray(
        spmv_f64(a, res.x))) / np.linalg.norm(np.asarray(b, np.float64))
    np.testing.assert_allclose(
        float(res.residual_norm) / float(jnp.linalg.norm(b)), true,
        rtol=0.05)

    path = str(tmp_path / "s.npz")
    cg_solve_checkpointed(a, b, tol=1e-6, maxiter=100, chunk=50,
                          checkpoint_path=path)
    resumed = cg_solve_checkpointed(a, b, tol=1e-6, maxiter=2000, chunk=50,
                                    checkpoint_path=path)
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(res.x))


def spmv_f64(a, x):
    import scipy.sparse as sp
    return sp.csr_matrix((np.asarray(a.values, np.float64),
                          np.asarray(a.col_indices), np.asarray(a.indptr)),
                         shape=a.shape) @ np.asarray(x, np.float64)
