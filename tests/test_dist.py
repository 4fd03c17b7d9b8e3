"""Distributed solver tests on a virtual 8-device CPU mesh (SURVEY.md §4.3).

Asserts (a) numerical identity with the single-device path, (b) halo-exchange
correctness on stencil matrices, (c) the communication plan — 2 psums per
iteration plus halo ppermutes (not all-gathers) for banded operators —
via compiled-HLO inspection.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cgx.dist.halo import halo_exchange, local_matvec
from cgx.dist.partition import (partition_csr, partition_dia, pad_vector,
                                unpad_vector)
from cgx.dist.solve import dist_cg_solve, make_row_mesh, operator_specs
from cgx.io.poisson import poisson2d, poisson2d_dia, poisson3d_dia
from cgx.ops.spmv import spmv
from cgx.solve.cg import cg_solve
from cgx.sparse.types import csr_from_scipy

from conftest import random_spd_csr
from jax.sharding import NamedSharding, PartitionSpec as P
from functools import partial

MESH = None


def setup_module():
    global MESH
    MESH = make_row_mesh(8)


def _sharded_matvec(part, x_pad):
    specs = operator_specs(part)
    f = jax.shard_map(
        lambda a_loc, xl: local_matvec(a_loc, xl, axis_name="rows"),
        mesh=MESH, in_specs=(specs, P("rows")), out_specs=P("rows"))
    a_dev = jax.device_put(part, jax.tree.map(
        lambda s: NamedSharding(MESH, s), specs,
        is_leaf=lambda v: isinstance(v, P)))
    x_dev = jax.device_put(x_pad, NamedSharding(MESH, P("rows")))
    return np.asarray(jax.jit(f)(a_dev, x_dev))


def test_halo_exchange_correctness():
    """Each shard sees its neighbors' boundary entries at the right slots."""
    n_local, hl, hr = 4, 2, 3
    x = jnp.arange(32.0)

    f = jax.shard_map(lambda xl: halo_exchange(xl, hl, hr, "rows"),
                      mesh=MESH, in_specs=P("rows"),
                      out_specs=P("rows"))
    out = np.asarray(f(x)).reshape(8, hl + n_local + hr)
    for p in range(8):
        lo = (p * n_local - hl) % 32
        left = [(lo + i) % 32 for i in range(hl)]
        mid = list(range(p * n_local, (p + 1) * n_local))
        right = [((p + 1) * n_local + i) % 32 for i in range(hr)]
        np.testing.assert_array_equal(out[p], np.array(left + mid + right,
                                                       dtype=float))


@pytest.mark.parametrize("mode", ["halo", "allgather"])
def test_partitioned_ell_matvec_matches_global(mode, rng):
    a = poisson2d(20, 13)  # n = 260, not divisible by 8
    n = a.shape[0]
    part = partition_csr(a, 8, mode=mode)
    x = rng.standard_normal(n)
    x_pad = pad_vector(jnp.asarray(x), part.n_padded)
    got = unpad_vector(_sharded_matvec(part, x_pad), n)
    ref = np.asarray(spmv(a, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_partitioned_ell_general_matrix_allgather(rng):
    s = random_spd_csr(100, 0.15, rng)  # dense-ish pattern → full bandwidth
    a = csr_from_scipy(s)
    part = partition_csr(a, 8, mode="auto")
    assert part.mode == "allgather"
    x = rng.standard_normal(100)
    x_pad = pad_vector(jnp.asarray(x), part.n_padded)
    got = unpad_vector(_sharded_matvec(part, x_pad), 100)
    np.testing.assert_allclose(got, s @ x, rtol=1e-12, atol=1e-12)


def test_partitioned_dia_matvec_matches_global(rng):
    a = poisson2d_dia(24, 16)
    n = a.shape[0]
    part = partition_dia(a, 8)
    x = rng.standard_normal(n)
    x_pad = pad_vector(jnp.asarray(x), part.n_padded)
    got = unpad_vector(_sharded_matvec(part, x_pad), n)
    ref = np.asarray(spmv(a, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("jacobi", [False, True])
def test_dist_cg_identical_to_single_device(jacobi, rng):
    """Sharded CG == single-device CG, bit-comparable in fp64."""
    a = poisson2d(16, 16)
    n = 256
    b = rng.standard_normal(n)

    ref = cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=600,
                   preconditioner=None if not jacobi else
                   __import__("cgx").JacobiPrecond.from_matrix(a))

    part = partition_csr(a, 8)
    assert part.mode == "halo"
    res = dist_cg_solve(part, jnp.asarray(b), MESH, tol=1e-10, maxiter=600,
                        jacobi=jacobi)
    assert bool(res.converged)
    x = unpad_vector(np.asarray(res.x), n)
    np.testing.assert_allclose(x, np.asarray(ref.x), rtol=1e-9, atol=1e-11)
    # Same iteration count — the trajectories are numerically identical
    # modulo reduction order.
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2


def test_dist_cg_dia_3d_poisson(rng):
    a = poisson3d_dia(12, 10, 11)
    n = a.shape[0]
    b = rng.standard_normal(n)
    part = partition_dia(a, 8)
    res = dist_cg_solve(part, jnp.asarray(b), MESH, tol=1e-9, jacobi=True,
                        maxiter=2000)
    assert bool(res.converged)
    x = unpad_vector(np.asarray(res.x), n)
    from cgx.io.poisson import poisson3d
    s = poisson3d(12, 10, 11)
    r = b - np.asarray(spmv(s, jnp.asarray(x)))
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b)


def test_dist_cg_history_tracks(rng):
    a = poisson2d_dia(16, 16)
    b = rng.standard_normal(256)
    part = partition_dia(a, 8)
    res = dist_cg_solve(part, jnp.asarray(b), MESH, tol=0.0, maxiter=30,
                        track_history=True)
    hist = np.asarray(res.history)
    assert hist.shape == (31,)
    ref = cg_solve(poisson2d(16, 16), jnp.asarray(b), tol=0.0, maxiter=30,
                   track_history=True)
    np.testing.assert_allclose(hist, np.asarray(ref.history), rtol=1e-8)


def test_halo_mode_emits_no_allgather():
    """Communication plan check: banded operator uses ppermute halos and
    psum scalars only — no all-gather of the iterate (SURVEY.md §4.3c)."""
    a = poisson2d_dia(16, 16)
    part = partition_dia(a, 8)
    b = jnp.ones(256)

    from cgx.dist.solve import operator_specs, AXIS
    specs = operator_specs(part)
    b_pad = pad_vector(b, part.n_padded)

    def local_solve(a_loc, b_loc):
        mv = partial(local_matvec, a_loc, axis_name="rows")
        return cg_solve(mv, b_loc, tol=1e-6, maxiter=50, axis_name="rows").x

    f = jax.shard_map(local_solve, mesh=MESH, in_specs=(specs, P("rows")),
                      out_specs=P("rows"))
    hlo = jax.jit(f).lower(part, b_pad).compile().as_text()
    assert "all-gather" not in hlo, "halo mode must not all-gather x"
    assert "collective-permute" in hlo
    assert "all-reduce" in hlo  # the psum dots


def test_launch_single_process_noop():
    from cgx.dist.launch import initialize, is_multihost
    initialize()  # must no-op without coordinator config
    assert not is_multihost()


def test_profiling_stats():
    from cgx.utils.profiling import solve_stats
    s = solve_stats(0.1, 100, 14_581_760, bytes_per_iter=16 * 2**20)
    assert abs(s["gnnz_per_s"] - 14.58176) < 0.01
    assert s["s_per_iter"] == 0.001


def test_2d_partition_matvec_matches_global(rng):
    from cgx.dist.grid2d import (make_grid_mesh, matvec_2d,
                                 partition_csr_2d, ROWS, COLS)
    a = poisson2d(14, 13)   # n=182, not divisible by 2
    n = a.shape[0]
    part = partition_csr_2d(a, 2)
    mesh = make_grid_mesh(2)
    x = rng.standard_normal(n)
    x_pad = jnp.pad(jnp.asarray(x), (0, part.n_padded - n))

    op_spec = jax.tree.map(lambda l: P(ROWS, COLS, None, None), part)
    f = jax.shard_map(matvec_2d, mesh=mesh, in_specs=(op_spec, P(ROWS)),
                      out_specs=P(ROWS))
    got = np.asarray(jax.jit(f)(part, x_pad))[:n]
    ref = np.asarray(spmv(a, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("jacobi", [False, True])
def test_2d_cg_matches_single_device(jacobi, rng):
    from cgx.dist.grid2d import (dist_cg_solve_2d, make_grid_mesh,
                                 partition_csr_2d)
    a = poisson2d(16, 16)
    n = 256
    b = rng.standard_normal(n)
    part = partition_csr_2d(a, 2)
    mesh = make_grid_mesh(2)
    res = dist_cg_solve_2d(part, jnp.asarray(b), mesh, tol=1e-10,
                           maxiter=600, jacobi=jacobi)
    assert bool(res.converged)
    ref = cg_solve(a, jnp.asarray(b), tol=1e-10, maxiter=600,
                   preconditioner=None if not jacobi else
                   __import__("cgx").JacobiPrecond.from_matrix(a))
    np.testing.assert_allclose(np.asarray(res.x)[:n], np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2


def test_dist_cg_single_reduction_method(rng):
    a = poisson2d_dia(16, 16)
    b = rng.standard_normal(256)
    part = partition_dia(a, 8)
    res = dist_cg_solve(part, jnp.asarray(b), MESH, tol=1e-10, maxiter=600,
                        jacobi=True, method="single_reduction")
    assert bool(res.converged)
    ref = dist_cg_solve(part, jnp.asarray(b), MESH, tol=1e-10, maxiter=600,
                        jacobi=True)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# Distributed preconditioner breadth (VERDICT r1 #5)
# ---------------------------------------------------------------------------

def test_dist_block_jacobi_matches_single_device(rng):
    """Sharded block-Jacobi PCG == single-device BlockJacobiPrecond PCG."""
    from cgx.solve.precond import BlockJacobiPrecond
    a = poisson2d_dia(16, 16)                 # n=256, rows_local=32
    part = partition_dia(a, 8)
    b = jnp.asarray(rng.standard_normal(256))
    res = dist_cg_solve(part, b, MESH, tol=1e-10, maxiter=400,
                        preconditioner="block_jacobi", blocksize=8)
    assert bool(res.converged)
    m = BlockJacobiPrecond.from_matrix(
        csr_from_scipy(__import__("scipy.sparse", fromlist=["x"]).csr_matrix(
            _dia_to_scipy(a))), 8)
    ref = cg_solve(a, b, tol=1e-10, maxiter=400, preconditioner=m)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x)[:256], np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)


def _dia_to_scipy(a):
    import scipy.sparse as sp
    import numpy as _np
    n = a.shape[0]
    m = sp.lil_matrix((n, n))
    data = _np.asarray(a.data)
    for k, off in enumerate(a.offsets):
        for i in range(n):
            j = i + off
            if 0 <= j < n and data[k, i] != 0:
                m[i, j] = data[k, i]
    return m.tocsr()


def test_dist_block_jacobi_ell_matches_single_device(rng):
    """Same, through the ELL (CSR-partitioned) local layout."""
    from cgx.solve.precond import BlockJacobiPrecond
    a_sp = random_spd_csr(256, 0.03, rng)
    a = csr_from_scipy(a_sp)
    part = partition_csr(a, 8)
    b = jnp.asarray(rng.standard_normal(256))
    res = dist_cg_solve(part, b, MESH, tol=1e-10, maxiter=400,
                        preconditioner="block_jacobi", blocksize=8)
    assert bool(res.converged)
    m = BlockJacobiPrecond.from_matrix(a, 8)
    ref = cg_solve(a, b, tol=1e-10, maxiter=400, preconditioner=m)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x)[:256], np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)


def test_dist_poly_precond_matches_single_device(rng):
    from cgx.solve.precond import PolynomialPrecond
    a = poisson2d_dia(16, 16)
    part = partition_dia(a, 8)
    b = jnp.asarray(rng.standard_normal(256))
    res = dist_cg_solve(part, b, MESH, tol=1e-10, maxiter=400,
                        preconditioner="poly", poly_steps=3)
    assert bool(res.converged)
    m = PolynomialPrecond.from_matrix(a, steps=3)
    ref = cg_solve(a, b, tol=1e-10, maxiter=400, preconditioner=m)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x)[:256], np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)


def test_dist_chebyshev_matches_single_device(rng):
    """method='chebyshev' under shard_map (zero per-iteration reductions)
    == single-device chebyshev_solve with the same bounds."""
    from cgx.solve.chebyshev import chebyshev_solve
    a = poisson2d_dia(16, 16)
    part = partition_dia(a, 8)
    b = jnp.asarray(rng.standard_normal(256))
    lo, hi = 0.07, 8.0
    res = dist_cg_solve(part, b, MESH, tol=1e-8, maxiter=3000,
                        method="chebyshev", lam_min=lo, lam_max=hi)
    assert bool(res.converged)
    ref = chebyshev_solve(a, b, lo, hi, tol=1e-8, maxiter=3000)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x)[:256], np.asarray(ref.x),
                               rtol=1e-8, atol=1e-10)


def test_dist_chebyshev_estimated_bounds(rng):
    """Chebyshev with distributed power-iteration bound estimation."""
    a = poisson2d_dia(16, 16)
    part = partition_dia(a, 8)
    b = jnp.asarray(rng.standard_normal(256))
    res = dist_cg_solve(part, b, MESH, tol=1e-8, maxiter=5000,
                        method="chebyshev", preconditioner="jacobi")
    assert bool(res.converged)
    x = np.asarray(res.x)[:256]
    r = np.asarray(b) - np.asarray(_dia_to_scipy(a) @ x)
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(np.asarray(b))


def test_halo_exchange_multi_step_wide_halo():
    """Halos wider than one shard (multi ring steps) deliver the exact
    neighbor entries with O(halo) traffic (VERDICT r1 weak #6)."""
    n_local, hl, hr = 4, 7, 9               # ceil(7/4)=2, ceil(9/4)=3 steps
    x = jnp.arange(32.0)
    f = jax.shard_map(lambda xl: halo_exchange(xl, hl, hr, "rows"),
                      mesh=MESH, in_specs=P("rows"), out_specs=P("rows"))
    out = np.asarray(f(x)).reshape(8, hl + n_local + hr)
    for p in range(8):
        lo = (p * n_local - hl) % 32
        left = [(lo + i) % 32 for i in range(hl)]
        mid = list(range(p * n_local, (p + 1) * n_local))
        right = [((p + 1) * n_local + i) % 32 for i in range(hr)]
        np.testing.assert_array_equal(out[p], np.array(left + mid + right,
                                                       dtype=float))


# ---------------------------------------------------------------------------
# Distributed IC(0): one-level additive Schwarz with sweep applies
# ---------------------------------------------------------------------------

def test_dist_ic0_sweep_single_shard_matches_ic0sweep(rng):
    """With one shard the Schwarz block IS the whole matrix: trajectory
    identity with the single-device IC0SweepPrecond."""
    from cgx.solve.ic0 import IC0SweepPrecond
    a = poisson2d_dia(16, 16)
    a_csr = poisson2d(16, 16)
    part = partition_dia(a, 1)
    mesh1 = make_row_mesh(1)
    b = jnp.asarray(rng.standard_normal(256))
    res = dist_cg_solve(part, b, mesh1, tol=1e-10, maxiter=400,
                        preconditioner="ic0_sweep", nsweeps=2)
    assert bool(res.converged)
    m = IC0SweepPrecond.from_matrix(a_csr, nsweeps=2)
    ref = cg_solve(a, b, tol=1e-10, maxiter=400, preconditioner=m)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x)[:256], np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)


def test_dist_ic0_sweep_8shard_matches_blockwise_reference(rng):
    """8-shard Schwarz-IC(0) trajectory == single-device PCG with the
    equivalent block-diagonal preconditioner built from the same data."""
    from cgx.dist.schwarz import ic0_sweep_blocks, sweep_apply
    a = poisson2d_dia(16, 16)                 # n=256, rl=32, no padding
    part = partition_dia(a, 8)
    blocks = ic0_sweep_blocks(part)
    b = jnp.asarray(rng.standard_normal(256))
    res = dist_cg_solve(part, b, MESH, tol=1e-10, maxiter=400,
                        preconditioner="ic0_sweep", nsweeps=1)
    assert bool(res.converged)

    def ref_apply(r):
        rp = r.reshape(part.n_shards, part.rows_local)
        return jnp.concatenate([
            sweep_apply(blocks, 1, rp[s], shard_index=s)
            for s in range(part.n_shards)])

    ref = cg_solve(a, b, tol=1e-10, maxiter=400, preconditioner=ref_apply)
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x)[:256], np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)


def test_dist_ic0_sweep_beats_jacobi_iterations(rng):
    """Block-IC(0) sweeps must cut iterations vs distributed Jacobi."""
    a = poisson2d_dia(32, 32)
    part = partition_dia(a, 8)
    b = jnp.asarray(rng.standard_normal(1024))
    it_jac = int(dist_cg_solve(part, b, MESH, tol=1e-8, maxiter=2000,
                               preconditioner="jacobi").iterations)
    res = dist_cg_solve(part, b, MESH, tol=1e-8, maxiter=2000,
                        preconditioner="ic0_sweep", nsweeps=1)
    assert bool(res.converged)
    assert int(res.iterations) < it_jac


def test_dist_ic0_sweep_ell_and_padding(rng):
    """ELL (CSR-partitioned) layout + ragged n (padding rows) both work;
    solution matches the plain single-device solve."""
    a_csr = poisson2d(15, 15)                 # n=225 → rl=29, 7 pad rows
    part = partition_csr(a_csr, 8)
    n = 225
    b = jnp.asarray(rng.standard_normal(n))
    res = dist_cg_solve(part, b, MESH, tol=1e-10, maxiter=600,
                        preconditioner="ic0_sweep", nsweeps=2)
    assert bool(res.converged)
    ref = cg_solve(a_csr, b, tol=1e-10, maxiter=600)
    np.testing.assert_allclose(np.asarray(res.x)[:n], np.asarray(ref.x),
                               rtol=1e-7, atol=1e-9)
