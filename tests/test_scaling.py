"""Scaling harness tests (virtual mesh; analytic model checks)."""
import jax.numpy as jnp
import numpy as np

from cgx.bench.scaling import LinkModel, comm_report, measure_scaling
from cgx.dist.partition import partition_csr, partition_dia
from cgx.io.poisson import poisson2d, poisson3d_dia


def test_comm_report_halo_small_vs_allgather():
    a = poisson3d_dia(16, 16, 16)
    part = partition_dia(a, 8)
    rep = comm_report(part)
    assert rep["mode"] == "halo"
    # Halo traffic = (hl + hr) entries = 2 * 16 * 16 rows * 4 B.
    assert rep["comm_bytes_per_iter_per_chip"] == 2 * 256 * 4
    assert 0 < rep["predicted_efficiency"] <= 1.0

    # Same matrix, both comm plans: halo must move less data.
    a2 = poisson2d(64, 64)
    halo = comm_report(partition_csr(a2, 8, mode="halo"))
    ag = comm_report(partition_csr(a2, 8, mode="allgather"))
    assert ag["mode"] == "allgather" and halo["mode"] == "halo"
    assert (ag["comm_bytes_per_iter_per_chip"]
            > halo["comm_bytes_per_iter_per_chip"])


def test_comm_report_single_reduction_fewer_syncs():
    a = poisson3d_dia(12, 12, 12)
    part = partition_dia(a, 8)
    std = comm_report(part, sync_points=2)
    sr = comm_report(part, sync_points=1)
    assert sr["predicted_iter_us"] < std["predicted_iter_us"]


def test_measure_scaling_runs_on_virtual_mesh(rng):
    a = poisson3d_dia(12, 12, 12)
    b = rng.standard_normal(a.shape[0])
    out = measure_scaling(a, jnp.asarray(b), [1, 2, 4], tol=1e-6,
                          maxiter=150, reps=2)
    assert [o["devices"] for o in out] == [1, 2, 4]
    assert out[0]["efficiency"] == 1.0
    assert all(o["seconds"] > 0 for o in out)


def test_xplane_trace_report(tmp_path, rng):
    """Capture a real jax.profiler trace (CPU), parse the xplane.pb with
    the dependency-free reader, and get a per-op report (ROADMAP #13)."""
    import jax
    import jax.numpy as jnp
    from cgx.io.poisson import poisson2d
    from cgx.solve.cg import cg_solve
    from cgx.utils.profiling import trace, trace_report

    a = poisson2d(24, 24)
    b = jnp.asarray(rng.standard_normal(576))
    solve = jax.jit(lambda b: cg_solve(a, b, tol=1e-8, maxiter=300))
    jax.block_until_ready(solve(b))          # compile outside the trace
    d = str(tmp_path / "tb")
    with trace(d):
        jax.block_until_ready(solve(b * 1.001))
    rows = trace_report(d, device_only=False, top=None)
    assert rows, "no events parsed from the trace"
    assert any(r["total_us"] > 0 for r in rows)
    names = " ".join(r["op"] for r in rows)
    assert "while" in names.lower() or "jit" in names.lower() or len(rows) > 3


