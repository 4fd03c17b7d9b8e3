"""Scaling-efficiency harness (BASELINE.json: ≥80 % efficiency 1→N hosts).

Two complementary tools:

* :func:`comm_report` — an *analytic* per-iteration communication/compute
  model from the actual partition: bytes moved between devices per CG
  iteration (halo slices + psum scalars), bytes streamed from HBM, and the
  predicted scaling efficiency on a given link model.  Exact — it reads the
  halo widths and shard sizes straight off the :class:`Partition` — and
  hardware-independent, so it runs in CI.
* :func:`measure_scaling` — measured wall-clock of the same sharded solve
  on 1, 2, ..., N devices of whatever mesh is available.  On the virtual
  CPU mesh this validates the machinery only (CPU numbers say nothing
  about a device); on real devices it gives the scaling row.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = ["LinkModel", "comm_report", "measure_scaling"]


@dataclass(frozen=True)
class LinkModel:
    """Bandwidths/latencies for the efficiency prediction.

    Defaults: NVIDIA's H100 SXM data sheet (3.35 TB/s HBM, 900 GB/s NVLink
    per card = 450 GB/s each way); the latencies are round placeholders,
    not measurements."""

    hbm_gbps: float = 3350.0       # H100 SXM HBM3
    link_gbps: float = 450.0        # H100 NVLink, one direction
    link_latency_us: float = 1.0    # per hop
    psum_latency_us: float = 4.0   # small-allreduce latency per sync point


def comm_report(part, dtype_bytes: int = 4,
                link: LinkModel = LinkModel(),
                sync_points: int = 2) -> dict:
    """Per-iteration traffic + predicted scaling efficiency for a partition.

    ``sync_points``: global scalar reductions per iteration (2 for standard
    CG, 1 for :func:`cgx.solve.cg.cg_solve_single_reduction`).
    """
    rl = part.rows_local
    s = part.n_shards
    if part.kind == "dia":
        nnz_local = int(np.count_nonzero(np.asarray(part.dia_data))) // s
        vec_passes = 11  # q=Ap & pq; x,r updates; z; rz; p update (fused)
    else:
        nnz_local = int(np.count_nonzero(np.asarray(part.ell_values))) // s
        vec_passes = 11
    hbm_bytes = (nnz_local * 2 + vec_passes * rl) * dtype_bytes

    if part.mode == "halo":
        comm_bytes = (part.halo_lo + part.halo_hi) * dtype_bytes
        hops = 1
    else:
        comm_bytes = (part.n_padded - rl) * dtype_bytes
        hops = max(s - 1, 1)

    t_compute = hbm_bytes / (link.hbm_gbps * 1e9)
    t_comm = (comm_bytes / (link.link_gbps * 1e9)
              + hops * link.link_latency_us * 1e-6)
    t_sync = sync_points * link.psum_latency_us * 1e-6
    # Halo exchange overlaps with interior compute (cgx.dist.halo); count
    # only its non-overlappable excess.
    t_iter = max(t_compute, t_comm) + t_sync
    t_iter_1dev = (hbm_bytes * s) / (link.hbm_gbps * 1e9)
    eff = t_iter_1dev / (s * t_iter)
    return {
        "n_shards": s,
        "rows_local": rl,
        "mode": part.mode,
        "hbm_bytes_per_iter_per_chip": hbm_bytes,
        "comm_bytes_per_iter_per_chip": comm_bytes,
        "sync_points": sync_points,
        "predicted_iter_us": t_iter * 1e6,
        "predicted_efficiency": min(eff, 1.0),
    }


def measure_scaling(a_dia, b, device_counts: Sequence[int],
                    *, tol: float = 1e-6, maxiter: Optional[int] = None,
                    reps: int = 3) -> list:
    """Measured solve wall-clock across mesh sizes (same global problem)."""
    import jax
    import jax.numpy as jnp
    from cgx.dist.partition import partition_dia
    from cgx.dist.solve import dist_cg_solve, make_row_mesh

    results = []
    for nd in device_counts:
        part = partition_dia(a_dia, nd)
        mesh = make_row_mesh(nd)
        bs = [jax.block_until_ready(jnp.asarray(b) * (1 + 0.001 * i))
              for i in range(reps)]
        res = jax.block_until_ready(dist_cg_solve(
            part, bs[0], mesh, tol=tol, maxiter=maxiter, jacobi=True))
        best = float("inf")
        for i in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(dist_cg_solve(
                part, bs[i], mesh, tol=tol, maxiter=maxiter, jacobi=True))
            best = min(best, time.perf_counter() - t0)
        results.append({"devices": nd, "seconds": best,
                        "iterations": int(res.iterations)})
    base = results[0]
    for r in results:
        r["efficiency"] = (base["seconds"] * base["devices"]
                           / (r["seconds"] * r["devices"]))
    return results
