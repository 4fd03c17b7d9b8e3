"""SPMD CG: the full solver while_loop inside one ``shard_map`` region.

Per iteration, the only cross-chip traffic is (a) the halo exchange (or
all-gather) inside the local matvec and (b) the two ``psum`` scalar
reductions for α and β — the same two global sync points the math requires
(SURVEY.md §3.2).  The iterate, residual and direction vectors
live sharded for the whole solve; nothing is ever replicated.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cgx.dist.halo import local_matvec
from cgx.dist.partition import Partition, pad_vector
from cgx.solve.cg import CGResult, cg_solve

__all__ = ["AXIS", "make_row_mesh", "operator_specs", "dist_cg_solve"]

AXIS = "rows"


def make_row_mesh(n_devices: Optional[int] = None,
                  devices=None) -> Mesh:
    """1-D device mesh over matrix rows."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (AXIS,), devices=devices)


def operator_specs(part: Partition):
    """PartitionSpecs for a :class:`Partition`: shard the stacked leading
    axis over ``"rows"``, replicate nothing else (same treedef as ``part``,
    usable for both ``device_put`` shardings and ``shard_map`` in_specs)."""
    return jax.tree.map(
        lambda leaf: P(AXIS, *(None,) * (leaf.ndim - 1)), part)


def _local_block_inverses(a_loc: Partition, bs: int) -> jnp.ndarray:
    """Dense inverses of the (bs, bs) diagonal blocks of this shard's rows,
    built entirely from the local operator layout (no global traffic).

    Requires ``rows_local % bs == 0`` so blocks never straddle shards.
    Matches :class:`cgx.solve.precond.BlockJacobiPrecond` block-for-block
    (padding rows get identity), so sharded PCG trajectories are identical
    to the single-device path.
    """
    rl = a_loc.rows_local
    if rl % bs:
        raise ValueError(f"blocksize {bs} must divide rows_local {rl}")
    nb = rl // bs
    i_loc = jnp.arange(rl)
    if a_loc.kind == "dia":
        data = a_loc.dia_data.reshape(a_loc.dia_data.shape[1:])  # (rl, nd)
        blocks = jnp.zeros((nb, bs, bs), data.dtype)
        ir = i_loc % bs
        for k, off in enumerate(a_loc.dia_offsets):
            ic = ir + off
            ok = (ic >= 0) & (ic < bs)
            blocks = blocks.at[i_loc // bs, ir,
                               jnp.clip(ic, 0, bs - 1)].add(
                jnp.where(ok, data[:, k], 0.0))
    else:
        vals = a_loc.ell_values.reshape(a_loc.ell_values.shape[1:])
        cols = a_loc.ell_cols.reshape(a_loc.ell_cols.shape[1:])
        first = jax.lax.axis_index(AXIS).astype(cols.dtype) * rl
        if a_loc.mode == "halo":
            # Extended-local → global: col_g = col_ext + first - halo_lo.
            col_g = cols + first - a_loc.halo_lo
        else:
            col_g = cols
        row_g = (first + i_loc)[:, None]
        ic = col_g - (row_g // bs) * bs
        ok = (col_g // bs) == (row_g // bs)
        ir = (i_loc % bs)[:, None] + jnp.zeros_like(cols)
        blk = jnp.broadcast_to((i_loc // bs)[:, None], cols.shape)
        blocks = jnp.zeros((nb, bs, bs), vals.dtype)
        blocks = blocks.at[blk, ir, jnp.clip(ic, 0, bs - 1)].add(
            jnp.where(ok, vals, 0.0))
    # Zero diagonal slots (padding rows / empty rows) get 1 so the inverse
    # is defined — identical convention to BlockJacobiPrecond.from_matrix.
    di = jnp.arange(bs)
    d = blocks[:, di, di]
    blocks = blocks.at[:, di, di].set(jnp.where(d == 0, 1.0, d))
    return jnp.linalg.inv(blocks)


def _make_local_precond(a_loc: Partition, kind: str, mv, *, blocksize: int,
                        poly_steps: int, ic0_blocks=None, nsweeps: int = 1):
    """Shard-local preconditioner closure (SURVEY §5.h: zero global setup
    traffic — everything derives from the local operator; ``ic0_sweep``
    additionally receives host-factored :class:`IC0SweepBlocks`)."""
    from cgx.ops.blas import safe_recip

    if kind == "none":
        return None
    if kind == "ic0_sweep":
        from cgx.dist.schwarz import sweep_apply
        return partial(sweep_apply, ic0_blocks, nsweeps)
    if kind == "jacobi":
        inv = safe_recip(_local_diag(a_loc))
        return lambda r: inv * r
    if kind == "block_jacobi":
        inv_blocks = _local_block_inverses(a_loc, blocksize)
        bs = blocksize

        def apply_bj(r):
            zb = jnp.einsum("bij,bj->bi", inv_blocks, r.reshape(-1, bs),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=r.dtype)
            return zb.reshape(-1)

        return apply_bj
    if kind == "poly":
        from cgx.solve.precond import PolynomialPrecond
        inv = safe_recip(_local_diag(a_loc))
        return PolynomialPrecond(mv, inv, steps=poly_steps).apply
    raise ValueError(f"unknown preconditioner {kind!r} (distributed path "
                     "supports none/jacobi/block_jacobi/poly/ic0_sweep)")


def _local_diag(a_loc: Partition) -> jnp.ndarray:
    """Diagonal of this shard's rows, from the local operator layout."""
    if a_loc.kind == "dia":
        data = a_loc.dia_data.reshape(a_loc.dia_data.shape[1:])
        return data[:, a_loc.dia_offsets.index(0)]
    vals = a_loc.ell_values.reshape(a_loc.ell_values.shape[1:])
    cols = a_loc.ell_cols.reshape(a_loc.ell_cols.shape[1:])
    rl = vals.shape[0]
    if a_loc.mode == "halo":
        # Extended-local coords: the diagonal of local row i sits at col
        # halo_lo + i.
        own = a_loc.halo_lo + jnp.arange(rl, dtype=cols.dtype)[:, None]
        on_diag = cols == own
    else:
        # Global coords: recover this shard's global row offset from its
        # position on the mesh axis.
        first = jax.lax.axis_index(AXIS).astype(cols.dtype) * rl
        own = first + jnp.arange(rl, dtype=cols.dtype)[:, None]
        on_diag = cols == own
    return jnp.sum(jnp.where(on_diag, vals, 0), axis=1)


def dist_cg_solve(
    part: Partition,
    b: jnp.ndarray,
    mesh: Mesh,
    *,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    jacobi: bool = False,
    preconditioner: Optional[str] = None,
    blocksize: int = 8,
    poly_steps: int = 3,
    nsweeps: int = 1,
    track_history: bool = False,
    method: str = "cg",
    adaptive_replace: bool = False,
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
) -> CGResult:
    """Solve ``A x = b`` with row-sharded (P)CG over ``mesh``.

    ``b`` may be the true-length or padded global RHS (host or device); it is
    zero-padded to ``part.n_padded`` and sharded ``P("rows")``.  The returned
    :class:`CGResult` carries the padded global solution — strip with
    :func:`cgx.dist.partition.unpad_vector`.

    ``preconditioner``: ``"none"`` | ``"jacobi"`` | ``"block_jacobi"`` |
    ``"poly"`` | ``"ic0_sweep"`` — the first four are built *inside* the
    shard from the local operator (no global setup traffic); padding rows
    stay exactly zero.  Sharded trajectories are identical to the
    single-device PCG with the matching preconditioner.  ``"ic0_sweep"``
    is one-level additive Schwarz: each shard's diagonal block is
    IC(0)-factored host-side once (:mod:`cgx.dist.schwarz`) and applied
    with ``nsweeps`` gather-free Neumann sweeps per triangle — zero
    cross-chip traffic in the apply.  ``jacobi=True`` is the round-1
    spelling of ``preconditioner="jacobi"`` (kept for compatibility).

    ``method``: ``"cg"`` (2 psums/iter), ``"single_reduction"``
    (Chronopoulos–Gear, 1 fused psum/iter — halves cross-chip latency on
    large meshes; no history tracking), ``"pipelined"`` (Ghysels–Vanroose,
    1 psum/iter that additionally OVERLAPS the local SpMV — reduction
    latency off the critical path, at 3 extra carried vectors;
    ``adaptive_replace=True`` selects the van der Vorst–Ye replacement
    cadence, which extends the fp32 convergence envelope — see
    :func:`cgx.solve.cg.cg_solve_pipelined`), or
    ``"chebyshev"`` (ZERO reductions per iteration given eigenvalue
    bounds ``lam_min``/``lam_max`` of ``M⁻¹A`` — estimated by distributed
    power iteration when omitted; the latency-optimal method on large
    meshes).
    """
    if maxiter is None:
        maxiter = part.n
    if preconditioner is None:
        preconditioner = "jacobi" if jacobi else "none"
    b_pad = pad_vector(jnp.asarray(b), part.n_padded)

    blocks = None
    blocks_key = None
    if preconditioner == "ic0_sweep":
        from cgx.dist.schwarz import ic0_sweep_blocks
        blocks = ic0_sweep_blocks(part)
        blocks_key = (blocks.lower_offsets, blocks.upper_offsets)

    specs = operator_specs(part)
    vec = P(AXIS)
    f = _cached_solver(mesh, _static_key(part), float(tol), float(atol),
                       int(maxiter), preconditioner, int(blocksize),
                       int(poly_steps), bool(track_history),
                       method, x0 is not None,
                       None if lam_min is None else float(lam_min),
                       None if lam_max is None else float(lam_max),
                       int(nsweeps), blocks_key, bool(adaptive_replace))

    part_dev = jax.device_put(
        part, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                           is_leaf=lambda v: isinstance(v, P)))
    args = [part_dev, jax.device_put(b_pad, NamedSharding(mesh, vec))]
    if blocks is not None:
        args.append(jax.device_put(blocks, jax.tree.map(
            lambda leaf: NamedSharding(
                mesh, P(AXIS, *(None,) * (leaf.ndim - 1))), blocks)))
    if x0 is not None:
        args.append(jax.device_put(
            pad_vector(jnp.asarray(x0), part.n_padded),
            NamedSharding(mesh, vec)))
    return f(*args)


def _static_key(part: Partition):
    return (part.kind, part.mode, part.n, part.n_shards, part.rows_local,
            part.halo_lo, part.halo_hi, part.dia_offsets, part.dtype.name)


@lru_cache(maxsize=64)
def _cached_solver(mesh, part_key, tol, atol, maxiter, precond_kind,
                   blocksize, poly_steps, track_history, method, has_x0,
                   lam_min, lam_max, nsweeps=1, blocks_key=None,
                   adaptive_replace=False):
    """Build-and-jit the shard_map solver once per static configuration.

    A fresh closure per call would key ``jax.jit`` on function identity and
    retrace/compile (plus re-lower the collectives) on EVERY solve — fatal
    for time-stepping loops that call :func:`dist_cg_solve` repeatedly with
    new right-hand sides.
    """
    vec = P(AXIS)
    rep = P()
    out_specs = CGResult(x=vec, iterations=rep, residual_norm_sq=rep,
                         converged=rep, history=rep)
    # Pytree-prefix spec for the whole Partition argument: a single
    # P(AXIS) broadcasts to every leaf (leading stacked axis sharded,
    # trailing dims unsharded) — equivalent to operator_specs(part).
    op_specs = P(AXIS)

    has_blocks = precond_kind == "ic0_sweep"

    def local_solve(a_loc: Partition, b_loc, *rest):
        rest = list(rest)
        ic0_blocks = rest.pop(0) if has_blocks else None
        mv = partial(local_matvec, a_loc, axis_name=AXIS)
        precond = _make_local_precond(a_loc, precond_kind, mv,
                                      blocksize=blocksize,
                                      poly_steps=poly_steps,
                                      ic0_blocks=ic0_blocks,
                                      nsweeps=nsweeps)
        x0l = rest[0] if rest else None
        if method == "single_reduction":
            from cgx.solve.cg import cg_solve_single_reduction
            return cg_solve_single_reduction(
                mv, b_loc, x0l, tol=tol, atol=atol, maxiter=maxiter,
                preconditioner=precond, axis_name=AXIS)
        if method == "pipelined":
            from cgx.solve.cg import cg_solve_pipelined
            return cg_solve_pipelined(
                mv, b_loc, x0l, tol=tol, atol=atol, maxiter=maxiter,
                preconditioner=precond, axis_name=AXIS,
                adaptive_replace=adaptive_replace)
        if method == "chebyshev":
            from cgx.solve.chebyshev import chebyshev_solve, estimate_bounds
            if lam_min is None or lam_max is None:
                op = mv if precond is None else (
                    lambda v: precond(mv(v)))
                lo, hi = estimate_bounds(op, b_loc.shape[0],
                                         axis_name=AXIS,
                                         dtype=b_loc.dtype)
            else:
                lo, hi = lam_min, lam_max
            return chebyshev_solve(mv, b_loc, lo, hi, x0l, tol=tol,
                                   maxiter=maxiter, preconditioner=precond,
                                   axis_name=AXIS)
        return cg_solve(mv, b_loc, x0l,
                        tol=tol, atol=atol, maxiter=maxiter,
                        preconditioner=precond, axis_name=AXIS,
                        track_history=track_history)

    in_specs = ((op_specs, vec) + ((P(AXIS),) if has_blocks else ())
                + ((vec,) if has_x0 else ()))
    return jax.jit(jax.shard_map(local_solve, mesh=mesh,
                                 in_specs=in_specs, out_specs=out_specs))



