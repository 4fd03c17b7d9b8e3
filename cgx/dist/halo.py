"""Ring halo exchange and the shard-local matvec (runs inside ``shard_map``).

The replacement for what MPI point-to-point would have been in the
reference's assignment series (no comm code exists in the tree — SURVEY.md
§2.2/2.3): neighbor boundary slices of the iterate move over ICI via
``jax.lax.ppermute`` ring steps; general sparsity falls back to
``jax.lax.all_gather``.  Both paths keep every shape static so the whole CG
``while_loop`` body stays one traced SPMD program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from cgx.dist.partition import Partition

__all__ = ["halo_exchange", "local_matvec"]


def _ring_perm(n: int, shift: int):
    """Device ``i`` sends to ``i + shift`` (mod n) → each receives from
    ``i - shift``."""
    return [(i, (i + shift) % n) for i in range(n)]


def _halo_parts(x_local: jnp.ndarray, halo_lo: int, halo_hi: int,
                axis_name: str):
    """(left_halo, right_halo) slices of the neighbors via ring ppermutes.

    Sends only the boundary slices (not whole shards) when one ring step
    suffices — ``halo_lo + halo_hi`` entries of ICI traffic per exchange.
    """
    nl = x_local.shape[0]
    n_dev = jax.lax.psum(1, axis_name)

    left = right = None
    if halo_lo:
        # The halo spans the (steps-1) nearest shards fully plus the tail
        # `rem` entries of the farthest — each shard sends exactly what the
        # receiver needs, O(halo) total traffic (round 1 shipped whole
        # shards from every step and sliced afterwards).
        steps = -(-halo_lo // nl)
        rem = halo_lo - (steps - 1) * nl        # in (0, nl]
        blocks = [jax.lax.ppermute(x_local[nl - rem:], axis_name,
                                   _ring_perm(n_dev, steps))]
        blocks += [jax.lax.ppermute(x_local, axis_name,
                                    _ring_perm(n_dev, j))
                   for j in range(steps - 1, 0, -1)]  # farthest first
        left = jnp.concatenate(blocks) if len(blocks) > 1 else blocks[0]
    if halo_hi:
        steps = -(-halo_hi // nl)
        rem = halo_hi - (steps - 1) * nl
        blocks = [jax.lax.ppermute(x_local, axis_name,
                                   _ring_perm(n_dev, -j))
                  for j in range(1, steps)]           # nearest first
        blocks += [jax.lax.ppermute(x_local[:rem], axis_name,
                                    _ring_perm(n_dev, -steps))]
        right = jnp.concatenate(blocks) if len(blocks) > 1 else blocks[0]
    return left, right


def halo_exchange(x_local: jnp.ndarray, halo_lo: int, halo_hi: int,
                  axis_name: str) -> jnp.ndarray:
    """Return ``[left_halo | x_local | right_halo]`` via ring ppermutes.

    ``left_halo`` is the trailing ``halo_lo`` entries of the preceding
    shards, ``right_halo`` the leading ``halo_hi`` entries of the following
    shards (both cyclic — first/last shard wrap, which is harmless because a
    banded matrix never references those slots).  Halos wider than one shard
    take multiple ring steps; the step count is static.
    """
    left, right = _halo_parts(x_local, halo_lo, halo_hi, axis_name)
    parts = [p for p in (left, x_local, right) if p is not None]
    return jnp.concatenate(parts) if len(parts) > 1 else x_local


def local_matvec(a_loc: Partition, x_local: jnp.ndarray,
                 axis_name: str, overlap: bool = True) -> jnp.ndarray:
    """``y_local = (A x)_local`` for one shard's rows, inside ``shard_map``.

    Communication per call: ``halo_lo + halo_hi`` vector entries over the
    ring (halo mode) or one tiled all-gather of the iterate (allgather
    mode).  In halo mode with ``overlap=True`` (default) the rows are split
    into interior (first/last ``halo`` rows excluded) and boundary: interior
    rows depend only on ``x_local``, so XLA's latency-hiding scheduler runs
    the ring ppermutes concurrently with the interior FMAs — the
    ring-attention-style compute/comm overlap of SURVEY.md §2.2 (CP row).
    """
    # shard_map delivers the stacked leading axis as a size-1 local slice.
    squeeze = lambda arr: arr.reshape(arr.shape[1:])
    hl, hr = a_loc.halo_lo, a_loc.halo_hi

    if a_loc.mode != "halo":
        x_ext = jax.lax.all_gather(x_local, axis_name, tiled=True)
        vals = squeeze(a_loc.ell_values)          # (rows_local, width)
        cols = squeeze(a_loc.ell_cols)
        return jnp.sum(vals * x_ext[cols], axis=1)

    rl = x_local.shape[0]
    if not overlap or hl + hr >= rl or (hl == 0 and hr == 0):
        x_ext = halo_exchange(x_local, hl, hr, axis_name)
        return _rows_matvec(a_loc, squeeze, x_ext, 0, rl, hl)

    left, right = _halo_parts(x_local, hl, hr, axis_name)
    # Interior rows [hl, rl-hr): every referenced column lives in x_local —
    # no dependency on the in-flight halos.
    y_mid = _rows_matvec(a_loc, squeeze, x_local, hl, rl - hr, 0)
    # Boundary rows read the extended vector once the halos land.
    parts = [p for p in (left, x_local, right) if p is not None]
    x_ext = jnp.concatenate(parts)
    y_top = _rows_matvec(a_loc, squeeze, x_ext, 0, hl, hl)
    y_bot = _rows_matvec(a_loc, squeeze, x_ext, rl - hr, rl, hl)
    return jnp.concatenate([y for y in (y_top, y_mid, y_bot)
                            if y.shape[0]])


def _rows_matvec(a_loc: Partition, squeeze, x_src: jnp.ndarray,
                 r0: int, r1: int, base: int) -> jnp.ndarray:
    """Rows ``[r0, r1)`` of the local matvec against ``x_src``, where local
    extended column ``c`` maps to ``x_src[c - halo_lo + base]`` (``base`` is
    ``halo_lo`` when ``x_src`` is the extended vector, 0 for the bare local
    shard)."""
    hl = a_loc.halo_lo
    nrows = r1 - r0
    if nrows <= 0:
        dtype = (a_loc.ell_values if a_loc.kind == "ell"
                 else a_loc.dia_data).dtype
        return jnp.zeros((0,), dtype)

    if a_loc.kind == "ell":
        vals = squeeze(a_loc.ell_values)[r0:r1]   # (nrows, width)
        cols = squeeze(a_loc.ell_cols)[r0:r1] - (hl - base)
        return jnp.sum(vals * x_src[cols], axis=1)

    data = squeeze(a_loc.dia_data)[r0:r1]         # (nrows, n_diags)
    y = jnp.zeros((nrows,), dtype=x_src.dtype)
    for k, off in enumerate(a_loc.dia_offsets):
        start = r0 + off + base
        y = y + data[:, k] * jax.lax.dynamic_slice(x_src, (start,), (nrows,))
    return y
