"""Dense vector ops: dots, norms, axpy.

Replacement for the reference's sequential vector kernels
``dot_product`` (``mv_ops.c:117-132``), ``sv_mult`` (``mv_ops.c:134-158``),
``vec_add`` (``mv_ops.c:203-230``) and ``vec_sub`` (``mv_ops.c:232-259``).
These are not standalone kernels: ``axpy`` is written so XLA fuses it
into the surrounding CG loop body, and dots lower to a single on-device
reduction.  The reference's ``-1.0`` error sentinel on shape mismatch
(``mv_ops.c:122-126``) becomes a trace-time shape check — impossible states
are compile errors, not runtime sentinels.

Every reduction takes an optional ``axis_name``: inside ``shard_map`` the
local partial reduces globally with one ``psum`` over the mesh (the only two
cross-chip sync points per CG iteration ride these).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["dot", "dot_compensated", "norm_sq", "norm", "axpy",
           "safe_recip"]


def dot(a: jnp.ndarray, b: jnp.ndarray,
        axis_name: Optional[str] = None) -> jnp.ndarray:
    """Inner product ``aᵀb``; global over ``axis_name`` when given."""
    if a.shape != b.shape:
        raise ValueError(f"dot: shape mismatch {a.shape} vs {b.shape}")
    local = jnp.vdot(a, b)
    if axis_name is not None:
        local = jax.lax.psum(local, axis_name)
    return local


def dot_compensated(a: jnp.ndarray, b: jnp.ndarray,
                    axis_name: Optional[str] = None) -> jnp.ndarray:
    """Inner product with fp32 products + Kahan-compensated tree reduction.

    For bf16/low-precision iterates (SURVEY.md §7 hard part 4: keep fp32
    CPU validation, low precision on chip, "compensated dot products for
    the reductions if trajectories drift").  Products are upcast to fp32,
    then a 2Sum chunked accumulation recovers the rounding error of the
    partial sums — ~1 ulp fp32 accuracy independent of n, at 2x the
    reduction FLOPs (noise next to the memory traffic).  Returns fp32.
    """
    if a.shape != b.shape:
        raise ValueError(f"dot: shape mismatch {a.shape} vs {b.shape}")
    prod = a.astype(jnp.float32) * b.astype(jnp.float32)
    # Chunked Kahan: accumulate C lanes of partial sums with a running
    # compensation term, then sum the C survivors (C small).
    c_lanes = 256
    n = prod.shape[0]
    pad = (-n) % c_lanes
    g = jnp.pad(prod, (0, pad)).reshape(-1, c_lanes)

    def body(carry, row):
        s, comp = carry
        y = row - comp
        t = s + y
        comp = (t - s) - y
        return (t, comp), None

    # Under shard_map the carry must match the scanned input's
    # device-varying manner; a plain zeros literal is replicated.
    zero = jnp.zeros((c_lanes,), jnp.float32)
    if axis_name is not None:
        zero = jax.lax.pcast(zero, axis_name, to="varying")
    (s, comp), _ = jax.lax.scan(body, (zero, zero), g)
    local = jnp.sum(s - comp)
    if axis_name is not None:
        local = jax.lax.psum(local, axis_name)
    return local


def norm_sq(a: jnp.ndarray, axis_name: Optional[str] = None) -> jnp.ndarray:
    """Squared 2-norm ``‖a‖²``; global over ``axis_name`` when given."""
    return dot(a, a, axis_name)


def norm(a: jnp.ndarray, axis_name: Optional[str] = None) -> jnp.ndarray:
    """2-norm ``‖a‖``; global over ``axis_name`` when given."""
    return jnp.sqrt(norm_sq(a, axis_name))


def axpy(alpha: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """``alpha * x + y`` — written for XLA to fuse into its consumer."""
    return alpha * x + y


def safe_recip(d: jnp.ndarray) -> jnp.ndarray:
    """Elementwise ``1/d`` with zeros mapped to zero (not inf).

    The shared zero-diagonal policy for Jacobi-type preconditioners: zero
    diagonal entries (padding rows from shard/tile equalization) leave
    their components untouched.
    """
    return jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0),
                     jnp.zeros_like(d))
