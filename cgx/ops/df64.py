"""Double-word fp32 ("df64") arithmetic: ~2⁻⁴⁸ effective precision.

The reference computes in ``double`` throughout (``mv_ops.h:19-21``);
matching its accuracy envelope on ill-conditioned SPD systems
(bcsstk-class, κ ≈ 10¹⁰ — where fp32 CG's recurrence stalls near
``eps·κ``) needs extended precision.  This module builds it from fp32
pairs, so the refinement outer of :mod:`cgx.solve.hp` runs on fp32 data
paths.

A df64 value is an unevaluated sum ``hi + lo`` with ``|lo| ≤ ½ulp(hi)``:
two fp32 words give 48 mantissa bits (eps ≈ 3.6e-15), enough that
``κ·eps ≪ 1`` at κ = 10¹⁰.  The primitives are the classical error-free
transformations (Dekker 1971, Knuth TAOCP §4.2.2):

* ``two_sum``      — 6-flop branch-free exact fp32 addition (s, err)
* ``two_prod``     — exact fp32 product via Dekker 12-bit splitting
  (no FMA dependency — IEEE round-to-nearest fp32 elementwise arithmetic
  is all these require)
* double-word add/mul/div built on them (QD-library style)

Reductions (``df_sum`` / ``df_dot``) use pairwise tree folding with the
double-word add — every step is elementwise, so the whole reduction has
log₂(n) depth and no scalar loops.

Everything here is jit-safe and shape-polymorphic.  Used by
:mod:`cgx.solve.hp` for the high-accuracy CG paths.

.. warning:: **CPU backend requires** ``--xla_cpu_max_isa=AVX``.
   XLA:CPU duplicates cheap multiplies into consumer fusions and LLVM
   contracts the resulting mul+add/sub pairs into FMAs — re-rounding the
   SAME product inconsistently across uses, which silently destroys the
   error-free transforms (measured: df64 collapses to fp32 accuracy, a CG
   solve stalls at relres 5e-2 instead of 2e-8).  Graph-level guards
   (``lax.optimization_barrier``, bitcast roundtrips) are erased by the
   algebraic simplifier before fusion; no fast-math flag disables the
   contraction; capping the codegen ISA below FMA3 is the one reliable
   off switch (tests/conftest.py does this).  The GPU backend preserves
   the transforms under jit: on an H100, 2²⁰ random pairs give 0
   mismatches for ``two_sum`` and ``two_prod`` against float64
   (``chip_smoke.py`` phase C), so df64 solves there need no flag.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DF64", "two_sum", "quick_two_sum", "two_prod",
           "df", "df_from_f64", "df_to_f64", "df_zeros_like",
           "df_neg", "df_add", "df_sub", "df_mul", "df_mul_f32",
           "df_div", "df_sum", "df_dot", "df_axpy"]

# Dekker splitting constant for fp32: 2^12 + 1 (splits a 24-bit mantissa
# into two 12-bit halves whose product is exact in fp32).
_SPLIT = np.float32(4097.0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DF64:
    """A double-word fp32 array: the unevaluated sum ``hi + lo``."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype


def two_sum(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Error-free fp32 sum: ``a + b = s + err`` exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Error-free sum assuming ``|a| ≥ |b|`` (3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Error-free fp32 product: ``a·b = p + err`` exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def df(hi, lo=None) -> DF64:
    """Wrap fp32 array(s) as a :class:`DF64` (lo defaults to zero)."""
    hi = jnp.asarray(hi, jnp.float32)
    return DF64(hi, jnp.zeros_like(hi) if lo is None else
                jnp.asarray(lo, jnp.float32))


def df_from_f64(x) -> DF64:
    """Split a HOST float64 array into an exact df64 pair (hi = fp32
    rounding of x, lo = fp32 of the remainder — exact because the
    remainder has ≤ 24 significant bits left)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF64(jnp.asarray(hi), jnp.asarray(lo))


def df_to_f64(x: DF64) -> np.ndarray:
    """HOST float64 view of a df64 array (fetches both words)."""
    return (np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64))


def df_zeros_like(x: DF64) -> DF64:
    return DF64(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))


# ---------------------------------------------------------------------------
# Double-word arithmetic (QD-style)
# ---------------------------------------------------------------------------

def df_neg(x: DF64) -> DF64:
    return DF64(-x.hi, -x.lo)


def df_add(x: DF64, y: DF64) -> DF64:
    """Double-word addition (the standard 11-flop "sloppy" variant —
    error O(eps²·|x+y|), the right trade for long accumulations)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    s, e = quick_two_sum(s, e)
    return DF64(s, e)


def df_sub(x: DF64, y: DF64) -> DF64:
    return df_add(x, df_neg(y))


def df_mul(x: DF64, y: DF64) -> DF64:
    """Double-word product (drops the lo·lo term — O(eps²))."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    p, e = quick_two_sum(p, e)
    return DF64(p, e)


def df_mul_f32(x: DF64, c) -> DF64:
    """df64 × fp32."""
    p, e = two_prod(x.hi, c)
    e = e + x.lo * c
    p, e = quick_two_sum(p, e)
    return DF64(p, e)


def df_div(x: DF64, y: DF64) -> DF64:
    """Double-word division via one Newton correction of the fp32
    quotient — full df64 accuracy for scalar CG coefficients."""
    q1 = x.hi / y.hi
    r = df_sub(x, df_mul_f32(y, q1))
    q2 = (r.hi + r.lo) / (y.hi + y.lo)
    s, e = quick_two_sum(q1, q2)
    return DF64(s, e)


# ---------------------------------------------------------------------------
# Reductions — pairwise tree folding on the VPU
# ---------------------------------------------------------------------------

def _fold_axis(x: DF64, axis: int) -> DF64:
    """Sum a df64 array along ``axis`` by pairwise halving (log₂ steps of
    elementwise double-word adds — each step one fused elementwise pass)."""
    hi, lo = x.hi, x.lo
    n = hi.shape[axis]
    # Pad to the next power of two with zeros (exact under two_sum).
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad = [(0, 0)] * hi.ndim
        pad[axis] = (0, p - n)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while hi.shape[axis] > 1:
        m = hi.shape[axis] // 2
        a = DF64(jax.lax.slice_in_dim(hi, 0, m, axis=axis),
                 jax.lax.slice_in_dim(lo, 0, m, axis=axis))
        b = DF64(jax.lax.slice_in_dim(hi, m, 2 * m, axis=axis),
                 jax.lax.slice_in_dim(lo, m, 2 * m, axis=axis))
        s = df_add(a, b)
        hi, lo = s.hi, s.lo
    return DF64(jnp.squeeze(hi, axis), jnp.squeeze(lo, axis))


def df_sum(x: DF64) -> DF64:
    """Full pairwise df64 sum of a flat df64 array → df64 scalar."""
    return _fold_axis(DF64(x.hi.reshape(-1), x.lo.reshape(-1)), 0)


def df_dot(x: DF64, y: DF64) -> DF64:
    """df64 inner product ``xᵀy`` with error-free products and pairwise
    double-word accumulation (~1 ulp of 2⁻⁴⁸ independent of n)."""
    return df_sum(df_mul(x, y))


def df_axpy(alpha: DF64, x: DF64, y: DF64) -> DF64:
    """``alpha·x + y`` fully in df64 (alpha a df64 scalar)."""
    ax = df_mul(DF64(jnp.broadcast_to(alpha.hi, x.hi.shape),
                     jnp.broadcast_to(alpha.lo, x.lo.shape)), x)
    return df_add(ax, y)
