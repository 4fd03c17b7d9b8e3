"""Chebyshev iteration — the zero-reduction companion solver to CG.

Chebyshev semi-iteration solves SPD ``A x = b`` given eigenvalue bounds
``[λ_min, λ_max]`` with NO inner products at all: per iteration one SpMV
plus fused axpys and two precomputed scalars.  On a multi-chip mesh that
means **zero global sync points per iteration** (CG needs 2, the
single-reduction variant 1) — the latency-optimal smoother/solver for
well-characterized operators, and the standard CG companion when the
spectrum is known (e.g. Poisson: ``λ ∈ [c·h², 2·diag]`` analytically).

Convergence is checked every ``check_every`` iterations (a periodic
reduction, amortized to ~0 sync cost).  ``estimate_bounds`` supplies
``λ_max`` by power iteration (and a crude ``λ_min`` via the smallest
Rayleigh quotient of the shifted operator) when bounds are unknown —
spend a few SpMVs once, save every-iteration reductions forever.

The reference has no such solver (CG only, ``cg.c:88-141``); this is
north-star framework breadth with the same operator/preconditioner
machinery.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from cgx.ops import blas
from cgx.solve.cg import CGResult, _as_apply, _settled, as_matvec

__all__ = ["chebyshev_solve", "estimate_bounds", "analytic_bounds"]


def analytic_bounds(a) -> Optional[Tuple[float, float]]:
    """Closed-form (λ_min, λ_max) for axis-aligned constant-coefficient
    Dirichlet stencils, or ``None`` when ``a`` has no such form.

    For a tensor-product operator (5-point 2-D / 7-point 3-D Poisson and
    anisotropic variants: center ``c₀``, symmetric per-axis couplings
    ``c_ax`` at offset ±1) the eigenvalues are exactly

        λ(i, j, k) = c₀ + Σ_ax 2·c_ax·cos(π·m_ax / (n_ax + 1)),

    so the extreme eigenvalues are ``c₀ ∓ Σ 2|c_ax|·cos(π/(n_ax+1))`` —
    no power iteration needed (the SURVEY §5 "spectrum known
    analytically" case).  Returns Python floats (static under jit)."""
    import math

    from cgx.sparse.grid import stencil_taps

    spec = stencil_taps(a)
    if spec is None:
        spec = _dia_constant_taps(a)     # constant-coefficient DIA form
    if spec is None:
        return None
    nx, ny, nz, taps, coeffs = spec
    if any(c is None for c in coeffs):
        return None                      # variable-coefficient planes
    lens = (nx, ny, nz)
    center = None
    per = {}                             # axis -> {+1: c, -1: c}
    for d, c in zip(taps, coeffs):
        nzs = [i for i, v in enumerate(d) if v != 0]
        if not nzs:
            if center is not None:
                return None
            center = float(c)
        elif len(nzs) == 1 and abs(d[nzs[0]]) == 1:
            ax, sg = nzs[0], d[nzs[0]]
            if sg in per.setdefault(ax, {}):
                return None
            per[ax][sg] = float(c)
        else:
            return None                  # diagonal tap / reach > 1
    if center is None:
        return None
    lo = hi = center
    for ax, d in per.items():
        if set(d) != {1, -1} or d[1] != d[-1]:
            return None                  # non-symmetric coupling
        n_ax = lens[ax]
        if n_ax <= 1:
            continue                     # no neighbors along this axis
        span = 2.0 * abs(d[1]) * math.cos(math.pi / (n_ax + 1))
        lo -= span
        hi += span
    return lo, hi


def _dia_constant_taps(a):
    """``(nx, ny, nz, taps, coeffs)`` for a DIA operator whose every
    diagonal is a single constant on its grid-valid slots (and zero at
    boundary-crossing slots), or ``None``.  Host-side, concrete data."""
    import numpy as np

    from cgx.sparse.grid import dia_grid_taps

    spec = dia_grid_taps(a)
    if spec is None:
        return None
    nx, ny, nz, taps = spec
    data = np.asarray(a.data)            # (n_diags, n): data[k, i]
    n = data.shape[1]
    if n != nx * ny * nz:
        return None
    r = np.arange(n)
    zc = r % nz
    yc = (r // nz) % ny
    xc = r // (ny * nz)
    coeffs = []
    for t, (dx, dy, dk) in enumerate(taps):
        valid = ((xc + dx >= 0) & (xc + dx < nx)
                 & (yc + dy >= 0) & (yc + dy < ny)
                 & (zc + dk >= 0) & (zc + dk < nz))
        col = data[t]
        if np.any(col[~valid] != 0):
            return None                  # wrap entries — not a grid stencil
        vals = col[valid]
        if vals.size == 0:
            coeffs.append(0.0)
            continue
        c = vals[0]
        if np.any(vals != c):
            return None                  # variable coefficients
        coeffs.append(float(c))
    return nx, ny, nz, list(map(tuple, taps)), coeffs


def estimate_bounds(a, n: int, iters: int = 30, key=None,
                    safety: float = 1.05, min_margin: float = 2.0,
                    axis_name: Optional[str] = None,
                    dtype=None, v0=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(λ_min, λ_max) estimates for SPD ``A`` via power iteration.

    λ_max: power iteration × ``safety``.  λ_min: power iteration on
    ``λ_max I − A``, then ÷ ``min_margin`` — power iteration converges
    slowly into clustered small eigenvalues, and a λ_min estimate *above*
    the true minimum degrades Chebyshev badly, so err low (costs only
    ~√min_margin extra iterations).

    ``dtype``: start-vector dtype — pass the operand dtype so the power
    iteration runs in the operator's own precision (defaults to fp32)."""
    matvec = as_matvec(a)
    if key is None:
        key = jax.random.PRNGKey(0)
    shape = tuple(n) if isinstance(n, (tuple, list)) else (n,)
    if v0 is None:
        v0 = (jax.random.normal(key, shape) if dtype is None
              else jax.random.normal(key, shape, dtype))
    # ``v0``: callers with PADDED layouts must mask padding slots to zero
    # — the operator is zero there, so the shifted power iteration for
    # λ_min otherwise locks onto the padding eigenspace and returns ~0.
    if axis_name is not None:
        # Same key on every shard → v0 is "unvarying" to the vma checker,
        # but the matvec output is varying; cast so the power-iteration
        # carry types agree.  (The identical per-shard pattern is still a
        # perfectly good random start vector.)
        v0 = jax.lax.pcast(v0, axis_name, to="varying")

    def power(mv, v):
        def body(_, v):
            w = mv(v)
            return w / blas.norm(w, axis_name)
        v = jax.lax.fori_loop(0, iters, body, v / blas.norm(v, axis_name))
        return blas.dot(v, mv(v), axis_name)

    lam_max = power(matvec, v0) * safety
    lam_min_shift = power(lambda v: lam_max * v - matvec(v), v0)
    lam_min = jnp.maximum(lam_max - lam_min_shift,
                          lam_max * 1e-6) / min_margin
    return lam_min, lam_max


def chebyshev_solve(
    a,
    b: jnp.ndarray,
    lam_min,
    lam_max,
    x0: Optional[jnp.ndarray] = None,
    *,
    tol: float = 1e-6,
    maxiter: Optional[int] = None,
    preconditioner=None,
    check_every: int = 16,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Chebyshev iteration on ``[λ_min, λ_max]`` (of ``M⁻¹A`` if a
    preconditioner is given).  Jittable; ``CGResult`` like ``cg_solve``.
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n
    maxiter = int(maxiter)
    check_every = max(1, int(check_every))
    dtype = b.dtype

    theta = (jnp.asarray(lam_max, dtype) + jnp.asarray(lam_min, dtype)) / 2
    delta = (jnp.asarray(lam_max, dtype) - jnp.asarray(lam_min, dtype)) / 2
    # Guard the degenerate / collapsed-bounds case (lam_min == lam_max is a
    # legal single-point spectrum, e.g. A = c·I; a bad estimate can also
    # collapse the interval): clamp delta away from zero relative to theta
    # so sigma1 stays finite.  With a point spectrum the first step
    # x += z/theta is exact, r becomes 0 and the delta-scaled term never
    # contributes, so the clamp does not perturb that trajectory.
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    delta = jnp.maximum(delta, eps * jnp.maximum(jnp.abs(theta), eps))
    sigma1 = theta / delta

    bb = blas.norm_sq(b, axis_name)
    tol_sq = jnp.asarray(tol, dtype) ** 2 * bb

    def run(x0, k0, aux):
        if x0 is None:
            x0 = jnp.zeros_like(b)
            r0 = b
        else:
            r0 = b - matvec(x0)
        z0 = apply_m(r0) if apply_m is not None else r0
        d0 = z0 / theta
        rr0 = blas.norm_sq(r0, axis_name)
        # Carry: (x, r, d, rho, k, rr); rho is the Chebyshev recursion
        # scalar.
        x, r, d, rho, k, rr = jax.lax.while_loop(cond, body, (
            x0 + d0, r0 - matvec(d0), d0, 1.0 / sigma1, k0 + 1, rr0))
        return x, k, blas.norm_sq(r, axis_name), aux

    def cond(c):
        x, r, d, rho, k, rr = c
        return jnp.logical_and(k < maxiter, rr > tol_sq)

    def body(c):
        x, r, d, rho, k, rr = c
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        z = apply_m(r) if apply_m is not None else r
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        r = r - matvec(d)
        # Periodic convergence check: the only reduction in the loop.
        rr = jax.lax.cond(
            (k + 1) % check_every == 0,
            lambda: blas.norm_sq(r, axis_name),
            lambda: rr)
        return (x, r, d, rho_new, k + 1, rr)

    return _settled(run, x0, matvec, b, tol_sq, maxiter, axis_name)
