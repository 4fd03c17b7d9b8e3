"""Multi-RHS solves: batched CG over a block of right-hand sides.

The reference solves a single RHS (``cg.c:88-141``); the north star adds
SpMM (BASELINE.json).  :func:`cg_solve_multi` vmaps the whole CG
``while_loop`` over RHS columns: the per-column matvecs batch into one SpMM
per iteration (``vmap`` of the DIA/stencil/ELL matvec lowers to exactly the
:func:`cgx.ops.spmv.spmm` computation), so k RHS cost ≈ one solve's memory
traffic on the operator plus k vectors — far better than k sequential
solves.  Each column keeps its own α/β scalars and converges on its own
schedule (finished columns coast at zero extra math but keep streaming; for
very uneven spectra prefer separate solves).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from cgx.solve.cg import (RESTARTS, CGResult, _as_apply, as_matvec,
                          cg_solve, settle)

__all__ = ["cg_solve_multi", "block_cg_solve"]


def cg_solve_multi(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    restarts: int = RESTARTS,
) -> CGResult:
    """Solve ``A X = B`` column-by-column with one batched CG loop.

    ``b``: (n, k) block of right-hand sides.  Returns a :class:`CGResult`
    whose fields carry a trailing/leading batch axis (``x``: (n, k);
    ``iterations``/``converged``/``residual_norm_sq``: (k,)).
    ``restarts`` as for :func:`cgx.solve.cg.cg_solve`, per column.
    """
    if b.ndim != 2:
        raise ValueError(f"cg_solve_multi expects b of shape (n, k), "
                         f"got {b.shape}")
    matvec = as_matvec(a)
    if maxiter is None:
        maxiter = b.shape[0]

    def one(b_col, x0_col):
        return cg_solve(matvec, b_col, x0_col, tol=tol, atol=atol,
                        maxiter=int(maxiter), preconditioner=preconditioner,
                        restarts=restarts)

    if x0 is None:
        x0 = jnp.zeros_like(b)
    res = jax.vmap(one, in_axes=(1, 1), out_axes=CGResult(
        x=1, iterations=0, residual_norm_sq=0, converged=0, history=0))(
            b, x0)
    return res


def block_cg_solve(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
) -> CGResult:
    """TRUE block CG: all ``k`` columns share one Krylov space, so
    spectrally clustered RHS families converge in substantially fewer
    iterations than independent per-column recurrences
    (:func:`cg_solve_multi`) — each extra RHS effectively deflates the
    spectrum for the others.

    Breakdown-free form (BFBCG, Ji & Li 2017): the direction block ``P``
    is re-orthonormalized by thin QR every iteration, which keeps the
    k×k system ``PᵀAP`` SPD with conditioning bounded by the OPERATOR's
    spectrum — independent of how converged individual columns are.
    The naive O'Leary Gram recurrence collapses in fp32 exactly when
    columns start converging; this form does not.  Per iteration: one
    SpMM, one (n, k) thin QR, and a handful of k×k Cholesky solves and
    (k, n)·(n, k) Gram products with fp32 accumulation, amortized over the
    SpMM.  Every float32 contraction runs at ``Precision.HIGHEST``: a GPU
    would otherwise take TF32 inputs, which keep ~3 digits and stall the
    Krylov recurrence, for products too thin to gain from it.

    Stops when EVERY column satisfies ``‖r_j‖ ≤ max(tol·‖b_j‖, atol)``
    or at ``maxiter``, then holds the block to its true residual
    (:func:`cgx.solve.cg.settle`).
    """
    if b.ndim != 2:
        raise ValueError(f"block_cg_solve expects b of shape (n, k), "
                         f"got {b.shape}")
    n, k = b.shape
    if maxiter is None:
        maxiter = n
    matvec = as_matvec(a)
    mv = jax.vmap(matvec, in_axes=1, out_axes=1)    # (n, k) SpMM
    if preconditioner is None:
        def apply_m(r):
            return r
    else:
        apply_m = jax.vmap(_as_apply(preconditioner), in_axes=1, out_axes=1)

    f32 = jnp.float32 if b.dtype in (jnp.dtype(jnp.bfloat16),
                                     jnp.dtype(jnp.float16),
                                     jnp.dtype(jnp.float32)) else b.dtype

    hi = jax.lax.Precision.HIGHEST

    def gram(u, v):
        # (k, k) = uᵀ v with accumulation in f32 (or f64 for f64 inputs).
        return jnp.matmul(u.astype(f32).T, v.astype(f32), precision=hi,
                          preferred_element_type=f32)

    def mm(u, v):
        return jnp.matmul(u, v, precision=hi)

    def solve_spd(g, rhs):
        # g = PᵀAP with orthonormal P: SPD, cond(g) ≤ cond(A).  A tiny
        # relative jitter guards the Cholesky against fp32 roundoff on
        # the last bits; it does not change the math at convergence.
        eps = (jnp.trace(g) / k) * jnp.asarray(1e-6 if f32 == jnp.float32
                                               else 1e-14, f32) \
            + jnp.asarray(1e-30, f32)
        c, low = jax.scipy.linalg.cho_factor(
            g + eps * jnp.eye(k, dtype=f32), lower=True)
        return jax.scipy.linalg.cho_solve((c, low), rhs)

    def orth(u):
        # Thin QR in f32; near-zero columns yield arbitrary-but-
        # orthonormal replacements (harmless extra search directions).
        q, _ = jnp.linalg.qr(u.astype(f32))
        return q

    def norm_sq(r):
        return jnp.sum(r.astype(f32) ** 2, axis=0)   # (k,)

    bb = norm_sq(b)
    tol_sq = jnp.maximum(jnp.asarray(tol, f32) ** 2 * bb,
                         jnp.asarray(atol, f32) ** 2)

    def run(x, it, aux):
        if x is None:
            x = jnp.zeros_like(b)
            r = b
        else:
            x = x.astype(b.dtype)
            r = b - mv(x)
        x, r, p, rr, it = jax.lax.while_loop(
            cond, body, (x, r, orth(apply_m(r)), norm_sq(r), it))
        return x, it, rr, aux

    def cond(c):
        x, r, p, rr, it = c
        return jnp.logical_and(it < maxiter, jnp.any(rr > tol_sq))

    def body(c):
        x, r, p, rr, it = c
        q = mv(p.astype(b.dtype))
        g = gram(p, q)                               # (k, k) SPD
        alpha = solve_spd(g, gram(p, r))             # (k, k)
        x = x + mm(p, alpha).astype(b.dtype)
        r = r - mm(q.astype(f32), alpha).astype(b.dtype)
        z = apply_m(r)
        beta = -solve_spd(g, gram(q, z))             # (k, k)
        p = orth(z.astype(f32) + mm(p, beta))
        return (x, r, p, norm_sq(r), it + 1)

    x, it, rr, _ = run(x0, jnp.zeros((), jnp.int32), ())
    x, it, _, tt, converged, _ = settle(
        run, x, it, rr, (), true_rr=lambda x: norm_sq(b - mv(x)),
        tol_sq=tol_sq, maxiter=maxiter)
    return CGResult(x=x,
                    iterations=jnp.broadcast_to(it, (k,)),
                    residual_norm_sq=tt.astype(b.dtype),
                    converged=converged,
                    history=jnp.zeros((0,), b.dtype))
