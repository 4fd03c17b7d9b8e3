"""One solve entry for every operator and right-hand-side shape.

:func:`auto_solve` takes any cgx operator (stored format, matrix-free
stencil or matvec callable) and either one right-hand side or an ``(n, k)``
block, and runs the XLA ``while_loop`` solvers: :func:`cgx.solve.cg.cg_solve`
for a vector, :func:`cgx.solve.block.cg_solve_multi` for a block.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from cgx.solve.cg import CGResult

__all__ = ["auto_solve"]


def auto_solve(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    track_history: bool = False,
) -> CGResult:
    """:func:`cg_solve` semantics for a vector ``b``; a 2-D ``b`` of shape
    ``(n, k)`` routes to the batched :func:`cg_solve_multi` (per-column
    convergence, fields carry a ``(k,)`` batch axis).  Jittable."""
    if b.ndim == 2:
        if track_history:
            raise ValueError("track_history is not supported for "
                             "multi-RHS (2-D b) solves")
        from cgx.solve.block import cg_solve_multi
        return cg_solve_multi(a, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                              preconditioner=preconditioner)
    from cgx.solve.cg import cg_solve
    return cg_solve(a, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                    preconditioner=preconditioner,
                    track_history=track_history)
