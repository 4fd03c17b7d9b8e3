"""Checkpoint / resume and elastic recovery for iterative solves.

The reference has no failure story (errors are ignored ``-1`` returns,
SURVEY.md §5.c).  Here CG is restartable by construction: the O(n)
:class:`~cgx.solve.cg.CGState` is a complete snapshot, the solver advances
in chunks (:func:`~cgx.solve.cg.cg_chunk`), and every chunk boundary is a
checkpoint opportunity.  Snapshots are host-side ``.npz`` (atomic rename) —
cheap relative to solve time because state is O(n), and format-stable for
cross-process resume after preemption.

:func:`make_checkpointed_solver` builds the jitted chunk step ONCE and
returns a reusable solver — repeated solves on the same operator (bench
reps, multi-RHS sweeps) pay trace/compile cost a single time.
:func:`cg_solve_checkpointed` is the one-shot convenience wrapper.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import numpy as np

from cgx.solve.cg import (RESTARTS, TRUE_SLACK, CGResult, CGState, cg_chunk,
                          cg_init, cg_restart)

__all__ = ["save_state", "load_state", "cg_solve_checkpointed",
           "make_checkpointed_solver"]

_FIELDS = ("x", "r", "z", "p", "rz", "rr", "k", "history")


def save_state(path: str, state: CGState) -> None:
    """Atomically snapshot a :class:`CGState` to ``.npz``."""
    arrays = {f: np.asarray(getattr(state, f)) for f in _FIELDS}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> CGState:
    """Load a snapshot back into a (device) :class:`CGState`."""
    import jax.numpy as jnp

    with np.load(path) as z:
        return CGState(**{f: jnp.asarray(z[f]) for f in _FIELDS})


def make_checkpointed_solver(
    a,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    chunk: int = 100,
    restarts: int = RESTARTS,
) -> Callable[..., CGResult]:
    """Build a reusable chunked solver for operator ``a``.

    Returns ``solve(b, x0=None, *, checkpoint_path=None, on_chunk=None)``
    with :func:`cg_solve_checkpointed` semantics (``restarts`` as for
    :func:`cgx.solve.cg.cg_solve`).  The jitted chunk step is
    traced once at build time and shared across every call — repeated
    solves (bench reps, parameter sweeps) recompile nothing (the per-call
    retrace was measured at ~1.1-1.9 s on CPU; see ADVICE r2).
    """
    import jax
    import jax.numpy as jnp

    from cgx.solve.cg import _tol_sq

    # NOTE on donation (SURVEY.md §2.1 #2): the initial state aliases b
    # (r0 = z0 = p0 = b when x0 is None), so donate_argnums=1 would donate
    # one buffer several times; XLA's while_loop already updates the carried
    # state in place inside each chunk, which is where the traffic is.
    # `iters` is traced (only the while_loop cond uses it), so every chunk —
    # including a short final one — reuses one compilation.  The matrix AND
    # the preconditioner ride as traced ARGUMENTS, not closure constants:
    # closed-over arrays would be baked into the executable as constants
    # (hundreds of MB for large operators or IC(0) factors).  Callables
    # (matvec closures / function preconditioners) are not JAX types and
    # stay closed over.
    a_arg = None if callable(a) else a
    m_arg = (None if (preconditioner is None or callable(preconditioner)
                      and not hasattr(preconditioner, "apply"))
             else preconditioner)

    @jax.jit
    def step(a_, m_, s, b, iters):
        m_step = preconditioner if m_ is None else m_
        return cg_chunk(a if a_ is None else a_, s, iters, b=b, tol=tol,
                        atol=atol, preconditioner=m_step)

    @jax.jit
    def restart(a_, m_, s, b):
        m_step = preconditioner if m_ is None else m_
        return cg_restart(a if a_ is None else a_, b, s,
                          preconditioner=m_step)

    def solve(b, x0=None, *, checkpoint_path: Optional[str] = None,
              on_chunk: Optional[Callable[[CGState], None]] = None
              ) -> CGResult:
        # Default cap: the CG dimension bound.
        mi = int(maxiter) if maxiter is not None else int(b.shape[0])
        if checkpoint_path and os.path.exists(checkpoint_path):
            state = load_state(checkpoint_path)
        else:
            state = cg_init(a, b, x0, preconditioner=preconditioner)
        tol_sq = float(_tol_sq(tol, atol, b, None))

        # cg_solve's loop, stepped from the host, then held to the true
        # residual as cgx.solve.cg.settle does: a restart is snapshotted
        # like any chunk.
        n_restarts = 0
        while True:
            while int(state.k) < mi and float(state.rr) > tol_sq:
                iters = min(chunk, mi - int(state.k))
                state = jax.block_until_ready(
                    step(a_arg, m_arg, state, b, jnp.int32(iters)))
                if checkpoint_path:
                    save_state(checkpoint_path, state)
                if on_chunk is not None:
                    on_chunk(state)
            fresh = restart(a_arg, m_arg, state, b)   # rr = ‖b − A x‖²
            if (float(state.rr) > tol_sq or float(fresh.rr) <= tol_sq
                    or int(state.k) >= mi or n_restarts == restarts):
                break
            state = fresh
            n_restarts += 1

        return CGResult(
            x=state.x,
            iterations=state.k,
            residual_norm_sq=fresh.rr,
            converged=jnp.asarray(
                float(state.rr) <= tol_sq
                and float(fresh.rr) <= TRUE_SLACK ** 2 * tol_sq),
            history=state.history,
        )

    return solve


def cg_solve_checkpointed(
    a,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    chunk: int = 100,
    checkpoint_path: Optional[str] = None,
    on_chunk: Optional[Callable[[CGState], None]] = None,
) -> CGResult:
    """:func:`cg_solve` semantics with periodic snapshots every ``chunk``
    iterations.

    If ``checkpoint_path`` exists the solve RESUMES from it (elastic
    recovery after preemption: relaunch with the same arguments).  The
    trajectory is bit-identical to an uninterrupted solve — chunking only
    changes where the host observes the state.

    One-shot wrapper over :func:`make_checkpointed_solver`; for repeated
    solves on one operator build the solver once instead (each call here
    re-traces the chunk step).
    """
    solver = make_checkpointed_solver(
        a, tol=tol, atol=atol, maxiter=maxiter,
        preconditioner=preconditioner, chunk=chunk)
    return solver(b, x0, checkpoint_path=checkpoint_path, on_chunk=on_chunk)
