"""Conjugate-gradient solver as a single on-device ``lax.while_loop``.

Re-design of the reference's ``conj_grad`` (``cg.c:88-141``).
Differences that matter (see SURVEY.md §3.2):

* The reference exits **only** on an iteration count (``cg.c:125-127``); here
  convergence is tested on-device every iteration
  (``‖r‖² ≤ max(tol²·‖b‖², atol²)``) with ``maxiter`` as the cap.  Setting
  ``tol=0`` reproduces the reference's fixed-count trajectory exactly (note:
  the reference runs ``max_iter + 1`` updates — its break happens *after*
  the x/r update of iteration ``k == max_iter``).
* The reference recomputes ``rᵀr`` twice per iteration (4 dots/iter,
  ``cg.c:113`` + ``cg.c:129``) and deep-copies x and r every iteration
  (``cg.c:117,120``).  In exact arithmetic the trajectory is identical to
  textbook Hestenes–Stiefel CG with the ``rᵀr`` reuse, which is what this
  implements: 2 global reductions per iteration — the only cross-chip sync
  points when running sharded.
* Everything between the SpMVs (axpy updates, β/α scalars, the convergence
  test) fuses into a couple of XLA fusions; no host round-trips inside the
  loop.
* Convergence is judged on the TRUE residual ``b − A·x``, not on the
  recurrence alone: see :func:`settle`.

Preconditioned CG (PCG) is the same loop with ``z = M⁻¹ r`` and the
``rᵀz`` inner products; ``preconditioner=None`` degenerates to plain CG with
zero overhead (XLA deduplicates the aliased arrays).

Inside ``shard_map`` pass ``axis_name=...`` and a matvec over the local
shard: the two dots become ``psum``s and the whole while_loop runs SPMD.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp

from cgx.ops import blas
from cgx.ops.spmv import spmv

__all__ = ["CGResult", "CGState", "cg_solve", "cg_solve_single_reduction",
           "cg_solve_pipelined", "cg_init", "cg_chunk", "cg_restart",
           "as_matvec", "settle", "RESTARTS", "TRUE_SLACK"]

MatVec = Callable[[jnp.ndarray], jnp.ndarray]

# A recurrence residual drifts from b − A·x under rounding: in float32 at
# tol 1e-6 it reports the tolerance while the true residual is 7x (64²
# 2-D Poisson, random b), 35x (256²) or 130x (thermal2 stand-in at 1/10
# scale, Jacobi) above it (XLA:CPU).  When the recurrence claims the
# tolerance, the solvers recompute b − A·x and, if that misses, restart
# from the iterate with the true residual, at most RESTARTS times, each a
# few iterations: 64² and 128² then end below the tolerance, 256² at 2.1x
# and the thermal2 stand-in at 16x, where more restarts gain nothing.
# ``converged`` needs the true residual within TRUE_SLACK x the
# tolerance, float32's rounding headroom.
RESTARTS = 2
TRUE_SLACK = 10.0


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CGResult:
    """Solver output (a pytree — safe to return from ``jit``)."""

    x: jnp.ndarray                 # solution iterate
    iterations: jnp.ndarray        # int32 — CG iterations performed
    residual_norm_sq: jnp.ndarray  # ‖b - A x‖², recomputed at exit
    # bool — the recurrence met the tolerance before maxiter and the true
    # residual is within TRUE_SLACK x of it (see settle)
    converged: jnp.ndarray
    # ‖r_k‖² for k = 0..maxiter (padded with last value after exit); only
    # populated when track_history=True, else a size-0 array.
    history: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((0,)))

    @property
    def residual_norm(self) -> jnp.ndarray:
        return jnp.sqrt(self.residual_norm_sq)


def as_matvec(a: Union[MatVec, object]) -> MatVec:
    """Normalize a matrix pytree or callable into a matvec closure."""
    if callable(a):
        return a
    return partial(spmv, a)


@dataclass(frozen=True)
class CGState:
    """Full solver state — O(n) and sufficient to resume a solve exactly.

    This is the checkpoint/elasticity unit (SURVEY.md §5.c/d): CG is
    restartable from ``(x, r, z, p, rz, rr, k)``; snapshot it with
    :mod:`cgx.utils.checkpoint` and resume via :func:`cg_chunk`.
    """

    x: jnp.ndarray
    r: jnp.ndarray
    z: jnp.ndarray
    p: jnp.ndarray
    rz: jnp.ndarray
    rr: jnp.ndarray
    k: jnp.ndarray
    history: jnp.ndarray


jax.tree_util.register_dataclass(
    CGState, data_fields=["x", "r", "z", "p", "rz", "rr", "k", "history"],
    meta_fields=[])

_State = CGState


def cg_solve(
    a: Union[MatVec, object],
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner: Optional[Union[MatVec, object]] = None,
    axis_name: Optional[str] = None,
    track_history: bool = False,
    restarts: int = RESTARTS,
) -> CGResult:
    """Solve ``A x = b`` for SPD ``A`` by (preconditioned) CG.

    Args:
      a: a cgx sparse matrix pytree or a matvec callable. Inside
        ``shard_map`` this must act on the *local* shard (including any halo
        exchange) and return the local result shard.
      b: right-hand side (local shard when sharded).
      x0: initial iterate; defaults to zeros (the reference's choice,
        ``mv_ops.c:32`` via calloc).
      tol: relative tolerance — exit when ``‖r‖² ≤ tol²·‖b‖²``.  ``tol=0``
        with ``atol=0`` gives fixed-iteration behavior (reference parity).
      atol: absolute tolerance floor on ``‖r‖``.
      maxiter: iteration cap (defaults to the global problem size).
      preconditioner: ``None`` | matvec callable | object with ``.apply``;
        applies ``M⁻¹`` to a residual.
      axis_name: mesh axis for global reductions when running under
        ``shard_map``.
      track_history: record ``‖r_k‖²`` per iteration into
        ``CGResult.history`` (length ``maxiter + 1``).
      restarts: cap on restarts from the true residual (:func:`settle`);
        0 for inner solves whose caller holds the true residual itself.

    Returns:
      :class:`CGResult`. Fully jit-compatible; differentiable in the inputs
      only via implicit-function tricks (not provided here).
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    maxiter = _default_maxiter(maxiter, b, axis_name)

    state0 = cg_init(matvec, b, x0, preconditioner=apply_m,
                     axis_name=axis_name,
                     history_len=maxiter + 1 if track_history else 0)
    tol_sq = _tol_sq(tol, atol, b, axis_name)

    cond, body = _make_cond_body(matvec, apply_m, axis_name, maxiter,
                                 tol_sq, track_history)
    final = jax.lax.while_loop(cond, body, state0)

    def run(x, k, history):
        s = cg_restart(matvec, b, dataclasses.replace(
            final, x=x, k=k, history=history), preconditioner=apply_m,
            axis_name=axis_name)
        s = jax.lax.while_loop(cond, body, s)
        return s.x, s.k, s.rr, s.history

    x, k, rr, true_rr, converged, history = settle(
        run, final.x, final.k, final.rr, final.history,
        true_rr=partial(_true_rr, matvec, b, axis_name=axis_name),
        tol_sq=tol_sq, maxiter=maxiter, restarts=restarts)
    if track_history:
        # Pad post-exit slots with the final residual so plots stay flat.
        idx = jnp.arange(maxiter + 1)
        history = jnp.where(idx <= k, history, rr)

    return CGResult(x=x, iterations=k, residual_norm_sq=true_rr,
                    converged=converged, history=history)


def _true_rr(matvec, b, x, axis_name=None):
    r = b - matvec(x)
    return blas.dot(r, r, axis_name)


def settle(run, x, k, rr, aux, *, true_rr, tol_sq, maxiter,
           restarts=RESTARTS):
    """Hold a finished solve to its true residual.

    ``(x, k, rr, aux)`` is what a solver's loop ended on: iterate,
    iteration count, recurrence ``‖r‖²`` and any state the caller carries
    across restarts (a history buffer, or ``()``).  ``run(x, k, aux)``
    restarts that loop from iterate ``x`` with its count at ``k``.  While
    the recurrence meets ``tol_sq`` but ``true_rr(x) = ‖b − A x‖²`` does
    not, and ``k < maxiter``, the loop is restarted, at most ``restarts``
    times.  ``rr`` and ``tol_sq`` may carry a column axis: a block
    restarts when every column's recurrence met its tolerance and any
    column's true residual misses it.

    Returns ``(x, k, rr, true ‖b − A x‖², converged, aux)``;
    ``converged`` holds where the recurrence met ``tol_sq`` and the true
    residual lies within :data:`TRUE_SLACK` x the tolerance.
    """
    def again(c):
        x, k, rr, tt, aux, j = c
        return (jnp.all(rr <= tol_sq) & jnp.any(tt > tol_sq)
                & (k < maxiter) & (j < restarts))

    def restart(c):
        x, k, _, _, aux, j = c
        x, k, rr, aux = run(x, k, aux)
        return x, k, rr, true_rr(x), aux, j + 1

    x, k, rr, tt, aux, _ = jax.lax.while_loop(
        again, restart,
        (x, k, rr, true_rr(x), aux, jnp.zeros((), jnp.int32)))
    converged = (rr <= tol_sq) & (tt <= TRUE_SLACK ** 2 * tol_sq)
    return x, k, rr, tt, converged, aux


def _as_apply(preconditioner):
    if preconditioner is None:
        return None
    if hasattr(preconditioner, "apply"):
        return preconditioner.apply
    return preconditioner


def _default_maxiter(maxiter, b, axis_name):
    if maxiter is None:
        # Global dimension: CG terminates in <= n steps in exact arithmetic.
        n_global = b.shape[0]
        if axis_name is not None:
            # axis size is static under shard_map; stays a Python int.
            n_global = n_global * jax.lax.psum(1, axis_name)
        maxiter = n_global
    return int(maxiter)


def _tol_sq(tol, atol, b, axis_name):
    bb = blas.norm_sq(b, axis_name)
    dtype = b.dtype
    return jnp.maximum(
        jnp.asarray(tol, dtype) ** 2 * bb, jnp.asarray(atol, dtype) ** 2)


def cg_init(a, b, x0=None, *, preconditioner=None, axis_name=None,
            history_len: int = 0) -> CGState:
    """Initial :class:`CGState` for ``A x = b`` (x₀ defaults to zeros)."""
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    if x0 is None:
        x0 = jnp.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    z0 = apply_m(r0) if apply_m is not None else r0
    rz0 = blas.dot(r0, z0, axis_name)
    rr0 = blas.dot(r0, r0, axis_name) if apply_m is not None else rz0
    hist0 = (jnp.zeros((history_len,), b.dtype).at[0].set(rr0)
             if history_len else jnp.zeros((0,), b.dtype))
    return CGState(x=x0, r=r0, z=z0, p=z0, rz=rz0, rr=rr0,
                   k=jnp.zeros((), jnp.int32), history=hist0)


def cg_restart(a, b, state: CGState, *, preconditioner=None,
               axis_name=None) -> CGState:
    """``state`` re-seeded from its iterate: the true residual
    ``r = b − A x`` and fresh search directions ``p = z = M⁻¹ r``, with its
    iteration count and history kept."""
    s = cg_init(a, b, state.x, preconditioner=preconditioner,
                axis_name=axis_name)
    return dataclasses.replace(s, k=state.k, history=state.history)


def _make_cond_body(matvec, apply_m, axis_name, maxiter, tol_sq,
                    track_history):
    def cond(s: CGState):
        return jnp.logical_and(s.k < maxiter, s.rr > tol_sq)

    def body(s: CGState) -> CGState:
        q = matvec(s.p)
        pq = blas.dot(s.p, q, axis_name)
        alpha = s.rz / pq
        x = s.x + alpha * s.p
        r = s.r - alpha * q
        z = apply_m(r) if apply_m is not None else r
        rz = blas.dot(r, z, axis_name)
        rr = blas.dot(r, r, axis_name) if apply_m is not None else rz
        beta = rz / s.rz
        p = z + beta * s.p
        if track_history:
            # Saturate at the last slot rather than silently dropping
            # out-of-bounds writes (cg_chunk may run past the buffer).
            idx = jnp.minimum(s.k + 1, s.history.shape[0] - 1)
            hist = s.history.at[idx].set(rr)
        else:
            hist = s.history
        return CGState(x=x, r=r, z=z, p=p, rz=rz, rr=rr, k=s.k + 1,
                       history=hist)

    return cond, body


def cg_solve_single_reduction(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    axis_name: Optional[str] = None,
) -> CGResult:
    """Chronopoulos–Gear CG: ONE fused global reduction per iteration.

    Standard CG needs two *dependent* reductions per iteration (pᵀq, then
    rᵀz) — two latency-bound ``psum`` sync points when sharded.  This
    variant restructures the recurrences so both scalars (γ = rᵀu and
    δ = wᵀu) are computed together from independent data and fuse into a
    single ``psum`` of a length-2 vector, at the cost of one extra axpy and
    one extra carried vector.  Per-iteration cross-chip latency halves;
    use for many-host meshes where ICI/DCN latency, not bandwidth, bounds
    the iteration.  Trajectory is algebraically identical to CG (slightly
    different rounding).

    Reference: Chronopoulos & Gear, J. Comput. Appl. Math. 25 (1989);
    the same restructuring used by pipelined-CG literature (Ghysels &
    Vanroose, 2014) without the depth-1 pipelining.
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    maxiter = _default_maxiter(maxiter, b, axis_name)
    dtype = b.dtype
    tol_sq = _tol_sq(tol, atol, b, axis_name)

    def fused_dots(r, u, w):
        """γ = rᵀu, δ = wᵀu, ρ = rᵀr in ONE cross-chip reduction."""
        local = jnp.stack([jnp.vdot(r, u), jnp.vdot(w, u), jnp.vdot(r, r)])
        if axis_name is not None:
            local = jax.lax.psum(local, axis_name)
        return local[0], local[1], local[2]

    def run(x0, k0, aux):
        if x0 is None:
            x0 = jnp.zeros_like(b)
            r0 = b
        else:
            r0 = b - matvec(x0)
        u0 = apply_m(r0) if apply_m is not None else r0
        w0 = matvec(u0)
        gamma0, delta0, rr0 = fused_dots(r0, u0, w0)
        alpha0 = gamma0 / delta0
        # Carried state: (x, r, u, w, p, s, alpha, beta, gamma, rr, k).
        zeros = jnp.zeros_like(b)
        f = jax.lax.while_loop(cond, body, (
            x0, r0, u0, w0, zeros, zeros, alpha0, jnp.zeros((), dtype),
            gamma0, rr0, k0))
        return f[0], f[10], f[9], aux

    def cond(c):
        return jnp.logical_and(c[10] < maxiter, c[9] > tol_sq)

    def body(c):
        x, r, u, w, p, s, alpha, beta, gamma, rr, k = c
        p = u + beta * p
        s = w + beta * s            # s = A p by linearity
        x = x + alpha * p
        r = r - alpha * s
        u = apply_m(r) if apply_m is not None else r
        w = matvec(u)
        gamma_new, delta, rr = fused_dots(r, u, w)
        beta = gamma_new / gamma
        alpha = gamma_new / (delta - beta * gamma_new / alpha)
        return (x, r, u, w, p, s, alpha, beta, gamma_new, rr, k + 1)

    return _settled(run, x0, matvec, b, tol_sq, maxiter, axis_name)


def _settled(run, x0, matvec, b, tol_sq, maxiter, axis_name):
    """A :class:`CGResult` for a solver whose loop ``run(x0, k0, aux)``
    returns ``(x, k, rr, aux)``: one run from ``x0``, then :func:`settle`."""
    x, k, rr, _ = run(x0, jnp.zeros((), jnp.int32), ())
    x, k, _, tt, converged, _ = settle(
        run, x, k, rr, (), true_rr=partial(_true_rr, matvec, b,
                                           axis_name=axis_name),
        tol_sq=tol_sq, maxiter=maxiter)
    return CGResult(x=x, iterations=k, residual_norm_sq=tt,
                    converged=converged, history=jnp.zeros((0,), b.dtype))


def cg_solve_pipelined(
    a,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    preconditioner=None,
    axis_name: Optional[str] = None,
    replace_every: int = 25,
    adaptive_replace: bool = False,
) -> CGResult:
    """Ghysels–Vanroose pipelined (P)CG: the single fused reduction
    OVERLAPS the preconditioner apply and the SpMV.

    :func:`cg_solve_single_reduction` fuses the two reductions into one
    ``psum`` but that psum still sits on the critical path (α/β gate every
    vector update).  This variant restructures the recurrences one step
    further (Ghysels & Vanroose, Parallel Computing 40, 2014): the body
    computes ``m = M⁻¹w`` and ``n = A m`` from data that does NOT depend
    on the in-flight reduction, so XLA's latency-hiding scheduler can run
    the cross-chip ``psum`` concurrently with the local matvec — per-
    iteration critical path ≈ max(matvec, reduction latency) instead of
    their sum.  The price: three extra carried vectors (z, q, s) and the
    textbook pipelined-CG rounding drift.  Two stabilizations (both
    measured necessary in fp32, where the naive form stalls already at
    48²-Poisson scale):

    * α is formed from the honest Rayleigh quotient — ``pᵀAp`` expanded
      bilinearly from three extra cross dots fused into the SAME single
      reduction — instead of the cancellation-prone recurrence
      ``δ − βγ/α_prev``.
    * Every ``replace_every`` iterations the drifted auxiliary vectors
      are rebuilt from their definitions (``r = b − Ax``, ``u = M⁻¹r``,
      ``w = Au``, ``s = Ap``, ``q = M⁻¹s``, ``z = Aq`` — Cools et al.'s
      residual replacement), ~3 extra matvecs per replacement.
      ``replace_every=0`` disables (fp64 needs neither fix: trajectory
      then matches CG to the iteration).

    ``adaptive_replace=True`` switches the cadence to the van der
    Vorst–Ye (1999) drift criterion: a running bound on the gap between
    the true and recurrence residuals, ``d ← d + ε·(‖r‖ + λ̂·‖x‖)``
    (λ̂ = running max of the Rayleigh quotient δ/γ — free from the fused
    dots), triggers replacement when all three hold: ``d > √ε·‖r‖``
    (the gap is about to matter), ``d > 1.1·d_at_last_replacement``
    (geometric spacing — without it the criterion saturates to
    continuous firing once ‖r‖ is small), and ``‖r‖² > 100·tol²‖b‖²``
    (near the target the plain recurrence runs free, so late-stage exit
    semantics match ``cg_solve``).  ``replace_every`` is ignored when
    adaptive.

    Measured fp32 envelope (2-D Poisson, tol=1e-6, tests/test_cg.py):
    the periodic form converges only to κ ≈ 4·10³ — beyond that its
    honest (replacement-refreshed) residual sits at the fp32 floor,
    10–100× above tol, and the loop exits on the stagnation guard with
    ``converged=False``.  ``adaptive_replace`` converges through the
    whole measured range (κ up to ≈ 5·10⁴: 128²/192²/256² Poisson) at
    +1–17% iterations vs standard CG, with TRUE residuals 1.4–2.6×
    BETTER than standard CG's at the same tol (CG's recurrence drifts
    optimistically; the adaptive form re-syncs it exactly while it
    still converges).  Use on many-host meshes where reduction latency
    rivals the local SpMV; for the tightest fp32 tolerances on the
    worst-conditioned systems prefer ``cg_solve_single_reduction``.

    Algorithm anchor: the reference's ``conj_grad`` (cg.c:88-141) —
    same iteration in exact arithmetic, reorganized for overlap.
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    maxiter = _default_maxiter(maxiter, b, axis_name)
    dtype = b.dtype
    tol_sq = _tol_sq(tol, atol, b, axis_name)

    def fused_dots(r, u, w, p, s, x):
        """Seven scalars in ONE cross-chip reduction: γ = rᵀu, δ = wᵀu,
        ρ = rᵀr, the cross terms uᵀs, pᵀw, pᵀs that let the next
        iteration form α's denominator ``p'ᵀAp' = δ + β(uᵀs + pᵀw) +
        β²·pᵀs`` by bilinearity — the honest Rayleigh quotient instead of
        the cancellation-prone recurrence ``δ − βγ/α_prev`` — and ``xᵀx``
        for the adaptive-replacement drift model.  (Measured: the
        recurrence form stalls fp32 solves at 48²-Poisson scale even
        with per-iteration residual replacement; the bilinear form
        tracks standard CG's iteration counts.)"""
        local = jnp.stack([jnp.vdot(r, u), jnp.vdot(w, u), jnp.vdot(r, r),
                           jnp.vdot(u, s), jnp.vdot(p, w), jnp.vdot(p, s),
                           jnp.vdot(x, x)])
        if axis_name is not None:
            local = jax.lax.psum(local, axis_name)
        return local

    # Carry: (x, r, u, w, z, q, s, p, γ_prev, dots, k) — the dots slot
    # always holds the fused reduction over the CURRENT vectors, computed
    # at the END of the previous body (that psum is the one the next
    # body's m/n matvec overlaps).
    # best_rr/strikes: stagnation guard — evaluated on a fixed
    # 50-iteration cadence (NOT per replacement: adaptive replacements
    # cluster near the accuracy floor, and consecutive closely-spaced
    # evaluations would read CG's normal short plateaus as stalls —
    # measured early-exit at 2e-2 relative residual on 192² Poisson):
    # two consecutive windows without a 1% improvement end the solve
    # (converged=False) instead of burning maxiter against the pipelined
    # accuracy plateau.
    # Adaptive-replacement drift model (van der Vorst & Ye 1999; Cools
    # et al. 2018): the gap between the true and recurrence residuals
    # grows per iteration by ~ε·(‖r‖ + ‖A‖·‖x‖); replace once the
    # accumulated bound reaches √ε·‖r‖.  ‖A‖ is estimated for free as
    # the running max of the Rayleigh quotient δ/γ = uᵀAu/uᵀru (exact
    # λ̂ ∈ [λmin, λmax]; a mild underestimate only makes replacement
    # slightly more eager via the √ε margin).
    eps = jnp.asarray(jnp.finfo(dtype).eps, jnp.float32)

    def run(x0, k0, aux):
        if x0 is None:
            x0 = jnp.zeros_like(b)
            r0 = b
        else:
            r0 = b - matvec(x0)
        u0 = apply_m(r0) if apply_m is not None else r0
        w0 = matvec(u0)
        zeros = jnp.zeros_like(b)
        dots0 = fused_dots(r0, u0, w0, zeros, zeros, x0)
        zero32 = jnp.zeros((), jnp.float32)
        f = jax.lax.while_loop(cond, body, (
            x0, r0, u0, w0, zeros, zeros, zeros, zeros,
            jnp.ones((), dtype), dots0, k0,
            dots0[2], jnp.zeros((), jnp.int32), zero32, zero32, zero32))
        return f[0], f[10], f[9][2], aux

    def cond(c):
        return (c[10] < maxiter) & (c[9][2] > tol_sq) & (c[12] < 2)

    def body(c):
        (x, r, u, w, z, q, s, p, g_prev, dots, k, best_rr, strikes,
         drift, lam, d_gate) = c
        gamma, delta, _rr, us, pw, ps = (dots[0], dots[1], dots[2],
                                         dots[3], dots[4], dots[5])
        # m/n depend only on w — independent of the in-flight reduction.
        m = apply_m(w) if apply_m is not None else w
        n = matvec(m)
        beta = jnp.where(k == 0, 0.0, gamma / g_prev).astype(dtype)
        alpha = (gamma
                 / (delta + beta * (us + pw) + beta * beta * ps)
                 ).astype(dtype)
        z = n + beta * z
        q = m + beta * q
        s = w + beta * s
        p = u + beta * p
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        new_dots = fused_dots(r, u, w, p, s, x)
        # Running ‖A‖ estimate (M-weighted Rayleigh quotient, free).
        lam = jnp.maximum(lam, jnp.where(
            gamma > 0, delta / gamma, 0.0).astype(jnp.float32))
        if replace_every or adaptive_replace:
            # Residual replacement: rebuild every recurrence-drifted
            # vector from its definition and refresh the dots.  One
            # lax.cond — the matvecs only execute on replacement steps.
            def refresh(args):
                x, p, *_ = args
                r2 = b - matvec(x)
                u2 = apply_m(r2) if apply_m is not None else r2
                w2 = matvec(u2)
                s2 = matvec(p)
                q2 = apply_m(s2) if apply_m is not None else s2
                z2 = matvec(q2)
                return (r2, u2, w2, z2, q2, s2,
                        fused_dots(r2, u2, w2, p, s2, x))

            def keep(args):
                return args[2:]

            drift = drift + eps * (
                jnp.sqrt(new_dots[2].astype(jnp.float32))
                + lam * jnp.sqrt(new_dots[6].astype(jnp.float32)))
            if adaptive_replace:
                # van der Vorst–Ye trigger, all three clauses measured
                # necessary (see the docstring): (a) the drift bound
                # reached √ε·‖r‖; (b) it grew 1.1× past its value at the
                # last replacement — spaces replacements geometrically
                # and stops them at the accuracy floor, where (a) alone
                # saturates to continuous firing; (c) still well above
                # the target (rr > 100·tol²) — the final stretch then
                # runs the plain recurrence, giving the same late-stage
                # semantics as cg_solve (an honest residual kept synced
                # to the true one can never pass an fp32-floor-level
                # tolerance that the drifted recurrence does pass).
                rr32 = new_dots[2].astype(jnp.float32)
                at_replace = ((drift * drift > eps * rr32)
                              & (drift > 1.1 * d_gate)
                              & (new_dots[2] > 100.0 * tol_sq))
            else:
                at_replace = (k + 1) % replace_every == 0
            d_gate = jnp.where(at_replace, drift, d_gate)
            (r, u, w, z, q, s, new_dots) = jax.lax.cond(
                at_replace, refresh, keep,
                (x, p, r, u, w, z, q, s, new_dots))
            # Replacement resets the drift bound to one fresh step.
            drift = jnp.where(
                at_replace,
                eps * (jnp.sqrt(new_dots[2].astype(jnp.float32))
                       + lam * jnp.sqrt(new_dots[6].astype(jnp.float32))),
                drift)
            at_guard = (k + 1) % 50 == 0
            improved = new_dots[2] < 0.99 * best_rr
            strikes = jnp.where(
                at_guard, jnp.where(improved, 0, strikes + 1), strikes)
            best_rr = jnp.where(at_guard & improved,
                                new_dots[2], best_rr)
        return (x, r, u, w, z, q, s, p, gamma, new_dots, k + 1,
                best_rr, strikes, drift, lam, d_gate)

    return _settled(run, x0, matvec, b, tol_sq, maxiter, axis_name)


def cg_chunk(
    a,
    state: CGState,
    iters: int,
    *,
    b: Optional[jnp.ndarray] = None,
    tol: float = 0.0,
    atol: float = 0.0,
    preconditioner=None,
    axis_name: Optional[str] = None,
) -> CGState:
    """Advance a :class:`CGState` by up to ``iters`` CG iterations.

    The chunked-stepping primitive behind checkpoint/resume and elastic
    recovery (:mod:`cgx.utils.checkpoint`): run a chunk, snapshot the
    returned state, repeat; the trajectory is identical to one uninterrupted
    :func:`cg_solve`.  Pass ``b`` with a nonzero ``tol`` to stop early
    inside the chunk (relative tolerance needs ‖b‖).  Jittable.

    History note: the residual history buffer is sized at :func:`cg_init`
    (``history_len``); once the cumulative iteration count reaches the
    buffer end, further entries overwrite the last slot (saturate) rather
    than being silently dropped.
    """
    matvec = as_matvec(a)
    apply_m = _as_apply(preconditioner)
    if b is not None:
        tol_sq = _tol_sq(tol, atol, b, axis_name)
    else:
        tol_sq = jnp.asarray(atol, state.r.dtype) ** 2
    upto = state.k + iters
    track = state.history.shape[0] > 0

    def cond(s: CGState):
        return jnp.logical_and(s.k < upto, s.rr > tol_sq)

    _, body = _make_cond_body(matvec, apply_m, axis_name, 0, tol_sq, track)
    return jax.lax.while_loop(cond, body, state)
