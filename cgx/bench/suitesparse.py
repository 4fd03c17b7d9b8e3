"""SuiteSparse-SPD PCG benchmark row (SURVEY.md §6).

Runs (P)CG to ``tol`` on the SuiteSparse target set — the real matrices
when vendored (``CGX_SUITESPARSE_DIR``), else the documented stand-ins
from :mod:`cgx.io.suitesparse` — across the preconditioner set, and
prints one JSON line per (matrix, preconditioner).  Output marks
stand-ins explicitly: their numbers are comparable in character
(dimension, sparsity, conditioning class), not identical to the real
matrices.

Usage: ``python -m cgx.bench.suitesparse [--scale 0.1] [--tol 1e-6]``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def bench_matrix(name: str, a, is_standin: bool, *, tol: float = 1e-6,
                 maxiter: int = 8000, reps: int = 2, dtype="float32",
                 fmt: str = "auto", preconds=None,
                 escalate_df64: bool = False):
    """One matrix across the preconditioner set; returns result dicts.

    ``fmt``: solve-operator storage — ``"ell"`` (row-padded ELLPACK:
    static-shape gathers, but on IRREGULAR matrices the max-degree padding
    multiplies the gather count), ``"csr"``, or ``"auto"``
    (:func:`cgx.sparse.types.pick_format`: ELL when the padding waste is
    ≤ 1.5 slots per nonzero, else CSR).  The preconditioners are always
    built from the exact CSR data.

    Non-converged solves (e.g. bcsstk17's κ≈10¹⁰ in fp32) time a single
    rep — the iteration count and honest ``converged=False`` are the
    data point, not the repeat noise.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cgx
    from cgx.sparse.types import ell_from_csr, pick_format

    a32 = a.astype(jnp.dtype(dtype))
    if fmt == "auto":
        fmt = pick_format(a)
    if fmt == "ell":
        a32 = ell_from_csr(a, width_multiple=8).astype(jnp.dtype(dtype))
    n = a.shape[0]
    rng = np.random.default_rng(0)
    base = rng.standard_normal(n).astype(dtype)

    # Preconditioners build from the exact CSR data (a32 may be ELL).
    wanted = (None if preconds is None
              else [p.strip() for p in preconds.split(",")]
              if isinstance(preconds, str) else list(preconds))

    def want(p):
        return wanted is None or p in wanted

    preconds = {}
    ic0_setup_s = None
    if want("none"):
        preconds["none"] = None
    if want("jacobi"):
        preconds["jacobi"] = cgx.JacobiPrecond(
            inv_diag=(1.0 / a.diagonal()).astype(jnp.dtype(dtype)))
    if want("ic0"):
        try:
            t0 = time.perf_counter()
            preconds["ic0"] = cgx.IC0Precond.from_matrix(
                a, dtype=np.dtype(dtype))
            ic0_setup_s = time.perf_counter() - t0
        except np.linalg.LinAlgError as exc:  # IC(0) breakdown is a real
            preconds["ic0"] = exc             # property of the matrix
        except ValueError as exc:   # a caller-set gather budget refused
            preconds["ic0"] = exc   # the level-packed apply
    if want("block_jacobi"):
        # 3 dof/node for the stiffness set; 8 otherwise.
        bs = 3 if name.startswith("bcsstk") and n % 3 == 0 else 8
        preconds["block_jacobi"] = cgx.BlockJacobiPrecond.from_matrix(a, bs)

    out = []
    df64_cache = {}          # per-matrix df64 solver, shared across rows

    # One compiled solve per (matrix, preconditioner): the timed reps
    # reuse it; operator and preconditioner are traced arguments.
    @jax.jit
    def solve(a_, m_, b_):
        return cgx.cg_solve(a_, b_, tol=tol, maxiter=maxiter,
                            preconditioner=m_)

    for pname, m in preconds.items():
        rec = {"matrix": name, "standin": bool(is_standin), "n": n,
               "nnz": int(a.nnz), "precond": pname, "dtype": dtype,
               "tol": tol, "format": fmt}
        if isinstance(m, Exception):
            pre = ("IC(0) breakdown" if isinstance(m, np.linalg.LinAlgError)
                   else "IC(0) guard")
            rec["error"] = f"{pre}: {m}"[:300]
            out.append(rec)
            continue

        try:
            res = jax.block_until_ready(solve(a32, m, jnp.asarray(base)))
        except Exception as exc:   # noqa: BLE001 — a failing row (e.g.
            # device out of memory) must not kill the sweep; record it.
            rec["error"] = f"{type(exc).__name__}: {exc}"[:300]
            out.append(rec)
            continue
        best = None
        n_reps = reps if bool(res.converged) else 1
        for i in range(n_reps):
            b = jnp.asarray(base * (1 + 0.001 * (i + 1)))
            jax.block_until_ready(b)
            t0 = time.perf_counter()
            res = jax.block_until_ready(solve(a32, m, b))
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        rec.update(iterations=int(res.iterations),
                   converged=bool(res.converged),
                   relres=float(res.residual_norm
                                / jnp.linalg.norm(jnp.asarray(base))),
                   solve_ms=round(best * 1e3, 2))
        if pname == "ic0" and ic0_setup_s is not None:
            rec["setup_s"] = round(ic0_setup_s, 2)
        if escalate_df64 and not rec["converged"]:
            # fp32 NOT-conv is the df64 use case, not a dead end (VERDICT
            # r4 weak #6): record the closed number inline in the same
            # row.  One factory per matrix, shared by every escalated
            # preconditioner row (build + compile paid once).
            rec["df64"] = _df64_escalation(a, base, tol=tol,
                                           maxiter=maxiter,
                                           cache=df64_cache)
        out.append(rec)
    return out


def _df64_escalation(a, b, *, tol, maxiter, cache):
    """df64 retry of a NOT-converged fp32 row: TRUE-relres iterative
    refinement with Jacobi fp32 inners.  ``cache`` holds the per-matrix
    solver so repeated escalations pay the build/compile once."""
    import time

    import jax.numpy as jnp
    import numpy as np

    import cgx
    from cgx.ops.df64 import df_to_f64
    from cgx.solve.hp import make_ir_df64_solver

    try:
        if "solve" not in cache:
            t0 = time.perf_counter()
            m = cgx.JacobiPrecond(
                inv_diag=jnp.asarray(1.0 / a.diagonal(), jnp.float32))
            cache["solve"] = make_ir_df64_solver(
                a, tol=tol, inner_tol=1e-2, inner_maxiter=maxiter,
                preconditioner=m, inner_format="auto")
            cache["build_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        res, info = cache["solve"](np.asarray(b, np.float64))
        dt = time.perf_counter() - t0
        x = df_to_f64(res.x)
        b64 = np.asarray(b, np.float64)
        true_rel = float(np.linalg.norm(b64 - _csr64(a) @ x)
                         / np.linalg.norm(b64))
        return {"true_relres": true_rel, "outer": info["outer"],
                "inner_iterations": info["inner_iterations"],
                "solve_s": round(dt, 2), "build_s": cache["build_s"],
                "converged": bool(res.converged)}
    except Exception as exc:   # noqa: BLE001 — escalation failure must
        return {"error": f"{type(exc).__name__}: {exc}"[:300]}


def _csr64(a):
    import numpy as np
    import scipy.sparse as sp
    if hasattr(a, "indptr") and hasattr(a, "col_indices"):
        return sp.csr_matrix((np.asarray(a.values, np.float64),
                              np.asarray(a.col_indices),
                              np.asarray(a.indptr)), shape=a.shape)
    return sp.csr_matrix(a).astype(np.float64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--names", default="bcsstk17,thermal2")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink stand-in dimensions (CPU smoke)")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=8000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--format", default="auto",
                    choices=["auto", "ell", "csr"])
    ap.add_argument("--dir", default=None,
                    help="directory with real .mtx artifacts")
    ap.add_argument("--preconds", default=None,
                    help="comma-separated preconditioner subset "
                         "(none,jacobi,ic0,block_jacobi); default all")
    ap.add_argument("--escalate-df64", action="store_true",
                    help="retry NOT-converged fp32 rows through the df64 "
                         "true-residual route and record the closed "
                         "number inline (one build per matrix)")
    args = ap.parse_args(argv)

    from cgx.io.suitesparse import load_or_standin

    for name in args.names.split(","):
        a, standin = load_or_standin(name, args.dir, scale=args.scale)
        for rec in bench_matrix(name, a, standin, tol=args.tol,
                                maxiter=args.maxiter, reps=args.reps,
                                fmt=args.format,
                                preconds=args.preconds,
                                escalate_df64=args.escalate_df64):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
