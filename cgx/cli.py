"""``cgx`` command-line interface: solve / gen / bench / info.

Replacement for the reference CLI (``main`` at ``cg.c:42-85``):
``cg <input-data> <max-iterations> [suppress-output]``.  Differences
(SURVEY.md §2.1 #14, §5.f):

* A real flag system (problem source, format, dtype, tol, maxiter,
  preconditioner, device count) instead of 3 positional args with a dead
  ``suppress-output`` flag (parsed at ``cg.c:56-57``, never read).
* ``--legacy-compat`` reproduces the reference's exact semantics: fixed
  iteration count (``tol=0``), ``max_iterations + 1`` updates (the
  reference's break is post-update, ``cg.c:125-127``), and a final solution
  dump in ``print_sparse``'s ``\\t%f`` format (``mv_ops.c:77-95``).
* Timing is wall-clock with ms resolution plus per-solve device stats — the
  reference prints whole seconds from ``time(NULL)`` (``cg.c:71-75``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, NamedTuple


def _build_matrix(args):
    """Problem setup from flags → (matrix-or-matvec, b, n)."""
    import jax.numpy as jnp
    import numpy as np

    dtype = dict(f32=np.float32, f64=np.float64,
                 bf16=jnp.bfloat16)[args.dtype]
    if getattr(args, "accuracy", "fp32") == "df64":
        dtype = np.float64       # the df64 split takes the exact values

    if args.format is None:
        # The reference-class user (`cg <file> <iters>`, cg.c:42-85) gets
        # a storage pick with no extra flags: file inputs default to `auto`
        # (cgx.auto_format: ELL or CSR, printed); the synthetic generators
        # keep their explicit csr default.
        args.format = "auto" if args.input else "csr"

    if args.input:
        if args.input.endswith(".npz"):
            from cgx.io.native_format import load_matrix
            a, b = load_matrix(args.input)
            if b is None:
                b = jnp.ones((a.shape[0],))
            a = a.astype(dtype)
            b = jnp.asarray(b, dtype)
            a = _apply_unstructured_format(args, a)
            return a, b, a.shape[0]
        if args.input.endswith((".mtx", ".mtx.gz")):
            from cgx.io.matrix_market import read_matrix_market
            a = read_matrix_market(args.input, dtype=np.float64)
            b = jnp.ones((a.shape[0],))
        else:
            from cgx.io.legacy import read_legacy
            a, b = read_legacy(args.input)
        a = a.astype(dtype)
        b = jnp.asarray(b, dtype)
        a = _apply_unstructured_format(args, a)
        return a, b, a.shape[0]

    dims = [int(d) for d in args.poisson.split("x")]
    from cgx.io import poisson
    if len(dims) == 2:
        gen = {"csr": poisson.poisson2d, "dia": poisson.poisson2d_dia}
    elif len(dims) == 3:
        gen = {"csr": poisson.poisson3d, "dia": poisson.poisson3d_dia}
    else:
        raise SystemExit("--poisson must be NXxNY or NXxNYxNZ")

    if args.format == "stencil":
        from cgx.sparse import stencil as st
        if len(dims) == 2:
            a = st.poisson2d_stencil(*dims)
        else:
            a = st.poisson3d_stencil(*dims)
        n = a.shape[0]
        b = jnp.ones((n,), dtype)
        return a, b, n

    fmt = args.format if args.format in ("csr", "dia") else "csr"
    a = gen[fmt](*dims, dtype=np.float64)
    if args.format == "ell":
        from cgx.sparse.types import ell_from_csr
        a = ell_from_csr(a)
    elif args.format == "bsr":
        from cgx.sparse.types import bsr_from_csr
        a = bsr_from_csr(a, args.blocksize)
    a = a.astype(dtype)
    a = _apply_unstructured_format(args, a)
    n = a.shape[0]
    b = jnp.ones((n,), dtype)
    return a, b, n


def _apply_unstructured_format(args, a):
    """``--format auto`` on a CSR source: ELL when its row padding wastes
    little, else CSR (:func:`cgx.sparse.types.auto_format`; the pick is
    printed).  No-op for other formats, for the df64 path (it builds its
    own operators from the CSR) and for ``--devices N`` (the partitioner
    takes the CSR)."""
    if args.format != "auto" or not hasattr(a, "indptr"):
        return a
    if getattr(args, "accuracy", "fp32") == "df64":
        return a
    if getattr(args, "devices", 1) > 1:
        return a
    from cgx.sparse.types import auto_format
    op, fmt = auto_format(a)
    print(f"format={fmt}", file=sys.stderr)
    return op


def _make_precond(args, a):
    if args.precond == "none":
        return None
    import cgx
    if args.precond == "jacobi":
        return cgx.JacobiPrecond.from_matrix(a)
    if args.precond == "block-jacobi":
        return cgx.BlockJacobiPrecond.from_matrix(a, args.blocksize)
    if args.precond == "ic0":
        return cgx.IC0Precond.from_matrix(a)
    if args.precond == "ic0-sweep":
        return cgx.IC0SweepPrecond.from_matrix(a, nsweeps=args.sweeps)
    if args.precond == "poly":
        return cgx.PolynomialPrecond.from_matrix(a, steps=args.poly_steps)
    raise SystemExit(f"unknown preconditioner {args.precond!r}")


class Solved(NamedTuple):
    """What ``cgx solve`` computed: its exit code, the operator and
    right-hand side it built, the solver result, the solve's wall seconds
    and the solution as a host array of the problem's length."""

    code: int
    a: Any
    b: Any
    res: Any
    seconds: float
    x: Any


def cmd_solve(args):
    return run_solve(args).code


def run_solve(args) -> Solved:
    """``cgx solve`` for parsed ``args`` (:func:`parse_args`): builds,
    solves, reports on stderr and returns :class:`Solved`."""
    import jax

    if args.devices > 1 and args.accuracy == "df64":
        raise SystemExit("--accuracy df64 runs on one device")
    if args.accuracy == "df64" or args.dtype == "f64":
        # float64 values must reach the solver (or the df64 split)
        # unrounded: build and solve under a scoped x64 (the df64 path's
        # fp32 inners are typed).
        with jax.enable_x64(True):
            return _solve_and_report(args)
    return _solve_and_report(args)


def _solve_and_report(args):
    import jax
    import numpy as np
    import cgx

    a, b, n = _build_matrix(args)
    maxiter = args.maxiter
    tol = args.tol
    if args.legacy_compat:
        tol = 0.0
        maxiter = (maxiter if maxiter is not None else 30) + 1

    if args.devices > 1:
        res, dt, x = _solve_distributed(args, a, b, n, tol, maxiter)
    elif args.accuracy == "df64":
        # High-accuracy path (the reference computes in double throughout,
        # mv_ops.h:19-21): fp32 PCG inner solves inside a df64
        # true-residual iterative-refinement loop — reaches TRUE relres
        # <= tol on kappa ~ 1e10 systems.
        from cgx.ops.df64 import df_to_f64
        from cgx.solve.hp import make_ir_df64_solver
        if not hasattr(a, "indptr"):
            raise SystemExit("--accuracy df64 needs a CSR-loadable source "
                             "(Matrix Market / legacy / poisson)")
        m = _make_precond(args, a.astype(np.float32))   # fp32 inners
        inner_fmt = "auto" if args.format == "auto" else "ell"
        solver = make_ir_df64_solver(
            a, tol=tol, inner_maxiter=maxiter or 8000, preconditioner=m,
            inner_format=inner_fmt)
        t0 = time.perf_counter()
        res, info = solver(np.asarray(b, np.float64))
        dt = time.perf_counter() - t0
        x = df_to_f64(res.x)
        print(f"df64 outer cycles={info['outer']} "
              f"true_relres={info['relres']:.3e}", file=sys.stderr)
    else:
        m = _make_precond(args, a)
        solve = jax.jit(lambda a, b: cgx.auto_solve(
            a, b, tol=tol, maxiter=maxiter, preconditioner=m))
        t0 = time.perf_counter()
        res = jax.block_until_ready(solve(a, b))
        dt = time.perf_counter() - t0
        x = np.asarray(res.x)

    if args.legacy_compat:
        # print_sparse ordering: size, nnz lines omitted; x entries \t%f.
        for v in x:
            sys.stdout.write("\t%f\n" % float(v))
    print(f"iterations={int(res.iterations)} "
          f"converged={bool(res.converged)} "
          f"residual_norm={float(res.residual_norm):.3e} "
          f"wall_s={dt:.3f}", file=sys.stderr)
    if (not bool(res.converged) and not args.legacy_compat
            and getattr(args, "accuracy", "fp32") != "df64"):
        # An fp32 iterate that stalls above tol on a κ ≥ 1e7 system is
        # exactly the df64 use case — say so instead of dead-ending at
        # exit code 2.
        print("hint: the true residual did not reach tol — this is the "
              "--accuracy df64 use case (df64 true-residual iterative "
              "refinement over fp32 inners reaches TRUE relres <= tol on "
              "κ>=1e7 systems)", file=sys.stderr)
    code = 0 if bool(res.converged) or args.legacy_compat else 2
    return Solved(code, a, b, res, dt, x)


def _solve_distributed(args, a, b, n, tol, maxiter):
    """``solve --devices N``: the row-partitioned solver
    (:func:`cgx.dist.solve.dist_cg_solve`).  ``--method auto`` is plain CG;
    ``single_reduction``/``pipelined``/``chebyshev`` pick the variant.
    DIA and CSR sources partition directly; a stencil is stored as DIA
    first (:func:`cgx.sparse.grid.stencil_to_dia`).
    """
    import jax
    import numpy as np

    from cgx.dist.partition import (partition_csr, partition_dia,
                                    unpad_vector)
    from cgx.dist.solve import dist_cg_solve, make_row_mesh
    from cgx.sparse.grid import stencil_to_dia
    from cgx.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D
    from cgx.sparse.types import CSRMatrix, DIAMatrix

    mesh = make_row_mesh(args.devices)
    method = "cg" if args.method == "auto" else args.method
    precond = {"none": "none", "jacobi": "jacobi",
               "block-jacobi": "block_jacobi", "poly": "poly",
               "ic0-sweep": "ic0_sweep"}.get(args.precond)
    if precond is None:
        raise SystemExit(f"--devices>1 supports --precond none/jacobi/"
                         f"block-jacobi/poly/ic0-sweep (got "
                         f"{args.precond!r})")
    if isinstance(a, (Stencil2D, Stencil3D, GeneralStencil3D)):
        try:
            a = stencil_to_dia(a)
        except ValueError as e:
            raise SystemExit(f"--devices>1: {e}")
    if isinstance(a, DIAMatrix):
        part = partition_dia(a, args.devices)
    elif isinstance(a, CSRMatrix):
        part = partition_csr(a, args.devices)
    else:
        raise SystemExit("--devices>1 supports csr/dia/stencil sources")
    lam = (None, None)
    if method == "chebyshev" and precond == "none":
        # Tensor-product stencil operators have closed-form extreme
        # eigenvalues — skip the distributed power iteration entirely.
        from cgx.solve.chebyshev import analytic_bounds
        lam = analytic_bounds(a) or (None, None)
    t0 = time.perf_counter()
    res = jax.block_until_ready(dist_cg_solve(
        part, b, mesh, tol=tol, maxiter=maxiter, preconditioner=precond,
        blocksize=args.blocksize, poly_steps=args.poly_steps,
        nsweeps=args.sweeps, method=method,
        lam_min=lam[0], lam_max=lam[1]))
    dt = time.perf_counter() - t0
    return res, dt, unpad_vector(np.asarray(res.x), n)


def cmd_gen(args):
    import numpy as np
    from cgx.io import poisson
    dims = [int(d) for d in args.poisson.split("x")]
    if len(dims) == 2:
        a = poisson.poisson2d(*dims)
    elif len(dims) == 3:
        a = poisson.poisson3d(*dims)
    else:
        raise SystemExit("--poisson must be NXxNY or NXxNYxNZ")
    n = a.shape[0]
    rng = np.random.default_rng(args.seed)
    b = rng.standard_normal(n)
    if args.out.endswith(".mtx"):
        from cgx.io.matrix_market import write_matrix_market
        write_matrix_market(args.out, a)
    else:
        from cgx.io.legacy import write_legacy
        write_legacy(args.out, a, b)
    print(f"wrote {args.out}: n={n} nnz={a.nnz}", file=sys.stderr)
    return 0


def cmd_bench(args):
    """Single-config benchmark: time-to-tol + SpMV throughput, JSON out."""
    import jax
    import numpy as np
    import cgx

    a, b, n = _build_matrix(args)
    m = _make_precond(args, a)
    # Route through auto_solve so the bench measures the path users get.
    solve = jax.jit(lambda a, b: cgx.auto_solve(
        a, b, tol=args.tol, maxiter=args.maxiter or 2 * n,
        preconditioner=m))
    res = jax.block_until_ready(solve(a, b))     # compile
    best = min(_timed(lambda: jax.block_until_ready(solve(a, b)))
               for _ in range(args.reps))

    # Chain K SpMVs inside one jitted call and difference two loop lengths:
    # cancels the fixed per-call dispatch and synchronisation cost.
    from functools import partial

    @partial(jax.jit, static_argnums=2)
    def spmv_loop(a, x, k):
        return jax.lax.fori_loop(
            0, k, lambda i, y: cgx.spmv(a, y) * 0.125, x)

    xl = b
    k1, k2 = 20, 60
    jax.block_until_ready(spmv_loop(a, xl, k1))
    jax.block_until_ready(spmv_loop(a, xl, k2))
    t1 = min(_timed(lambda: jax.block_until_ready(spmv_loop(a, xl, k1)))
             for _ in range(3))
    t2 = min(_timed(lambda: jax.block_until_ready(spmv_loop(a, xl, k2)))
             for _ in range(3))
    t_spmv = max(t2 - t1, 1e-9) / (k2 - k1)
    nnz = _nnz(a)
    print(json.dumps({
        "n": n, "nnz": nnz, "format": type(a).__name__,
        "dtype": args.dtype, "precond": args.precond,
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "solve_ms": round(best * 1e3, 3),
        "spmv_us": round(t_spmv * 1e6, 2),
        "spmv_gnnz_s": round(nnz / t_spmv / 1e9, 3),
        "device": jax.devices()[0].platform,
    }))
    return 0


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _nnz(a):
    import numpy as np
    from cgx.sparse.types import DIAMatrix, ELLMatrix, BSRMatrix
    from cgx.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D
    if isinstance(a, GeneralStencil3D):
        return sum((a.nx - abs(dx)) * (a.ny - abs(dy)) * (a.nz - abs(dz))
                   for (dx, dy, dz) in a.taps)
    if isinstance(a, Stencil2D):
        return 5 * a.shape[0] - 2 * (a.nx + a.ny)
    if isinstance(a, Stencil3D):
        return (7 * a.shape[0]
                - 2 * (a.nx * a.ny + a.ny * a.nz + a.nx * a.nz))
    if isinstance(a, DIAMatrix):
        return int(np.count_nonzero(np.asarray(a.data)))
    if isinstance(a, ELLMatrix):
        return int(np.count_nonzero(np.asarray(a.values)))
    if isinstance(a, BSRMatrix):
        return int(a.nnzb) * a.blocksize ** 2
    return int(a.nnz)


def cmd_info(args):
    import jax
    print(f"devices: {jax.devices()}")
    print(f"default backend: {jax.default_backend()}")
    import cgx
    print(f"cgx {cgx.__version__}")
    return 0


def _add_problem_flags(p):
    p.add_argument("--input", help="input file (.mtx[.gz] or legacy 4-line)")
    p.add_argument("--poisson", default="64x64",
                   help="synthetic Poisson dims, e.g. 128x128 or 64x64x64")
    p.add_argument("--format", default=None,
                   choices=["csr", "dia", "ell", "bsr", "stencil", "auto"],
                   help="operator storage; auto = ELL when row padding "
                        "wastes little, else CSR (cgx.auto_format).  "
                        "Default: auto for --input files, csr for "
                        "--poisson")
    p.add_argument("--blocksize", type=int, default=8)
    p.add_argument("--dtype", default="f32", choices=["f32", "f64", "bf16"])
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--precond", default="none",
                   choices=["none", "jacobi", "block-jacobi", "ic0",
                            "ic0-sweep", "poly"])
    p.add_argument("--poly-steps", type=int, default=3)
    p.add_argument("--sweeps", type=int, default=1,
                   help="Neumann sweeps per triangular solve (ic0-sweep)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="cgx", description="conjugate-gradient framework in JAX")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve A x = b")
    _add_problem_flags(ps)
    ps.add_argument("--devices", type=int, default=1,
                    help="row-shard the solve over N devices")
    ps.add_argument("--method", default="auto",
                    choices=["auto", "cg", "single_reduction", "pipelined",
                             "chebyshev"],
                    help="distributed solver method (with --devices>1); "
                         "auto = cg")
    ps.add_argument("--legacy-compat", action="store_true",
                    help="reference semantics: fixed iters, \\t%%f dump")
    ps.add_argument("--accuracy", default="fp32",
                    choices=["fp32", "df64"],
                    help="df64: double-word fp32 iterative refinement to "
                         "TRUE relres <= tol (the reference's fp64 "
                         "envelope; single device)")
    ps.set_defaults(fn=cmd_solve)

    pg = sub.add_parser("gen", help="generate a problem file")
    pg.add_argument("--poisson", default="64x64")
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--out", required=True)
    pg.set_defaults(fn=cmd_gen)

    pb = sub.add_parser("bench", help="benchmark one config (JSON line)")
    _add_problem_flags(pb)
    pb.add_argument("--reps", type=int, default=5)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="device / version info")
    pi.set_defaults(fn=cmd_info)

    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from cgx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
