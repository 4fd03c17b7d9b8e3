#!/usr/bin/env python3
"""Smoke run of cgx on an NVIDIA GPU: the main path at real sizes.

    python chip_smoke.py              # one card: phases A-G
    python chip_smoke.py --devices 4  # four cards: the row-sharded phase only

One process drives the card(s); no child process opens JAX.  Every phase
prints one ``phase=...`` line (shape, dtype, iterations, seconds and the
TRUE relative residual ``‖b − A·x‖/‖b‖``, computed in float64 with
NumPy/SciPy on the host — never by cgx's own solver) and raises when it
misses its bound.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every phase passed.  Without a GPU, or without the cgx
package beside this file, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Bounds, each with its reason.
# fp32 solves stop when the recurrence residual reaches tol = 1e-6 and
# report convergence only when the true residual, recomputed in fp32, is
# within cgx.solve.cg.TRUE_SLACK = 10x of it; the float64 true residual
# is held to the same 10x (fp32 rounding headroom).
TOL = 1e-6
FP32_TRUE_BOUND = 1e-5
# float64 solves restart from the true residual until it meets tol.
F64_TRUE_BOUND = TOL
# The residual a solve reports must agree with the float64 true residual
# within this factor (no silent drift).  Where float32 cannot reach 1e-6
# (a smooth right-hand side such as the CLI's b = ones on a large grid
# needs ~κ·ε), the solve must say so: converged=False and exit code 2.
AGREE_FACTOR = 10.0
# The df64 refinement targets a TRUE float64 relres of 1e-6.
DF64_TRUE_BOUND = 1e-6
# Small-system comparison: fp32 cgx at tol 1e-6 against SciPy's float64
# CG; 64³ Poisson has κ ≈ 1.7e3, so 1e-4 leaves the fp32 solve its
# rounding while catching any wrong operator or preconditioner.
SCIPY_REL_ERR_BOUND = 1e-4
# Four cards against one: same system, right-hand side and method;
# iteration counts may differ only by reduction order.
ITER_MATCH = 0.05


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def phase_line(name, shape, dtype, iters, seconds, relres, **extra):
    parts = [f"phase={name}", f"shape={shape}", f"dtype={dtype}",
             f"iterations={iters}", f"seconds={seconds:.3f}",
             f"true_relres={relres:.3e}"]
    parts += [f"{k}={v}" for k, v in extra.items()]
    print(" ".join(parts), flush=True)


# -- float64 host references --------------------------------------------------

def dia_matvec64(data, offsets, x):
    """``A @ x`` in float64 for row-aligned DIA data (``data[k, i] =
    A[i, i + offsets[k]]``)."""
    x = np.asarray(x, np.float64)
    y = np.zeros_like(x)
    n = x.shape[0]
    for k, off in enumerate(offsets):
        d = np.asarray(data[k], np.float64)
        if off >= 0:
            y[:n - off] += d[:n - off] * x[off:]
        else:
            y[-off:] += d[-off:] * x[:n + off]
    return y


def relres64(matvec64, b, x):
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - matvec64(x)) / np.linalg.norm(b))


def dia64(a):
    """float64 host matvec of a cgx DIA operator."""
    data = np.asarray(a.data)
    return lambda x: dia_matvec64(data, a.offsets, x)


def poisson_dia(nx, ny, nz):
    """3-D 7-point Poisson as fp32 DIA plus its float64 host matvec."""
    from cgx.io.poisson import poisson3d_dia

    a = poisson3d_dia(nx, ny, nz, dtype=np.float32)
    return a, dia64(a)


def scipy_csr64(a):
    import scipy.sparse as sp

    return sp.csr_matrix((np.asarray(a.values, np.float64),
                          np.asarray(a.col_indices), np.asarray(a.indptr)),
                         shape=a.shape)


def run_cli(argv):
    """``cgx solve`` through the CLI's own parser and solve
    (:func:`cgx.cli.run_solve`), keeping the operator, right-hand side,
    result and solution it computed (:class:`cgx.cli.Solved`)."""
    from cgx import cli

    return cli.run_solve(cli.parse_args(argv))


def honest(name, rep, rel, conv, bound):
    """A solve's report tells the truth: its residual agrees with the
    float64 true one, and a claimed convergence meets ``bound``."""
    ratio = max(rel, rep) / max(min(rel, rep), 1e-300)
    check(ratio <= AGREE_FACTOR,
          f"{name}: reported relres {rep:.3e} vs true {rel:.3e}")
    check(not conv or rel <= bound,
          f"{name}: converged at true relres {rel:.3e}")


def cli_phase(name, shape, dtype, out, matvec64, bound, must_converge=True):
    """Phase line and checks for one ``cgx solve`` run: an honest report
    whose exit code matches it (0 converged, 2 not) and, where
    ``must_converge``, convergence.  Returns its iteration count."""
    it = int(out.res.iterations)
    rel = relres64(matvec64, out.b, out.x)
    rep = float(out.res.residual_norm) / float(
        np.linalg.norm(np.asarray(out.b, np.float64)))
    conv = bool(out.res.converged)
    phase_line(name, shape, dtype, it, out.seconds, rel,
               reported_relres=f"{rep:.3e}", converged=conv,
               exit_code=out.code)
    check(out.code == (0 if conv else 2),
          f"{name}: exit code {out.code} with converged={conv}")
    honest(name, rep, rel, conv, bound)
    check(conv or not must_converge, f"{name}: not converged")
    return it


def timed_solve(fn, *args, warm=True):
    """(result, seconds of a second call) — the first call compiles.
    ``warm=False`` times the one call, compile included."""
    import jax

    if warm:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(*args))
    return res, time.perf_counter() - t0


# -- one-card phases ---------------------------------------------------------

def phase_structured(side=320):
    """A: 3-D Poisson DIA + Jacobi through the CLI (b = ones) in float32,
    which must report honestly whether it reached 1e-6, and in float64,
    which must reach it; then in-process through ``auto_solve`` in float32
    (seeded b)."""
    import jax
    import jax.numpy as jnp

    import cgx

    dims = f"{side}x{side}x{side}"
    for dtype, flag, bound, must in (("float32", "f32", FP32_TRUE_BOUND,
                                      False),
                                     ("float64", "f64", F64_TRUE_BOUND,
                                      True)):
        out = run_cli(["solve", "--poisson", dims, "--format", "dia",
                       "--precond", "jacobi", "--tol", str(TOL),
                       "--dtype", flag])
        cli_phase(f"A_cli_{flag}", dims, dtype, out, dia64(out.a), bound,
                  must_converge=must)
        del out

    a, mv64 = poisson_dia(side, side, side)
    n = a.shape[0]
    b = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                    jnp.float32)
    m = cgx.JacobiPrecond.from_matrix(a)
    solve = jax.jit(lambda a, m, b: cgx.auto_solve(
        a, b, tol=TOL, preconditioner=m))
    res, dt = timed_solve(solve, a, m, b)
    it = int(res.iterations)
    rel = relres64(mv64, b, np.asarray(res.x))
    phase_line("A", dims, "float32", it, dt, rel,
               us_per_iter=f"{dt / max(it, 1) * 1e6:.1f}")
    check(bool(res.converged), "A: not converged")
    check(rel <= FP32_TRUE_BOUND, f"A: true relres {rel:.3e}")
    return dict(a=a, m=m, b=b, solve=solve, iterations=it, seconds=dt)


def loop_seconds(step, arg, x, k1=50, k2=250):
    """Seconds per ``step(arg, y)`` on the card: two chained loop lengths
    inside one jit each, differenced (cancels the fixed per-call cost),
    median of three.  ``arg`` rides as a jit argument, not a constant."""
    from functools import partial

    import jax

    @partial(jax.jit, static_argnums=2)
    def loop(arg, x, k):
        return jax.lax.fori_loop(0, k, lambda i, y: step(arg, y), x)

    for k in (k1, k2):
        jax.block_until_ready(loop(arg, x, k))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(arg, x, k1))
        t1 = time.perf_counter()
        jax.block_until_ready(loop(arg, x, k2))
        t2 = time.perf_counter()
        ts.append(((t2 - t1) - (t1 - t0)) / (k2 - k1))
    return float(np.median(ts))


def spmv_seconds(op, k1=50, k2=250):
    """Seconds per ``cgx.spmv(op, ·)`` (scaled by 0.1 to keep the iterates
    bounded)."""
    import jax.numpy as jnp

    import cgx

    return loop_seconds(lambda a, y: cgx.spmv(a, y) * 0.1, op,
                        jnp.ones((op.shape[0],), op.dtype), k1, k2)


def rate_line(kind, label, t, nbytes):
    bw = nbytes / t
    print(f"{kind}={label} us={t * 1e6:.1f} GBps={bw / 1e9:.1f} "
          f"share_of_3.35TBps={bw / 3.35e12:.3f}", flush=True)
    return t, bw


def spmv_rates(side=320):
    """SpMV rates on the XLA route: matrix-free stencil at ``side`` and
    ``side - 1`` (8 B/row: x read, y written) and stored DIA (36 B/row:
    7 fp32 planes, x, y); and a plain scaled copy of an fp32 vector of the
    same two lengths (8 B/row), the ceiling an elementwise pass reaches."""
    import jax.numpy as jnp

    from cgx.sparse.stencil import poisson3d_stencil

    out = {}
    for s in (side, side - 1):
        st = poisson3d_stencil(s, s, s)
        out[f"stencil_{s}"] = rate_line("spmv", f"stencil_{s}",
                                        spmv_seconds(st), 8 * st.shape[0])
        n = st.shape[0]
        out[f"copy_{s}"] = rate_line(
            "copy", f"{s}^3", loop_seconds(lambda _, y: y * 1.0001, None,
                                           jnp.ones((n,), jnp.float32)),
            8 * n)
    a, _ = poisson_dia(side, side, side)
    out[f"dia_{side}"] = rate_line("spmv", f"dia_{side}", spmv_seconds(a),
                                   36 * a.shape[0])
    return out


def cg_stencil_rate(side=320):
    """Plain CG on the matrix-free stencil: µs/iter and the bytes per row
    per iteration that time implies at 3.35 TB/s (the unfused estimate is
    ~56 B/row)."""
    import jax
    import jax.numpy as jnp

    import cgx
    from cgx.sparse.stencil import poisson3d_stencil

    s = poisson3d_stencil(side, side, side)
    n = s.shape[0]
    b = jnp.ones((n,), jnp.float32)
    solve = jax.jit(lambda b: cgx.cg_solve(s, b, tol=0.0, maxiter=200))
    _, dt = timed_solve(solve, b)
    per = dt / 200
    print(f"cg_stencil={side}^3 us_per_iter={per * 1e6:.1f} "
          f"implied_B_per_row={per * 3.35e12 / n:.1f}", flush=True)
    return per


def phase_unstructured(scale=1.0):
    """B: thermal2 stand-in through auto_solve with Jacobi and
    level-scheduled IC(0): in float32, the path a user who loads the
    matrix gets, and in float64 under a scoped x64.  Each solve's
    reported residual must track the float64 true residual; a float32
    solve need not converge at 1e-6 (its iterate may stall above it), but
    may not claim it falsely."""
    import jax
    import jax.numpy as jnp

    import cgx
    from cgx.io.suitesparse import standin
    from cgx.sparse.types import csr_from_scipy

    t0 = time.perf_counter()
    with jax.enable_x64(True):
        a64 = standin("thermal2", seed=0, scale=scale)
    a_sp = scipy_csr64(a64)
    n = a64.shape[0]
    b64 = np.random.default_rng(1).standard_normal(n)
    a32 = csr_from_scipy(a_sp.astype(np.float32))
    op32, fmt32 = cgx.auto_format(a32)
    print(f"B_setup n={n} nnz={a64.nnz} format={fmt32} "
          f"build_s={time.perf_counter() - t0:.1f}", flush=True)

    def matvec64(x):
        return a_sp @ np.asarray(x, np.float64)

    solve = jax.jit(lambda a, m, b: cgx.auto_solve(
        a, b, tol=TOL, maxiter=20000, preconditioner=m))

    def run(label, op, fmt, a, b, bound):
        out = {}
        for name, make in (("jacobi", cgx.JacobiPrecond.from_matrix),
                           ("ic0", cgx.IC0Precond.from_matrix)):
            t0 = time.perf_counter()
            m = make(a)
            setup = time.perf_counter() - t0
            res, dt = timed_solve(solve, op, m, b)
            rel = relres64(matvec64, b, res.x)
            rep = float(res.residual_norm) / float(jnp.linalg.norm(b))
            conv = bool(res.converged)
            phase_line(f"B_{label}{name}", f"{n}x{n}",
                       jnp.dtype(b.dtype).name, int(res.iterations), dt,
                       rel, reported_relres=f"{rep:.3e}", converged=conv,
                       setup_s=f"{setup:.1f}", format=fmt)
            honest(f"B_{label}{name}", rep, rel, conv, bound)
            out[f"{label}{name}"] = (int(res.iterations), dt, rel, conv)
        return out

    out = run("fp32_", op32, fmt32, a32, jnp.asarray(b64, jnp.float32),
              FP32_TRUE_BOUND)
    with jax.enable_x64(True):
        op64, fmt64 = cgx.auto_format(a64)
        out.update(run("", op64, fmt64, a64, jnp.asarray(b64),
                       F64_TRUE_BOUND))
        for name in ("jacobi", "ic0"):
            check(out[name][3], f"B_{name}: float64 solve not converged")
        spmv_unstructured(op64, fmt64, a64.nnz, 8)
    spmv_unstructured(op32, fmt32, a64.nnz, 4)
    return out


def spmv_unstructured(op, fmt, nnz, itemsize):
    """SpMV rate of the unstructured operator on the XLA route; computed
    bytes: per nonzero one value, its column index and its row index
    (CSR's segment ids), per row x read and y written."""
    import jax.numpy as jnp

    n = op.shape[0]
    return rate_line("spmv", f"thermal2_{fmt}_{jnp.dtype(op.dtype).name}",
                     spmv_seconds(op, 20, 100),
                     (itemsize + 8) * nnz + 2 * itemsize * n)


def df64_exactness(count=1 << 20):
    """Mismatches of the error-free transforms against float64 on the
    device: ``two_sum`` (a + b == s + e) and ``two_prod`` (a·b == p + e)."""
    import jax
    import jax.numpy as jnp

    from cgx.ops.df64 import two_prod, two_sum

    rng = np.random.default_rng(2)
    a = (rng.standard_normal(count)
         * np.exp2(rng.integers(-12, 12, count))).astype(np.float32)
    b = (rng.standard_normal(count)
         * np.exp2(rng.integers(-12, 12, count))).astype(np.float32)
    s, es = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    p, ep = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    bad_sum = int(np.count_nonzero(
        np.asarray(s, np.float64) + np.asarray(es, np.float64) != a64 + b64))
    bad_prod = int(np.count_nonzero(
        np.asarray(p, np.float64) + np.asarray(ep, np.float64) != a64 * b64))
    return bad_sum, bad_prod


def phase_accuracy(scale=1.0):
    """C: bcsstk17 stand-in through ``cgx solve --accuracy df64``, held to
    its float64 true residual, plus the exactness of the error-free
    transforms on the device.  The stand-in is built under a scoped x64 so
    its float64 values reach the file unrounded."""
    import jax

    from cgx.io.matrix_market import write_matrix_market
    from cgx.io.suitesparse import standin

    bad_sum, bad_prod = df64_exactness()
    print(f"df64_eft pairs={1 << 20} two_sum_mismatch={bad_sum} "
          f"two_prod_mismatch={bad_prod}", flush=True)
    check(bad_sum == 0 and bad_prod == 0,
          f"C: error-free transforms inexact on this device "
          f"({bad_sum} sum, {bad_prod} prod mismatches)")

    with jax.enable_x64(True):
        a = standin("bcsstk17", seed=0, scale=scale)
    n = a.shape[0]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bcsstk17_standin.mtx")
        write_matrix_market(path, a)
        out = run_cli(["solve", "--input", path, "--accuracy", "df64",
                       "--tol", str(DF64_TRUE_BOUND)])
    a_sp = scipy_csr64(out.a)
    cli_phase("C_cli", f"{n}x{n}", "df64", out, lambda x: a_sp @ x,
              DF64_TRUE_BOUND)
    return relres64(lambda x: a_sp @ x, out.b, out.x)


def phase_multi_rhs(side=256, k=4):
    """D: cg_solve_multi and block_cg_solve on a (n, k) block, and the
    thin QR that block CG runs every iteration, alone."""
    import jax
    import jax.numpy as jnp

    import cgx

    a, mv64 = poisson_dia(side, side, side)
    n = a.shape[0]
    B = jnp.asarray(np.random.default_rng(3).standard_normal((n, k)),
                    jnp.float32)
    m = cgx.JacobiPrecond.from_matrix(a)
    out = {}
    # Block CG runs once, compile included: its iterations are long.
    for name, fn, warm in (("multi", cgx.cg_solve_multi, True),
                           ("block", cgx.block_cg_solve, False)):
        solve = jax.jit(lambda a, m, B, fn=fn: fn(
            a, B, tol=TOL, preconditioner=m))
        res, dt = timed_solve(solve, a, m, B, warm=warm)
        X = np.asarray(res.x)
        rels = [relres64(mv64, np.asarray(B[:, j]), X[:, j])
                for j in range(k)]
        its = int(np.max(np.asarray(res.iterations)))
        phase_line(f"D_{name}", f"{n}x{k}", "float32", its, dt, max(rels),
                   ms_per_iter=f"{dt / max(its, 1) * 1e3:.2f}",
                   compile_included=not warm,
                   per_column=",".join(f"{r:.2e}" for r in rels))
        check(bool(np.all(np.asarray(res.converged))),
              f"D_{name}: not converged")
        check(max(rels) <= FP32_TRUE_BOUND, f"D_{name}: true relres {rels}")
        out[name] = (its, dt, max(rels))
    qr = jax.jit(lambda B: jnp.linalg.qr(B)[0])
    _, t_qr = timed_solve(qr, B)
    print(f"D_qr shape={n}x{k} ms={t_qr * 1e3:.2f}", flush=True)
    return out


def phase_resume(side=256, chunk=100):
    """E: a checkpointed solve stopped at half its iterations and resumed
    from the snapshot ends on the bit-identical iterate."""
    import jax.numpy as jnp

    import cgx
    from cgx.utils.checkpoint import make_checkpointed_solver

    a, mv64 = poisson_dia(side, side, side)
    n = a.shape[0]
    b = jnp.asarray(np.random.default_rng(4).standard_normal(n),
                    jnp.float32)
    m = cgx.JacobiPrecond.from_matrix(a)
    t0 = time.perf_counter()
    full = cgx.cg_solve_checkpointed(a, b, tol=TOL, preconditioner=m,
                                     chunk=chunk)
    dt = time.perf_counter() - t0
    k_full = int(full.iterations)
    half = (k_full // 2 // chunk) * chunk
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cg_state.npz")
        stopped = make_checkpointed_solver(
            a, tol=TOL, maxiter=half, preconditioner=m, chunk=chunk)(
                b, checkpoint_path=path)
        resumed = make_checkpointed_solver(
            a, tol=TOL, preconditioner=m, chunk=chunk)(
                b, checkpoint_path=path)
    x_full, x_res = np.asarray(full.x), np.asarray(resumed.x)
    same = bool(np.array_equal(x_full, x_res))
    rel = relres64(mv64, b, x_full)
    phase_line("E", f"{n}x{n}", "float32", k_full, dt, rel,
               stopped_at=int(stopped.iterations),
               resumed_iterations=int(resumed.iterations),
               bit_identical=same)
    check(same, "E: resumed iterate differs from the uninterrupted run")
    check(int(resumed.iterations) == k_full, "E: iteration counts differ")
    check(bool(full.converged), "E: not converged")
    check(rel <= FP32_TRUE_BOUND, f"E: true relres {rel:.3e}")
    return same


def phase_trace(structured, top=5):
    """F: one traced solve of phase A's operator; the costliest device
    ops and the device events per CG iteration."""
    import jax

    from cgx.utils.profiling import trace, trace_report

    s = structured
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            res = jax.block_until_ready(s["solve"](s["a"], s["m"], s["b"]))
        rows = trace_report(d, top=None)
    lines = {}
    for r in rows:
        lines[r["line"]] = lines.get(r["line"], 0) + r["count"]
    print(f"F_lines {lines}", flush=True)
    streams = [r for r in rows if r["line"].startswith("Stream")]
    it = max(int(res.iterations), 1)
    events = sum(r["count"] for r in streams)
    busy = sum(r["total_us"] for r in streams)
    print(f"phase=F iterations={it} device_events={events} "
          f"events_per_iter={events / it:.2f} "
          f"device_us_per_iter={busy / it:.1f}", flush=True)
    for r in streams[:top]:
        print(f"F_top op={r['op'][:90]} count={r['count']} "
              f"total_us={r['total_us']:.0f} avg_us={r['avg_us']:.2f}",
              flush=True)
    check(events > 0, "F: no device events in the trace")
    return streams[:top]


def phase_scipy(side=64):
    """G: the small-system comparison against SciPy's float64 CG."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    import cgx

    a, mv64 = poisson_dia(side, side, side)
    n = a.shape[0]
    b64 = np.random.default_rng(5).standard_normal(n)
    op64 = spla.LinearOperator((n, n), matvec=mv64, dtype=np.float64)
    x_ref, info = spla.cg(op64, b64, rtol=1e-12, maxiter=10 * n)
    check(info == 0, f"G: scipy cg info={info}")
    b = jnp.asarray(b64, jnp.float32)
    solve = jax.jit(lambda a, b: cgx.auto_solve(a, b, tol=TOL))
    res, dt = timed_solve(solve, a, b)
    x = np.asarray(res.x, np.float64)
    err = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
    rel = relres64(mv64, b64, x)
    phase_line("G_scipy", f"{n}x{n}", "float32", int(res.iterations), dt,
               rel, rel_err_vs_scipy=f"{err:.3e}")
    check(bool(res.converged), "G: not converged")
    check(err <= SCIPY_REL_ERR_BOUND, f"G: relative error {err:.3e}")
    return err


# -- four-card phase ------------------------------------------------------------

def phase_sharded(n_devices, dims=(512, 256, 256)):
    """H: ``dist_cg_solve`` over an ``n_devices`` row mesh (cg + Jacobi,
    pipelined + Jacobi, Schwarz IC(0) sweeps) on a seeded b in float32,
    and the CLI's ``--devices`` route (b = ones) in float32, which must
    report honestly, and in float64, which must converge; each against
    the float64 true residual, and the cg + Jacobi runs against the
    one-card solve of the same system, right-hand side and precision."""
    import jax
    import jax.numpy as jnp

    import cgx
    from cgx.dist.partition import partition_dia, unpad_vector
    from cgx.dist.solve import dist_cg_solve, make_row_mesh
    from cgx.io.poisson import poisson3d_dia

    devices = jax.devices()
    check(len(devices) >= n_devices,
          f"H: {n_devices} devices asked, {len(devices)} present")
    nx, ny, nz = dims
    a, mv64 = poisson_dia(nx, ny, nz)
    n = a.shape[0]
    one = jax.jit(lambda a, m, b: cgx.cg_solve(a, b, tol=TOL,
                                               preconditioner=m))

    def one_card(name, a, b, bound):
        res, dt = timed_solve(one, a, cgx.JacobiPrecond.from_matrix(a), b)
        it = int(res.iterations)
        rel = relres64(mv64, b, np.asarray(res.x))
        phase_line(name, f"{n}x{n}", jnp.dtype(b.dtype).name, it, dt, rel)
        check(bool(res.converged) and rel <= bound,
              f"{name}: true relres {rel:.3e}")
        return it

    def iterations_match(name, it, it1):
        check(abs(it - it1) <= ITER_MATCH * it1,
              f"{name}: {it} iterations on {n_devices} cards vs {it1} "
              f"on one")

    def spread(name, x):
        shards = sorted({str(s.device) for s in x.addressable_shards})
        print(f"{name}_shards {';'.join(shards)}", flush=True)
        check(len(shards) == n_devices,
              f"{name}: result on {len(shards)} devices")

    b = jnp.asarray(np.random.default_rng(6).standard_normal(n),
                    jnp.float32)
    it1 = one_card("H_one_card", a, b, FP32_TRUE_BOUND)
    mesh = make_row_mesh(n_devices)
    t0 = time.perf_counter()
    part = partition_dia(a, n_devices)
    print(f"H_partition rows_per_card={part.rows_local} "
          f"s={time.perf_counter() - t0:.1f}", flush=True)
    for name, kw in (("cg_jacobi", dict(method="cg",
                                        preconditioner="jacobi")),
                     ("pipelined_jacobi", dict(method="pipelined",
                                               preconditioner="jacobi",
                                               adaptive_replace=True)),
                     ("cg_ic0_sweep", dict(method="cg",
                                           preconditioner="ic0_sweep"))):
        def run(kw=kw):
            return dist_cg_solve(part, b, mesh, tol=TOL, **kw)
        t0 = time.perf_counter()
        res = jax.block_until_ready(run())
        first = dt = time.perf_counter() - t0
        if name != "cg_ic0_sweep":      # its host factorization reruns
            t0 = time.perf_counter()
            res = jax.block_until_ready(run())
            dt = time.perf_counter() - t0
        x = unpad_vector(np.asarray(res.x), n)
        rel = relres64(mv64, b, x)
        it = int(res.iterations)
        phase_line(f"H_{name}", f"{n}x{n}", "float32", it, dt, rel,
                   first_call_s=f"{first:.1f}")
        spread(f"H_{name}", res.x)
        check(bool(res.converged), f"H_{name}: not converged")
        check(rel <= FP32_TRUE_BOUND, f"H_{name}: true relres {rel:.3e}")
        if name == "cg_jacobi":
            iterations_match(f"H_{name}", it, it1)
    del part

    shape = f"{nx}x{ny}x{nz}"
    argv = ["solve", "--poisson", shape, "--format", "dia", "--precond",
            "jacobi", "--devices", str(n_devices), "--tol", str(TOL)]
    out = run_cli(argv + ["--dtype", "f32"])
    cli_phase("H_cli_f32", shape, "float32", out, mv64, FP32_TRUE_BOUND,
              must_converge=False)
    spread("H_cli_f32", out.res.x)
    del out
    with jax.enable_x64(True):
        it64 = one_card("H_one_card_f64",
                        poisson3d_dia(nx, ny, nz, dtype=np.float64),
                        jnp.ones((n,), jnp.float64), F64_TRUE_BOUND)
    out = run_cli(argv + ["--dtype", "f64"])
    it = cli_phase("H_cli_f64", shape, "float64", out, mv64, F64_TRUE_BOUND)
    spread("H_cli_f64", out.res.x)
    iterations_match("H_cli_f64", it, it64)


# -- driver -----------------------------------------------------------------

def result_line(platform, kind, count):
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the row-sharded phase on this many "
                         "cards (default: the one-card phases)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform "
              f"{devices[0].platform!r}); refusing", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "cgx")):
        print("chip_smoke: the cgx package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cgx.utils.compile_cache import enable_compile_cache

    print(f"compile_cache={enable_compile_cache()}", flush=True)
    print(f"devices kind={devices[0].device_kind} count={len(devices)} "
          f"list={[str(d) for d in devices]}", flush=True)
    print(nvidia_smi_line(), flush=True)

    t0 = time.perf_counter()
    if args.devices > 1:
        phase_sharded(args.devices)
    else:
        structured = phase_structured()
        spmv_rates()
        cg_stencil_rate()
        phase_unstructured()
        phase_accuracy()
        phase_multi_rhs()
        phase_resume()
        phase_trace(structured)
        phase_scipy()
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(result_line(devices[0].platform, devices[0].device_kind,
                      len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
