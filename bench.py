"""Benchmark harness — prints ONE JSON line for the driver.

Headline metric: wall-clock of a Jacobi-PCG solve to ‖r‖ ≤ 1e-6·‖b‖ on a 3D
7-point Poisson operator, 128³ rows (≈2.1 M rows, ≈14.6 M nnz), fp32, single
device (north-star config 2 of BASELINE.json).

``vs_baseline``: measured speedup over the compiled reference C solver
(rnelias/Conjugate-Gradient, built ``gcc -O2`` — more generous than its own
``-g``-only Makefile) on a problem both sides can run: 2D 5-point Poisson
128×128 at a fixed iteration count, compared per CG iteration.  The C SpMV is
O(n²) (``mv_ops.c:160-201``), so this ratio is dominated by the reference's
algorithmic complexity — that *is* its baseline.

Usage: ``python bench.py [--quick]``.  Extra context (SpMV throughput,
iteration counts, baseline details) goes to stderr; stdout gets exactly one
JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
REF_DIR = "/root/reference"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def stats(samples):
    """{median, spread_pct, n_samples} — spread is (max−min)/median."""
    s = sorted(samples)
    med = float(np.median(s))
    spread = (s[-1] - s[0]) / med * 100.0 if med > 0 else 0.0
    return dict(median=med, spread_pct=round(spread, 1), n_samples=len(s))


def timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bench_cgx_headline(quick):
    import jax
    import jax.numpy as jnp
    from functools import partial
    import cgx
    from cgx.sparse.stencil import poisson3d_stencil

    side = 64 if quick else 128
    # Matrix-free stencil operator for the north-star 3D Poisson config
    # (BASELINE.json config 2).  For the constant-diagonal Laplacian,
    # Jacobi preconditioning is an exact rescaling (M = I/6): the CG
    # trajectory is identical, so plain CG is run and labeled
    # jacobi-equivalent.
    a = poisson3d_stencil(side, side, side)
    n = a.shape[0]
    nnz = 7 * n - 2 * (side * side * 3)   # 7-point interior minus faces
    # A seeded rough b: fp32 reaches a true relres of 1e-6 on it, while a
    # smooth b = ones stalls above it at 128³ (cgx reports converged on
    # the true residual).
    b = jnp.asarray(np.random.default_rng(0).standard_normal(n),
                    jnp.float32)

    solve = jax.jit(lambda a, b: cgx.auto_solve(a, b, tol=1e-6,
                                                maxiter=2000))
    res = jax.block_until_ready(solve(a, b))  # compile + converge check
    iters = int(res.iterations)
    assert bool(res.converged), "headline solve did not converge"
    head = stats([timed(lambda: jax.block_until_ready(solve(a, b)))
                  for _ in range(3 if quick else 7)])

    @partial(jax.jit, static_argnums=2)
    def spmv_loop(a, x, k):
        # /8 keeps the iterates bounded (spectral radius of A/8 <= 1).
        return jax.lax.fori_loop(
            0, k, lambda i, y: cgx.spmv(a, y) * 0.125, x)

    # Difference two loop lengths inside one jitted call each: cancels the
    # fixed per-call dispatch and synchronisation cost.
    k1, k2 = 100, 500
    jax.block_until_ready(spmv_loop(a, b, k1))
    jax.block_until_ready(spmv_loop(a, b, k2))
    per_iter = []
    for _ in range(3 if quick else 5):
        t1 = timed(lambda: jax.block_until_ready(spmv_loop(a, b, k1)))
        t2 = timed(lambda: jax.block_until_ready(spmv_loop(a, b, k2)))
        per_iter.append(max(t2 - t1, 1e-9) / (k2 - k1))
    sp = stats(per_iter)
    spmv_gnnz = stats([nnz / t / 1e9 for t in per_iter])
    log(f"[cgx] 3D Poisson {side}^3: n={n} nnz={nnz} iters={iters} "
        f"time_to_tol={head['median']*1e3:.2f} ms "
        f"(±{head['spread_pct']}% over {head['n_samples']})  "
        f"spmv={spmv_gnnz['median']:.2f} Gnnz/s "
        f"(±{spmv_gnnz['spread_pct']}%, {sp['median']*1e6:.1f} us/spmv) "
        f"on {jax.devices()[0].platform}")
    return dict(side=side, n=n, nnz=nnz, iters=iters, head=head,
                spmv=spmv_gnnz)


def build_reference():
    exe = os.path.join(tempfile.gettempdir(), "cg_ref_bench")
    if not os.path.exists(exe):
        subprocess.run(
            ["gcc", "-O2", "-o", exe, os.path.join(REF_DIR, "cg.c"),
             os.path.join(REF_DIR, "mv_ops.c"), "-I", REF_DIR, "-lm"],
            check=True, capture_output=True)
    return exe


def bench_vs_reference(quick):
    """Per-iteration CG time, cgx (fp32, device) vs C binary (fp64, host),
    identical 2D Poisson matrix and iteration count."""
    import jax
    import jax.numpy as jnp
    from cgx.io.legacy import write_legacy
    from cgx.io.poisson import poisson2d
    from cgx.solve.cg import cg_solve

    side = 64 if quick else 128
    iters = 20 if quick else 60
    a = poisson2d(side, side)
    n = side * side
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)

    try:
        exe = build_reference()
    except (OSError, subprocess.CalledProcessError) as e:
        log(f"[ref] unavailable ({e}); vs_baseline omitted")
        return None

    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in.txt")
        write_legacy(inp, a, b)
        t0 = time.perf_counter()
        subprocess.run([exe, inp, str(iters)], check=True,
                       capture_output=True)
        t_ref = time.perf_counter() - t0

    a32 = a.astype(jnp.float32)
    b32 = jnp.asarray(b, jnp.float32)
    # Difference two iteration counts to cancel the fixed per-call cost
    # (the C binary pays its startup+parse analogously once; its per-iter
    # cost dominates regardless at O(n^2) SpMV).
    from functools import partial
    solve = partial(cg_solve, tol=0.0)
    f1 = jax.jit(lambda a, b: solve(a, b, maxiter=iters + 1))
    f2 = jax.jit(lambda a, b: solve(a, b, maxiter=4 * iters + 1))
    jax.block_until_ready(f1(a32, b32))
    jax.block_until_ready(f2(a32, b32))
    t1 = min(timed(lambda: jax.block_until_ready(f1(a32, b32)))
             for _ in range(4))
    t2 = min(timed(lambda: jax.block_until_ready(f2(a32, b32)))
             for _ in range(4))
    cgx_per_iter = max(t2 - t1, 1e-9) / (3 * iters)

    ref_per_iter = t_ref / (iters + 1)
    speedup = ref_per_iter / cgx_per_iter
    log(f"[ref] 2D Poisson {side}^2, {iters + 1} updates: "
        f"C={t_ref:.2f}s ({ref_per_iter*1e3:.1f} ms/iter, incl. parse)  "
        f"cgx={t1*1e3:.2f}ms/call ({cgx_per_iter*1e3:.3f} ms/iter)  "
        f"speedup={speedup:.0f}x")
    return speedup


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    from cgx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    head = bench_cgx_headline(args.quick)
    speedup = bench_vs_reference(args.quick)

    h = head["head"]
    s = head["spmv"]
    print(json.dumps({
        "metric": (f"cg_time_to_1e-6_poisson3d_{head['side']}^3_fp32"
                   "_jacobi_equiv"),
        "value": round(h["median"] * 1e3, 3),
        "unit": "ms",
        "vs_baseline": round(speedup, 1) if speedup else None,
        "spread_pct": h["spread_pct"],
        "n_samples": h["n_samples"],
        "iterations": head["iters"],
        "spmv": {
            "median_gnnz_s": round(s["median"], 2),
            "spread_pct": s["spread_pct"],
            "n_samples": s["n_samples"],
        },
    }), flush=True)


if __name__ == "__main__":
    main()
