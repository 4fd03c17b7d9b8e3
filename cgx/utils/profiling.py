"""Tracing / profiling hooks (SURVEY.md §5.a).

The reference's only instrumentation is whole-second wall clock around the
solve (``time(NULL)``, ``cg.c:71-75``).  Here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  Perfetto/TensorBoard trace of the device timeline.
* :func:`trace_report` — per-op device time table from such a trace.
* :func:`solve_stats` — derived metrics for a solve: per-iteration time,
  nnz/s, effective HBM bandwidth vs an operator byte model.
"""
from __future__ import annotations

import contextlib
from typing import Optional

__all__ = ["trace", "solve_stats", "annotate", "trace_report"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: ``with trace('/tmp/tb'): solve(...)``.

    View with TensorBoard's profile plugin or Perfetto, or parse directly
    with :func:`trace_report` (no TensorBoard needed).
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up on the device trace timeline."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def trace_report(log_dir: str, device_only: bool = True,
                 top: Optional[int] = 25) -> list:
    """Per-op timing table from a captured trace (round-1 ROADMAP #13).

    Parses the ``.xplane.pb`` files :func:`trace` wrote (no TensorBoard /
    protobuf dependency — :mod:`cgx.utils.xplane`) and aggregates event
    durations per op name.  Returns dicts sorted by total time:
    ``{"plane", "line", "op", "count", "total_us", "avg_us"}``.
    """
    from collections import defaultdict

    from cgx.utils.xplane import load_xspace

    acc = defaultdict(lambda: [0, 0])        # (plane, line, op) -> [n, ps]
    for plane in load_xspace(log_dir):
        if device_only and not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for e in line.events:
                k = (plane.name, line.label, e.name)
                acc[k][0] += 1
                acc[k][1] += e.duration_ps
    rows = [{"plane": p, "line": ln, "op": op, "count": n,
             "total_us": ps / 1e6, "avg_us": ps / n / 1e6}
            for (p, ln, op), (n, ps) in acc.items()]
    rows.sort(key=lambda r: -r["total_us"])
    return rows[:top] if top else rows


def solve_stats(seconds: float, iterations: int, nnz: int,
                bytes_per_iter: Optional[int] = None) -> dict:
    """Throughput summary for a converged solve."""
    it = max(int(iterations), 1)
    per_iter = seconds / it
    out = {
        "seconds": seconds,
        "iterations": int(iterations),
        "s_per_iter": per_iter,
        "gnnz_per_s": nnz / per_iter / 1e9,
    }
    if bytes_per_iter:
        out["effective_gb_per_s"] = bytes_per_iter / per_iter / 1e9
    return out
