"""Multi-host launch: process-group init + mesh construction.

Replacement for the reference's vestigial ``mpiexec`` targets
(``Makefile:20-30`` — which launched N *independent* copies of a sequential
binary; SURVEY.md §2.2).  On a multi-host cluster every host runs the same
program; :func:`initialize` wires them into one JAX process group, and
:func:`global_row_mesh` builds the 1-D solver mesh over every device of
every host.  One host drives all of its own devices from one process and
needs none of this.

Elastic recovery (SURVEY.md §5.c): on preemption, relaunch the same command
— `initialize()` re-forms the group and the solver resumes from the last
:mod:`cgx.utils.checkpoint` snapshot.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["initialize", "global_row_mesh", "is_multihost"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``jax.distributed.initialize`` with env-var defaults.

    No-ops when single-process (the common dev case), so library code can
    call it unconditionally.  Set ``CGX_COORDINATOR``/``CGX_NUM_PROCS``/
    ``CGX_PROC_ID`` or pass them explicitly.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "CGX_COORDINATOR")
    if num_processes is None and "CGX_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["CGX_NUM_PROCS"])
    if process_id is None and "CGX_PROC_ID" in os.environ:
        process_id = int(os.environ["CGX_PROC_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def is_multihost() -> bool:
    import jax

    return jax.process_count() > 1


def global_row_mesh():
    """1-D ``"rows"`` mesh over every device of every host.

    Device order follows ``jax.devices()`` — contiguous per host, so a
    contiguous row partition keeps each host's shards local and the ring
    halo exchange crosses the network once per host boundary.
    """
    from cgx.dist.solve import make_row_mesh

    return make_row_mesh()
