"""Distributed (multi-chip) layer: row partitioning, halo exchange, SPMD CG.

The reference is entirely sequential (no MPI in code; the ``mpiexec`` Makefile
targets at ``Makefile:20-30`` launch N independent copies — SURVEY.md §2.2).
This package is the distribution story the assignment series was heading
toward: a 1-D device mesh over matrix rows, ``shard_map`` SPMD with XLA
collectives between devices — ``ppermute`` ring halo exchange for the off-block
columns of A, ``psum`` for the two global dot products per CG iteration, and
an ``all_gather`` fallback for general (unbanded) sparsity.
"""
from cgx.dist.partition import (Partition, partition_csr, partition_dia,
                                pad_vector, unpad_vector)
from cgx.dist.halo import halo_exchange, local_matvec
from cgx.dist.solve import (AXIS, dist_cg_solve, make_row_mesh,
                            operator_specs)
from cgx.dist.schwarz import IC0SweepBlocks, ic0_sweep_blocks

__all__ = [
    "Partition", "partition_csr", "partition_dia", "pad_vector",
    "unpad_vector", "halo_exchange", "local_matvec", "AXIS",
    "dist_cg_solve", "make_row_mesh", "operator_specs",
    "IC0SweepBlocks", "ic0_sweep_blocks",
]
