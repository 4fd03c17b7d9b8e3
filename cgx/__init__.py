"""cgx — a sparse iterative-solver framework in JAX.

From-scratch JAX/XLA re-design with the capabilities of the reference
C conjugate-gradient solver (rnelias/Conjugate-Gradient; structural analysis
in SURVEY.md): CSR/COO/BSR/ELL/DIA sparse storage, O(nnz) SpMV/SpMM, fused
vector ops, (preconditioned) CG under ``lax.while_loop``, and row-partitioned
multi-chip solves over a ``jax.sharding.Mesh`` with psum dots and halo
exchange.
"""
from cgx.sparse.types import (BSRMatrix, COOMatrix, CSRMatrix, DIAMatrix,
                              ELLMatrix, bsr_from_csr, coo_from_scipy,
                              csr_from_scipy, dia_from_csr, ell_from_csr)
from cgx.ops.spmv import spmv, spmm
from cgx.ops import blas
from cgx.solve.cg import (CGResult, cg_solve, cg_solve_pipelined,
                          cg_solve_single_reduction)
from cgx.solve.precond import (BlockJacobiPrecond, JacobiPrecond,
                               PolynomialPrecond)
from cgx.solve.ic0 import IC0Precond, IC0SweepPrecond
from cgx.solve.block import block_cg_solve, cg_solve_multi
from cgx.solve.auto import auto_solve
from cgx.solve.chebyshev import (analytic_bounds, chebyshev_solve,
                                 estimate_bounds)
from cgx.solve.hp import (df64_cg_solve, ir_df64_solve,
                          make_ir_df64_solver, make_ir_df64_solver_multi)
from cgx.sparse.types import auto_format, pick_format
from cgx.utils.checkpoint import cg_solve_checkpointed

__version__ = "0.1.0"

__all__ = [
    "BSRMatrix", "COOMatrix", "CSRMatrix", "DIAMatrix", "ELLMatrix",
    "bsr_from_csr", "coo_from_scipy", "csr_from_scipy", "dia_from_csr",
    "ell_from_csr", "auto_format", "pick_format",
    "spmv", "spmm", "blas", "CGResult", "cg_solve",
    "cg_solve_single_reduction", "cg_solve_pipelined", "cg_solve_multi",
    "block_cg_solve",
    "auto_solve", "cg_solve_checkpointed",
    "analytic_bounds", "chebyshev_solve", "estimate_bounds",
    "df64_cg_solve", "ir_df64_solve",
    "make_ir_df64_solver", "make_ir_df64_solver_multi",
    "JacobiPrecond", "BlockJacobiPrecond", "PolynomialPrecond",
    "IC0Precond", "IC0SweepPrecond",
]
