"""Preconditioners for PCG.

The reference has none (plain CG only, ``cg.c:88-141``); these are part of
the north-star capability set (BASELINE.json: "Jacobi/IC(0) preconditioner
path").  Each preconditioner is a frozen pytree dataclass with an
``apply(r) -> z`` method computing ``z = M⁻¹ r``; construction ("setup
phase") happens once on host/device before the solve, ``apply`` runs inside
the CG ``while_loop`` and must be cheap, fused, and free of data-dependent
shapes.

Notes:

* :class:`JacobiPrecond` — one elementwise multiply; fuses into the loop
  body at zero bandwidth cost beyond reading ``inv_diag``.
* :class:`BlockJacobiPrecond` — batched dense ``(bs, bs)`` block inverse
  applied with a batched matvec, still fully fused.
* IC(0) lives in :mod:`cgx.solve.ic0` — sparse triangular solves are
  sequential by row, so it is implemented with host-side factorization and
  level-scheduled on-device solves.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import jax
import jax.numpy as jnp

__all__ = ["JacobiPrecond", "BlockJacobiPrecond", "PolynomialPrecond"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class JacobiPrecond:
    """Diagonal (Jacobi) preconditioner: ``M⁻¹ = diag(A)⁻¹``.

    Zero diagonal entries (e.g. padding rows introduced by shard
    equalization) map to 0, leaving those components untouched.
    """

    inv_diag: jnp.ndarray

    @classmethod
    def from_matrix(cls, a) -> "JacobiPrecond":
        from cgx.ops.blas import safe_recip
        return cls(inv_diag=safe_recip(a.diagonal()))

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        return self.inv_diag * r


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BlockJacobiPrecond:
    """Block-Jacobi: ``M⁻¹ = blockdiag(D₁⁻¹, …, D_k⁻¹)``.

    ``inv_blocks`` holds the dense inverses of the ``(bs, bs)`` diagonal
    blocks of A; ``apply`` is a batched matvec.  Serves both as a
    standalone preconditioner and as the data-parallel fallback where a
    sequential IC(0) triangular solve would serialize (SURVEY.md §7 "hard
    parts").
    """

    inv_blocks: jnp.ndarray   # (n_blocks, bs, bs)
    blocksize: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_matrix(cls, a, blocksize: int) -> "BlockJacobiPrecond":
        """Extract diagonal blocks of a CSR matrix and invert them (host)."""
        import numpy as np

        vals = np.asarray(a.values)
        cols = np.asarray(a.col_indices)
        rows = np.asarray(a.row_indices)
        n = a.shape[0]
        bs = blocksize
        nb = -(-n // bs)
        blocks = np.zeros((nb, bs, bs), dtype=vals.dtype)
        blk_r = rows // bs
        blk_c = cols // bs
        on_blockdiag = blk_r == blk_c
        br = blk_r[on_blockdiag]
        ir = (rows % bs)[on_blockdiag]
        ic = (cols % bs)[on_blockdiag]
        blocks[br, ir, ic] = vals[on_blockdiag]
        # Padding rows (beyond n) get identity so the inverse is defined.
        pad = nb * bs - n
        if pad:
            tail_rows = np.arange(n, nb * bs)
            blocks[tail_rows // bs, tail_rows % bs, tail_rows % bs] = 1.0
        # Empty diagonal slots also get 1 to keep blocks nonsingular.
        diag_idx = np.arange(bs)
        d = blocks[:, diag_idx, diag_idx]
        blocks[:, diag_idx, diag_idx] = np.where(d == 0, 1.0, d)
        inv = np.linalg.inv(blocks)
        return cls(inv_blocks=jnp.asarray(inv), blocksize=bs)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        n = r.shape[0]
        bs = self.blocksize
        nb = self.inv_blocks.shape[0]
        pad = nb * bs - n
        rp = jnp.pad(r, (0, pad)) if pad else r
        rb = rp.reshape(nb, bs)
        # HIGHEST: keep a float32 contraction out of TF32 on a GPU.
        zb = jnp.einsum("bij,bj->bi", self.inv_blocks, rb,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=r.dtype)
        z = zb.reshape(-1)
        return z[:n] if pad else z


class PolynomialPrecond:
    """m-step damped-Jacobi (truncated Neumann) polynomial preconditioner.

    ``z = M⁻¹ r`` approximated by ``m`` weighted Jacobi sweeps on ``A z = r``
    from ``z₀ = 0``: ``z ← z + ω D⁻¹ (r − A z)``.  The induced operator is a
    fixed symmetric polynomial in ``D⁻¹A`` applied to ``D⁻¹``, hence a valid
    SPD preconditioner for CG when ``ω < 2 / λ_max(D⁻¹A)`` (``ω = 2/3`` is
    safe for diagonally dominant stencils).

    This is the data-parallel alternative to IC(0)'s triangular sweeps
    (SURVEY.md §7 "hard parts"): each step is one SpMV + fused axpys — pure
    streaming work, no sequential row dependencies, and it distributes for
    free (the matvec may be a ``shard_map``-local closure).

    Not a pytree on purpose: it closes over the matvec; pass it per-solve.
    """

    def __init__(self, matvec, inv_diag: jnp.ndarray, steps: int = 3,
                 omega: float = 2.0 / 3.0):
        from cgx.solve.cg import as_matvec
        self.matvec = as_matvec(matvec)
        self.inv_diag = inv_diag
        self.steps = int(steps)
        self.omega = float(omega)

    @classmethod
    def from_matrix(cls, a, steps: int = 3,
                    omega: float = 2.0 / 3.0) -> "PolynomialPrecond":
        from cgx.ops.blas import safe_recip
        return cls(a, safe_recip(a.diagonal()), steps=steps, omega=omega)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        z = self.omega * self.inv_diag * r
        for _ in range(self.steps - 1):
            z = z + self.omega * self.inv_diag * (r - self.matvec(z))
        return z
