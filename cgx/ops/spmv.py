"""Sparse matrix–vector / matrix–matrix products (XLA paths).

Replacement for the reference's ``mv_mult`` (``mv_ops.c:160-201``),
which densifies each CSR row (``mat_get_row``, ``mv_ops.c:99-113``) and takes
a full dense dot — O(n²) work per SpMV.  Every path here is O(nnz), traced
once under ``jit``, and built from primitives XLA fuses:

* COO/CSR — gather ``x[col]`` + multiply + ``segment_sum`` (sorted segments).
* ELL     — static-width gather → multiply → row-sum (no segment ids at all).
* BSR     — batched dense-block contraction + block segment-sum.
* DIA     — statically-shifted fused multiply-adds (stencil speed-of-light).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cgx.sparse.types import (BSRMatrix, COOMatrix, CSRMatrix, DIAMatrix,
                              ELLMatrix)
from cgx.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D

__all__ = ["spmv", "spmm", "shifted"]


@functools.singledispatch
def spmv(a, x: jnp.ndarray) -> jnp.ndarray:
    """``y = A @ x`` for any cgx sparse container (O(nnz))."""
    raise TypeError(f"spmv: unsupported operand type {type(a)!r}")


@functools.singledispatch
def spmm(a, x: jnp.ndarray) -> jnp.ndarray:
    """``Y = A @ X`` for a dense block of right-hand sides ``X: (m, k)``."""
    raise TypeError(f"spmm: unsupported operand type {type(a)!r}")


# -- COO --------------------------------------------------------------------

@spmv.register
def _coo_spmv(a: COOMatrix, x: jnp.ndarray) -> jnp.ndarray:
    prods = a.values * x[a.col_indices]
    return jax.ops.segment_sum(prods, a.row_indices,
                               num_segments=a.shape[0],
                               indices_are_sorted=True)


@spmm.register
def _coo_spmm(a: COOMatrix, x: jnp.ndarray) -> jnp.ndarray:
    prods = a.values[:, None] * x[a.col_indices]
    return jax.ops.segment_sum(prods, a.row_indices,
                               num_segments=a.shape[0],
                               indices_are_sorted=True)


# -- CSR --------------------------------------------------------------------

@spmv.register
def _csr_spmv(a: CSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    prods = a.values * x[a.col_indices]
    return jax.ops.segment_sum(prods, a.row_indices,
                               num_segments=a.shape[0],
                               indices_are_sorted=True)


@spmm.register
def _csr_spmm(a: CSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    prods = a.values[:, None] * x[a.col_indices]
    return jax.ops.segment_sum(prods, a.row_indices,
                               num_segments=a.shape[0],
                               indices_are_sorted=True)


# -- ELL --------------------------------------------------------------------

@spmv.register
def _ell_spmv(a: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    gathered = x[a.col_indices]                 # (n, width)
    return jnp.sum(a.values * gathered, axis=1)


@spmm.register
def _ell_spmm(a: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    gathered = x[a.col_indices]                 # (n, width, k)
    return jnp.sum(a.values[..., None] * gathered, axis=1)


# -- BSR --------------------------------------------------------------------

@spmv.register
def _bsr_spmv(a: BSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    bs = a.blocksize
    nbr = a.shape[0] // bs
    xb = x.reshape(-1, bs)                       # (n_block_cols, bs)
    gathered = xb[a.col_indices]                 # (nnzb, bs)
    # Dense (bs, bs) @ (bs,) per block.  HIGHEST: a float32 contraction
    # may otherwise run in TF32 on a GPU, which costs digits and buys
    # nothing on a product this small and memory-bound.
    prods = jnp.einsum("bij,bj->bi", a.values, gathered,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=a.dtype)
    yb = jax.ops.segment_sum(prods, a.row_indices, num_segments=nbr,
                             indices_are_sorted=True)
    return yb.reshape(-1)


@spmm.register
def _bsr_spmm(a: BSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    bs = a.blocksize
    nbr = a.shape[0] // bs
    k = x.shape[1]
    xb = x.reshape(-1, bs, k)                    # (n_block_cols, bs, k)
    gathered = xb[a.col_indices]                 # (nnzb, bs, k)
    prods = jnp.einsum("bij,bjk->bik", a.values, gathered,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=a.dtype)
    yb = jax.ops.segment_sum(prods, a.row_indices, num_segments=nbr,
                             indices_are_sorted=True)
    return yb.reshape(-1, k)


# -- DIA --------------------------------------------------------------------

def shifted(x: jnp.ndarray, offset: int) -> jnp.ndarray:
    """``shifted(x, o)[i] = x[i + o]`` with zero fill (static offset)."""
    n = x.shape[0]
    if offset == 0:
        return x
    zeros_shape = (abs(offset),) + x.shape[1:]
    z = jnp.zeros(zeros_shape, dtype=x.dtype)
    if offset > 0:
        return jnp.concatenate([x[offset:], z], axis=0)
    return jnp.concatenate([z, x[:n + offset]], axis=0)


@spmv.register
def _dia_spmv(a: DIAMatrix, x: jnp.ndarray) -> jnp.ndarray:
    # Unrolled over the (few, static) offsets; XLA fuses the whole sum into
    # one elementwise pass — no gathers, no segment ids.
    y = a.data[0] * shifted(x, a.offsets[0])
    for k in range(1, len(a.offsets)):
        y = y + a.data[k] * shifted(x, a.offsets[k])
    return y


@spmm.register
def _dia_spmm(a: DIAMatrix, x: jnp.ndarray) -> jnp.ndarray:
    y = a.data[0][:, None] * shifted(x, a.offsets[0])
    for k in range(1, len(a.offsets)):
        y = y + a.data[k][:, None] * shifted(x, a.offsets[k])
    return y


# -- Matrix-free stencils ---------------------------------------------------

@spmv.register(Stencil2D)
def _stencil2d_spmv(a, x: jnp.ndarray) -> jnp.ndarray:
    return a.matvec(x)


@spmv.register(Stencil3D)
def _stencil3d_spmv(a, x: jnp.ndarray) -> jnp.ndarray:
    return a.matvec(x)


@spmv.register(GeneralStencil3D)
def _general_stencil_spmv(a, x: jnp.ndarray) -> jnp.ndarray:
    return a.matvec(x)


@spmm.register(Stencil2D)
@spmm.register(Stencil3D)
@spmm.register(GeneralStencil3D)
def _stencil_spmm(a, x: jnp.ndarray) -> jnp.ndarray:
    return jax.vmap(a.matvec, in_axes=1, out_axes=1)(x)
