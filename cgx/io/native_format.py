"""cgx's own on-disk matrix format: ``.npz`` with a format tag.

Binary, mmap-friendly, exact — unlike the reference's decimal text format
(``cg.c:146-218``), a round-trip preserves every bit.  Stores any cgx
container (including the matrix-free stencils, which serialize to their
static metadata only).
"""
from __future__ import annotations

import numpy as np

__all__ = ["save_matrix", "load_matrix"]


def save_matrix(path: str, a, b=None) -> None:
    """Save a cgx matrix (and optional RHS) to ``.npz``."""
    from cgx.sparse import stencil, types

    arrays = {}
    if isinstance(a, types.CSRMatrix):
        arrays = dict(kind="csr", values=np.asarray(a.values),
                      col_indices=np.asarray(a.col_indices),
                      indptr=np.asarray(a.indptr),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.COOMatrix):
        arrays = dict(kind="coo", values=np.asarray(a.values),
                      row_indices=np.asarray(a.row_indices),
                      col_indices=np.asarray(a.col_indices),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.DIAMatrix):
        arrays = dict(kind="dia", data=np.asarray(a.data),
                      offsets=np.asarray(a.offsets),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.ELLMatrix):
        arrays = dict(kind="ell", values=np.asarray(a.values),
                      col_indices=np.asarray(a.col_indices),
                      shape=np.asarray(a.shape))
    elif isinstance(a, types.BSRMatrix):
        arrays = dict(kind="bsr", values=np.asarray(a.values),
                      col_indices=np.asarray(a.col_indices),
                      indptr=np.asarray(a.indptr),
                      shape=np.asarray(a.shape),
                      blocksize=np.asarray(a.blocksize))
    elif isinstance(a, stencil.Stencil3D):
        arrays = dict(kind="stencil3d",
                      dims=np.asarray([a.nx, a.ny, a.nz]),
                      coeffs=np.asarray([a.c_center, a.c_x, a.c_y, a.c_z]))
    elif isinstance(a, stencil.Stencil2D):
        arrays = dict(kind="stencil2d", dims=np.asarray([a.nx, a.ny]),
                      coeffs=np.asarray([a.c_center, a.c_x, a.c_y]))
    else:
        raise TypeError(f"save_matrix: unsupported type {type(a)!r}")
    if b is not None:
        arrays["rhs"] = np.asarray(b)
    np.savez_compressed(path, **arrays)


def load_matrix(path: str):
    """Load ``(matrix, rhs_or_None)`` saved by :func:`save_matrix`."""
    import jax.numpy as jnp
    from cgx.sparse import stencil, types

    with np.load(path) as z:
        kind = str(z["kind"])
        b = jnp.asarray(z["rhs"]) if "rhs" in z else None
        if kind == "csr":
            a = types.CSRMatrix.from_arrays(
                z["values"], z["col_indices"], z["indptr"],
                tuple(int(v) for v in z["shape"]))
        elif kind == "coo":
            a = types.COOMatrix(
                jnp.asarray(z["values"]),
                jnp.asarray(z["row_indices"], dtype=jnp.int32),
                jnp.asarray(z["col_indices"], dtype=jnp.int32),
                tuple(int(v) for v in z["shape"]))
        elif kind == "dia":
            a = types.DIAMatrix(
                jnp.asarray(z["data"]),
                tuple(int(v) for v in z["offsets"]),
                tuple(int(v) for v in z["shape"]))
        elif kind == "ell":
            a = types.ELLMatrix(
                jnp.asarray(z["values"]),
                jnp.asarray(z["col_indices"], dtype=jnp.int32),
                tuple(int(v) for v in z["shape"]))
        elif kind == "bsr":
            vals = z["values"]
            indptr = z["indptr"]
            counts = np.diff(indptr)
            rows = np.repeat(np.arange(len(counts), dtype=np.int32),
                             counts)
            a = types.BSRMatrix(
                jnp.asarray(vals),
                jnp.asarray(z["col_indices"], dtype=jnp.int32),
                jnp.asarray(indptr, dtype=jnp.int32),
                jnp.asarray(rows),
                tuple(int(v) for v in z["shape"]),
                int(z["blocksize"]))
        elif kind == "stencil3d":
            d = z["dims"]
            c = z["coeffs"]
            a = stencil.Stencil3D(int(d[0]), int(d[1]), int(d[2]),
                                  float(c[0]), float(c[1]), float(c[2]),
                                  float(c[3]))
        elif kind == "stencil2d":
            d = z["dims"]
            c = z["coeffs"]
            a = stencil.Stencil2D(int(d[0]), int(d[1]), float(c[0]),
                                  float(c[1]), float(c[2]))
        else:
            raise ValueError(f"unknown format kind {kind!r}")
    return a, b
