"""Grid views of structured operators: stencil taps and DIA ⇄ grid maps.

A constant-coefficient stencil and a banded DIA matrix discretized on an
``nx × ny × nz`` grid (row ``(x·ny + y)·nz + z``) both reduce to a list of
taps ``(dx, dy, dz)`` with one coefficient plane each.  This module holds
that reduction, which the analytic Chebyshev bounds
(:func:`cgx.solve.chebyshev.analytic_bounds`) and the distributed CLI path
(a stencil is partitioned as DIA) read.  2-D operators map to the grid
``(nx, 1, ny)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["stencil_taps", "dia_pattern_dims", "dia_grid_taps",
           "stencil_to_dia"]

# Offset order (-o3, -o2, -1, 0, 1, o2, o3) of the 7-point DIA pattern.
_DIA7_TAPS = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
              (0, 1, 0), (1, 0, 0))


def stencil_taps(s):
    """``(nx, ny, nz, taps, coeffs)`` of a matrix-free stencil, or None.

    2-D stencils map to the grid ``(nx, 1, ny)``; a
    :class:`~cgx.sparse.stencil.GeneralStencil3D` qualifies only when its
    taps reach at most one x-plane.
    """
    from cgx.sparse.stencil import GeneralStencil3D, Stencil2D, Stencil3D

    if isinstance(s, Stencil3D):
        taps = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
                (1, 0, 0), (-1, 0, 0))
        coeffs = (s.c_center, s.c_z, s.c_z, s.c_y, s.c_y, s.c_x, s.c_x)
        return s.nx, s.ny, s.nz, taps, coeffs
    if isinstance(s, Stencil2D):
        taps = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0))
        coeffs = (s.c_center, s.c_y, s.c_y, s.c_x, s.c_x)
        return s.nx, 1, s.ny, taps, coeffs
    if isinstance(s, GeneralStencil3D):
        if any(abs(dx) > 1 for (dx, _, _) in s.taps):
            return None
        return s.nx, s.ny, s.nz, tuple(s.taps), tuple(s.coeffs)
    return None


def dia_pattern_dims(d) -> Optional[Tuple[int, int, int]]:
    """(nx, ny, nz) if ``d`` has the 3-D 7-point offset pattern, else None."""
    from cgx.sparse.types import DIAMatrix

    if not isinstance(d, DIAMatrix):
        return None
    offs = tuple(d.offsets)
    if len(offs) != 7:
        return None
    o3 = offs[6]
    o2 = offs[5]
    if offs != (-o3, -o2, -1, 0, 1, o2, o3):
        return None
    n = d.shape[0]
    if o2 <= 0 or o3 % o2 or n % o3:
        return None
    return (n // o3, o3 // o2, o2)


def dia_grid_taps(d):
    """``(nx, ny, nz, taps)`` decomposing ``d.offsets`` into grid taps
    ``(dx, dy, dz)`` with ``|dx| ≤ 1``, or ``None``.

    Works for the exact 7-point pattern without metadata; any other banded
    set needs ``d.grid`` (the generators set it).  Each offset takes its
    minimal-magnitude decomposition ``off = dx·ny·nz + dy·nz + dz``
    (``|dz| ≤ nz/2``, ``|dy| ≤ ny/2``).
    """
    from cgx.sparse.types import DIAMatrix

    if not isinstance(d, DIAMatrix):
        return None
    dims = dia_pattern_dims(d)
    if dims is not None:
        return (*dims, list(_DIA7_TAPS))
    g = getattr(d, "grid", None)
    if g is None:
        return None
    nx, ny, nz = map(int, g)
    if nx * ny * nz != d.shape[0] or min(nx, ny, nz) < 1:
        return None
    taps = []
    for off in map(int, d.offsets):
        dz = off % nz
        if dz > nz // 2:
            dz -= nz
        rem = (off - dz) // nz
        dy = rem % ny
        if dy > ny // 2:
            dy -= ny
        dx = (rem - dy) // ny
        if abs(dx) > 1 or dx * ny * nz + dy * nz + dz != off:
            return None
        taps.append((dx, dy, dz))
    if len(set(taps)) != len(taps):
        return None
    return nx, ny, nz, taps


def stencil_to_dia(s, dtype=None):
    """The stored DIA form of a matrix-free stencil (host build).

    Entries whose neighbour falls off the grid are zero, so the DIA matrix
    is the same operator as ``s.matvec``.  Raises ``ValueError`` for an
    operator :func:`stencil_taps` does not cover.
    """
    from cgx.sparse.types import DIAMatrix

    spec = stencil_taps(s)
    if spec is None:
        raise ValueError(f"no grid-tap form for {type(s).__name__}")
    nx, ny, nz, taps, coeffs = spec
    n = nx * ny * nz
    r = np.arange(n)
    zc, yc, xc = r % nz, (r // nz) % ny, r // (ny * nz)
    planes = {}
    for (dx, dy, dz), c in zip(taps, coeffs):
        valid = ((xc + dx >= 0) & (xc + dx < nx) & (yc + dy >= 0)
                 & (yc + dy < ny) & (zc + dz >= 0) & (zc + dz < nz))
        off = dx * ny * nz + dy * nz + dz
        planes[off] = planes.get(off, 0.0) + np.where(valid, c, 0.0)
    offsets = tuple(sorted(planes))
    data = np.stack([planes[o] for o in offsets]).astype(dtype or s.dtype)
    import jax.numpy as jnp
    return DIAMatrix(jnp.asarray(data), offsets, (n, n), grid=(nx, ny, nz))
