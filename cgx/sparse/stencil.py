"""Matrix-free constant-coefficient stencil operators.

The reference stores its Poisson-type matrices explicitly in CSR and pays
O(n²) per SpMV (``mv_ops.c:160-201``).  For constant-coefficient
finite-difference operators this design stores *nothing*: the
matrix action is a handful of statically-shifted multiply-adds whose
boundary masks are recomputed on the fly from index arithmetic (iota +
compare — register work, zero HBM traffic).  SpMV bandwidth then drops to
reading x + writing y ≈ 8 bytes/row fp32, ~4-5× under a stored DIA/CSR
operator — the speed-of-light for the north-star Poisson benchmarks
(BASELINE.json configs 1/2/5).

``Stencil2D``/``Stencil3D`` are frozen pytrees (shape/coefficients static)
and plug into :func:`cgx.ops.spmv.spmv`, :func:`cgx.solve.cg.cg_solve`, and
the distributed layer like any stored format.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["Stencil2D", "Stencil3D", "GeneralStencil3D", "poisson2d_stencil",
           "poisson3d_stencil", "poisson3d_27point"]


def _shift2(g, axis: int, sign: int):
    """``out[..i..] = g[..i+sign..]`` along ``axis`` with zero boundary."""
    sl = [slice(None)] * 2
    pad = [(0, 0)] * 2
    sl[axis] = slice(1, None) if sign > 0 else slice(None, -1)
    pad[axis] = (0, 1) if sign > 0 else (1, 0)
    return jnp.pad(g[tuple(sl)], pad)


def _shift3(g, axis: int, sign: int):
    sl = [slice(None)] * 3
    pad = [(0, 0)] * 3
    sl[axis] = slice(1, None) if sign > 0 else slice(None, -1)
    pad[axis] = (0, 1) if sign > 0 else (1, 0)
    return jnp.pad(g[tuple(sl)], pad)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Stencil2D:
    """5-point constant stencil on an ``nx × ny`` grid (Dirichlet).

    ``A[r, r] = c_center``; ``A[r, r±1] = c_y`` (within a grid row);
    ``A[r, r±ny] = c_x``.  Row-major numbering: node (i, j) → i·ny + j.
    """

    nx: int = dataclasses.field(metadata=dict(static=True))
    ny: int = dataclasses.field(metadata=dict(static=True))
    c_center: float = dataclasses.field(metadata=dict(static=True))
    c_x: float = dataclasses.field(metadata=dict(static=True))
    c_y: float = dataclasses.field(metadata=dict(static=True))
    dtype_name: str = dataclasses.field(default="float32",
                                        metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nx * self.ny
        return (n, n)

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    def diagonal(self) -> jnp.ndarray:
        return jnp.full((self.nx * self.ny,), self.c_center, self.dtype)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        # Expressed as pad-shifted adds (no scatter): XLA fuses the whole
        # sum into one elementwise pass.
        g = x.reshape(self.nx, self.ny)
        y = self.c_center * g
        y = y + self.c_y * _shift2(g, 1, +1) + self.c_y * _shift2(g, 1, -1)
        y = y + self.c_x * _shift2(g, 0, +1) + self.c_x * _shift2(g, 0, -1)
        return y.reshape(-1)



@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Stencil3D:
    """7-point constant stencil on an ``nx × ny × nz`` grid (Dirichlet).

    Node (i, j, k) → (i·ny + j)·nz + k; couplings ``c_x/c_y/c_z`` along the
    three axes, ``c_center`` on the diagonal.
    """

    nx: int = dataclasses.field(metadata=dict(static=True))
    ny: int = dataclasses.field(metadata=dict(static=True))
    nz: int = dataclasses.field(metadata=dict(static=True))
    c_center: float = dataclasses.field(metadata=dict(static=True))
    c_x: float = dataclasses.field(metadata=dict(static=True))
    c_y: float = dataclasses.field(metadata=dict(static=True))
    c_z: float = dataclasses.field(metadata=dict(static=True))
    dtype_name: str = dataclasses.field(default="float32",
                                        metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nx * self.ny * self.nz
        return (n, n)

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    def diagonal(self) -> jnp.ndarray:
        return jnp.full((self.nx * self.ny * self.nz,), self.c_center,
                        self.dtype)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        # Pad-shifted adds, not scatter — see Stencil2D.matvec.
        g = x.reshape(self.nx, self.ny, self.nz)
        y = self.c_center * g
        y = y + self.c_z * _shift3(g, 2, +1) + self.c_z * _shift3(g, 2, -1)
        y = y + self.c_y * _shift3(g, 1, +1) + self.c_y * _shift3(g, 1, -1)
        y = y + self.c_x * _shift3(g, 0, +1) + self.c_x * _shift3(g, 0, -1)
        return y.reshape(-1)



def _shiftk(g, axis: int, off: int):
    """``out[..i..] = g[..i+off..]`` along ``axis`` with zero fill (any
    static offset)."""
    if off == 0:
        return g
    sl = [slice(None)] * g.ndim
    pad = [(0, 0)] * g.ndim
    if off > 0:
        sl[axis] = slice(off, None)
        pad[axis] = (0, off)
    else:
        sl[axis] = slice(None, off)
        pad[axis] = (-off, 0)
    return jnp.pad(g[tuple(sl)], pad)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GeneralStencil3D:
    """Arbitrary constant-coefficient stencil on an ``nx × ny × nz`` grid
    (Dirichlet): ``A[(i,j,k), (i+dx, j+dy, k+dz)] = coeffs[t]`` for each tap
    ``taps[t] = (dx, dy, dz)``.  Covers 27-point (and any fixed-offset)
    patterns the 7-point :class:`Stencil3D` cannot express; same matrix-free
    zero-storage design, same solver/fused-kernel plumbing.
    """

    nx: int = dataclasses.field(metadata=dict(static=True))
    ny: int = dataclasses.field(metadata=dict(static=True))
    nz: int = dataclasses.field(metadata=dict(static=True))
    taps: Tuple[Tuple[int, int, int], ...] = dataclasses.field(
        metadata=dict(static=True))
    coeffs: Tuple[float, ...] = dataclasses.field(metadata=dict(static=True))
    dtype_name: str = dataclasses.field(default="float32",
                                        metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.nx * self.ny * self.nz
        return (n, n)

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    def diagonal(self) -> jnp.ndarray:
        c0 = 0.0
        for t, tap in enumerate(self.taps):
            if tap == (0, 0, 0):
                c0 = self.coeffs[t]
        return jnp.full((self.nx * self.ny * self.nz,), c0, self.dtype)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        g = x.reshape(self.nx, self.ny, self.nz)
        y = jnp.zeros_like(g)
        for (dx, dy, dz), c in zip(self.taps, self.coeffs):
            s = _shiftk(_shiftk(_shiftk(g, 0, dx), 1, dy), 2, dz)
            y = y + c * s
        return y.reshape(-1)


def poisson3d_27point(nx: int, ny: int, nz: int) -> GeneralStencil3D:
    """27-point Laplacian-type operator: neighbour weights −2/−1/−½ by
    face/edge/corner adjacency, center 28 (zero interior row sum — weakly
    diagonally dominant; SPD with the Dirichlet truncation, like the
    7-point Poisson operators)."""
    taps = []
    coeffs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nnz_axes = (dx != 0) + (dy != 0) + (dz != 0)
                taps.append((dx, dy, dz))
                coeffs.append(28.0 if nnz_axes == 0
                              else -float(2 ** (3 - nnz_axes) / 2))
    return GeneralStencil3D(nx=nx, ny=ny, nz=nz, taps=tuple(taps),
                            coeffs=tuple(coeffs))


def poisson2d_stencil(nx: int, ny: int) -> Stencil2D:
    """Matrix-free 2D 5-point Laplacian (== :func:`cgx.io.poisson.poisson2d`
    applied to any vector, at zero storage)."""
    return Stencil2D(nx=nx, ny=ny, c_center=4.0, c_x=-1.0, c_y=-1.0)


def poisson3d_stencil(nx: int, ny: int, nz: int) -> Stencil3D:
    """Matrix-free 3D 7-point Laplacian."""
    return Stencil3D(nx=nx, ny=ny, nz=nz, c_center=6.0, c_x=-1.0, c_y=-1.0,
                     c_z=-1.0)
