"""Grid views of structured operators (cgx.sparse.grid) and the ELL/CSR
storage pick (cgx.sparse.types.pick_format)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from cgx.io.poisson import poisson2d_dia, poisson3d_dia, poisson3d_dia27
from cgx.ops.spmv import spmv
from cgx.sparse.grid import (dia_grid_taps, dia_pattern_dims, stencil_taps,
                             stencil_to_dia)
from cgx.sparse.stencil import (poisson2d_stencil, poisson3d_27point,
                                poisson3d_stencil)
from cgx.sparse.types import (auto_format, csr_from_scipy, ell_from_csr,
                              pick_format)


@pytest.mark.parametrize("make", [
    lambda: poisson2d_stencil(7, 5),
    lambda: poisson3d_stencil(4, 5, 6),
    lambda: poisson3d_27point(3, 4, 5),
], ids=["stencil2d", "stencil3d", "stencil27"])
def test_stencil_to_dia_is_the_same_operator(make, rng):
    s = make()
    d = stencil_to_dia(s, np.float64)
    x = jnp.asarray(rng.standard_normal(s.shape[0]))
    np.testing.assert_allclose(np.asarray(spmv(d, x)),
                               np.asarray(spmv(s.__class__(
                                   **{**s.__dict__,
                                      "dtype_name": "float64"}), x)),
                               rtol=1e-13, atol=1e-13)
    assert d.offsets == tuple(sorted(d.offsets))
    nx, ny, nz, _, _ = stencil_taps(s)
    assert d.grid == (nx, ny, nz)
    # The grid metadata decomposes back into the stencil's own taps.
    assert dia_grid_taps(d) is not None


def test_stencil_to_dia_rejects_unknown_operator():
    with pytest.raises(ValueError):
        stencil_to_dia(poisson2d_dia(3, 3))


def test_dia_grid_taps_7point_and_27point():
    d7 = poisson3d_dia(5, 4, 3)
    assert dia_pattern_dims(d7) == (5, 4, 3)
    nx, ny, nz, taps = dia_grid_taps(d7)
    assert (nx, ny, nz) == (5, 4, 3) and len(taps) == 7
    d27 = poisson3d_dia27(4, 4, 4)
    nx, ny, nz, taps = dia_grid_taps(d27)
    assert (nx, ny, nz) == (4, 4, 4) and len(set(taps)) == 27
    assert all(max(map(abs, t)) <= 1 for t in taps)
    # A banded matrix with no grid metadata and no 7-point pattern.
    assert dia_grid_taps(poisson2d_dia(4, 4)) is None


def test_stencil_taps_maps_2d_to_single_y_plane():
    nx, ny, nz, taps, coeffs = stencil_taps(poisson2d_stencil(6, 9))
    assert (nx, ny, nz) == (6, 1, 9)
    assert len(taps) == len(coeffs) == 5
    assert stencil_taps(poisson2d_dia(3, 3)) is None


@pytest.mark.parametrize("kind,expected", [("banded", "ell"),
                                           ("skewed", "csr")])
def test_pick_format_ell_vs_csr(kind, expected, rng):
    n = 200
    if kind == "banded":
        # 7 nonzeros per interior row: the 8-rounded width wastes ~15 %.
        a = sp.diags([-0.5] * 6 + [8.0], [-3, -2, -1, 1, 2, 3, 0],
                     shape=(n, n), format="csr")
    else:
        # One dense row: padding every row to its width wastes > 1.5x.
        a = sp.lil_matrix((n, n))
        a.setdiag(4.0)
        a[0, :] = 1.0
        a[:, 0] = 1.0
        a[0, 0] = n + 4.0
        a = a.tocsr()
    a.sort_indices()
    csr = csr_from_scipy(a)
    assert pick_format(csr) == expected
    op, fmt = auto_format(csr)
    assert fmt == expected
    x = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(np.asarray(spmv(op, x)), a @ np.asarray(x),
                               rtol=1e-12)


def test_ell_diagonal_matches_csr(rng):
    a = csr_from_scipy(sp.random(40, 40, density=0.1, random_state=3,
                                 format="csr") + sp.eye(40) * 3.0)
    e = ell_from_csr(a, width_multiple=8)
    np.testing.assert_allclose(np.asarray(e.diagonal()),
                               np.asarray(a.diagonal()), rtol=1e-14)
