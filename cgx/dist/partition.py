"""Host-side row partitioner: global sparse matrix → per-shard local operators.

Produces a :class:`Partition` — a pytree whose array leaves are *stacked*
along a leading shard axis, so the whole thing shards onto a 1-D ``"rows"``
mesh with ``P("rows", None, ...)`` and each device receives exactly its local
operator.  Two local-operator layouts:

* **Padded ELL** (from CSR): every local row stores a fixed ``width`` of
  (value, column) slots — static shapes, no segment ids.  In
  ``"halo"`` mode columns are rewritten into *extended local* coordinates
  (index into ``[left_halo | local | right_halo]``); in ``"allgather"`` mode
  they stay global.
* **Row-major DIA** (from stencil DIA): ``data_t[i, k] = A[row_i, row_i +
  offsets[k]]`` — SpMV is a handful of statically-shifted FMAs on the
  halo-extended vector, no gathers at all.

The bandwidth analysis in :func:`partition_csr` picks the communication plan:
ring ``ppermute`` halo exchange when the matrix band is narrow enough that
exchanging halos beats gathering the whole iterate, ``all_gather`` otherwise.

Replaces nothing in the reference (it has no distribution — SURVEY.md §2.2);
this is the north-star "rows/blocks of the matrix partitioned per chip"
capability (BASELINE.json).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cgx.sparse.types import CSRMatrix, DIAMatrix

__all__ = ["Partition", "partition_csr", "partition_dia", "pad_vector",
           "unpad_vector"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Partition:
    """Row-partitioned operator, stacked along a leading shard axis.

    Exactly one of the (``ell_values``/``ell_cols``) or ``dia_data`` groups
    is populated, per ``kind``.  All static metadata is aux data so the
    pytree traces cleanly under ``shard_map``.
    """

    # ELL local operators: (n_shards, rows_local, width); None for DIA kind.
    ell_values: Optional[jnp.ndarray]
    ell_cols: Optional[jnp.ndarray]        # int32; extended-local or global
    # DIA local operators: (n_shards, rows_local, n_diags); None for ELL.
    dia_data: Optional[jnp.ndarray]
    dia_offsets: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))
    kind: str = dataclasses.field(metadata=dict(static=True))   # "ell"|"dia"
    mode: str = dataclasses.field(metadata=dict(static=True))   # comm plan
    n: int = dataclasses.field(metadata=dict(static=True))      # true dim
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    rows_local: int = dataclasses.field(metadata=dict(static=True))
    halo_lo: int = dataclasses.field(metadata=dict(static=True))
    halo_hi: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.rows_local

    @property
    def dtype(self):
        arr = self.ell_values if self.kind == "ell" else self.dia_data
        return arr.dtype


def pad_vector(x: jnp.ndarray, n_padded: int) -> jnp.ndarray:
    """Zero-pad a global vector to the shard-equalized length."""
    pad = n_padded - x.shape[0]
    return jnp.pad(x, (0, pad)) if pad else x


def unpad_vector(x, n: int):
    """Strip the shard-equalization padding off a global vector."""
    return x[:n]


def _band_bounds(rows: np.ndarray, cols: np.ndarray) -> Tuple[int, int]:
    """(halo_lo, halo_hi): max distance of any nnz below/above the diagonal."""
    if len(rows) == 0:
        return 0, 0
    band = cols.astype(np.int64) - rows.astype(np.int64)
    return max(0, -int(band.min())), max(0, int(band.max()))


def partition_csr(a: CSRMatrix, n_shards: int,
                  mode: str = "auto") -> Partition:
    """Partition a CSR matrix into ``n_shards`` stacked padded-ELL blocks.

    ``mode``: ``"halo"`` | ``"allgather"`` | ``"auto"`` (bandwidth analysis —
    halo exchange when the band fits in one ring step and moves less data
    than gathering the iterate).
    """
    vals = np.asarray(a.values)
    cols = np.asarray(a.col_indices)
    indptr = np.asarray(a.indptr)
    n = a.shape[0]
    counts = np.diff(indptr).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)

    rl = -(-n // n_shards)               # rows per shard (ceil)
    n_padded = n_shards * rl
    hlo, hhi = _band_bounds(rows, cols)

    if mode == "auto":
        # Halo wins when its per-shard traffic (halo_lo + halo_hi entries)
        # undercuts all-gather (n_padded - rl entries) AND one ring step
        # reaches all needed neighbors (halo <= rows_local).
        halo_ok = (max(hlo, hhi) <= rl
                   and (hlo + hhi) < (n_padded - rl))
        mode = "halo" if halo_ok else "allgather"
    if mode not in ("halo", "allgather"):
        raise ValueError(f"unknown mode {mode!r}")

    width = int(counts.max()) if n else 1
    ell_vals = np.zeros((n_padded, width), dtype=vals.dtype)
    slot = np.concatenate([np.arange(c) for c in counts]) if len(vals) else \
        np.zeros(0, dtype=np.int64)

    shard = rows // rl
    start = shard * rl                    # owning shard's first global row
    if mode == "halo":
        hl, hr = hlo, hhi
        ext_w = hl + rl + hr
        # Extended-local coordinates; padding slots point at the row itself.
        loc_cols = cols.astype(np.int64) - start + hl
        assert loc_cols.min() >= 0 and loc_cols.max() < ext_w, \
            "band bounds violated"
        own = np.arange(n_padded, dtype=np.int64) % rl + hl
    else:
        hl = hr = 0
        loc_cols = cols.astype(np.int64)
        own = np.minimum(np.arange(n_padded, dtype=np.int64), n - 1)

    ell_cols = np.tile(own[:, None], (1, width)).astype(np.int32)
    ell_vals[rows, slot] = vals
    ell_cols[rows, slot] = loc_cols.astype(np.int32)

    return Partition(
        ell_values=jnp.asarray(ell_vals.reshape(n_shards, rl, width)),
        ell_cols=jnp.asarray(ell_cols.reshape(n_shards, rl, width)),
        dia_data=None, dia_offsets=(),
        kind="ell", mode=mode, n=n, n_shards=n_shards, rows_local=rl,
        halo_lo=hl, halo_hi=hr)


def partition_dia(a: DIAMatrix, n_shards: int) -> Partition:
    """Partition a DIA stencil operator into row shards (always halo mode).

    The row-aligned convention ``data[k, i] = A[i, i + offsets[k]]``
    transposes to a per-row layout ``(rows, n_diags)`` that stacks directly
    onto the shard axis; the halo widths are the stencil offsets themselves.
    """
    data = np.asarray(a.data)             # (n_diags, n)
    n = a.shape[0]
    rl = -(-n // n_shards)
    n_padded = n_shards * rl
    data_t = np.zeros((n_padded, data.shape[0]), dtype=data.dtype)
    data_t[:n] = data.T
    offs = a.offsets
    hl = max(0, -min(offs)) if offs else 0
    hr = max(0, max(offs)) if offs else 0
    return Partition(
        ell_values=None, ell_cols=None,
        dia_data=jnp.asarray(data_t.reshape(n_shards, rl, -1)),
        dia_offsets=tuple(offs),
        kind="dia", mode="halo", n=n, n_shards=n_shards, rows_local=rl,
        halo_lo=hl, halo_hi=hr)
