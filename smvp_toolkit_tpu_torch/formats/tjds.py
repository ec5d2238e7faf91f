"""TJDS (Transpose Jagged Diagonal Storage) codec on torch tensors.

Counterpart of the JAX package's ``formats/tjds.py``, the reference's
second format (main-cli.c:752-967: col-major sort, per-column vertical
compression, column-length reorder, column renumber, jagged-diagonal
pack), with the JAX package's fixes:

* the diagonal count is the true maximum column length (the reference
  reads it from the unsorted reorder table, SURVEY.md §B2);
* ``start_pos`` holds every diagonal plus a final sentinel (§B3);
* SpMV gathers x by position within the diagonal, i.e. by permuted
  column (§B4), so any x works and decode is possible.

Encode is two stable torch sorts plus prefix builds on the COO's device,
the same keys in the same order as the JAX encoder, so every array is
bit-identical to it; a COO on the CPU takes the native counting sorts
instead (``formats/encode_native.py``), as the JAX encoder does for host
arrays, with the same arrays. Decode recovers columns from ``start_pos`` and
``perm`` alone and is bit-exact on indices and stored values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

__all__ = ["TJDSMatrix", "tjds_encode", "tjds_decode"]


@dataclasses.dataclass(frozen=True, eq=False)
class TJDSMatrix:
    """Transpose Jagged Diagonal Storage on one device (padded shapes).

    Compressed footprint = ``vals`` + ``row_ind`` + ``start_pos`` (first
    ``num_diags + 1`` entries) + ``perm``. ``offsets`` (position within
    the diagonal, reconstructible from ``start_pos``) is derived scratch
    for the gather-free SpMV and is not counted. ``eq=False`` keeps
    identity hashing, so a matrix can key the operator cache weakly.
    """

    vals: torch.Tensor  # dtype[nnz_padded], packed by (diag, position)
    row_ind: torch.Tensor  # int32[nnz_padded], original row per entry
    start_pos: torch.Tensor  # int32[diag_bound + 1], prefix starts (then nnz)
    perm: torch.Tensor  # int32[ncols]: original column at permuted position
    offsets: torch.Tensor  # int32[nnz_padded]: position within diagonal
    num_diags: int  # true number of jagged diagonals
    shape: Tuple[int, int]
    nnz: int

    @property
    def nnz_padded(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def diag_bound(self) -> int:
        """Upper bound on the diagonal count (start_pos length - 1)."""
        return int(self.start_pos.shape[0]) - 1

    def footprint_bytes(self) -> int:
        """Compressed footprint at true sizes (vals+row_ind+start_pos+perm)."""
        isz = 4
        vsz = self.vals.element_size()
        return (
            self.nnz * (isz + vsz)  # row_ind + vals
            + (self.num_diags + 1) * isz  # start_pos
            + self.ncols * isz  # perm
        )

    def __repr__(self) -> str:
        return (
            f"TJDSMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"padded={self.nnz_padded}, diags<={self.diag_bound}, "
            f"dtype={self.dtype}, device={self.device})"
        )


def _max_col_count(coo: COOMatrix) -> int:
    """Longest column's entry count (the true jagged-diagonal count)."""
    ncols = coo.shape[1]
    if ncols == 0 or coo.nnz == 0:
        return 0
    cols = coo.cols[: coo.nnz].long()
    return int(torch.bincount(cols, minlength=ncols).max())


def _tjds_encode_native(coo: COOMatrix, diag_bound: int) -> TJDSMatrix:
    """Host fast path: native counting-sort pack (the same order)."""
    from smvp_toolkit_tpu_torch.formats import encode_native as en

    r, c, v = en.host_triplets(coo)
    order, offsets, perm, start_pos, num_diags = en.tjds_order(
        r, c, coo.nnz, coo.shape[0], coo.shape[1], diag_bound)
    dev = coo.device
    return TJDSMatrix(
        vals=v[torch.from_numpy(order)].to(dev),
        row_ind=torch.from_numpy(r[order]).to(dev),
        start_pos=torch.from_numpy(start_pos).to(dev),
        perm=torch.from_numpy(np.ascontiguousarray(perm)).to(dev),
        offsets=torch.from_numpy(offsets).to(dev),
        num_diags=num_diags,
        shape=coo.shape,
        nnz=coo.nnz,
    )


def tjds_encode(coo: COOMatrix) -> TJDSMatrix:
    """Encode COO → TJDS on the COO's device.

    ``start_pos`` is sized by the measured diagonal count rounded up to a
    multiple of 8 (at least 8), as the JAX encoder sizes it.
    """
    from smvp_toolkit_tpu_torch.formats import encode_native as en

    nd = _max_col_count(coo)
    diag_bound = max(-(-nd // 8) * 8, 8)
    if en.use_native(coo):
        return _tjds_encode_native(coo, diag_bound)
    nrows, ncols = coo.shape
    nnz, npad, dev = coo.nnz, coo.nnz_padded, coo.device

    pos = torch.arange(npad, device=dev)
    valid = pos < nnz
    rows = torch.where(valid, coo.rows.long(), nrows)
    cols = torch.where(valid, coo.cols.long(), ncols)
    vals = torch.where(valid, coo.vals,
                       torch.zeros((), dtype=coo.dtype, device=dev))

    # Column lengths, then the column permutation by descending length,
    # ties by column id (a stable sort of -length).
    counts = torch.bincount(cols, minlength=ncols + 1)[:ncols]
    perm = torch.sort(-counts, stable=True).indices
    rank = torch.empty(ncols + 1, dtype=torch.long, device=dev)
    rank[perm] = torch.arange(ncols, device=dev)
    rank[ncols] = ncols  # padding sentinel maps to itself
    new_col = rank[cols]

    # Vertical compression: sort by (permuted column, row); the rank of an
    # entry within its column is its jagged diagonal.
    order1 = torch.sort(new_col * (nrows + 1) + rows, stable=True).indices
    nc1, rows1, vals1 = new_col[order1], rows[order1], vals[order1]
    col_start = torch.searchsorted(nc1, nc1, side="left")
    diag = torch.where(nc1 >= ncols, diag_bound, pos - col_start)

    # Pack by (diagonal, permuted column): within diagonal d the entries
    # occupy permuted columns 0..n_d-1 contiguously.
    order2 = torch.sort(diag * (ncols + 1) + nc1, stable=True).indices
    diag2 = diag[order2]
    offsets = torch.where(valid, nc1[order2], 0)
    start_pos = torch.searchsorted(
        diag2, torch.arange(diag_bound + 1, device=dev), side="left"
    ).clamp(max=nnz)
    return TJDSMatrix(
        vals=vals1[order2],
        row_ind=rows1[order2].to(torch.int32),
        start_pos=start_pos.to(torch.int32),
        perm=perm.to(torch.int32),
        offsets=offsets.to(torch.int32),
        num_diags=nd,
        shape=coo.shape,
        nnz=nnz,
    )


def tjds_decode(tjds: TJDSMatrix) -> COOMatrix:
    """Decode TJDS → COO from the compressed footprint only.

    Positions within a diagonal come from ``start_pos`` (not the cached
    ``offsets``), which shows the compressed form is self-contained.
    Entries keep the TJDS storage order; padding keeps the ``row ==
    nrows`` sentinel.
    """
    dev = tjds.device
    j = torch.arange(tjds.nnz_padded, device=dev)
    sp = tjds.start_pos.long()
    d = (torch.searchsorted(sp, j, side="right") - 1).clamp(
        0, tjds.diag_bound)
    valid = j < tjds.nnz
    offset = torch.where(valid, j - sp[d], 0).clamp(
        0, max(tjds.ncols - 1, 0))
    if tjds.ncols:
        cols = torch.where(valid, tjds.perm.long()[offset], 0)
    else:
        cols = torch.zeros_like(j)
    rows = torch.where(valid, tjds.row_ind.long(), tjds.nrows)
    vals = torch.where(valid, tjds.vals,
                       torch.zeros((), dtype=tjds.dtype, device=dev))
    return COOMatrix(rows=rows.to(torch.int32), cols=cols.to(torch.int32),
                     vals=vals, shape=tjds.shape, nnz=tjds.nnz)

