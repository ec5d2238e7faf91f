"""CSR (Compressed Sparse Row) codec on torch tensors.

Counterpart of the JAX package's ``formats/csr.py``: encode is one stable
sort on the int64 key ``row·ncols + col`` (the same order as the JAX
package's ``lexsort((cols, rows))`` and its native counting sort) plus a
``searchsorted`` prefix build of ``row_ptr``, which handles empty rows by
construction. A COO on the CPU takes the native counting sort instead
(``formats/encode_native.py``), as the JAX encoder does for host arrays;
both give the same arrays. Decode recovers row ids from ``row_ptr`` and is bit-exact
on indices and stored values. ``col_ind``/``vals`` may be padded beyond
``nnz``; padded entries carry ``col = 0, val = 0`` past ``row_ptr[nrows]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.utils import tracing

__all__ = ["CSRMatrix", "csr_encode", "csr_decode", "row_ids_from_ptr"]


@dataclasses.dataclass(frozen=True, eq=False)
class CSRMatrix:
    """Compressed Sparse Row matrix on one device.

    ``row_ids`` (row index per nnz slot) is derived scratch for the
    segment-sum SpMV; it is reconstructible from ``row_ptr``.
    """

    row_ptr: torch.Tensor  # int32[nrows + 1]
    col_ind: torch.Tensor  # int32[nnz_padded]
    vals: torch.Tensor  # dtype[nnz_padded]
    shape: Tuple[int, int]
    nnz: int
    row_ids: Optional[torch.Tensor] = None  # int32[nnz_padded]

    @property
    def nnz_padded(self) -> int:
        return int(self.col_ind.shape[0])

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

    def footprint_bytes(self) -> int:
        """Compressed footprint: row_ptr, col_ind and vals at the true nnz,
        the values at their dtype's own size (bfloat16: 2 bytes), as the
        JAX ``CSRMatrix.footprint_bytes``; ``row_ids`` is not counted."""
        isz = 4  # int32 row_ptr and col_ind
        return (self.nrows + 1) * isz + self.nnz * (
            isz + self.vals.element_size())

    def with_row_ids(self) -> "CSRMatrix":
        """This matrix with the per-slot row ids materialized (padding
        slots get the ``nrows`` sentinel); itself if it has them."""
        if self.row_ids is not None:
            return self
        return dataclasses.replace(self, row_ids=row_ids_from_ptr(self))

    def __repr__(self) -> str:
        return (
            f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"padded={self.nnz_padded}, dtype={self.dtype}, "
            f"device={self.device})"
        )


def _csr_encode_native(coo: COOMatrix) -> CSRMatrix:
    """Host fast path: native stable counting sort (the same order)."""
    from smvp_toolkit_tpu_torch.formats import encode_native as en

    r, c, v = en.host_triplets(coo)
    order, row_ptr = en.csr_order(r, c, coo.nnz, coo.shape[0], coo.shape[1])
    dev = coo.device
    idx = torch.from_numpy(order)
    return CSRMatrix(
        row_ptr=torch.from_numpy(row_ptr).to(dev),
        col_ind=torch.from_numpy(c[order]).to(dev),
        vals=v[idx].to(dev),
        shape=coo.shape,
        nnz=coo.nnz,
        row_ids=torch.from_numpy(r[order]).to(dev),
    )


def csr_encode(coo: COOMatrix) -> CSRMatrix:
    """Encode COO → CSR on the COO's device: the native counting sort for
    a COO on the CPU (``encode_native.use_native``), else torch sorts."""
    with tracing.span("encode.csr"):
        return _csr_encode(coo)


def _csr_encode(coo: COOMatrix) -> CSRMatrix:
    from smvp_toolkit_tpu_torch.formats import encode_native as en

    if en.use_native(coo):
        return _csr_encode_native(coo)
    nrows, ncols = coo.shape
    dev = coo.device
    # Padding entries carry row == nrows; force that invariant so they
    # sort last however the COO was built.
    valid = torch.arange(coo.nnz_padded, device=dev) < coo.nnz
    rows = torch.where(valid, coo.rows, nrows).long()
    cols = torch.where(valid, coo.cols, 0).long()
    vals = torch.where(valid, coo.vals, torch.zeros((), dtype=coo.dtype,
                                                    device=dev))
    order = torch.sort(rows * max(ncols, 1) + cols, stable=True).indices
    rows_s = rows[order]
    row_ptr = torch.searchsorted(
        rows_s, torch.arange(nrows + 1, device=dev), side="left"
    ).to(torch.int32)
    return CSRMatrix(
        row_ptr=row_ptr,
        col_ind=cols[order].to(torch.int32),
        vals=vals[order],
        shape=coo.shape,
        nnz=coo.nnz,
        row_ids=rows_s.to(torch.int32),
    )


def row_ids_from_ptr(csr: CSRMatrix) -> torch.Tensor:
    """Row id per nnz slot; padded slots get the ``nrows`` sentinel."""
    j = torch.arange(csr.nnz_padded, device=csr.device)
    ids = torch.searchsorted(csr.row_ptr.long(), j, side="right") - 1
    return ids.clamp(0, csr.nrows).to(torch.int32)


def csr_decode(csr: CSRMatrix) -> COOMatrix:
    """Decode CSR → COO (canonical row-major order), bit-exact."""
    return COOMatrix(
        rows=csr.with_row_ids().row_ids, cols=csr.col_ind, vals=csr.vals,
        shape=csr.shape, nnz=csr.nnz,
    )
