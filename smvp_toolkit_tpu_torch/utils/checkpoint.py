"""Checkpoint: save/load encoded matrices to .npz archives.

Counterpart of ``save_matrix`` and ``load_matrix`` of the JAX package's
``utils/checkpoint.py``: encode once, store the compressed representation
(CSR: row_ptr + col_ind + vals; TJDS adds start_pos / perm / offsets;
COO: the triplets), reload it bit for bit. The archive keys and the
``__meta__`` record are the JAX package's, so a file written by either
package loads in the other. numpy has no bfloat16: the port stores
bfloat16 values as their exact float32 and names the dtype in the record
(``"dtype"``, which the JAX loader ignores), so that they load back as
bfloat16.
"""

from __future__ import annotations

import json
from typing import Union

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix, host_array
from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix
from smvp_toolkit_tpu_torch.io.mtx import MMTypeCode
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = ["save_matrix", "load_matrix"]

_KINDS = {"COOMatrix": COOMatrix, "CSRMatrix": CSRMatrix,
          "TJDSMatrix": TJDSMatrix}


def save_matrix(dest, matrix: Union[COOMatrix, CSRMatrix, TJDSMatrix]) -> None:
    """Serialize an encoded matrix (or COO) to an ``.npz`` archive."""
    kind = type(matrix).__name__
    if kind not in _KINDS:
        raise TypeError(f"cannot checkpoint {kind}")
    meta = {"kind": kind, "shape": list(matrix.shape), "nnz": int(matrix.nnz)}
    if matrix.dtype == torch.bfloat16:
        meta["dtype"] = "bfloat16"
    if isinstance(matrix, COOMatrix):
        meta["typecode"] = str(matrix.typecode)
        arrays = {"rows": host_array(matrix.rows),
                  "cols": host_array(matrix.cols),
                  "vals": host_array(matrix.vals)}
    elif isinstance(matrix, CSRMatrix):
        arrays = {"row_ptr": host_array(matrix.row_ptr),
                  "col_ind": host_array(matrix.col_ind),
                  "vals": host_array(matrix.vals)}
    else:
        arrays = {
            "vals": host_array(matrix.vals),
            "row_ind": host_array(matrix.row_ind),
            "start_pos": host_array(matrix.start_pos),
            "perm": host_array(matrix.perm),
            "offsets": host_array(matrix.offsets),
            "num_diags": np.asarray(np.int32(matrix.num_diags)),
        }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(dest, **arrays)


def _values(a: np.ndarray, meta: dict, dev) -> torch.Tensor:
    """Stored values as a tensor: bfloat16 where the record says so, or
    where the array holds 2-byte bfloat16 words (a JAX bfloat16 file)."""
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if meta.get("dtype") == "bfloat16":
            t = t.to(torch.bfloat16)
    return t.to(dev)


def load_matrix(source, *, device=None
                ) -> Union[COOMatrix, CSRMatrix, TJDSMatrix]:
    """Load a matrix checkpoint written by :func:`save_matrix` (either
    package's) onto ``device`` (default: the card)."""
    dev = resolve_device(device)

    def index(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    with np.load(source) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        kind = meta["kind"]
        shape = tuple(int(s) for s in meta["shape"])
        nnz = int(meta["nnz"])
        if kind == "COOMatrix":
            parts = meta.get("typecode",
                             "matrix coordinate real general").split()
            return COOMatrix(rows=index(z["rows"]), cols=index(z["cols"]),
                             vals=_values(z["vals"], meta, dev), shape=shape,
                             nnz=nnz, typecode=MMTypeCode(*parts))
        if kind == "CSRMatrix":
            return CSRMatrix(row_ptr=index(z["row_ptr"]),
                             col_ind=index(z["col_ind"]),
                             vals=_values(z["vals"], meta, dev), shape=shape,
                             nnz=nnz)
        if kind == "TJDSMatrix":
            return TJDSMatrix(
                vals=_values(z["vals"], meta, dev),
                row_ind=index(z["row_ind"]),
                start_pos=index(z["start_pos"]),
                perm=index(z["perm"]),
                offsets=index(z["offsets"]),
                num_diags=int(z["num_diags"]),
                shape=shape,
                nnz=nnz,
            )
    raise ValueError(f"unknown checkpoint kind {kind!r}")
