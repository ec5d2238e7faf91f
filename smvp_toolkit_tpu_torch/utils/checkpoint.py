"""Checkpoint: save/load encoded matrices, SELL plans and AMG hierarchies
to .npz archives.

Counterpart of the JAX package's ``utils/checkpoint.py``: encode once,
store the compressed representation (CSR: row_ptr + col_ind + vals; TJDS
adds start_pos / perm / offsets; COO: the triplets), the kernel-ready SELL
planes of a plan (``save_plan``: no re-planning on reload) or an AMG
hierarchy's level operators (``save_hierarchy``: the set-up is the
expensive half), and reload them bit for bit. The archive keys and the
``__meta__`` record are the JAX package's, so a file written by either
package loads in the other. numpy has no bfloat16: the port stores
bfloat16 values as their exact float32 and names the dtype in the record
(``"dtype"``, which the JAX loader ignores), so that they load back as
bfloat16.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Union

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix, host_array
from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix
from smvp_toolkit_tpu_torch.io.mtx import MMTypeCode
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = ["save_matrix", "load_matrix", "save_plan", "load_plan",
           "save_hierarchy", "load_hierarchy"]

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


def _meta_bytes(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def save_plan(dest, plan) -> None:
    """Serialize a SELL execution plan (``ops.sell_plan.SellPlan``), the
    kernel-ready planes and their window and block maps, to ``.npz``."""
    base, window = plan.reduce_window()
    meta = {
        "kind": "SellPlan",
        "shape": list(plan.shape),
        "nnz": int(plan.nnz),
        "n_slices": int(plan.n_slices),
        "n_coltiles": int(plan.n_coltiles),
        "window_tiles": int(plan.window_tiles),
        "chunk": int(plan.chunk),
        "slice_window": int(window),
        "y_block_slices": int(plan.y_block_slices),
    }
    arrays = dict(
        vals=np.asarray(plan.vals),
        lane_idx=np.asarray(plan.lane_idx),
        rel_tile=np.asarray(plan.rel_tile),
        slice_of=np.asarray(plan.slice_of),
        tile_base=np.asarray(plan.tile_base),
        slice_base=np.asarray(base),
    )
    if plan.y_block_slices:  # streamed-y plans
        arrays["y_block_id"] = np.asarray(plan.y_block_id)
    np.savez_compressed(dest, __meta__=_meta_bytes(meta), **arrays)


def load_plan(source):
    """Load a SELL plan checkpoint written by :func:`save_plan` (either
    package's) as host arrays, ready for ``SellSpMV(plan, device=...)``."""
    from smvp_toolkit_tpu_torch.ops.sell_plan import SellPlan

    with np.load(source) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("kind") != "SellPlan":
            raise ValueError(f"not a SellPlan checkpoint: {meta.get('kind')}")
        return SellPlan(
            vals=z["vals"],
            lane_idx=z["lane_idx"],
            rel_tile=z["rel_tile"],
            slice_of=z["slice_of"],
            tile_base=z["tile_base"],
            shape=tuple(int(s) for s in meta["shape"]),
            nnz=int(meta["nnz"]),
            n_slices=int(meta["n_slices"]),
            n_coltiles=int(meta["n_coltiles"]),
            window_tiles=int(meta["window_tiles"]),
            chunk=int(meta["chunk"]),
            # Older checkpoints have no reduce window (the full reduce) and
            # no streamed-y block map (a resident-y plan).
            slice_base=z["slice_base"] if "slice_base" in z.files else None,
            slice_window=int(meta.get("slice_window", 0)),
            y_block_id=z["y_block_id"] if "y_block_id" in z.files else None,
            y_block_slices=int(meta.get("y_block_slices", 0)),
        )


def save_hierarchy(dest, levels) -> None:
    """Serialize an AMG hierarchy (``models.amg.amg_setup``) to one
    ``.npz``; reload it into ``amg_preconditioner(..., levels=...)``."""
    meta = {"kind": "AMGHierarchy", "levels": []}
    arrays = {}

    def put(prefix, mat):
        arrays[f"{prefix}_row_ptr"] = host_array(mat.row_ptr)
        arrays[f"{prefix}_col_ind"] = host_array(mat.col_ind)
        arrays[f"{prefix}_vals"] = host_array(mat.vals)
        return {"shape": list(mat.shape), "nnz": int(mat.nnz)}

    for li, lv in enumerate(levels):
        entry = {"n": int(lv.n), "omega": float(lv.omega),
                 "rho": float(lv.rho)}
        if lv.coarse_inv is not None:
            arrays[f"l{li}_coarse_inv"] = host_array(lv.coarse_inv)
        else:
            entry["a"] = put(f"l{li}_a", lv.a_csr)
            entry["p"] = put(f"l{li}_p", lv.p_csr)
            entry["pt"] = put(f"l{li}_pt", lv.pt_csr)
            arrays[f"l{li}_inv_diag"] = host_array(lv.inv_diag)
        meta["levels"].append(entry)
    arrays["__meta__"] = _meta_bytes(meta)
    np.savez(dest, **arrays)


def load_hierarchy(source, *, device=None):
    """Load an AMG hierarchy written by :func:`save_hierarchy` (either
    package's) onto ``device`` (default: the card). Each level's CSR
    carries its row ids, as a fresh encode does."""
    from smvp_toolkit_tpu_torch.models.amg import AMGLevel

    dev = resolve_device(device)

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(dev)

    with np.load(source) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("kind") != "AMGHierarchy":
            raise TypeError(f"not an AMG hierarchy: {meta.get('kind')}")

        def get(prefix, spec):
            return CSRMatrix(
                row_ptr=tensor(z[f"{prefix}_row_ptr"], np.int32),
                col_ind=tensor(z[f"{prefix}_col_ind"], np.int32),
                vals=tensor(z[f"{prefix}_vals"], np.float32),
                shape=tuple(int(s) for s in spec["shape"]),
                nnz=int(spec["nnz"]),
            ).with_row_ids()

        levels = []
        for li, entry in enumerate(meta["levels"]):
            if f"l{li}_coarse_inv" in z.files:
                levels.append(AMGLevel(
                    n=int(entry["n"]),
                    coarse_inv=tensor(z[f"l{li}_coarse_inv"], np.float32)))
            else:
                levels.append(AMGLevel(
                    n=int(entry["n"]),
                    a_csr=get(f"l{li}_a", entry["a"]),
                    p_csr=get(f"l{li}_p", entry["p"]),
                    pt_csr=get(f"l{li}_pt", entry["pt"]),
                    inv_diag=tensor(z[f"l{li}_inv_diag"], np.float32),
                    omega=float(entry["omega"]),
                    rho=float(entry["rho"]),
                ))
        return levels
