"""2-D sharded SpMV: row × column blocks over a grid of ranks.

Counterpart of the JAX package's ``parallel/spmv_2d.py``. The grid is R
rows × C columns of ranks, rank ``i·C + j`` at (i, j); it owns the
non-zeros of row block i whose columns fall in column block j, and reads
only x's column block j. Each rank sums its partial y block, an
all-reduce along its grid row (the JAX ``dpc`` axis) adds the column
blocks' partials, and an all-gather along its grid column (``dpr``)
stacks the row blocks in order. At C = 1 this is the 1-D row-block
design; at R = 1 pure column parallelism.

As in ``spmv_dist``, every rank builds the same host stacks, (R, C,
nnz_blk), and keeps its own cell on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
from smvp_toolkit_tpu_torch.parallel.mesh import (
    _group_device,
    gather_rows,
    reduce_sum,
)
from smvp_toolkit_tpu_torch.parallel.spmv_dist import (
    _csr_entry_rows,
    _round_up,
)
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = [
    "Mesh2D",
    "ShardedCSR2D",
    "make_mesh_2d",
    "shard_csr_2d",
    "spmv_csr_2d",
    "spmm_csr_2d",
]


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """An R × C grid of ranks: this process at (``row``, ``col``), the
    group of its grid row (``row_group``, C ranks: the all-reduce) and of
    its grid column (``col_group``, R ranks: the all-gather); None where
    this process runs no collective."""

    rows: int
    cols: int
    row: int
    col: int
    device: torch.device
    row_group: Optional[object] = None
    col_group: Optional[object] = None


def make_mesh_2d(rows: int, cols: int, *, device=None) -> Mesh2D:
    """An R × C grid over the group's first R·C ranks. Every rank of the
    group creates every grid row's and column's group, in the same order;
    a rank outside the grid gets ``row == col == -1``."""
    n = rows * cols
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(
            f"mesh {rows}x{cols} needs {n} devices, only {world} present"
        )
    if not dist.is_initialized():
        return Mesh2D(rows, cols, 0, 0, resolve_device(device))
    row_groups = [dist.new_group([i * cols + j for j in range(cols)])
                  for i in range(rows)]
    col_groups = [dist.new_group([i * cols + j for i in range(rows)])
                  for j in range(cols)]
    me = dist.get_rank()
    if me >= n:
        return Mesh2D(rows, cols, -1, -1, _group_device())
    i, j = divmod(me, cols)
    return Mesh2D(rows, cols, i, j, _group_device(), row_groups[i],
                  col_groups[j])


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCSR2D:
    """Per-cell entry sets of equal padded width: host stacks (R, C,
    nnz_blk) with block-relative rows and columns (padding: row
    ``rows_blk``, value 0), and cell (``row``, ``col``)'s on its device in
    ``local``."""

    vals: torch.Tensor  # host dtype[R, C, nnz_blk]
    local_cols: torch.Tensor  # host int32[R, C, nnz_blk]
    local_rows: torch.Tensor  # host int32[R, C, nnz_blk]
    shape: Tuple[int, int]
    nnz: int
    rows_blk: int
    cols_blk: int
    grid: Tuple[int, int]
    cell: Tuple[int, int] = (0, 0)
    local: tuple = ()  # (vals, local_cols, local_rows) of ``cell``

    def for_cell(self, row: int, col: int, device) -> "ShardedCSR2D":
        """This sharding as the rank at (row, col) holds it."""
        return dataclasses.replace(self, cell=(row, col), local=tuple(
            s[row, col].to(device)
            for s in (self.vals, self.local_cols, self.local_rows)))


def shard_csr_2d(csr: CSRMatrix, mesh: Mesh2D) -> ShardedCSR2D:
    """Repack a CSR into (row block, column block) cells."""
    R, C = mesh.rows, mesh.cols
    nrows, ncols = csr.shape
    rows_blk = _round_up(nrows, R) // R
    cols_blk = _round_up(ncols, C) // C
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col = csr.col_ind[: csr.nnz].cpu().numpy().astype(np.int64)
    val = csr.vals[: csr.nnz].cpu()
    row = _csr_entry_rows(csr, row_ptr)

    cell = (row // rows_blk) * C + col // cols_blk
    order = np.argsort(cell, kind="stable")  # row-sorted within a cell
    counts = np.bincount(cell, minlength=R * C)
    nnz_blk = max(_round_up(int(counts.max()), 8), 8)
    vals_b = torch.zeros((R * C, nnz_blk), dtype=val.dtype)
    lcols_b = torch.zeros((R * C, nnz_blk), dtype=torch.int32)
    lrows_b = torch.full((R * C, nnz_blk), rows_blk, dtype=torch.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for k in range(R * C):
        sel = order[starts[k]: starts[k + 1]]
        w = len(sel)
        vals_b[k, :w] = val[torch.from_numpy(sel)]
        lcols_b[k, :w] = torch.from_numpy(
            (col[sel] - (k % C) * cols_blk).astype(np.int32))
        lrows_b[k, :w] = torch.from_numpy(
            (row[sel] - (k // C) * rows_blk).astype(np.int32))
    shape3 = (R, C, nnz_blk)
    sh = ShardedCSR2D(
        vals=vals_b.reshape(shape3), local_cols=lcols_b.reshape(shape3),
        local_rows=lrows_b.reshape(shape3), shape=csr.shape, nnz=csr.nnz,
        rows_blk=rows_blk, cols_blk=cols_blk, grid=(R, C),
    )
    return sh.for_cell(max(mesh.row, 0), max(mesh.col, 0), mesh.device)


def _local_2d(sharded: ShardedCSR2D, X: torch.Tensor) -> torch.Tensor:
    """The cell's partial y block, rows_blk (× k): products of its entries
    with x's column block, summed per block row."""
    vals, lcols, lrows = sharded.local
    j = sharded.cell[1]
    npad = sharded.grid[1] * sharded.cols_blk
    if X.shape[0] < npad:
        X = torch.nn.functional.pad(
            X, (0, 0) * (X.dim() - 1) + (0, npad - X.shape[0]))
    xb = X[j * sharded.cols_blk:(j + 1) * sharded.cols_blk]
    gathered = xb[lcols.long()]
    prod = (vals if X.dim() == 1 else vals[:, None]) * gathered
    out = torch.zeros((sharded.rows_blk + 1, *X.shape[1:]),
                      dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, lrows.long(), prod)[:-1]


def _spmv_2d(sharded: ShardedCSR2D, X: torch.Tensor,
             mesh: Mesh2D) -> torch.Tensor:
    if mesh.row < 0:
        raise ValueError(f"this process is outside the {mesh.rows}x"
                         f"{mesh.cols} grid")
    y_blk = reduce_sum(_local_2d(sharded, X), mesh.cols, mesh.row_group)
    y = gather_rows(y_blk, mesh.rows, mesh.col_group)
    return y[: sharded.shape[0]]


def spmv_csr_2d(sharded: ShardedCSR2D, x: torch.Tensor,
                mesh: Mesh2D) -> torch.Tensor:
    """y = A·x on the 2-D sharding: an all-reduce of the partial y blocks
    along the grid row, an all-gather along the grid column; y on every
    rank. x is given whole; each rank reads only its column block."""
    return _spmv_2d(sharded, x, mesh)


def spmm_csr_2d(sharded: ShardedCSR2D, x: torch.Tensor,
                mesh: Mesh2D) -> torch.Tensor:
    """Y = A·X (X (ncols, k)) on the 2-D sharding, the same collectives."""
    return _spmv_2d(sharded, x, mesh)
