"""Sharded SpMV: CSR row blocks and TJDS nnz stripes over a process group.

Counterpart of the JAX package's ``parallel/spmv_dist.py``, with rank =
shard in place of ``shard_map`` over a device mesh:

* **CSR row blocks** — rows split into ``n`` contiguous blocks, each
  block's entries repacked and padded to the widest block (pad entries
  carry the row sentinel ``rows_per_shard``). x is replicated; each rank
  sums its block's products per row (plain PyTorch ``index_add_``); the
  global y is an all-gather in rank order, which is row order, with each
  block's padded rows dropped.
* **TJDS nnz stripes** — the packed entry stream cut into ``n`` equal
  contiguous stripes; each rank sums its stripe into a full-length
  partial y and an all-reduce adds the partials.

Every rank builds the same host stacks (``(n, nnz_blk)`` CPU tensors, the
JAX arrays element for element) and keeps only its own row of them on
its device (``local``); ``for_rank`` gives another rank's view, and
``_local_*`` computes one rank's part without a collective.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix
from smvp_toolkit_tpu_torch.parallel.mesh import (
    Mesh,
    _member,
    gather_rows,
    make_mesh,
    reduce_sum,
)

__all__ = [
    "ShardedCSR",
    "ShardedTJDS",
    "shard_csr",
    "shard_tjds",
    "spmv_csr_sharded",
    "spmm_csr_sharded",
    "spmv_tjds_sharded",
    "shard_and_bench",
]

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _csr_entry_rows(csr: CSRMatrix, row_ptr: np.ndarray) -> np.ndarray:
    """Global row id per true entry (host int64)."""
    rows = csr.with_row_ids().row_ids
    return rows[: csr.nnz].cpu().numpy().astype(np.int64)


def _rank_rows(stacks, rank: int, device) -> tuple:
    """Row ``rank`` of each host stack, on ``device``."""
    return tuple(s[rank].to(device) for s in stacks)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCSR:
    """CSR split into contiguous row blocks, one per rank.

    ``vals``, ``col_ind`` and ``local_rows`` are the host stacks of every
    block, shape (n, nnz_blk); ``local`` holds row ``rank`` of each on
    ``device``. ``row_starts`` holds each block's first global row and
    ``nnz_starts`` its first CSR entry.
    """

    vals: torch.Tensor  # host dtype[n, nnz_blk]
    col_ind: torch.Tensor  # host int32[n, nnz_blk]
    local_rows: torch.Tensor  # host int32[n, nnz_blk] (pad = rows_per_shard)
    shape: Tuple[int, int]
    nnz: int
    rows_per_shard: int
    n_shards: int
    row_starts: Tuple[int, ...] = ()
    nnz_starts: Tuple[int, ...] = ()
    rank: int = 0
    local: tuple = ()  # (vals, col_ind, local_rows) of shard ``rank``

    def for_rank(self, rank: int, device) -> "ShardedCSR":
        """This sharding as rank ``rank`` holds it, on ``device``."""
        return dataclasses.replace(self, rank=rank, local=_rank_rows(
            (self.vals, self.col_ind, self.local_rows), rank, device))

    def with_vals(self, ev: torch.Tensor) -> "ShardedCSR":
        """The sharding with values ``ev`` in the encoded CSR's entry order
        (at least ``nnz`` long); the rank's block is a padded slice of
        ``ev``, so a gradient flows back to it (distributed edge-weight
        training)."""
        ends = self.nnz_starts[1:] + (self.nnz,)
        width = int(self.vals.shape[1])
        blocks = [torch.nn.functional.pad(ev[s:e], (0, width - (e - s)))
                  for s, e in zip(self.nnz_starts, ends)]
        host = torch.stack([b.detach().cpu() for b in blocks]).to(
            self.vals.dtype)
        mine = blocks[self.rank].to(self.local[0].device, self.vals.dtype)
        return dataclasses.replace(self, vals=host,
                                   local=(mine,) + self.local[1:])

    def block_rows(self) -> Tuple[int, ...]:
        """True (unpadded) row count of each block."""
        ends = self.row_starts[1:] + (self.shape[0],)
        return tuple(e - s for s, e in zip(self.row_starts, ends))


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTJDS:
    """TJDS packed entries split into equal contiguous nnz stripes; host
    stacks (n, nnz_blk) and rank ``rank``'s stripe (with ``perm``) in
    ``local``."""

    vals: torch.Tensor  # host dtype[n, nnz_blk]
    row_ind: torch.Tensor  # host int32[n, nnz_blk] (pad -> nrows sentinel)
    offsets: torch.Tensor  # host int32[n, nnz_blk]
    perm: torch.Tensor  # host int32[ncols]
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    rank: int = 0
    local: tuple = ()  # (vals, row_ind, offsets, perm) of stripe ``rank``

    def for_rank(self, rank: int, device) -> "ShardedTJDS":
        return dataclasses.replace(self, rank=rank, local=_rank_rows(
            (self.vals, self.row_ind, self.offsets), rank, device)
            + (self.perm.to(device),))


# ---------------------------------------------------------------------------
# Sharding (host repack, once per matrix)
# ---------------------------------------------------------------------------


def shard_csr(csr: CSRMatrix, mesh: Mesh, *,
              balance: str = "rows") -> ShardedCSR:
    """Repack a CSR into contiguous row blocks, one per rank.

    ``balance="rows"`` splits rows evenly; ``balance="nnz"`` puts the
    block boundaries at equal-nnz quantiles of ``row_ptr``, so a skewed
    (power-law) matrix loads the ranks evenly. Blocks stay contiguous in
    row order either way.
    """
    n = mesh.size
    nrows = csr.shape[0]
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    if balance == "nnz":
        targets = (np.arange(1, n) * csr.nnz) // n
        cuts = np.searchsorted(row_ptr, targets, side="left")
        row_starts = np.concatenate([[0], cuts, [nrows]]).astype(np.int64)
        np.maximum.accumulate(row_starts, out=row_starts)
    elif balance == "rows":
        blk = _round_up(max(nrows, 1), n) // n
        row_starts = np.minimum(np.arange(n + 1) * blk, nrows)
    else:
        raise ValueError(f"balance must be 'rows' or 'nnz', got {balance!r}")
    rows_blk = max(int(np.diff(row_starts).max()), 1)

    col = csr.col_ind[: csr.nnz].cpu()
    val = csr.vals[: csr.nnz].cpu()
    starts = row_ptr[row_starts[:-1]]
    ends = row_ptr[row_starts[1:]]
    nnz_blk = max(_round_up(int((ends - starts).max()), 8), 8)

    vals_b = torch.zeros((n, nnz_blk), dtype=val.dtype)
    cols_b = torch.zeros((n, nnz_blk), dtype=torch.int32)
    lrows_b = torch.full((n, nnz_blk), rows_blk, dtype=torch.int32)
    grow = _csr_entry_rows(csr, row_ptr)
    for k in range(n):
        s, e = int(starts[k]), int(ends[k])
        vals_b[k, : e - s] = val[s:e]
        cols_b[k, : e - s] = col[s:e]
        lrows_b[k, : e - s] = torch.from_numpy(
            (grow[s:e] - int(row_starts[k])).astype(np.int32))
    sh = ShardedCSR(
        vals=vals_b, col_ind=cols_b, local_rows=lrows_b, shape=csr.shape,
        nnz=csr.nnz, rows_per_shard=rows_blk, n_shards=n,
        row_starts=tuple(int(s) for s in row_starts[:-1]),
        nnz_starts=tuple(int(s) for s in starts),
    )
    return sh.for_rank(max(mesh.rank, 0), mesh.device)


def shard_tjds(tjds: TJDSMatrix, mesh: Mesh) -> ShardedTJDS:
    """Cut the packed entry stream into equal contiguous nnz stripes."""
    n = mesh.size
    nnz = tjds.nnz
    nnz_blk = max(_round_up(max(nnz, 1), n) // n, 8)
    total = n * nnz_blk
    vals_b = torch.zeros(total, dtype=tjds.vals.dtype)
    rows_b = torch.full((total,), tjds.shape[0], dtype=torch.int32)
    offs_b = torch.zeros(total, dtype=torch.int32)
    vals_b[:nnz] = tjds.vals[:nnz].cpu()
    rows_b[:nnz] = tjds.row_ind[:nnz].cpu()
    offs_b[:nnz] = tjds.offsets[:nnz].cpu()
    sh = ShardedTJDS(
        vals=vals_b.reshape(n, nnz_blk), row_ind=rows_b.reshape(n, nnz_blk),
        offsets=offs_b.reshape(n, nnz_blk), perm=tjds.perm.cpu(),
        shape=tjds.shape, nnz=nnz, n_shards=n,
    )
    return sh.for_rank(max(mesh.rank, 0), mesh.device)


# ---------------------------------------------------------------------------
# Sharded SpMV: each rank's local part, then the collective
# ---------------------------------------------------------------------------


def _local_csr(sharded: ShardedCSR, X: torch.Tensor) -> torch.Tensor:
    """The rank's row block of A·X for x (ncols,) or X (ncols, k): the
    block's products summed per local row, pad entries (row
    ``rows_per_shard``) dropped. The result has the dtype of vals·X."""
    vals, cols, lrows = sharded.local
    gathered = X[cols.long()]
    prod = (vals if X.dim() == 1 else vals[:, None]) * gathered
    out = torch.zeros((sharded.rows_per_shard + 1, *X.shape[1:]),
                      dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, lrows.long(), prod)[:-1]


def _csr_sharded(sharded: ShardedCSR, X, mesh: Mesh, gather: bool):
    _member(mesh)
    yblk = _local_csr(sharded, X)
    if not gather:
        return yblk[None]
    y = gather_rows(yblk, mesh.size, mesh.group)
    yb = y.reshape(sharded.n_shards, sharded.rows_per_shard, *X.shape[1:])
    return torch.cat([yb[i, :r] for i, r in enumerate(sharded.block_rows())])


def spmv_csr_sharded(sharded: ShardedCSR, x: torch.Tensor, mesh: Mesh,
                     gather: bool = True) -> torch.Tensor:
    """y = A·x with row blocks; x replicated, y in row order.

    With ``gather=True`` the rank's y block goes through an all-gather in
    rank order and each block's padded rows are dropped: every rank holds
    the whole y. With ``False`` the rank keeps its own block, shape (1,
    rows_per_shard): its row of the JAX function's sharded (n,
    rows_per_shard) result.
    """
    return _csr_sharded(sharded, x, mesh, gather)


def spmm_csr_sharded(sharded: ShardedCSR, x: torch.Tensor, mesh: Mesh,
                     gather: bool = True) -> torch.Tensor:
    """Y = A·X for a dense block X (ncols, k) with row blocks, X
    replicated; ``gather=False`` keeps the rank's (1, rows_per_shard, k)
    block. The local product is differentiable; the all-gather is not
    (``sell_dist.differentiable_spmm_sharded`` carries the gradient
    across ranks)."""
    return _csr_sharded(sharded, x, mesh, gather)


def _local_tjds(sharded: ShardedTJDS, x: torch.Tensor) -> torch.Tensor:
    """The rank's stripe summed into a full-length partial y."""
    vals, rows, offs, perm = sharded.local
    prod = vals * x[perm.long()][offs.long()]
    nrows = sharded.shape[0]
    out = torch.zeros(nrows + 1, dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, rows.long(), prod)[:nrows]


def spmv_tjds_sharded(sharded: ShardedTJDS, x: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """y = A·x with nnz stripes; the partial y all-reduced."""
    _member(mesh)
    return reduce_sum(_local_tjds(sharded, x), mesh.size, mesh.group)


# ---------------------------------------------------------------------------
# CLI helper
# ---------------------------------------------------------------------------


def shard_and_bench(alg_name, encoded, x, n_shards, *, iterations=1000,
                    kernel="auto", balance="rows", mesh=None):
    """Shard an encoded matrix over ``n_shards`` ranks and time the
    sharded SpMV; returns ``(stats, y)``, y on every rank.

    ``kernel="auto"`` (the JAX ``"pallas"``) runs the SELL kernels on
    each rank's row block (``sell_dist``, from the format's host
    triplets); ``"torch"`` (the JAX ``"xla"``) the plain-PyTorch row-block
    CSR or striped TJDS sums. Each timed call includes its collective.
    ``mesh`` defaults to ``make_mesh(n_shards)`` on x's device.
    """
    from smvp_toolkit_tpu_torch.bench.harness import time_fn

    if kernel not in ("auto", "torch"):
        raise ValueError(f"unknown kernel {kernel!r}")
    mesh = mesh or make_mesh(n_shards, device=x.device)
    _member(mesh)
    if kernel == "auto":
        from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
        from smvp_toolkit_tpu_torch.ops import spmv_sell
        from smvp_toolkit_tpu_torch.parallel.sell_dist import (
            shard_sell,
            spmv_sell_sharded,
        )

        trip = (spmv_sell._triplets_from_csr_host if alg_name == "CSR"
                else spmv_sell._triplets_from_tjds_host)(encoded)
        r, c, v, shape = trip
        coo = COOMatrix.from_numpy(r, c, v, shape=shape, device="cpu")
        # A bfloat16 matrix keeps the bf16 value mode across shards.
        vdt = (torch.bfloat16 if encoded.dtype == torch.bfloat16
               else torch.float32)
        sharded = shard_sell(coo, mesh, value_dtype=vdt)

        def fn():
            return spmv_sell_sharded(sharded, x, mesh)
    elif alg_name == "CSR":
        sharded = shard_csr(encoded, mesh, balance=balance)

        def fn():
            return spmv_csr_sharded(sharded, x, mesh)
    elif alg_name == "TJDS":
        sharded = shard_tjds(encoded, mesh)

        def fn():
            return spmv_tjds_sharded(sharded, x, mesh)
    else:
        raise ValueError(f"unknown algorithm {alg_name!r}")
    stats = time_fn(fn, device=mesh.device, iterations=iterations)
    return stats, fn()
