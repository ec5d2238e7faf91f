"""Data-parallel SELL SpMV and SpMM: row-block shards, the CUDA kernels
on each rank.

Counterpart of the JAX package's ``parallel/sell_dist.py``. Rows are cut
into ``n`` contiguous blocks of ``rows_per_shard`` rows (a multiple of
128); each block is planned on its own (chunk 1024, no small-chunk
shrink) and the plans are padded to common shapes: the widest sublane
count S, one tile window WT and slice window over all shards
(``common_window``), dead padding sublanes (rel and slice -1), and the
merged rel‖slice word built after the rewindow, where WT <= 511 and the
slice count fits. Lane indices are int8 where the chunk is a multiple of
32 (unless ``SMVP_SELL_LIDX32=1``). These host stacks equal the JAX
``ShardedSell`` arrays element for element.

Where JAX runs one ``shard_map`` over a mesh of devices, here rank k is
shard k: every rank builds the same host stacks and uploads only its
own shard, as a ``SellSpMV`` over shard k's plan (``op``). A call runs
the rank's kernel on its planes, then a collective:

* ``spmv_sell_sharded``: K1 (``sell_spmv``) on the merged word; K4
  (``sell_split``) when the word does not fit or ``SMVP_SELL_RELSL=0``;
  K6 (``sell_onehot``) under ``SMVP_SELL_COMPAT=1``; then an all-gather of
  each rank's first ``rows_per_shard`` rows in rank order, trimmed to the
  matrix's rows;
* ``bench_loop_sharded`` (K2-sharded): N SpMVs in one launch of K2
  (``sell_bench_loop``, ``sell_bench_kernel``) on the rank's merged-word
  planes, then the same all-gather; it raises without the merged word,
  as the JAX function does; its launches count on
  ``bench_loop_sharded.launches``;
* ``spmm_sell_sharded``: K1 or K4 with k columns (``sell_spmm``,
  ``sell_split_spmm``), one launch for all k; per column under COMPAT or
  ``SMVP_SELL_SPMM=0``;
* ``spmm_sell_sharded_t``: each rank multiplies its slice of the
  cotangent by its block's transpose, then an all-reduce;
* ``differentiable_spmm_sharded``: the two as a ``torch.autograd.Function``.

The JAX SpMM cuts k into column groups sized by the TPU's VMEM
(``_spmm_group``); the card's k-column kernels take any k in one launch,
so there is no group. The JAX ``tile_base`` carries a slice-window row
(``tile_base[1]``) the exact gather does not read. In bfloat16 value mode
x is rounded to bf16 before use, as on one chip. On the CPU the kernels'
plain versions run; on a CUDA tensor a wrapper launches its kernel or
raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    build_sell_plan,
    common_window,
    lidx_bytes_for_chunk,
)
from smvp_toolkit_tpu_torch.parallel.mesh import (
    Mesh,
    _member,
    gather_rows,
    reduce_sum,
)

__all__ = [
    "ShardedSell", "shard_sell", "shard_sell_transpose",
    "bench_loop_sharded",
    "spmv_sell_sharded", "spmm_sell_sharded", "spmm_sell_sharded_t",
    "differentiable_spmm_sharded",
]


def _round_up(x: int, m: int) -> int:
    return -(-max(int(x), 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSell:
    """Per-shard SELL plans stacked on a leading shard dimension (host),
    and rank ``rank``'s shard on its device (``op``).

    The stacks are the JAX ``ShardedSell``'s: ``vals`` float32 (the
    planner's values; the kernels read them in ``value_dtype``), ``lidx``
    int8 or int32, ``rel_tile`` (n, S, 1), ``slice_of`` (n, n_chunks,
    chunk), ``tile_base`` (n, 2, n_chunks) with the slice-window bases in
    row 1, ``relsl`` (n, n_chunks, chunk) or None. ``plan_nnz`` holds each
    shard's non-zeros.
    """

    vals: np.ndarray
    lidx: np.ndarray
    rel_tile: np.ndarray
    slice_of: np.ndarray
    tile_base: np.ndarray
    shape: Tuple[int, int]
    nnz: int
    chunk: int
    n_shards: int
    rows_per_shard: int
    n_coltiles: int
    window_tiles: int
    n_slices_local: int
    slice_window: int
    relsl: Optional[np.ndarray]
    value_dtype: torch.dtype
    local_shape: Tuple[int, int]
    plan_nnz: Tuple[int, ...]
    rank: int = 0
    op: Optional[S.SellSpMV] = None

    @property
    def S(self) -> int:
        return int(self.vals.shape[1])

    @property
    def WT(self) -> int:
        return self.window_tiles

    @property
    def NSl(self) -> int:
        return self.n_slices_local

    @property
    def CT(self) -> int:
        return self.n_coltiles

    def plan(self, rank: int) -> SellPlan:
        """Shard ``rank``'s plan: its rows of the stacks, the common
        window and sizes, the local shape (rows_per_shard, ncols), or
        (ncols, rows_per_shard) for a transpose sharding."""
        return SellPlan(
            vals=self.vals[rank], lane_idx=self.lidx[rank].astype(np.int32),
            rel_tile=self.rel_tile[rank], slice_of=self.slice_of[rank],
            tile_base=self.tile_base[rank, 0], shape=self.local_shape,
            nnz=self.plan_nnz[rank], n_slices=self.NSl,
            n_coltiles=self.CT, window_tiles=self.WT, chunk=self.chunk,
            slice_base=self.tile_base[rank, 1],
            slice_window=self.slice_window,
        )

    def for_rank(self, rank: int, device) -> "ShardedSell":
        """This sharding as rank ``rank`` holds it: shard ``rank``'s
        planes uploaded to ``device``."""
        return dataclasses.replace(self, rank=rank, op=S.SellSpMV(
            self.plan(rank), value_dtype=self.value_dtype, device=device))


def _row_blocks(coo: COOMatrix, n: int):
    """Rows per shard (a multiple of 128) and each shard's triplets."""
    rows_blk = _round_up(coo.shape[0], n * LANES) // n
    r, c, v = coo.to_numpy()
    parts = []
    for k in range(n):
        sel = (r >= k * rows_blk) & (r < (k + 1) * rows_blk)
        parts.append((r[sel] - k * rows_blk, c[sel], v[sel]))
    return rows_blk, parts


def _value_dtype(value_dtype) -> torch.dtype:
    return (torch.bfloat16 if value_dtype == torch.bfloat16
            else torch.float32)


def shard_sell(coo: COOMatrix, mesh: Mesh, *, chunk: int = 1024,
               value_dtype=None) -> ShardedSell:
    """Split rows into ``mesh.size`` contiguous blocks and plan each.

    ``value_dtype=torch.bfloat16`` runs the bf16 value mode on every
    rank. The rank uploads its own shard; ``for_rank`` gives another's.
    """
    rows_blk, parts = _row_blocks(coo, mesh.size)
    sh = _stack_shard_plans(
        parts, (rows_blk, coo.shape[1]), coo.shape, coo.nnz, chunk=chunk,
        value_dtype=_value_dtype(value_dtype), rows_per_shard=rows_blk)
    return sh.for_rank(max(mesh.rank, 0), mesh.device)


def shard_sell_transpose(coo: COOMatrix, mesh: Mesh, *, chunk: int = 1024,
                         value_dtype=None) -> ShardedSell:
    """Per-shard plans of (row block of A)ᵀ, the backward operator.

    Rank k owns rows ``[k·rows_blk, (k+1)·rows_blk)`` of A on the forward
    path; its block's transpose A_kᵀ is (ncols, rows_blk) and ``Aᵀ·G =
    Σ_k A_kᵀ·G_k``. ``shape`` is Aᵀ's (ncols, nrows); ``rows_per_shard``
    is the forward row split (the width of G_k).
    """
    rows_blk, parts = _row_blocks(coo, mesh.size)
    parts = [(c, r, v) for r, c, v in parts]
    nrows, ncols = coo.shape
    sh = _stack_shard_plans(
        parts, (ncols, rows_blk), (ncols, nrows), coo.nnz, chunk=chunk,
        value_dtype=_value_dtype(value_dtype), rows_per_shard=rows_blk)
    return sh.for_rank(max(mesh.rank, 0), mesh.device)


def _stack_shard_plans(parts, local_shape, global_shape, nnz, *, chunk,
                       value_dtype, rows_per_shard) -> ShardedSell:
    """Plan each shard's triplets and pad to common shapes: one planner
    pass per shard, then the common tile and slice windows
    (``common_window``), then the merged word of the rewindowed rel."""
    n = len(parts)
    plans = [build_sell_plan(pr, pc, pv, local_shape, chunk=chunk,
                             allow_small_chunk=False)
             for pr, pc, pv in parts]
    NSl = max(p.n_slices for p in plans)
    plans, WT, NSW, sub_bases = common_window(plans, NSl)
    S_ = max(p.n_sublanes for p in plans)
    CT = max(p.n_coltiles for p in plans)
    n_chunks = S_ // chunk

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, dtype=a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    vals = np.stack([pad(p.vals, (S_, LANES)) for p in plans])
    ldt = np.int8 if lidx_bytes_for_chunk(chunk) == 1 else np.int32
    lidx = np.stack([pad(p.lane_idx, (S_, LANES)) for p in plans]).astype(
        ldt)
    rel = np.stack([pad(p.rel_tile, (S_, 1), -1) for p in plans])
    slc = np.stack([pad(p.slice_of, (n_chunks, chunk), -1) for p in plans])
    tbase = np.stack([
        np.stack([pad(p.tile_base.astype(np.int32), (n_chunks,)),
                  pad(sb, (n_chunks,))])
        for p, sb in zip(plans, sub_bases)])
    relsl = None
    if WT <= S.REL_DEAD and NSl < S.SLICE_DEAD:
        relu = np.where(rel < 0, S.REL_DEAD, rel).astype(np.uint32)
        slu = np.where(slc < 0, S.SLICE_DEAD, slc).astype(np.uint32)
        relsl = (relu.reshape(n, n_chunks, chunk)
                 | (slu << S.SLICE_SHIFT)).view(np.int32)
    return ShardedSell(
        vals=vals, lidx=lidx, rel_tile=rel, slice_of=slc, tile_base=tbase,
        shape=tuple(global_shape), nnz=nnz, chunk=chunk, n_shards=n,
        rows_per_shard=rows_per_shard, n_coltiles=CT, window_tiles=WT,
        n_slices_local=NSl, slice_window=NSW, relsl=relsl,
        value_dtype=value_dtype, local_shape=tuple(local_shape),
        plan_nnz=tuple(p.nnz for p in plans),
    )


# ---------------------------------------------------------------------------
# One rank's launches (no collective)
# ---------------------------------------------------------------------------


def _relsl_route(sh: ShardedSell) -> bool:
    """The merged word: present and ``SMVP_SELL_RELSL`` not 0."""
    return sh.op.relsl is not None and S._relsl_on()


def _local_spmv(sh: ShardedSell, x: torch.Tensor) -> torch.Tensor:
    """The rank's SpMV, y float32 of all NSl·128 local rows: K6 under
    ``SMVP_SELL_COMPAT=1``, else K1 on the merged word or K4 on the split
    planes."""
    op = sh.op
    xt = op._x_tiles(x)
    if S._compat():
        return S.sell_onehot(op.vals, op.lidx, *op.split_planes(),
                             op.tile_base, xt, **op._onehot_kw())
    kw = dict(n_slices=sh.NSl, chunk=sh.chunk)
    if _relsl_route(sh):
        return S.sell_spmv(op.vals, op.lidx, op.relsl, op.tile_base, xt,
                           **kw)
    return S.sell_split(op.vals, op.lidx, *op.split_planes(), op.tile_base,
                        xt, **kw)


def _local_mat(sh: ShardedSell, X: torch.Tensor) -> torch.Tensor:
    """The rank's Y = A_k·X, float32 (NSl·128, k): one k-wide launch (K1
    or K4 with k columns), or one ``_local_spmv`` per column for k = 1,
    under COMPAT and under ``SMVP_SELL_SPMM=0``."""
    k = int(X.shape[1])
    if k == 1 or S._compat() or os.environ.get("SMVP_SELL_SPMM") == "0":
        return torch.stack([_local_spmv(sh, X[:, j]) for j in range(k)], 1)
    op = sh.op
    Xt = op._block(X, sh.CT * LANES, sh.value_dtype, "X")
    if _relsl_route(sh):
        return S.sell_spmm(op.vals, op.lidx, op.relsl, op.tile_base, Xt,
                           **op._mat_kw())
    return S.sell_split_spmm(op.vals, op.lidx, *op.split_planes(),
                             op.tile_base, Xt, **op._mat_kw())


def _local_bench(sh: ShardedSell, x: torch.Tensor,
                 iterations: int) -> torch.Tensor:
    """The rank's part of K2-sharded: N SpMVs in one ``sell_bench_loop``
    launch on the merged-word planes; y float32 of NSl·128 rows."""
    if sh.relsl is None:
        raise ValueError("bench_loop_sharded needs the relsl plane")
    op = sh.op
    y = S.sell_bench_loop(op.vals, op.lidx, op.relsl, op.tile_base,
                          op._x_tiles(x), n_slices=sh.NSl, chunk=sh.chunk,
                          iterations=iterations)
    if op.vals.device.type == "cuda":
        bench_loop_sharded.launches += 1
    return y


def _local_mat_t(sh_t: ShardedSell, G: torch.Tensor) -> torch.Tensor:
    """The rank's A_kᵀ·G_k, float32 (NSl·128, k), G_k its forward rows'
    slice of the cotangent G (nrows, k)."""
    blk = sh_t.rows_per_shard
    gk = G[sh_t.rank * blk:(sh_t.rank + 1) * blk]
    return _local_mat(sh_t, gk)


def _rows(sh: ShardedSell, y_blk: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each rank's first ``rows_per_shard`` rows, all-gathered in rank
    order (the ranks' row blocks), trimmed to the matrix's rows."""
    y = gather_rows(y_blk[: sh.rows_per_shard], mesh.size, mesh.group)
    return y[: sh.shape[0]]


# ---------------------------------------------------------------------------
# The sharded functions
# ---------------------------------------------------------------------------


def spmv_sell_sharded(sh: ShardedSell, x: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """y = A·x, each rank running its SELL kernel on its row block (the
    switches read at each call); y float32 on every rank."""
    _member(mesh)
    return _rows(sh, _local_spmv(sh, x), mesh)


def bench_loop_sharded(sh: ShardedSell, x: torch.Tensor, mesh: Mesh,
                       iterations: int) -> torch.Tensor:
    """N sequential sharded SpMVs in ONE K2 launch per rank (K2-sharded):
    y re-zeroed and the planes re-read every iteration; the final global
    y. Raises without the merged rel‖slice word."""
    _member(mesh)
    return _rows(sh, _local_bench(sh, x, iterations), mesh)


bench_loop_sharded.launches = 0
bench_loop_sharded.kernel = "sell_bench_kernel"


def spmm_sell_sharded(sh: ShardedSell, X: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """Y = A·X (k right-hand sides, X replicated): each rank reads its
    planes once for all k columns; Y float32 (nrows, k) on every rank."""
    _member(mesh)
    return _rows(sh, _local_mat(sh, X), mesh)


def spmm_sell_sharded_t(sh_t: ShardedSell, G: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """Z = Aᵀ·G from the transpose shards (``shard_sell_transpose``): G
    (nrows, k) replicated; rank k multiplies its forward rows' slice of G
    by A_kᵀ and an all-reduce sums the ranks' (ncols, k) parts. COMPAT and
    ``SMVP_SELL_SPMM=0`` run per column, as the forward does."""
    _member(mesh)
    rows_full = sh_t.n_shards * sh_t.rows_per_shard
    if G.shape[0] < rows_full:
        G = torch.nn.functional.pad(G, (0, 0, 0, rows_full - G.shape[0]))
    z = reduce_sum(_local_mat_t(sh_t, G), mesh.size, mesh.group)
    return z[: sh_t.shape[0]]


class _ShardedSpMM(torch.autograd.Function):
    """Y = A·X forward on the sharded SpMM kernels, X̄ = Aᵀ·Ȳ backward on
    the transpose shards."""

    @staticmethod
    def forward(ctx, X, sh, sh_t, mesh):
        ctx.sh_t, ctx.mesh, ctx.dtype = sh_t, mesh, X.dtype
        return spmm_sell_sharded(sh, X, mesh)

    @staticmethod
    def backward(ctx, G):
        gx = spmm_sell_sharded_t(ctx.sh_t, G, ctx.mesh).to(ctx.dtype)
        return gx, None, None, None


def differentiable_spmm_sharded(sh: ShardedSell, sh_t: ShardedSell,
                                mesh: Mesh):
    """``f(X) = A·X`` on the sharded SELL kernels, differentiable in X: the
    cotangent ``Aᵀ·G`` comes from the transpose shards and an all-reduce.
    Fits the ``spmm=`` seam of ``models.graph.gcn_train_step`` as
    ``spmm=lambda m, X: f(X)``."""

    def f(X):
        return _ShardedSpMM.apply(X, sh, sh_t, mesh)

    return f
