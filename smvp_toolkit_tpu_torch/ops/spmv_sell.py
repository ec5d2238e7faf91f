"""SELL-T1 SpMV operator over the hand-written CUDA kernels.

Counterpart of the main-path part of the JAX package's
``ops/spmv_pallas.py``
(``relsl_plane_host``, ``SellSpMV``, ``_auto_plan``, ``_cached_op``,
``spmv_csr_pallas``/``sell_op_csr``, ``spmv_tjds_pallas``,
``spmv_coo_pallas``/``sell_op_coo``, ``spmv_cisr_pallas``). The operator
picks one of four routes from its plan, as the JAX operator's
``_apply_tiles`` and ``bench_loop`` do; each route has a forward wrapper
(one y = A·x) and a bench wrapper (N SpMVs in one launch):

* ``relsl``: K1 ``sell_spmv``, K2 ``sell_bench_loop``;
* ``streamy_relsl``: K3 ``sell_streamy_relsl``, ``sell_bench_streamy_relsl``;
* ``streamy``: K3 ``sell_streamy``, ``sell_bench_streamy``;
* ``split``: K4 ``sell_split``, ``sell_bench_split``.

``relsl`` and ``streamy_relsl`` read one merged rel‖slice word per
sublane, taken where ``window_tiles <= 511`` and ``n_slices < 2^23 - 1``;
``streamy`` and ``split`` read the split ``rel_tile`` and ``slice_of``
planes. The two ``streamy`` routes run plans from
``build_streamed_sell_plan`` (y in blocks, block-local slice ids,
``y_block_id`` per chunk). The forward kernels are built from
``csrc/sell_spmv.cu``, the bench kernels from ``csrc/sell_bench.cu``.

The k-column kernels (``csrc/sell_spmm.cu``, ``csrc/sell_vals_grad.cu``)
serve the SpMM and training path on resident-y plans:

* ``sell_spmm`` (K1 with k > 1, merged word) and ``sell_split_spmm`` (K4
  with k > 1, split planes): Y = A·X in one launch for all k columns, on
  the warp-per-sublane k-column body (``sell_common.cuh::sublane_mat_run``:
  a run of one slice's sublanes summed per row before one vector atomic,
  the columns of a row over the threads of ``spmm_shape(k)``);
* ``sell_bench_spmm`` (K2 with k > 1, merged word): N sweeps of that body
  in one cooperative launch (``sublane_mat_bench_sweeps``: the work items
  and column blocks in a grid-stride loop, ``MAT_BENCH_Y_BUFFERS`` Y
  buffers);
* ``sell_vals_grad`` (K7): the cotangent of the values plane, on either
  kind of planes, scheduled by slice (``vals_grad_schedule``: the live
  sublanes grouped by slice, so that a block reads its slice's G block
  once).

The JAX operator lays k columns side by side in 128-lane groups
(``pack_columns``/``unpack_columns``) and cuts k into launch groups of 8
(``spmm_launch_group``); both exist for the TPU's lanes and VMEM. Here X,
Y and G are plain row-major (rows, k) tensors, any k runs in one launch,
and there is no column layout or group. Streamed-y plans run SpMM column
by column on their K3 kernel, as the JAX operator falls back to a vmap
over columns there; they have no values gradient, as in the JAX package.

In bfloat16 value mode, ``SMVP_SELL_PACK=1`` (read at each call, where
the JAX operator reads it) takes the packed route of ``csrc/sell_packed.cu``
on plans whose window fits the 9-bit rel field (``window_tiles <= 511``),
for the operator's own values plane only: one int32 word per slot holds
the bf16 value, rel and lane (``packed_plane_host``), beside the
per-sublane ``slice_of`` plane:

* ``sell_packed`` (K5, k = 1, resident or streamed y), ``sell_packed_spmm``
  (K5 with k > 1, resident y) and ``sell_bench_packed`` (K2-packed, N K5
  sweeps in one cooperative launch, resident y; a streamed plan's
  ``bench_loop`` raises under the switch, as the JAX one does).

K5 runs K1's warp-per-sublane body and K2-packed K2's (two y buffers,
``PACKED_BENCH_Y_BUFFERS``); both read a sublane's rel from its lane-0
word, as the JAX ``_unpack_plane`` and ``sell_packed_plain`` do, and
refuse a packed plane or y not aligned to 16 bytes and planes of no
sublane. K5 with k columns runs the k-column body of K1 with k columns,
rel from the lane-0 word too, and refuses a packed plane not aligned to 16
bytes and, where k % 4 == 0, an X not aligned to four elements.

Two kernels serve the JAX operator's opt-in switches:

* ``sell_onehot`` (K6, ``csrc/sell_onehot.cu``): y = A·x on the plan's
  own planes (the split ``rel`` plane), each row summed over its slice's
  live sublanes in plan order (``device_slice_index``), under
  ``SMVP_SELL_COMPAT=1``; the JAX kernel's dense one-hot operands are
  built only by its plain version (``onehot_dense``);
* ``sell_bench_subwin`` (K2-subwin, ``csrc/sell_bench.cu``): K2 with
  per-sub-chain x and y windows (``_sub_windows``), under
  ``SMVP_SELL_SUBWIN=1``.

``CoClusteredSellSpMV`` runs the same kernels in co-clustered coordinates
(``ops/cocluster.py``); its ``bench_loop`` is K2 on the permuted planes
(K2-cocluster).

A plan that the SELL format fills poorly leaves the planes for one more
route, ``csr``, in ``SellSpMV.__call__``: K12, the merge-path CSR SpMV of
``ops/csr_merge.py`` on the operator's triplets, where the card's cost
model prices it at most half the plan's (``autotune.takes_csr``).

Each wrapper launches its kernel for a CUDA tensor, or raises; only a
tensor that lies on the CPU goes to the plain PyTorch version beside it
(``<wrapper>_plain``). Each wrapper counts its launches in a plain integer
attribute, ``launches``, which the smoke test reads to show that the main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import time
import weakref
from typing import Optional

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_array, host_tensor
from smvp_toolkit_tpu_torch.ops import _build, spmv_autograd
from smvp_toolkit_tpu_torch.ops.autotune import (
    chain_split,
    takes_csr,
    tuned_plan,
)
from smvp_toolkit_tpu_torch.ops.csr_merge import (
    csr_fits,
    csr_merge_spmv,
    csr_planes,
)
from smvp_toolkit_tpu_torch.ops.plan_checks import (
    PACK_REL_SHIFT,
    REL_DEAD,
    SLICE_DEAD,
    SLICE_SHIFT,
    VALUE_DTYPES,
    check_block,
    check_packed_plan,
    check_packed_planes,
    check_plan,
    check_planes,
)
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    build_sell_plan,
    build_streamed_sell_plan,
    lidx_bytes_for_chunk,
)
from smvp_toolkit_tpu_torch.utils import tracing
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = [
    "SellSpMV",
    "ROUTES",
    "plan_route",
    "relsl_plane_host",
    "lidx_dtype",
    "sell_spmv",
    "sell_spmv_plain",
    "sell_streamy_relsl",
    "sell_streamy_relsl_plain",
    "sell_streamy",
    "sell_streamy_plain",
    "sell_split",
    "sell_split_plain",
    "sell_bench_loop",
    "sell_bench_loop_plain",
    "sell_bench_streamy_relsl",
    "sell_bench_streamy_relsl_plain",
    "sell_bench_streamy",
    "sell_bench_streamy_plain",
    "sell_bench_split",
    "sell_bench_split_plain",
    "BENCH_Y_BUFFERS",
    "bench_buffer",
    "sell_spmm",
    "sell_spmm_plain",
    "sell_split_spmm",
    "sell_split_spmm_plain",
    "sell_bench_spmm",
    "sell_bench_spmm_plain",
    "MAT_BENCH_Y_BUFFERS",
    "spmm_shape",
    "sell_vals_grad",
    "sell_vals_grad_plain",
    "VG_RUN",
    "VG_CAP",
    "VgSchedule",
    "vals_grad_schedule",
    "packed_plane_host",
    "sell_packed",
    "sell_packed_plain",
    "sell_packed_spmm",
    "sell_packed_spmm_plain",
    "sell_bench_packed",
    "sell_bench_packed_plain",
    "PACKED_KERNELS",
    "PACKED_ROUTES",
    "bench_packed_blocks",
    "MAT_KERNELS",
    "bench_blocks",
    "bench_spmm_blocks",
    "spmv_csr_sell",
    "sell_op_csr",
    "spmv_tjds_sell",
    "sell_op_tjds",
    "spmv_coo_sell",
    "sell_op_coo",
    "spmv_cisr_sell",
    "sell_op_cisr",
    "sell_onehot",
    "sell_onehot_plain",
    "onehot_xw",
    "onehot_dense",
    "device_slice_index",
    "slice_index",
    "sell_bench_subwin",
    "sell_bench_subwin_plain",
    "SUBWIN_Y_BUFFERS",
    "PACKED_BENCH_Y_BUFFERS",
    "SWITCH_KERNELS",
    "CoClusteredSellSpMV",
    "sell_op_coo_coclustered",
]

# Above this many bytes of y the JAX operator leaves its resident-y plan
# (``_RESIDENT_Y_LIMIT`` there, a TPU VMEM limit) for a streamed-y plan
# with y blocks of ``_STREAM_Y_BLOCK_ROWS`` rows. The card has no VMEM, but
# the port keeps the same cut so that both packages run the same plan and
# compare plan by plan.
_RESIDENT_Y_LIMIT = 8 * 2**20
_STREAM_Y_BLOCK_ROWS = 512 * LANES

# The byte alignment of a plane that the warp-per-sublane kernels read with
# vector loads (``sell_common.cuh::sublane_aligned``: four f32 values).
_VEC_ALIGN = 16

# Route names and their ids in csrc/sell_common.cuh (sell::Route).
ROUTES = ("relsl", "streamy_relsl", "streamy", "split")
_ROUTE_IDS = {name: i for i, name in enumerate(ROUTES)}


def plan_route(plan: SellPlan) -> str:
    """The route a plan runs on: merged word or split planes, resident or
    streamed y (the JAX operator's gates, ``spmv_pallas.py:2382-2389``)."""
    if plan.y_block_slices:
        return "streamy_relsl" if plan.merged_word else "streamy"
    return "relsl" if plan.merged_word else "split"


def relsl_plane_host(plan: SellPlan) -> np.ndarray:
    """Merged rel‖slice word per sublane, (n_chunks, chunk) int32.

    rel sits in bits 0..8 (511 = dead), the slice id in bits 9..31
    (all ones = dead). The same packing rule as the JAX package.
    """
    rel = np.where(
        plan.rel_tile < 0, REL_DEAD, plan.rel_tile
    ).astype(np.uint32).reshape(plan.n_chunks, plan.chunk)
    sl = np.where(
        plan.slice_of < 0, SLICE_DEAD, plan.slice_of
    ).astype(np.uint32)
    return (rel | (sl << SLICE_SHIFT)).view(np.int32)


def lidx_dtype(chunk: int) -> torch.dtype:
    """int8 lane indices when ``chunk % 32 == 0``, else int32."""
    return torch.int8 if lidx_bytes_for_chunk(chunk) == 1 else torch.int32


def packed_plane_host(plan: SellPlan) -> np.ndarray:
    """The packed val‖rel‖lane word per slot, (S, 128) int32: the bf16
    rounding of the value in bits 16..31, the sublane's rel in bits 7..15
    (511 = dead), the lane index in bits 0..6. The JAX operator's
    ``SellSpMV._packed()`` bit for bit (bf16 rounds to nearest even in
    both)."""
    check_packed_plan(plan)
    bits = torch.from_numpy(np.ascontiguousarray(plan.vals, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16).astype(
        np.uint32) << 16
    rel = np.where(plan.rel_tile < 0, REL_DEAD, plan.rel_tile).astype(
        np.uint32).reshape(-1, 1)
    lane = plan.lane_idx.astype(np.uint32)
    return (bits | (rel << PACK_REL_SHIFT) | lane).view(np.int32)


def _sub_windows(plan: SellPlan, split: int):
    """Per-sub-chain tile and slice windows of the split chain (host,
    O(S)); the JAX package's ``_sub_windows`` bit for bit.

    Each chunk's ``split`` sub-chains of ``chunk / split`` sublanes span
    only about 1/split of the chunk's tiles and slices (tile-major sort),
    so each gets its own window: ``stb[c, h]`` tiles from its first tile
    rounded down to 16, ``ssb[c, h]`` slices likewise, of common widths
    ``sub_wt`` and ``sub_nsw`` (multiples of 16, clamped to the plan).

    Returns ``(stb, ssb, sub_wt, sub_nsw)``, int32 (n_chunks, split)
    window bases and the two widths, or None when the plan is
    ineligible: no non-zeros, a streamed y, a live sublane outside its
    chunk's window, or a base shift that would pull the dead rel marker
    (511) into a window.
    """
    if plan.nnz == 0 or plan.y_block_slices:
        return None
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    if ((rel < 0) & (plan.slice_of.reshape(-1) >= 0)).any():
        return None  # live out-of-window sublanes: rebuild the plan
    nch, chunk = plan.n_chunks, plan.chunk
    per = chunk // split
    tb = np.repeat(plan.tile_base.astype(np.int64), chunk)
    live = plan.slice_of.reshape(-1) >= 0
    ut = np.where(live, rel + tb, -1).reshape(nch, split, per)
    sl = np.where(
        live, plan.slice_of.reshape(-1).astype(np.int64), -1
    ).reshape(nch, split, per)
    big = 1 << 40
    t_lo = np.where(ut >= 0, ut, big).min(axis=2)
    t_hi = np.where(ut >= 0, ut, -1).max(axis=2)
    t_lo = np.where(t_hi < 0, 0, np.minimum(t_lo, big - 1))
    t_hi = np.maximum(t_hi, 0)
    t_lo16 = (t_lo // 16) * 16
    sub_wt = int(max(int((t_hi - t_lo16).max()) + 1, 8))
    sub_wt = min(-(-sub_wt // 16) * 16, plan.n_coltiles)
    stb = np.minimum(t_lo16, max(plan.n_coltiles - sub_wt, 0))
    s_lo = np.where(sl >= 0, sl, big).min(axis=2)
    s_hi = np.where(sl >= 0, sl, -1).max(axis=2)
    s_lo = np.where(s_hi < 0, 0, np.minimum(s_lo, big - 1))
    s_hi = np.maximum(s_hi, 0)
    s_lo16 = (s_lo // 16) * 16
    sub_nsw = int(max(int((s_hi - s_lo16).max()) + 1, 8))
    sub_nsw = min(-(-sub_nsw // 16) * 16, plan.n_slices)
    ssb = np.minimum(s_lo16, max(plan.n_slices - sub_nsw, 0))
    # Dead-marker guard: rel_adj(dead) = 511 - (stb - tile_base) must stay
    # outside [0, sub_wt).
    shift = (stb - plan.tile_base.astype(np.int64)[:, None]).max()
    if shift > REL_DEAD - sub_wt or shift < 0:
        return None
    return (stb.astype(np.int32), ssb.astype(np.int32), sub_wt, sub_nsw)


def subwin_split(chunk: int) -> int:
    """The chain split K2-subwin runs with: ``chain_split(chunk)``
    (``SMVP_SELL_SPLIT_CHAIN`` or the split policy), or 1 where the JAX
    chain falls back to one chain (a split below 2, a chunk that is not a
    multiple of ``split·128``, or sub-chains not a multiple of 8
    sublanes; ``_relsl_chain_store``, spmv_pallas.py:298-300)."""
    split = chain_split(chunk)
    if split < 2 or chunk % (split * LANES) or (chunk // split) % 8:
        return 1
    return split


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------


def _sweep_plain(vals, lidx, rel, sl, tile_base, ybase, x, *, n_slices: int,
                 chunk: int) -> torch.Tensor:
    """The kernels' function: direct gather, ``index_add_`` reduce.

    ``rel`` and ``sl`` are int64 per sublane with dead sublanes negative;
    ``ybase`` is the first y slice of each chunk's block (int64 per chunk)
    or None for a resident y. Returns y as float32 of length
    ``n_slices * 128``. Values and x are read in their storage dtype and
    multiplied in float32.
    """
    live = ((rel >= 0) & (sl >= 0)).nonzero().squeeze(1)
    c = live // chunk
    tile = tile_base.long()[c] + rel[live]
    col = (tile * LANES)[:, None] + lidx[live].long()
    prod = vals[live].float() * x.reshape(-1)[col].float()
    slice_ = sl[live] if ybase is None else ybase[c] + sl[live]
    row = (slice_ * LANES)[:, None] + torch.arange(LANES, device=x.device)
    y = torch.zeros(n_slices * LANES, dtype=torch.float32, device=x.device)
    return y.index_add_(0, row.reshape(-1), prod.reshape(-1))


def _decode_word(relsl):
    """(rel, slice) int64 per sublane from the merged word, -1 if dead."""
    word = relsl.reshape(-1).long() & 0xFFFFFFFF
    rel = word & REL_DEAD
    sl = word >> SLICE_SHIFT
    dead = (rel == REL_DEAD) | (sl == SLICE_DEAD)
    return rel.masked_fill(dead, -1), sl.masked_fill(dead, -1)


def _block_base(y_block_id, nsb: int):
    return y_block_id.long() * nsb


def sell_spmv_plain(vals, lidx, relsl, tile_base, x, *, n_slices: int,
                    chunk: int) -> torch.Tensor:
    """K1's function in plain PyTorch (merged word, resident y)."""
    rel, sl = _decode_word(relsl)
    return _sweep_plain(vals, lidx, rel, sl, tile_base, None, x,
                        n_slices=n_slices, chunk=chunk)


def sell_streamy_relsl_plain(vals, lidx, relsl, tile_base, y_block_id, x, *,
                             n_slices: int, chunk: int,
                             nsb: int) -> torch.Tensor:
    """K3-relsl's function in plain PyTorch (merged word, streamed y)."""
    rel, sl = _decode_word(relsl)
    return _sweep_plain(vals, lidx, rel, sl, tile_base,
                        _block_base(y_block_id, nsb), x,
                        n_slices=n_slices, chunk=chunk)


def sell_streamy_plain(vals, lidx, rel, slice_of, tile_base, y_block_id, x,
                       *, n_slices: int, chunk: int,
                       nsb: int) -> torch.Tensor:
    """K3-split's function in plain PyTorch (split planes, streamed y)."""
    return _sweep_plain(vals, lidx, rel.reshape(-1).long(),
                        slice_of.reshape(-1).long(), tile_base,
                        _block_base(y_block_id, nsb), x,
                        n_slices=n_slices, chunk=chunk)


def sell_split_plain(vals, lidx, rel, slice_of, tile_base, x, *,
                     n_slices: int, chunk: int) -> torch.Tensor:
    """K4's function in plain PyTorch (split planes, resident y)."""
    return _sweep_plain(vals, lidx, rel.reshape(-1).long(),
                        slice_of.reshape(-1).long(), tile_base, None, x,
                        n_slices=n_slices, chunk=chunk)


def _repeat(plain, iterations, *args, **kw):
    """``iterations`` fresh SpMVs of ``plain``; the last y."""
    y = None
    for _ in range(iterations):
        y = plain(*args, **kw)
    return y


def sell_bench_loop_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """K2's function in plain PyTorch: ``iterations`` fresh K1 SpMVs."""
    return _repeat(sell_spmv_plain, iterations, *args, **kw)


def sell_bench_streamy_relsl_plain(*args, iterations: int,
                                   **kw) -> torch.Tensor:
    """The streamed K2's function: ``iterations`` fresh K3-relsl SpMVs."""
    return _repeat(sell_streamy_relsl_plain, iterations, *args, **kw)


def sell_bench_streamy_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """The streamed split K2's function: ``iterations`` K3-split SpMVs."""
    return _repeat(sell_streamy_plain, iterations, *args, **kw)


def sell_bench_split_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """The split K2's function: ``iterations`` fresh K4 SpMVs."""
    return _repeat(sell_split_plain, iterations, *args, **kw)


# At most this many products exist at once in a k-column plain version:
# it works through the columns in groups, so a check at full width never
# materialises live slots × k products (at the GCN's k = 256 on
# ogbn-arxiv that would be several GB).
_PLAIN_ELEMS = 1 << 26


def _live_slots(lidx, rel, sl, tile_base, *, chunk: int, vals=None):
    """Flat slot index, X row and Y row (int64) of every slot in a live
    sublane; with ``vals``, only of the slots whose value is nonzero."""
    mask = ((rel >= 0) & (sl >= 0))[:, None].expand(-1, LANES)
    if vals is not None:
        mask = mask & (vals != 0)
    slot = mask.reshape(-1).nonzero().squeeze(1)
    s = slot // LANES
    col = ((tile_base.long()[s // chunk] + rel[s]) * LANES
           + lidx.reshape(-1)[slot].long())
    return slot, col, sl[s] * LANES + slot % LANES


def _spmm_plain(vals, lidx, rel, sl, tile_base, X, *, n_slices: int,
                chunk: int) -> torch.Tensor:
    """The k-column kernels' function: Y[row, :] += v·X[col, :] for every
    slot of a live sublane whose value v is nonzero; Y float32 of
    (n_slices·128, k). Gathered and ``index_add_``-ed in column groups."""
    slot, col, row = _live_slots(lidx, rel, sl, tile_base, chunk=chunk,
                                 vals=vals)
    v = vals.reshape(-1)[slot].float()[:, None]
    k = X.shape[1]
    Y = torch.zeros(n_slices * LANES, k, dtype=torch.float32,
                    device=X.device)
    group = max(1, _PLAIN_ELEMS // max(len(slot), 1))
    for j in range(0, k, group):
        Y[:, j:j + group].index_add_(0, row, v * X[col, j:j + group].float())
    return Y


def sell_spmm_plain(vals, lidx, relsl, tile_base, X, *, n_slices: int,
                    n_coltiles: int, chunk: int) -> torch.Tensor:
    """K1-with-k's function in plain PyTorch (merged word)."""
    rel, sl = _decode_word(relsl)
    return _spmm_plain(vals, lidx, rel, sl, tile_base, X,
                       n_slices=n_slices, chunk=chunk)


def sell_split_spmm_plain(vals, lidx, rel, slice_of, tile_base, X, *,
                          n_slices: int, n_coltiles: int,
                          chunk: int) -> torch.Tensor:
    """K4-with-k's function in plain PyTorch (split planes)."""
    return _spmm_plain(vals, lidx, rel.reshape(-1).long(),
                       slice_of.reshape(-1).long(), tile_base, X,
                       n_slices=n_slices, chunk=chunk)


def sell_bench_spmm_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """K2-with-k's function: ``iterations`` fresh K1 SpMMs, the last Y."""
    return _repeat(sell_spmm_plain, iterations, *args, **kw)


def sell_vals_grad_plain(lidx, tile_base, X, G, *, n_slices: int,
                         n_coltiles: int, chunk: int, relsl=None, rel=None,
                         slice_of=None) -> torch.Tensor:
    """K7's function in plain PyTorch: ``out[s, l] = Σ_j G[row, j]·X[col,
    j]`` with j ascending, on every slot of a live sublane (padding lanes
    included); 0 on dead sublanes. Returns the (S, 128) float32 plane."""
    if relsl is not None:
        rel, sl = _decode_word(relsl)
    else:
        rel, sl = rel.reshape(-1).long(), slice_of.reshape(-1).long()
    slot, col, row = _live_slots(lidx, rel, sl, tile_base, chunk=chunk)
    acc = torch.zeros(len(slot), dtype=torch.float32, device=X.device)
    for j in range(X.shape[1]):
        acc = acc + G[row, j] * X[col, j].float()
    out = torch.zeros(lidx.numel(), dtype=torch.float32, device=X.device)
    out[slot] = acc
    return out.reshape(lidx.shape)


def _unpack_word(packed):
    """(vals float32 (S, 128), lane indices, rel int64 per sublane with -1
    for dead) from the packed word plane; rel is read from lane 0, as the
    JAX ``_unpack_plane`` reads it."""
    w = packed.reshape(-1, LANES)
    vals = (w & -65536).view(torch.float32)
    lidx = w & 127
    rel = (w[:, 0].long() & 0xFFFFFFFF) >> PACK_REL_SHIFT & REL_DEAD
    return vals, lidx, rel.masked_fill(rel == REL_DEAD, -1)


def sell_packed_plain(packed, slice_of, tile_base, x, *, n_slices: int,
                      chunk: int, y_block_id=None,
                      nsb: int = 0) -> torch.Tensor:
    """K5's function in plain PyTorch: the word unpacked, then K1's sweep
    (resident y, or streamed with ``y_block_id`` and ``nsb``)."""
    vals, lidx, rel = _unpack_word(packed)
    ybase = None if y_block_id is None else _block_base(y_block_id, nsb)
    return _sweep_plain(vals, lidx, rel, slice_of.reshape(-1).long(),
                        tile_base, ybase, x, n_slices=n_slices, chunk=chunk)


def sell_packed_spmm_plain(packed, slice_of, tile_base, X, *, n_slices: int,
                           n_coltiles: int, chunk: int) -> torch.Tensor:
    """K5-with-k's function in plain PyTorch (resident y)."""
    vals, lidx, rel = _unpack_word(packed)
    return _spmm_plain(vals, lidx, rel, slice_of.reshape(-1).long(),
                       tile_base, X, n_slices=n_slices, chunk=chunk)


def sell_bench_packed_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """K2-packed's function: ``iterations`` fresh K5 SpMVs, the last y."""
    return _repeat(sell_packed_plain, iterations, *args, **kw)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_PLANE_ARGS = [ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP]
_SPMV_SIGNATURES = {
    "sell_spmv_launch": (ctypes.c_int, _PLANE_ARGS + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_BENCH_SIGNATURES = {
    "sell_bench_launch": (ctypes.c_int, _PLANE_ARGS + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_bench_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]),
    "sell_bench_subwin_launch": (ctypes.c_int, [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

_SPMM_SIGNATURES = {
    "sell_spmm_launch": (ctypes.c_int, [
        ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_bench_spmm_launch": (ctypes.c_int, [
        _VP, _VP, _VP, _VP, _VP, _VP,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_bench_spmm_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_VALS_GRAD_SIGNATURES = {
    "sell_vals_grad_launch": (ctypes.c_int, [
        ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# Kernel names per (route, bench), as csrc/ names them.
KERNEL_NAMES = {
    ("relsl", False): "sell_spmv_kernel",
    ("streamy_relsl", False): "sell_streamy_relsl_kernel",
    ("streamy", False): "sell_streamy_kernel",
    ("split", False): "sell_split_kernel",
    ("relsl", True): "sell_bench_kernel",
    ("streamy_relsl", True): "sell_bench_streamy_relsl_kernel",
    ("streamy", True): "sell_bench_streamy_kernel",
    ("split", True): "sell_bench_split_kernel",
}


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sell_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _kinds(vals: torch.Tensor, lidx: torch.Tensor):
    return (int(vals.dtype == torch.bfloat16), int(lidx.dtype == torch.int32))


def _launch_device(vals: torch.Tensor) -> torch.device:
    if vals.device.type != "cuda":
        raise ValueError(
            f"the SELL kernels run on cuda tensors (got {vals.device}); "
            "only CPU tensors take the plain version"
        )
    return vals.device


# y buffers of each route's N-iteration kernel (csrc/sell_bench.cu,
# ``bench_y_buffers``): K2 takes two in turn, one grid barrier an
# iteration; the others zero one y between two barriers.
BENCH_Y_BUFFERS = {"relsl": 2, "streamy_relsl": 1, "streamy": 1, "split": 1}


def bench_buffer(route: str, iterations: int) -> int:
    """Which y buffer an N-iteration launch of ``route`` leaves its result
    in: iteration ``it`` sweeps into buffer ``it % BENCH_Y_BUFFERS[route]``
    (``sell_common.cuh``, ``sublane_bench_sweeps``)."""
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    return (iterations - 1) % BENCH_Y_BUFFERS[route]


def _launch(route: str, *, vals, lidx, tile_base, x, n_slices: int,
            chunk: int, relsl=None, rel=None, slice_of=None,
            y_block_id=None, nsb: int = 0,
            iterations: Optional[int] = None) -> torch.Tensor:
    """One launch of the route's forward kernel (``iterations`` None) or
    its bench kernel; returns y (float32, ``n_slices * 128``). The bench
    kernel gets ``BENCH_Y_BUFFERS[route]`` y buffers, and y is a view of
    the one its last iteration wrote (``bench_buffer``)."""
    dev = _launch_device(vals)
    vk, lk = _kinds(vals, lidx)
    n_out = n_slices * LANES
    stream = torch.cuda.current_stream(dev).cuda_stream
    planes = [None if t is None else t.data_ptr() for t in (
        vals, lidx, relsl if relsl is not None else rel, slice_of,
        tile_base, y_block_id)]
    bench = iterations is not None
    name = KERNEL_NAMES[(route, bench)]
    if bench:
        lib = _build.load("sell_bench", _BENCH_SIGNATURES)
        ys = torch.empty(BENCH_Y_BUFFERS[route], n_out, dtype=torch.float32,
                         device=dev)
        rc = lib.sell_bench_launch(
            _ROUTE_IDS[route], *planes, x.data_ptr(), ys.data_ptr(),
            vals.numel(), n_out, chunk, nsb, iterations, vk, lk, dev.index,
            stream)
        _check_rc(lib, rc, f"{name} cooperative launch")
        y = ys[bench_buffer(route, iterations)]
    else:
        lib = _build.load("sell_spmv", _SPMV_SIGNATURES)
        y = torch.zeros(n_out, dtype=torch.float32, device=dev)
        rc = lib.sell_spmv_launch(
            _ROUTE_IDS[route], *planes, x.data_ptr(), y.data_ptr(),
            vals.numel(), chunk, nsb, vk, lk, dev.index, stream)
        _check_rc(lib, rc, f"{name} launch")
    return y


def _dispatch(wrapper, plain, route: str, planes: dict, x, *, n_slices: int,
              chunk: int, **kw) -> torch.Tensor:
    """Check the planes, then run ``plain`` on CPU tensors or launch the
    route's kernel (counted on ``wrapper``) on CUDA ones; ``kw`` carries
    ``nsb`` on streamed routes and ``iterations`` on bench kernels."""
    if kw.get("iterations", 1) < 1:
        raise ValueError("iterations must be >= 1")
    check_planes(**planes, x=x, chunk=chunk)
    if planes["vals"].device.type == "cpu":
        return plain(*planes.values(), x, n_slices=n_slices, chunk=chunk,
                     **kw)
    y = _launch(route, **planes, x=x, n_slices=n_slices, chunk=chunk, **kw)
    wrapper.launches += 1
    return y


def sell_spmv(vals, lidx, relsl, tile_base, x, *, n_slices: int,
              chunk: int) -> torch.Tensor:
    """K1: y = A·x over the SELL planes, y float32 of ``n_slices * 128``.

    Its kernel runs one warp per sublane with vector loads of four lanes
    (``sell_common.cuh::sublane_run``, staging the merged word): a values
    or lane-index plane not aligned to four elements (a view at an odd
    offset) raises, and so do planes of no sublane. Views over whole
    chunks (``SellSpMV._launch_range``) stay aligned."""
    return _dispatch(sell_spmv, sell_spmv_plain, "relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk)


def sell_streamy_relsl(vals, lidx, relsl, tile_base, y_block_id, x, *,
                       n_slices: int, chunk: int, nsb: int) -> torch.Tensor:
    """K3-relsl: y = A·x, merged word, y in blocks of ``nsb`` slices.

    Its kernel is K1's body under the streamed y policy, with K1's
    alignment rule."""
    return _dispatch(sell_streamy_relsl, sell_streamy_relsl_plain,
                     "streamy_relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb)


def sell_streamy(vals, lidx, rel, slice_of, tile_base, y_block_id, x, *,
                 n_slices: int, chunk: int, nsb: int) -> torch.Tensor:
    """K3-split: y = A·x, split planes, y in blocks of ``nsb`` slices.

    Its kernel runs one warp per sublane with vector loads of four lanes
    (``sell_common.cuh::sublane_run``): a values or lane-index plane not
    aligned to four elements (a view at an odd offset) raises."""
    return _dispatch(sell_streamy, sell_streamy_plain, "streamy",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb)


def sell_split(vals, lidx, rel, slice_of, tile_base, x, *, n_slices: int,
               chunk: int) -> torch.Tensor:
    """K4: y = A·x, split planes, resident y.

    Its kernel runs one warp per sublane with vector loads of four lanes
    (``sell_common.cuh::sublane_run``), as K3-split's: a values or
    lane-index plane not aligned to four elements (a view at an odd
    offset) raises, and so do planes of no sublane. Views over whole
    chunks (``SellSpMV._launch_range``) stay aligned."""
    return _dispatch(sell_split, sell_split_plain, "split",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk)


def sell_bench_loop(vals, lidx, relsl, tile_base, x, *, n_slices: int,
                    chunk: int, iterations: int) -> torch.Tensor:
    """K2: ``iterations`` K1 SpMVs in one cooperative launch; the last y.

    Its kernel runs K1's body (one warp per sublane, the merged word) in
    every iteration, with K1's alignment rule: a values or lane-index
    plane not aligned to four elements raises, and so do planes of no
    sublane."""
    return _dispatch(sell_bench_loop, sell_bench_loop_plain, "relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk,
                     iterations=iterations)


def sell_bench_streamy_relsl(vals, lidx, relsl, tile_base, y_block_id, x, *,
                             n_slices: int, chunk: int, nsb: int,
                             iterations: int) -> torch.Tensor:
    """K2 on the streamed merged-word route: ``iterations`` K3-relsl SpMVs
    in one cooperative launch, in K3-relsl's body and alignment rule (planes
    of no sublane raise too); the last y."""
    return _dispatch(sell_bench_streamy_relsl, sell_bench_streamy_relsl_plain,
                     "streamy_relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb,
                     iterations=iterations)


def sell_bench_streamy(vals, lidx, rel, slice_of, tile_base, y_block_id, x,
                       *, n_slices: int, chunk: int, nsb: int,
                       iterations: int) -> torch.Tensor:
    """K2 on the streamed split route: ``iterations`` K3-split SpMVs in one
    cooperative launch, in K3-split's body and alignment rule; the last
    y."""
    return _dispatch(sell_bench_streamy, sell_bench_streamy_plain, "streamy",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb,
                     iterations=iterations)


def sell_bench_split(vals, lidx, rel, slice_of, tile_base, x, *,
                     n_slices: int, chunk: int,
                     iterations: int) -> torch.Tensor:
    """K2 on the split route: ``iterations`` K4 SpMVs in one cooperative
    launch, in K4's body and alignment rule (planes of no sublane raise
    too); the last y."""
    return _dispatch(sell_bench_split, sell_bench_split_plain, "split",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk,
                     iterations=iterations)


for _fn in (sell_spmv, sell_streamy_relsl, sell_streamy, sell_split,
            sell_bench_loop, sell_bench_streamy_relsl, sell_bench_streamy,
            sell_bench_split):
    _fn.launches = 0

# The forward and bench wrapper and their plain versions, per route.
_ROUTE_FNS = {
    "relsl": (sell_spmv, sell_bench_loop),
    "streamy_relsl": (sell_streamy_relsl, sell_bench_streamy_relsl),
    "streamy": (sell_streamy, sell_bench_streamy),
    "split": (sell_split, sell_bench_split),
}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def spmm_shape(k: int):
    """The column shape ``(T, W, P)`` that K1, K4 and K5 with k columns
    launch (``csrc/sell_common.cuh::with_mat_shape``): T threads a row of Y, W
    columns a load (4: a float4 of f32 or four bf16, where k % 4 == 0; else
    1), P loads a thread; a launch has ``ceil(k / (T·W·P))`` column
    blocks. The vector form (W = 4) needs X aligned to four elements and Y
    to 16 bytes."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k % 4 == 0:
        n4 = k // 4
        for bound, shape in ((1, (1, 4, 1)), (2, (1, 4, 2)), (4, (1, 4, 4)),
                             (8, (2, 4, 4)), (16, (4, 4, 4))):
            if n4 <= bound:
                return shape
        return 8, 4, 4
    for t in (1, 2, 4, 8, 16):
        if k <= 4 * t:
            return t, 1, 4
    return 32, 1, 4


def _spmm_dispatch(wrapper, plain, route: str, planes: dict, X, *,
                   n_slices: int, n_coltiles: int, chunk: int,
                   iterations: Optional[int] = None) -> torch.Tensor:
    """Check the planes and X, then run ``plain`` on CPU tensors or launch
    the route's k-column kernel (the bench kernel when ``iterations`` is
    given), counted on ``wrapper``, on CUDA ones."""
    if iterations is not None and iterations < 1:
        raise ValueError("iterations must be >= 1")
    vals = planes["vals"]
    check_planes(**planes, chunk=chunk)
    k = check_block("X", X, rows=n_coltiles * LANES, dtypes=(vals.dtype,),
                    device=vals.device)
    kw = dict(n_slices=n_slices, n_coltiles=n_coltiles, chunk=chunk)
    if vals.device.type == "cpu":
        if iterations is not None:
            kw["iterations"] = iterations
        return plain(*planes.values(), X, **kw)
    dev = _launch_device(vals)
    vk, lk = _kinds(vals, planes["lidx"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("sell_spmm", _SPMM_SIGNATURES)
    n_slots = vals.numel()
    meta = planes.get("relsl", planes.get("rel"))
    if iterations is None:
        Y = torch.zeros(n_slices * LANES, k, dtype=torch.float32, device=dev)
        rc = lib.sell_spmm_launch(
            _ROUTE_IDS[route], vals.data_ptr(), planes["lidx"].data_ptr(),
            meta.data_ptr(), _ptr(planes.get("slice_of")),
            planes["tile_base"].data_ptr(), X.data_ptr(), Y.data_ptr(),
            n_slots, chunk, k, vk, lk, dev.index, stream)
    else:
        ys = torch.empty(MAT_BENCH_Y_BUFFERS, n_slices * LANES, k,
                         dtype=torch.float32, device=dev)
        rc = lib.sell_bench_spmm_launch(
            vals.data_ptr(), planes["lidx"].data_ptr(), meta.data_ptr(),
            planes["tile_base"].data_ptr(), X.data_ptr(), ys.data_ptr(),
            n_slots, ys[0].numel(), chunk, k, iterations, vk, lk, dev.index,
            stream)
        Y = ys[(iterations - 1) % MAT_BENCH_Y_BUFFERS]
    _check_rc(lib, rc, f"{wrapper.kernel} launch")
    wrapper.launches += 1
    return Y


def sell_spmm(vals, lidx, relsl, tile_base, X, *, n_slices: int,
              n_coltiles: int, chunk: int) -> torch.Tensor:
    """K1 with k columns: Y = A·X over the merged-word planes; X is (at
    least CT·128, k) in the value dtype, Y float32 (n_slices·128, k).

    Its kernel runs the warp-per-sublane k-column body: a values plane not
    aligned to four elements raises "misaligned address", and so does an X
    view not aligned to four elements when k % 4 == 0 (``spmm_shape``'s
    vector form); planes of no sublane raise "invalid argument".
    ``SellSpMV._block`` gives X new, aligned storage."""
    return _spmm_dispatch(sell_spmm, sell_spmm_plain, "relsl",
                          dict(vals=vals, lidx=lidx, relsl=relsl,
                               tile_base=tile_base),
                          X, n_slices=n_slices, n_coltiles=n_coltiles,
                          chunk=chunk)


def sell_split_spmm(vals, lidx, rel, slice_of, tile_base, X, *,
                    n_slices: int, n_coltiles: int,
                    chunk: int) -> torch.Tensor:
    """K4 with k columns: Y = A·X over the split planes, on K1-with-k's
    body and alignment rule."""
    return _spmm_dispatch(sell_split_spmm, sell_split_spmm_plain, "split",
                          dict(vals=vals, lidx=lidx, rel=rel,
                               slice_of=slice_of, tile_base=tile_base),
                          X, n_slices=n_slices, n_coltiles=n_coltiles,
                          chunk=chunk)


# Y buffers of K2 with k columns (``csrc/sell_spmm.cu``,
# ``kBenchMatYBuffers``): iteration ``it`` sweeps into buffer ``it % 2``, so
# the result is buffer ``(N - 1) % 2``.
MAT_BENCH_Y_BUFFERS = 2


def sell_bench_spmm(vals, lidx, relsl, tile_base, X, *, n_slices: int,
                    n_coltiles: int, chunk: int,
                    iterations: int) -> torch.Tensor:
    """K2 with k columns: ``iterations`` K1 SpMMs in one cooperative
    launch (merged word), on K1-with-k's body and alignment rule; the last
    Y, a view of the Y buffer the last iteration wrote
    (``MAT_BENCH_Y_BUFFERS``)."""
    return _spmm_dispatch(sell_bench_spmm, sell_bench_spmm_plain, "relsl",
                          dict(vals=vals, lidx=lidx, relsl=relsl,
                               tile_base=tile_base),
                          X, n_slices=n_slices, n_coltiles=n_coltiles,
                          chunk=chunk, iterations=iterations)


# Sublanes of one slice a unit of K7's schedule holds at most
# (csrc/sell_vals_grad.cu, ``kVgRun``): its shared memory holds that many
# sublanes' 128 outputs.
VG_RUN = 64
# The units ``vals_grad_schedule`` cuts by default. On gcn_arxiv's A (NVIDIA
# H100 80GB HBM3, 700 W; bench/bench_variants.py --vgrad) units of 32 took
# K7 from 0.660 to 0.570 ms at k = 256 and from 0.253 to 0.258 ms at k =
# 40 against units of 64 (a slice of 52 live sublanes on average, so about
# two blocks a slice and twice as many blocks in flight), and units of 16
# 0.631 / 0.285 ms.
VG_CAP = 32


@dataclasses.dataclass(frozen=True)
class VgSchedule:
    """K7's by-slice schedule of a plan (``vals_grad_schedule``): int32
    tensors on the planes' device. ``order`` lists every sublane once: the
    live ones grouped by slice (ascending), in plan order within a slice,
    then the dead ones in plan order. Unit u is ``order[unit_start[u] :
    unit_start[u + 1]]``, at most ``cap`` sublanes of slice
    ``unit_slice[u]`` (-1: dead sublanes, which the kernel zeroes).
    ``seconds`` is its build time (host clock, synchronised)."""

    order: torch.Tensor
    unit_start: torch.Tensor
    unit_slice: torch.Tensor
    cap: int
    seconds: float

    @property
    def n_units(self) -> int:
        return self.unit_slice.numel()


def _by_slice(rel, sl):
    """``(ids, key)``, int64 on the planes' device: the live sublanes (rel
    and slice both >= 0) grouped by slice, ascending, in plan order within
    a slice, and their slices. The one sort behind K7's schedule and the
    slice index that K6 and K8 walk."""
    rel, sl = rel.reshape(-1).long(), sl.reshape(-1).long()
    ids = ((rel >= 0) & (sl >= 0)).nonzero().squeeze(1)
    key, perm = torch.sort(sl[ids], stable=True)
    return ids[perm], key


def device_slice_index(rel, sl, n_slices: int):
    """``(slice_ptr, sublanes)``, int32 on the planes' device, built with
    torch ops from the per-sublane ``rel`` and ``slice`` (-1 where dead):
    the live sublanes of slice k are ``sublanes[slice_ptr[k] :
    slice_ptr[k + 1]]``, in plan order, which within a slice is (chunk,
    sublane) order. Dead sublanes are left out; a slice id of
    ``n_slices`` or more raises."""
    ids, key = _by_slice(rel, sl)
    counts = torch.bincount(key, minlength=n_slices)
    if counts.numel() != n_slices:
        raise ValueError(f"a live sublane names slice {counts.numel() - 1}, "
                         f"the plan has {n_slices}")
    ptr = torch.zeros(n_slices + 1, dtype=torch.int64, device=ids.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    return ptr.int(), ids.int()


def slice_index(plan: SellPlan):
    """``device_slice_index`` of a plan's planes on the host, as int32
    numpy arrays ``(slice_ptr, sublanes)``."""
    ptr, sub = device_slice_index(
        torch.from_numpy(np.ascontiguousarray(plan.rel_tile.reshape(-1))),
        torch.from_numpy(np.ascontiguousarray(plan.slice_of.reshape(-1))),
        plan.n_slices)
    return ptr.numpy(), sub.numpy()


def vals_grad_schedule(rel, sl, cap: int = VG_CAP) -> VgSchedule:
    """K7's schedule from the per-sublane ``rel`` and ``slice`` (-1 where
    dead; ``_decode_word`` of the merged word, or the split planes), built
    with torch ops on their device. A slice of more live sublanes than
    ``cap`` (at most ``VG_RUN``; a hub row, and at ``VG_CAP`` most slices
    of gcn_arxiv's A) is cut into several units, so that no block walks it
    alone. It is the kernel's schedule; the plan is unchanged."""
    if not 1 <= cap <= VG_RUN:
        raise ValueError(f"cap must be in [1, {VG_RUN}], got {cap}")
    t0 = time.perf_counter()
    rel, sl = rel.reshape(-1).long(), sl.reshape(-1).long()
    dev = sl.device
    live = (rel >= 0) & (sl >= 0)
    ids, key = _by_slice(rel, sl)
    head = torch.ones(ids.numel(), dtype=torch.bool, device=dev)
    head[1:] = key[1:] != key[:-1]
    first = head.nonzero().squeeze(1)  # each slice's first position
    pos = (torch.arange(ids.numel(), device=dev)
           - first[torch.cumsum(head.long(), 0) - 1])
    live_units = (pos % cap == 0).nonzero().squeeze(1)
    dead = (~live).nonzero().squeeze(1)
    dead_units = ids.numel() + torch.arange(0, dead.numel(), cap,
                                            device=dev)
    n = ids.numel() + dead.numel()
    order = torch.cat([ids, dead]).int()
    unit_start = torch.cat([live_units, dead_units,
                            torch.tensor([n], device=dev)]).int()
    unit_slice = torch.cat([key[live_units], torch.full(
        (dead_units.numel(),), -1, device=dev)]).int()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return VgSchedule(order, unit_start, unit_slice, cap,
                      time.perf_counter() - t0)


def _check_schedule(schedule: VgSchedule, n_sublanes: int,
                    device: torch.device) -> None:
    if schedule.cap > VG_RUN:
        raise ValueError(f"schedule units of {schedule.cap} sublanes, the "
                         f"kernel holds {VG_RUN}")
    for name, t, n in (("order", schedule.order, n_sublanes),
                       ("unit_start", schedule.unit_start,
                        schedule.n_units + 1),
                       ("unit_slice", schedule.unit_slice, None)):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != device or (n is not None and t.numel() != n)):
            raise ValueError(f"schedule {name} must be contiguous int32 of "
                             f"{n if n is not None else 'n_units'} entries "
                             f"on {device}")


def sell_vals_grad(lidx, tile_base, X, G, *, n_slices: int, n_coltiles: int,
                   chunk: int, relsl=None, rel=None, slice_of=None,
                   schedule: Optional[VgSchedule] = None) -> torch.Tensor:
    """K7: the (S, 128) float32 cotangent of the values plane of Y = A·X
    for output cotangent G (float32, at least NS·128 rows, as many columns
    as X). It decodes whichever planes it is given: the merged ``relsl``
    word or the split ``rel`` and ``slice_of``.

    Its kernel walks the plan by slice (``schedule``, built from the
    planes by ``vals_grad_schedule`` when none is passed;
    ``SellSpMV.vals_grad_schedule`` caches one per operator). A lane-index
    plane not aligned to four elements raises "misaligned address", and so
    does X not aligned to four elements or G not to 16 bytes where k % 4
    == 0; planes that are not whole chunks raise "invalid argument"."""
    planes = dict(lidx=lidx, tile_base=tile_base, relsl=relsl, rel=rel,
                  slice_of=slice_of)
    check_planes(**planes, chunk=chunk)
    dev = lidx.device
    k = check_block("X", X, rows=n_coltiles * LANES, dtypes=VALUE_DTYPES,
                    device=dev)
    if check_block("G", G, rows=n_slices * LANES, dtypes=(torch.float32,),
                   device=dev) != k:
        raise ValueError(f"X has {k} columns, G {G.shape[1]}")
    if schedule is not None:
        _check_schedule(schedule, lidx.shape[0], dev)
    kw = dict(n_slices=n_slices, n_coltiles=n_coltiles, chunk=chunk)
    if dev.type == "cpu":
        return sell_vals_grad_plain(lidx, tile_base, X, G, relsl=relsl,
                                    rel=rel, slice_of=slice_of, **kw)
    if dev.type != "cuda":
        raise ValueError(
            f"the SELL kernels run on cuda tensors (got {dev}); only CPU "
            "tensors take the plain version"
        )
    if schedule is None:
        schedule = vals_grad_schedule(
            *(_decode_word(relsl) if relsl is not None else (rel, slice_of)))
    vk, lk = _kinds(X, lidx)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("sell_vals_grad", _VALS_GRAD_SIGNATURES)
    out = torch.empty(lidx.shape, dtype=torch.float32, device=dev)
    route = "relsl" if relsl is not None else "split"
    rc = lib.sell_vals_grad_launch(
        _ROUTE_IDS[route], lidx.data_ptr(),
        (relsl if relsl is not None else rel).data_ptr(), _ptr(slice_of),
        tile_base.data_ptr(), X.data_ptr(), G.data_ptr(), out.data_ptr(),
        schedule.order.data_ptr(), schedule.unit_start.data_ptr(),
        schedule.unit_slice.data_ptr(), schedule.n_units, lidx.numel(),
        chunk, k, vk, lk, dev.index, stream)
    _check_rc(lib, rc, f"{sell_vals_grad.kernel} launch")
    sell_vals_grad.launches += 1
    return out


_PACKED_SIGNATURES = {
    "sell_packed_launch": (ctypes.c_int, [
        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _VP]),
    "sell_packed_spmm_launch": (ctypes.c_int, [
        _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _VP]),
    "sell_bench_packed_launch": (ctypes.c_int, [
        _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP]),
    "sell_bench_packed_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _packed_dispatch(wrapper, plain, packed, slice_of, tile_base, x, *,
                     n_slices: int, chunk: int, y_block_id=None, nsb: int = 0,
                     n_coltiles: Optional[int] = None,
                     iterations: Optional[int] = None) -> torch.Tensor:
    """Check the packed planes, then run ``plain`` on CPU tensors or launch
    the wrapper's kernel (counted on ``wrapper``) on CUDA ones: the
    k-column kernel when ``n_coltiles`` is given (x is then the (rows, k)
    block X), the N-iteration one when ``iterations`` is."""
    if iterations is not None and iterations < 1:
        raise ValueError("iterations must be >= 1")
    mat = n_coltiles is not None
    check_packed_planes(packed=packed, slice_of=slice_of, tile_base=tile_base,
                        chunk=chunk, x=None if mat else x,
                        y_block_id=y_block_id)
    kw = dict(n_slices=n_slices, chunk=chunk)
    if mat:
        k = check_block("X", x, rows=n_coltiles * LANES,
                        dtypes=(torch.bfloat16,), device=packed.device)
        kw["n_coltiles"] = n_coltiles
    elif y_block_id is not None:
        kw.update(y_block_id=y_block_id, nsb=nsb)
    if packed.device.type == "cpu":
        if iterations is not None:
            kw["iterations"] = iterations
        return plain(packed, slice_of, tile_base, x, **kw)
    dev = _launch_device(packed)
    lib = _build.load("sell_packed", _PACKED_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_slots, n_out = packed.numel(), n_slices * LANES
    planes = (packed.data_ptr(), slice_of.data_ptr(), tile_base.data_ptr())
    if mat:
        y = torch.zeros(n_out, k, dtype=torch.float32, device=dev)
        rc = lib.sell_packed_spmm_launch(*planes, x.data_ptr(), y.data_ptr(),
                                         n_slots, chunk, k, dev.index, stream)
    elif iterations is not None:
        ys = torch.empty(PACKED_BENCH_Y_BUFFERS, n_out, dtype=torch.float32,
                         device=dev)
        rc = lib.sell_bench_packed_launch(*planes, x.data_ptr(),
                                          ys.data_ptr(), n_slots, n_out,
                                          chunk, iterations, dev.index,
                                          stream)
        y = ys[(iterations - 1) % PACKED_BENCH_Y_BUFFERS]
    else:
        y = torch.zeros(n_out, dtype=torch.float32, device=dev)
        rc = lib.sell_packed_launch(*planes, _ptr(y_block_id), x.data_ptr(),
                                    y.data_ptr(), n_slots, chunk, nsb,
                                    dev.index, stream)
    _check_rc(lib, rc, f"{wrapper.kernel} launch")
    wrapper.launches += 1
    return y


def sell_packed(packed, slice_of, tile_base, x, *, n_slices: int, chunk: int,
                y_block_id=None, nsb: int = 0) -> torch.Tensor:
    """K5: y = A·x over the packed word plane (bf16 values and x), resident
    y, or streamed with ``y_block_id`` and ``nsb`` slices per block."""
    if y_block_id is not None and nsb < 1:
        raise ValueError("a streamed plan needs nsb >= 1")
    return _packed_dispatch(sell_packed, sell_packed_plain, packed, slice_of,
                            tile_base, x, n_slices=n_slices, chunk=chunk,
                            y_block_id=y_block_id, nsb=nsb)


def sell_packed_spmm(packed, slice_of, tile_base, X, *, n_slices: int,
                     n_coltiles: int, chunk: int) -> torch.Tensor:
    """K5 with k columns: Y = A·X over the packed word plane, resident y; X
    is (at least CT·128, k) bf16, Y float32 (n_slices·128, k).

    Its kernel runs the k-column body of K1 with k columns (rel from each
    sublane's lane-0 word, taken from the loaded word by a warp shuffle)
    at the column shape ``spmm_shape(k)``: a
    packed plane not aligned to 16 bytes, or X not aligned to four
    elements where k % 4 == 0, raises "misaligned address", and planes of
    no sublane "invalid argument"."""
    return _packed_dispatch(sell_packed_spmm, sell_packed_spmm_plain, packed,
                            slice_of, tile_base, X, n_slices=n_slices,
                            chunk=chunk, n_coltiles=n_coltiles)


# y buffers of K2-packed (csrc/sell_packed.cu, ``kPackedBenchYBuffers``):
# two in turn, one grid barrier an iteration, as K2.
PACKED_BENCH_Y_BUFFERS = 2


def sell_bench_packed(packed, slice_of, tile_base, x, *, n_slices: int,
                      chunk: int, iterations: int) -> torch.Tensor:
    """K2-packed: ``iterations`` K5 SpMVs in one cooperative launch
    (resident y); the last y.

    Its kernel runs K2's warp-per-sublane body, rel from each sublane's
    lane-0 word (taken by a warp shuffle from the loaded word), with
    ``PACKED_BENCH_Y_BUFFERS`` y buffers,
    the result in buffer ``(iterations - 1) % 2``: a packed plane not
    aligned to 16 bytes raises "misaligned address", and planes of no
    sublane "invalid argument"."""
    return _packed_dispatch(sell_bench_packed, sell_bench_packed_plain,
                            packed, slice_of, tile_base, x,
                            n_slices=n_slices, chunk=chunk,
                            iterations=iterations)


# The packed wrappers by kernel name, each with its launch counter, and
# the route names SellSpMV.route reports under SMVP_SELL_PACK=1.
PACKED_KERNELS = {
    "sell_packed_kernel": sell_packed,
    "sell_packed_spmm_kernel": sell_packed_spmm,
    "sell_bench_packed_kernel": sell_bench_packed,
}
for _name, _fn in PACKED_KERNELS.items():
    _fn.kernel = _name
    _fn.launches = 0
PACKED_ROUTES = ("packed", "streamy_packed")


def bench_packed_blocks(device=None) -> int:
    """Blocks of one ``sell_bench_packed_kernel`` launch on ``device``."""
    dev = resolve_device(device)
    lib = _build.load("sell_packed", _PACKED_SIGNATURES)
    out = ctypes.c_int(0)
    rc = lib.sell_bench_packed_blocks(dev.index, ctypes.byref(out))
    _check_rc(lib, rc, "sell_bench_packed_kernel occupancy query")
    return out.value


# The k-column wrappers by kernel name, each with its launch counter.
MAT_KERNELS = {
    "sell_spmm_kernel": sell_spmm,
    "sell_split_spmm_kernel": sell_split_spmm,
    "sell_bench_spmm_kernel": sell_bench_spmm,
    "sell_vals_grad_kernel": sell_vals_grad,
}
for _name, _fn in MAT_KERNELS.items():
    _fn.kernel = _name
    _fn.launches = 0
# The SpMM kernel of each resident-y route.
_SPMM_FNS = {"relsl": sell_spmm, "split": sell_split_spmm}


def bench_blocks(value_dtype: torch.dtype, lidx_dt: torch.dtype,
                 device=None, route: str = "relsl") -> int:
    """Blocks of one bench launch of ``route`` on ``device`` (SMs ×
    co-resident blocks)."""
    dev = resolve_device(device)
    lib = _build.load("sell_bench", _BENCH_SIGNATURES)
    out = ctypes.c_int(0)
    rc = lib.sell_bench_blocks(_ROUTE_IDS[route],
                               int(value_dtype == torch.bfloat16),
                               int(lidx_dt == torch.int32), dev.index,
                               ctypes.byref(out))
    _check_rc(lib, rc, f"{KERNEL_NAMES[(route, True)]} occupancy query")
    return out.value


def bench_spmm_blocks(value_dtype: torch.dtype, lidx_dt: torch.dtype,
                      device=None, k: int = 8) -> int:
    """Blocks of one ``sell_bench_spmm_kernel`` launch with ``k`` columns
    on ``device`` (SMs × co-resident blocks of ``spmm_shape(k)``'s
    kernel)."""
    dev = resolve_device(device)
    lib = _build.load("sell_spmm", _SPMM_SIGNATURES)
    out = ctypes.c_int(0)
    rc = lib.sell_bench_spmm_blocks(k, int(value_dtype == torch.bfloat16),
                                    int(lidx_dt == torch.int32), dev.index,
                                    ctypes.byref(out))
    _check_rc(lib, rc, "sell_bench_spmm_kernel occupancy query")
    return out.value


# ---------------------------------------------------------------------------
# The switch kernels: K6 (SMVP_SELL_COMPAT=1) and K2-subwin
# (SMVP_SELL_SUBWIN=1)
# ---------------------------------------------------------------------------


def onehot_xw(x_tiles: torch.Tensor, tile_base: torch.Tensor,
              window_tiles: int) -> torch.Tensor:
    """The JAX K6's x operand, (n_chunks, WT, 128) float32: each chunk's
    window of ``WT`` x tiles from ``tile_base[c]``, x cast to float32 first
    (in bf16 value mode x is already rounded to bf16), as the JAX launch
    stacks it (spmv_pallas.py:1340-1347)."""
    xt = x_tiles.reshape(-1, LANES).float()
    tiles = tile_base.long()[:, None] + torch.arange(
        window_tiles, device=xt.device)
    return xt[tiles]


def onehot_dense(rel, slice_of, *, n_slices: int, chunk: int,
                 window_tiles: int):
    """The JAX K6's one-hot operands from the split planes, as its launch
    builds them (spmv_pallas.py:1348-1355): ``oht`` (n_chunks, chunk, WT)
    float32, 1 at (s, rel[s]), and ``seg`` (n_chunks, NS, chunk) float32,
    1 at (slice_of[s], s); a dead rel or slice gives a zero row or column.
    Only the plain version and the checks against the dense kernel K6 ran
    before build them: S·(WT + NS)·4 bytes."""
    dev = rel.device
    n_chunks = rel.numel() // chunk
    oht = (rel.reshape(n_chunks, chunk, 1).long() == torch.arange(
        window_tiles, device=dev)).float()
    seg = (torch.arange(n_slices, device=dev)[None, :, None]
           == slice_of.reshape(n_chunks, 1, chunk).long()).float()
    return oht, seg


def sell_onehot_plain(vals, lidx, rel, slice_of, tile_base, x, *,
                      n_slices: int, chunk: int, window_tiles: int,
                      index=None) -> torch.Tensor:
    """K6's function in plain PyTorch, the JAX kernel's way: ``xw``
    (``onehot_xw``) and the one-hot operands (``onehot_dense``) built from
    the planes, then per chunk ``table = OHT_c·xw_c``, ``g = table[s,
    lidx]``, ``y += SEG_c·(vals ∘ g)``, as batched float32 matrix products
    (no TF32) summed over chunks; y float32 of ``NS·128``. The slice index
    is the kernel's schedule and is not read here."""
    n_chunks = tile_base.numel()
    xw = onehot_xw(x, tile_base, window_tiles)
    oht, seg = onehot_dense(rel, slice_of, n_slices=n_slices, chunk=chunk,
                            window_tiles=window_tiles)
    table = torch.bmm(oht, xw)
    g = torch.gather(table, 2, lidx.reshape(n_chunks, chunk, LANES).long())
    prod = vals.float().reshape(n_chunks, chunk, LANES) * g
    return torch.bmm(seg, prod).sum(0).reshape(-1)


def _check_onehot(vals, lidx, rel, slice_of, tile_base, x, *, n_slices: int,
                  chunk: int, window_tiles: int, index) -> None:
    """The planes as ``check_planes`` takes them; x whole tiles; the
    index's types and sizes and, on CPU tensors, its entries
    (``device_slice_index`` of the planes)."""
    check_planes(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                 tile_base=tile_base, x=x, chunk=chunk)
    if n_slices < 1 or window_tiles < 1:
        raise ValueError(f"n_slices {n_slices} and window_tiles "
                         f"{window_tiles} must be >= 1")
    if x.dim() != 1 or x.numel() % LANES:
        raise ValueError(f"x must be whole tiles of {LANES}, got "
                         f"{tuple(x.shape)}")
    if index is None:
        return
    slice_ptr, sublanes = index
    for name, t in (("slice_ptr", slice_ptr), ("sublanes", sublanes)):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != lidx.device):
            raise ValueError(f"{name} must be contiguous 1-D int32 on "
                             f"{lidx.device}")
    if slice_ptr.numel() != n_slices + 1 or sublanes.numel() > rel.numel():
        raise ValueError(f"the index has {slice_ptr.numel()} slice offsets "
                         f"and {sublanes.numel()} sublanes, the planes "
                         f"{n_slices} slices and {rel.numel()} sublanes")
    if lidx.device.type == "cpu":
        ptr, sub = device_slice_index(rel, slice_of, n_slices)
        if not (torch.equal(slice_ptr, ptr) and torch.equal(sublanes, sub)):
            raise ValueError("the index does not list the planes' live "
                             "sublanes by slice in plan order")


_ONEHOT_SIGNATURES = {
    "sell_onehot_launch": (ctypes.c_int, [_VP] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def sell_onehot(vals, lidx, rel, slice_of, tile_base, x, *, n_slices: int,
                chunk: int, window_tiles: int, index=None) -> torch.Tensor:
    """K6: y = A·x on the plan's own planes (values f32 or bf16, lane
    indices int8 or int32, the split ``rel`` and ``slice_of``, tile_base,
    x tiles in the value dtype); y float32 of ``NS·128``, each row summed
    over its slice's live sublanes in plan order, so a launch gives the
    same bits every time.

    ``index`` is the ``(slice_ptr, sublanes)`` the kernel walks
    (``device_slice_index`` of ``rel`` and ``slice_of``, built here when
    none is passed; ``SellSpMV.slice_index`` caches one per operator). A
    values or lane-index plane not aligned to four elements raises
    "misaligned address"."""
    kw = dict(n_slices=n_slices, chunk=chunk, window_tiles=window_tiles)
    _check_onehot(vals, lidx, rel, slice_of, tile_base, x, index=index, **kw)
    if lidx.device.type == "cpu":
        return sell_onehot_plain(vals, lidx, rel, slice_of, tile_base, x,
                                 **kw)
    dev = _launch_device(vals)
    if index is None:
        index = device_slice_index(rel, slice_of, n_slices)
    slice_ptr, sublanes = index
    vk, lk = _kinds(vals, lidx)
    lib = _build.load("sell_onehot", _ONEHOT_SIGNATURES)
    y = torch.empty(n_slices * LANES, dtype=torch.float32, device=dev)
    rc = lib.sell_onehot_launch(
        vals.data_ptr(), lidx.data_ptr(), rel.data_ptr(),
        tile_base.data_ptr(), slice_ptr.data_ptr(), sublanes.data_ptr(),
        x.data_ptr(), y.data_ptr(), n_slices * LANES, chunk, vk, lk,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(lib, rc, "sell_onehot_kernel launch")
    sell_onehot.launches += 1
    return y


def _subwin_windowed(relsl, tile_base, stb, ssb, *, chunk: int, split: int,
                     sub_wt: int, sub_nsw: int):
    """K2-subwin's window rule per sublane: the merged word's raw slice
    field, whether the sublane's sub-chain window keeps it (``rel_adj`` in
    ``[0, sub_wt)``, slice in ``[ssb, ssb + sub_nsw)``; dead sublanes fall
    outside both), and its x tile ``stb + rel_adj``, int64 each."""
    word = relsl.reshape(-1).long() & 0xFFFFFFFF
    rel, sl = word & REL_DEAD, word >> SLICE_SHIFT
    s = torch.arange(rel.numel(), device=relsl.device)
    c = s // chunk
    h = c * split + (s % chunk) // (chunk // split)
    stb_s = stb.reshape(-1).long()[h]
    ssb_s = ssb.reshape(-1).long()[h]
    rel_adj = rel - (stb_s - tile_base.long()[c])
    ok = ((rel_adj >= 0) & (rel_adj < sub_wt) & (sl >= ssb_s)
          & (sl < ssb_s + sub_nsw))
    return sl, ok, stb_s + rel_adj


def _subwin_sweep_plain(vals, lidx, relsl, tile_base, stb, ssb, x, *,
                        n_slices: int, chunk: int, split: int, sub_wt: int,
                        sub_nsw: int) -> torch.Tensor:
    """One K2-subwin sweep in plain PyTorch: the merged word decoded, each
    sublane's sub-chain window applied (``_subwin_windowed``), x read at
    ``(stb + rel_adj)·128 + lidx``."""
    sl, ok, tile = _subwin_windowed(relsl, tile_base, stb, ssb, chunk=chunk,
                                    split=split, sub_wt=sub_wt,
                                    sub_nsw=sub_nsw)
    live = ok.nonzero().squeeze(1)
    col = (tile[live] * LANES)[:, None] + lidx[live].long()
    prod = vals[live].float() * x.reshape(-1)[col].float()
    row = (sl[live] * LANES)[:, None] + torch.arange(LANES, device=x.device)
    y = torch.zeros(n_slices * LANES, dtype=torch.float32, device=x.device)
    return y.index_add_(0, row.reshape(-1), prod.reshape(-1))


def sell_bench_subwin_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """K2-subwin's function: ``iterations`` fresh windowed sweeps."""
    return _repeat(_subwin_sweep_plain, iterations, *args, **kw)


# y buffers of K2-subwin (csrc/sell_bench.cu, ``kSubwinYBuffers``): two in
# turn, one grid barrier an iteration, as K2.
SUBWIN_Y_BUFFERS = 2


def sell_bench_subwin(vals, lidx, relsl, tile_base, stb, ssb, x, *,
                      n_slices: int, chunk: int, split: int, sub_wt: int,
                      sub_nsw: int, iterations: int) -> torch.Tensor:
    """K2-subwin: ``iterations`` SpMVs over the merged-word planes in one
    cooperative launch, each sub-chain h of chunk c reading x from its
    window at ``stb[c, h]`` and reducing into its slices from
    ``ssb[c, h]`` (``_sub_windows``); the last y.

    Its kernel runs K2's warp-per-sublane body with the window rule
    applied once per sublane (``SubwinWord``): a values or lane-index
    plane not aligned to four elements raises "misaligned address", and
    planes of no sublane "invalid argument"."""
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    check_planes(vals=vals, lidx=lidx, relsl=relsl, tile_base=tile_base,
                 x=x, chunk=chunk)
    n_chunks = tile_base.numel()
    if split < 2 or chunk % split or sub_wt < 1 or sub_nsw < 1:
        raise ValueError(f"bad sub-chain windows: split {split} of chunk "
                         f"{chunk}, widths {sub_wt} and {sub_nsw}")
    for name, t in (("stb", stb), ("ssb", ssb)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (n_chunks, split)
                or not t.is_contiguous() or t.device != vals.device):
            raise ValueError(f"{name} must be contiguous int32 of shape "
                             f"({n_chunks}, {split}) on {vals.device}")
    kw = dict(n_slices=n_slices, chunk=chunk, split=split, sub_wt=sub_wt,
              sub_nsw=sub_nsw)
    if vals.device.type == "cpu":
        return sell_bench_subwin_plain(vals, lidx, relsl, tile_base, stb,
                                       ssb, x, iterations=iterations, **kw)
    dev = _launch_device(vals)
    vk, lk = _kinds(vals, lidx)
    n_out = n_slices * LANES
    lib = _build.load("sell_bench", _BENCH_SIGNATURES)
    ys = torch.empty(SUBWIN_Y_BUFFERS, n_out, dtype=torch.float32,
                     device=dev)
    rc = lib.sell_bench_subwin_launch(
        vals.data_ptr(), lidx.data_ptr(), relsl.data_ptr(),
        tile_base.data_ptr(), stb.data_ptr(), ssb.data_ptr(), x.data_ptr(),
        ys.data_ptr(), vals.numel(), n_out, chunk, split, sub_wt, sub_nsw,
        iterations, vk, lk, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(lib, rc, "sell_bench_subwin_kernel cooperative launch")
    sell_bench_subwin.launches += 1
    return ys[(iterations - 1) % SUBWIN_Y_BUFFERS]


# The switch kernels' wrappers by kernel name, each with its launch counter.
SWITCH_KERNELS = {
    "sell_onehot_kernel": sell_onehot,
    "sell_bench_subwin_kernel": sell_bench_subwin,
}
for _name, _fn in SWITCH_KERNELS.items():
    _fn.kernel = _name
    _fn.launches = 0


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


def _compat() -> bool:
    return os.environ.get("SMVP_SELL_COMPAT") == "1"


def _relsl_on() -> bool:
    return os.environ.get("SMVP_SELL_RELSL", "1") == "1"


def _n_split() -> int:
    return max(1, int(os.environ.get("SMVP_SELL_SPLIT", "1")))


def _plane_switch() -> bool:
    """Whether a switch names a plane route for ``__call__``:
    ``SMVP_SELL_PACK=1``, ``SMVP_SELL_COMPAT=1``, ``SMVP_SELL_SPLIT`` set
    or ``SMVP_SELL_RELSL=0``."""
    env = os.environ
    return (env.get("SMVP_SELL_PACK") == "1" or _compat()
            or "SMVP_SELL_SPLIT" in env or not _relsl_on())


class SellSpMV:
    """Encoded SELL-T1 operator: ``y = op(x)`` through the route's kernel,
    on one device.

    Build once per matrix (host planning + one upload), call many times.
    ``value_dtype`` is float32 or bfloat16; in bf16 mode vals and x are
    stored as bf16 and products accumulate in float32, as in the JAX
    operator. The planes of the plan's own route are uploaded at
    construction: ``relsl`` on merged-word plans, ``rel`` and ``slice_of``
    (int32 per sublane, -1 = dead) on split ones, ``y_block_id`` on
    streamed ones; the others are None. ``base_route`` is the plan's
    route.

    The JAX operator's switches are read at each call, where it reads
    them, and a call takes the JAX route (``route`` for ``__call__`` and
    ``matmat``, ``bench_route`` for ``bench_loop``):

    * ``SMVP_SELL_PACK=1``: the packed route, ``packed`` or
      ``streamy_packed``, in bf16 on plans with ``window_tiles <= 511``,
      for the operator's own values plane (``packed_planes``, built at
      first use);
    * ``SMVP_SELL_RELSL=0``: a merged-word plan runs on the split planes
      (K4 resident, K3-split streamed; ``split_planes``, uploaded at first
      use);
    * ``SMVP_SELL_COMPAT=1``: ``__call__`` on a resident-y plan runs K6,
      ``onehot``, on the split planes (``split_planes``) and the slice
      index (``slice_index``, built on the device at first use: one word
      per live sublane and per slice); a streamed plan leaves
      the merged word for the split planes, as the JAX gates do; ``matmat``
      runs one k = 1 call per column; ``bench_loop`` ignores the switch
      (the JAX bench kernel has no one-hot branch);
    * ``SMVP_SELL_LIDX32=1``: int32 lane planes (``lidx_dtype``, at
      construction) and 4 bytes per lane in ``SellPlan.traffic_bytes``;
    * ``SMVP_SELL_SPMM=0``: ``matmat`` makes one k = 1 call per column;
    * ``SMVP_SELL_SPLIT=N``: ``__call__`` cuts the chunks into N ranges of
      ``ceil(n_chunks / N)`` and sums one launch per range, on resident-y
      plans, without COMPAT, for the operator's own values;
    * ``SMVP_SELL_SUBWIN=1``: ``bench_loop`` on a resident merged-word
      plan runs K2-subwin, ``subwin``, when the chain split
      (``subwin_split``) is above 1 and ``_sub_windows`` returns windows;
    * ``SMVP_SELL_SPLIT_CHAIN=N``: the chain split of ``_sub_windows`` and
      K2-subwin; nothing else on the card.

    The port does not follow the JAX operator's other switches, because
    they shape only TPU work that an exact gather does not have:
    ``SMVP_SELL_REDUCE1`` and ``SMVP_SELL_REDUCE2`` are lossy bf16 MXU
    reductions (off by about 2.5e-3 and 1e-5), which an exact float32
    gather and sum have nothing to reproduce of; ``SMVP_SELL_BF16_TAA``
    rounds the gathered table to bf16 only in bf16 value mode, where it
    already is bf16; ``SMVP_SELL_NOWINDOW``, ``SMVP_SELL_PREFETCH``,
    ``SMVP_SELL_VMEM_MB`` and ``SMVP_SELL_SPMM_GROUP`` shape TPU VMEM
    windows, copies and budgets (the port runs any k in one launch).

    ``triplets`` are the host (rows, cols, values) the plan was built
    from, kept for the training hooks: ``transpose`` plans Aᵀ from them
    and ``slot_map`` finds each triplet's slot. ``from_coo`` and the CSR
    and TJDS caches pass them.

    The ``csr`` route (``csr_on``): where the operator has its triplets
    and the card's cost model prices K12 (``ops/csr_merge.py``) at most
    half the plan (``autotune.takes_csr``; ``plan_cost_us`` is the plan's
    modelled µs where the autotuner priced it, else it is priced at the
    first call), ``__call__`` runs K12 on CSR planes built from the
    triplets at that call (``csr_planes``), with x in place of its padded
    tiles, unless a switch above names a plane route. ``matmat``,
    ``bench_loop``, the values-gradient hooks and the fused solvers keep
    the planes.
    """

    def __init__(self, plan: SellPlan, value_dtype: Optional[torch.dtype] = None,
                 device=None, *, triplets=None,
                 plan_cost_us: Optional[float] = None):
        self.device = resolve_device(device)
        with tracing.span("plan.upload"):
            self._upload(plan, value_dtype)
        tracing.count("plan.slots", plan.n_sublanes * LANES)
        tracing.count("plan.live_slots", plan.nnz)
        self.kernel, self.bench_kernel = _ROUTE_FNS[self.base_route]
        self.spmm_kernel = _SPMM_FNS.get(self.base_route)
        self._packed: Optional[tuple] = None
        self._split: Optional[tuple] = None
        self._slice_index: Optional[tuple] = None
        self._subwin: dict = {}
        self._triplets = triplets
        self._plan_cost_us = plan_cost_us
        self._csr_gate: Optional[bool] = None
        self._csr = None
        self._t_op: Optional[SellSpMV] = None
        self._slot_map: Optional[np.ndarray] = None
        self._slot_index: Optional[torch.Tensor] = None
        self._vg_schedule: Optional[VgSchedule] = None

    def _upload(self, plan: SellPlan, value_dtype) -> None:
        """Check the plan, then upload the planes of its route."""
        check_plan(plan)
        self.value_dtype = torch.float32 if value_dtype is None else value_dtype
        if self.value_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("value_dtype must be float32 or bfloat16")
        self.plan = plan
        self.shape = plan.shape
        self.base_route = plan_route(plan)
        dev = self.device

        def upload(a):
            return host_tensor(np.asarray(a).reshape(-1), np.int32).to(dev)

        self.vals = host_tensor(plan.vals, np.float32).to(
            self.value_dtype).to(dev)
        self.lidx = host_tensor(plan.lane_idx, np.int32).to(
            lidx_dtype(plan.chunk)).to(dev)
        self.tile_base = upload(plan.tile_base)
        self.relsl = self.rel = self.slice_of = self.y_block_id = None
        if plan.merged_word:
            self.relsl = upload(relsl_plane_host(plan))
        else:
            self.rel = upload(plan.rel_tile)
            self.slice_of = upload(plan.slice_of)
        if plan.y_block_slices:
            self.y_block_id = upload(plan.y_block_id)

    def packed_on(self, vals: Optional[torch.Tensor] = None) -> bool:
        """Whether a call takes the packed route: ``SMVP_SELL_PACK=1``,
        bf16 values, a window that fits the 9-bit rel field, and the
        operator's own values plane (a ``vals`` plane passed by the
        training hooks never does), the JAX operator's gates."""
        return (os.environ.get("SMVP_SELL_PACK") == "1"
                and self.value_dtype == torch.bfloat16
                and self.plan.window_tiles <= REL_DEAD
                and vals is None)

    def _merged_route(self) -> bool:
        """The merged word under ``SMVP_SELL_RELSL`` (default on)."""
        return self.plan.merged_word and _relsl_on()

    def _plane_route(self, merged: bool) -> str:
        """The merged-word or split-plane route of this plan's y."""
        if self.plan.y_block_slices:
            return "streamy_relsl" if merged else "streamy"
        return "relsl" if merged else "split"

    def _route(self, vals: Optional[torch.Tensor] = None) -> str:
        streamed = bool(self.plan.y_block_slices)
        compat = _compat()
        if compat and not streamed:
            return "onehot"
        if not compat and self.packed_on(vals):
            return PACKED_ROUTES[int(streamed)]
        return self._plane_route(self._merged_route() and not compat)

    @property
    def route(self) -> str:
        """The route ``__call__`` takes now (class docstring)."""
        return "csr" if self.csr_on() else self._route()

    def csr_on(self) -> bool:
        """Whether ``__call__`` takes the csr route now: no plane switch,
        and ``_csr_priced``."""
        return not _plane_switch() and self._csr_priced()

    def _csr_priced(self) -> bool:
        """Whether K12 on the triplets is modelled ``autotune.CSR_GAIN``
        times cheaper than the plan (``autotune.takes_csr``); decided
        once."""
        if self._csr_gate is None:
            nnz = 0 if self._triplets is None else len(self._triplets[0])
            self._csr_gate = (
                self._triplets is not None and csr_fits(nnz, self.shape[0])
                and takes_csr(self.plan, nnz, self.vals.element_size(),
                              self._plan_cost_us))
        return self._csr_gate

    def csr_planes(self):
        """The csr route's planes (``csr_merge.CsrPlanes``) on the
        operator's device, built from the triplets at first use."""
        if self._csr is None:
            if self._triplets is None:
                raise ValueError("the csr route needs an operator built "
                                 "with its triplets")
            self._csr = csr_planes(*self._triplets, self.shape,
                                   self.value_dtype, self.device)
        return self._csr

    @property
    def bench_route(self) -> str:
        """The route ``bench_loop`` takes now: ``packed`` under
        ``SMVP_SELL_PACK=1`` (its gates), ``subwin`` under
        ``SMVP_SELL_SUBWIN=1`` (its gates), else the merged word or the
        split planes under ``SMVP_SELL_RELSL``; COMPAT is not read."""
        if self.packed_on():
            return PACKED_ROUTES[int(bool(self.plan.y_block_slices))]
        if self.subwin_windows() is not None:
            return "subwin"
        return self._plane_route(self._merged_route())

    def packed_planes(self):
        """(packed word plane (S, 128), slice_of per sublane), int32 on
        the operator's device; built and uploaded at first use."""
        if self._packed is None:
            pk = host_tensor(packed_plane_host(self.plan), np.int32)
            sl = self.slice_of
            if sl is None:
                sl = host_tensor(self.plan.slice_of.reshape(-1), np.int32)
            self._packed = (pk.to(self.device), sl.to(self.device))
        return self._packed

    def split_planes(self):
        """(rel_tile, slice_of), int32 per sublane on the operator's device:
        the split planes' metadata, uploaded at first use on a merged-word
        plan (``SMVP_SELL_RELSL=0``)."""
        if self.rel is not None:
            return self.rel, self.slice_of
        if self._split is None:
            self._split = tuple(
                host_tensor(a.reshape(-1), np.int32).to(self.device)
                for a in (self.plan.rel_tile, self.plan.slice_of))
        return self._split

    def slice_index(self):
        """K6's ``(slice_ptr, sublanes)`` on this plan
        (``device_slice_index`` of ``split_planes``), built on the
        operator's device at first use and cached."""
        if self._slice_index is None:
            self._slice_index = device_slice_index(*self.split_planes(),
                                                   self.plan.n_slices)
        return self._slice_index

    def _onehot_kw(self):
        """K6's keywords on this plan, the cached slice index among them."""
        return dict(n_slices=self.plan.n_slices, chunk=self.plan.chunk,
                    window_tiles=self.plan.window_tiles,
                    index=self.slice_index())

    def subwin_windows(self):
        """K2-subwin's windows now: ``(stb, ssb, split, sub_wt, sub_nsw)``
        with stb and ssb int32 (n_chunks, split) on the device, or None
        when ``bench_loop`` does not take K2-subwin: the switch is off,
        the plan is streamed or on split planes, the chain split
        (``subwin_split``) is 1, or ``_sub_windows`` finds the plan
        ineligible. Cached per split."""
        if (os.environ.get("SMVP_SELL_SUBWIN") != "1"
                or self.plan.y_block_slices or not self._merged_route()):
            return None
        split = subwin_split(self.plan.chunk)
        if split < 2:
            return None
        if split not in self._subwin:
            sub = _sub_windows(self.plan, split)
            if sub is not None:
                stb, ssb, sub_wt, sub_nsw = sub
                sub = (host_tensor(stb, np.int32).to(self.device),
                       host_tensor(ssb, np.int32).to(self.device), split,
                       sub_wt, sub_nsw)
            self._subwin[split] = sub
        return self._subwin[split]

    @staticmethod
    def from_coo(coo, value_dtype: Optional[torch.dtype] = None,
                 device=None) -> "SellSpMV":
        """The operator on the autotuned plan (``autotune.tuned_plan``:
        the chunk the card's cost model picks for this value dtype; chunk
        2048 under ``SMVP_SELL_AUTOTUNE=0``), as the JAX ``from_coo``."""
        with tracing.span("plan"):
            with tracing.span("plan.to_host"):
                r, c, v = coo.to_numpy()
            plan, cost = tuned_plan(r, c, v, coo.shape,
                                    bf16=value_dtype == torch.bfloat16)
            return SellSpMV(plan, value_dtype=value_dtype,
                            device=coo.device if device is None else device,
                            triplets=(r, c, v), plan_cost_us=cost)

    def _x_flat(self, x: torch.Tensor) -> torch.Tensor:
        """x as a vector, on the operator's device and at most CT·128
        long, or raise."""
        if x.device != self.device:
            raise ValueError(
                f"x is on {x.device}, the operator on {self.device}"
            )
        x = x.reshape(-1)
        if x.shape[0] > self.plan.n_coltiles * LANES:
            raise ValueError(f"x has {x.shape[0]} entries, the matrix "
                             f"{self.shape[1]} columns")
        return x

    def _x_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """x cast to the value dtype and zero-padded to CT·128."""
        with tracing.span("spmv.x_tiles"):
            x = self._x_flat(x)
            out = torch.zeros(self.plan.n_coltiles * LANES,
                              dtype=self.value_dtype, device=x.device)
            out[: x.shape[0]] = x.to(self.value_dtype)
            return out

    def _x_vector(self, x: torch.Tensor) -> torch.Tensor:
        """x for K12: in the value dtype and contiguous, read in place
        where it is so already; zero-padded only where it is shorter than
        the matrix's columns."""
        x = self._x_flat(x)
        if x.shape[0] < self.shape[1]:
            x = torch.nn.functional.pad(x, (0, self.shape[1] - x.shape[0]))
        return x.to(self.value_dtype).contiguous()

    def _planes(self, route: Optional[str] = None):
        """The planes of ``route`` (default the plan's own), in its
        wrappers' positional order: vals, lidx, the merged word or the
        split planes, tile_base and, streamed, y_block_id."""
        route = route or self.base_route
        meta = ((self.relsl,) if route in ("relsl", "streamy_relsl")
                else self.split_planes())
        tail = (self.y_block_id,) if self.plan.y_block_slices else ()
        return (self.vals, self.lidx, *meta, self.tile_base, *tail)

    def _kw(self):
        kw = dict(n_slices=self.plan.n_slices, chunk=self.plan.chunk)
        if self.plan.y_block_slices:
            kw["nsb"] = self.plan.y_block_slices
        return kw

    def _block(self, X: torch.Tensor, rows: int, dtype: torch.dtype,
               what: str) -> torch.Tensor:
        """X (n, k) cast to ``dtype`` and zero-padded to ``rows`` rows: a
        new contiguous row-major block, whatever the layout of X (an
        autograd cotangent may be an expanded, stride-0 view)."""
        if X.device != self.device:
            raise ValueError(
                f"{what} is on {X.device}, the operator on {self.device}"
            )
        if X.dim() != 2 or X.shape[0] > rows or X.shape[1] < 1:
            raise ValueError(f"{what} must be (n, k) with n <= {rows} and "
                             f"k >= 1, got {tuple(X.shape)}")
        out = torch.zeros(rows, X.shape[1], dtype=dtype, device=self.device)
        out[: X.shape[0]] = X.detach()
        return out

    def _vals_plane(self, vals: Optional[torch.Tensor]) -> torch.Tensor:
        """The values plane, or ``vals`` in its place, in the value dtype,
        contiguous and aligned to 16 bytes: the forward kernels' vector
        loads refuse a view at an odd offset, so such a ``vals`` is copied
        into new storage first."""
        if vals is None:
            return self.vals
        if vals.device != self.device or vals.numel() != self.vals.numel():
            raise ValueError(
                f"vals must hold {self.vals.numel()} slots on "
                f"{self.device}, got {vals.numel()} on {vals.device}"
            )
        out = vals.detach().reshape(self.vals.shape).to(
            self.value_dtype).contiguous()
        if out.data_ptr() % _VEC_ALIGN:
            out = out.clone()
        return out

    def _mat_kw(self):
        return dict(n_slices=self.plan.n_slices,
                    n_coltiles=self.plan.n_coltiles, chunk=self.plan.chunk)

    def vals_grad_schedule(self) -> VgSchedule:
        """K7's by-slice schedule of this plan (``vals_grad_schedule``),
        built on the operator's device from its planes at first use and
        cached."""
        if self._vg_schedule is None:
            self._vg_schedule = vals_grad_schedule(
                *(_decode_word(self.relsl) if self.relsl is not None
                  else self.split_planes()))
        return self._vg_schedule

    def _launch_range(self, route: str, a: int, b: int, xt: torch.Tensor,
                      vals: Optional[torch.Tensor]) -> torch.Tensor:
        """One forward launch of ``route`` over chunks ``[a, b)`` (views of
        the planes, contiguous along the sublanes); y of all NS slices."""
        with tracing.span("spmv.launch"):
            c0, c1 = a * self.plan.chunk, b * self.plan.chunk
            kw = self._kw()
            yb = None if self.y_block_id is None else self.y_block_id[a:b]
            if route in PACKED_ROUTES:
                pk, sl = self.packed_planes()
                return sell_packed(pk[c0:c1], sl[c0:c1], self.tile_base[a:b],
                                   xt, y_block_id=yb, **kw)
            planes = self._planes(route)
            n_chunk_planes = 2 if yb is not None else 1
            head = (self._vals_plane(vals),) + planes[1:-n_chunk_planes]
            tail = planes[-n_chunk_planes:]
            return _ROUTE_FNS[route][0](*(t[c0:c1] for t in head),
                                        *(t[a:b] for t in tail), xt, **kw)

    def _apply(self, x: torch.Tensor,
               vals: Optional[torch.Tensor] = None) -> torch.Tensor:
        route = self._route(vals)
        xt = self._x_tiles(x)
        if route == "onehot":
            return sell_onehot(self._vals_plane(vals), self.lidx,
                               *self.split_planes(), self.tile_base, xt,
                               **self._onehot_kw())[: self.shape[0]]
        # SMVP_SELL_SPLIT=N: N launches over chunk ranges, then a sum (the
        # JAX gates: resident y, no COMPAT, the operator's own values).
        nch = self.plan.n_chunks
        n_split = (1 if self.plan.y_block_slices or vals is not None
                   else min(_n_split(), nch))
        per = -(-nch // n_split)
        y = None
        for a in range(0, nch, per):
            part = self._launch_range(route, a, min(a + per, nch), xt, vals)
            y = part if y is None else y + part
        return y[: self.shape[0]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.span("spmv.call"):
            if self.csr_on():
                planes = self.csr_planes()
                xv = self._x_vector(x)
                with tracing.span("spmv.launch"):
                    return csr_merge_spmv(planes, xv)
            return self._apply(x)

    def matmat(self, X: torch.Tensor,
               vals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Y = A·X for a dense block X (ncols, k); Y float32 (nrows, k).

        k == 1 is one SpMV (``__call__``). A resident-y plan runs one
        k-wide launch of its route's SpMM kernel (K1 or K4 with k
        columns, or K5 with k columns on the packed route); a streamed-y
        plan, ``SMVP_SELL_SPMM=0`` and ``SMVP_SELL_COMPAT=1`` run one k = 1
        call per column, as the JAX operator's vmap fallback does. X is
        rounded to the value dtype first (bf16 mode rounds it to bf16, as
        the JAX operator does). ``vals`` (S·128 values in the planner's
        slot order) replaces the values plane for this call, as the
        trainable-edge path needs.
        """
        if X.dim() != 2:
            raise ValueError(f"X must be (ncols, k), got {tuple(X.shape)}")
        k = int(X.shape[1])
        if k == 1:
            return self._apply(X[:, 0], vals)[:, None]
        if (os.environ.get("SMVP_SELL_SPMM") == "0"
                or self.plan.y_block_slices or _compat()):
            return torch.stack([self._apply(X[:, j], vals)
                                for j in range(k)], dim=1)
        Xt = self._block(X, self.plan.n_coltiles * LANES, self.value_dtype,
                         "X")
        if self.packed_on(vals):
            return sell_packed_spmm(*self.packed_planes(), self.tile_base, Xt,
                                    **self._mat_kw())[: self.shape[0]]
        route = "relsl" if self._merged_route() else "split"
        planes = (self._vals_plane(vals),) + self._planes(route)[1:]
        return _SPMM_FNS[route](*planes, Xt, **self._mat_kw())[
            : self.shape[0]]

    def bench_loop_mat(self, X: torch.Tensor,
                       iterations: int) -> torch.Tensor:
        """N SpMMs in ONE launch of the k-column bench kernel (K2 with k
        columns; merged word, resident y); returns the last Y. k > 1
        ignores ``SMVP_SELL_PACK`` and refuses under ``SMVP_SELL_RELSL=0``,
        as the JAX ``bench_loop_mat`` does."""
        if self.plan.y_block_slices:
            raise ValueError("bench_loop_mat requires a resident-y plan")
        if X.dim() != 2:
            raise ValueError(f"X must be (ncols, k), got {tuple(X.shape)}")
        if X.shape[1] == 1:
            return self.bench_loop(X[:, 0], iterations)[:, None]
        if self.base_route != "relsl" or not _relsl_on():
            raise ValueError("bench_loop_mat runs the relsl layout only")
        Xt = self._block(X, self.plan.n_coltiles * LANES, self.value_dtype,
                         "X")
        return sell_bench_spmm(*self._planes(), Xt, iterations=iterations,
                               **self._mat_kw())[: self.shape[0]]

    # -- training hooks ---------------------------------------------------

    def transpose(self) -> "SellSpMV":
        """The operator of Aᵀ, planned lazily from the stored triplets at
        chunk 2048 (``_auto_plan``), as the JAX operator plans it."""
        if self._t_op is None:
            if self._triplets is None:
                raise ValueError(
                    "transpose requires an operator built via from_coo"
                )
            r, c, v = self._triplets
            plan_t = _auto_plan(np.asarray(c), np.asarray(r), v,
                                (self.shape[1], self.shape[0]))
            self._t_op = SellSpMV(plan_t, value_dtype=self.value_dtype,
                                  device=self.device, triplets=(c, r, v))
        return self._t_op

    def slot_map(self) -> np.ndarray:
        """Flat slot index (into ``vals.reshape(-1)``) of each triplet.

        The slot layout depends only on (rows, cols), so a probe plan with
        values 1..nnz at the operator's chunk gives each triplet's slot.
        Cached; needs the stored triplets and a resident-y plan.
        """
        if self._slot_map is None:
            if self._triplets is None:
                raise ValueError(
                    "slot_map requires an operator built via from_coo"
                )
            if self.plan.y_block_slices:
                raise ValueError(
                    "slot_map/differentiable_edges need a resident-y "
                    "plan; streamed-y operators (> ~2M rows) train via "
                    "spmm_csr (ops/spmv_torch.py) instead"
                )
            r, c, _ = self._triplets
            nnz = len(r)
            if nnz >= (1 << 24):
                raise ValueError(
                    "slot_map probe ids must stay exact in f32 "
                    "(nnz < 2^24); train larger matrices through spmm_csr"
                )
            probe = np.arange(1, nnz + 1, dtype=np.float32)
            p = build_sell_plan(np.asarray(r), np.asarray(c), probe,
                                self.shape, chunk=self.plan.chunk)
            flat = p.vals.reshape(-1)
            nz = np.flatnonzero(flat)
            if len(nz) != nnz:
                raise RuntimeError("probe plan slot count mismatch")
            slot = np.empty(nnz, dtype=np.int64)
            slot[flat[nz].astype(np.int64) - 1] = nz
            self._slot_map = slot
        return self._slot_map

    def slot_index(self) -> torch.Tensor:
        """``slot_map()`` as an int64 tensor on the operator's device."""
        if self._slot_index is None:
            self._slot_index = torch.from_numpy(self.slot_map()).to(
                self.device)
        return self._slot_index

    def scatter_values(self, v: torch.Tensor) -> torch.Tensor:
        """A values plane from the nnz values ``v`` in triplet order; every
        other slot holds 0."""
        idx = self.slot_index()
        if v.dim() != 1 or v.shape[0] != idx.shape[0]:
            raise ValueError(f"v must hold the {idx.shape[0]} triplet "
                             f"values, got shape {tuple(v.shape)}")
        vals = torch.zeros(self.vals.numel(), dtype=self.value_dtype,
                           device=self.device)
        vals[idx] = v.detach().to(self.device, self.value_dtype)
        return vals.reshape(self.vals.shape)

    def vjp_vals(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Cotangent of y = A·x w.r.t. the values plane, (S, 128) float32:
        ``g[row(s, l)]·x[col(s, l)]`` on every slot of a live sublane, 0
        on dead ones (K7 with one column)."""
        return self.vjp_vals_mat(x.reshape(-1, 1), g.reshape(-1, 1))

    def vjp_vals_mat(self, X: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
        """Cotangent of Y = A·X w.r.t. the values plane, (S, 128) float32:
        ``Σ_j G[row(s, l), j]·X[col(s, l), j]`` in one K7 launch on the
        operator's cached schedule. X is rounded to the value dtype, G
        taken as float32."""
        if self.plan.y_block_slices:
            raise ValueError(
                "vals-grad needs a resident-y plan; streamed-y operators "
                "(> ~2M rows) train via spmm_csr (ops/spmv_torch.py) "
                "instead"
            )
        Xt = self._block(X, self.plan.n_coltiles * LANES, self.value_dtype,
                         "X")
        Gt = self._block(G, self.plan.n_slices * LANES, torch.float32, "G")
        return sell_vals_grad(self.lidx, self.tile_base, Xt, Gt,
                              relsl=self.relsl, rel=self.rel,
                              slice_of=self.slice_of,
                              schedule=self.vals_grad_schedule(),
                              **self._mat_kw())

    def differentiable(self):
        """``f(x) = A·x`` with a backward pass ``Aᵀ·g`` on the kernels."""
        return spmv_autograd.differentiable(self)

    def differentiable_mat(self):
        """``f(X) = A·X`` on the SpMM kernels, backward ``Aᵀ·G`` through
        the transpose operator's ``matmat``."""
        return spmv_autograd.differentiable_mat(self)

    def differentiable_edges(self):
        """``f(v, x) = A(v)·x``, differentiable in both; ``v`` holds the
        nnz values in triplet order."""
        return spmv_autograd.differentiable_edges(self)

    def differentiable_edges_mat(self):
        """``f(v, X) = A(v)·X``, differentiable in both: forward on the
        SpMM kernels, d/dX through the transpose, d/dv on K7."""
        return spmv_autograd.differentiable_edges_mat(self)

    def bench_loop_refusal(self) -> Optional[str]:
        """Why ``bench_loop`` refuses this operator now, or None: the
        packed route's K2-packed has no streamed-y form."""
        if self.packed_on() and self.plan.y_block_slices:
            return ("streamed-y bench_loop supports relsl/split-plane modes "
                    "(SMVP_SELL_PACK=1 has no streamed-y N-iteration kernel)")
        return None

    def bench_loop(self, x: torch.Tensor, iterations: int) -> torch.Tensor:
        """N SpMVs in ONE launch of the bench kernel of ``bench_route``;
        returns the last iteration's y. On the packed route that is
        K2-packed: a streamed plan raises there (``bench_loop_refusal``),
        as the JAX operator does, rather than fall back to the unpacked
        kernel. On ``subwin`` it is K2-subwin."""
        why = self.bench_loop_refusal()
        if why:
            raise ValueError(why)
        route = self.bench_route
        xt = self._x_tiles(x)
        if route in PACKED_ROUTES:
            y = sell_bench_packed(*self.packed_planes(), self.tile_base, xt,
                                  iterations=iterations, **self._kw())
        elif route == "subwin":
            stb, ssb, split, sub_wt, sub_nsw = self.subwin_windows()
            y = sell_bench_subwin(self.vals, self.lidx, self.relsl,
                                  self.tile_base, stb, ssb, xt,
                                  split=split, sub_wt=sub_wt,
                                  sub_nsw=sub_nsw, iterations=iterations,
                                  **self._kw())
        else:
            y = _ROUTE_FNS[route][1](*self._planes(route), xt,
                                     iterations=iterations, **self._kw())
        return y[: self.shape[0]]


# ---------------------------------------------------------------------------
# Format-level wrappers with per-matrix operator caching
# ---------------------------------------------------------------------------


def _auto_plan(rows, cols, vals, shape, chunk: int = 2048) -> SellPlan:
    """The plan at ``chunk``: flat while y fits ``_RESIDENT_Y_LIMIT``,
    streamed-y beyond it; the JAX package's ``_auto_plan``, field for
    field at every chunk.

    The operators plan through ``autotune.tuned_plan``, which prices
    this plan at the sweep's chunks on the card's cost model and keeps
    chunk 2048 unless a candidate is modelled ``autotune.MARGIN``
    cheaper; ``SMVP_SELL_AUTOTUNE=0`` and ``transpose()`` take it at
    chunk 2048, as in the JAX package.
    """
    with tracing.span("plan.sort"):
        if shape[0] * 4 > _RESIDENT_Y_LIMIT:  # NS·128·4 ≈ nrows·4 bytes
            return build_streamed_sell_plan(
                rows, cols, vals, shape, chunk=chunk,
                y_block_rows=_STREAM_Y_BLOCK_ROWS,
            )
        return build_sell_plan(rows, cols, vals, shape, chunk=chunk)


_CACHE: "weakref.WeakKeyDictionary[object, SellSpMV]" = (
    weakref.WeakKeyDictionary()
)


def _triplets_from_csr_host(csr):
    """Host (numpy) CSR → COO triplets."""
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col = csr.col_ind[: csr.nnz].cpu().numpy()
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(row_ptr))
    return rows, col, host_array(csr.vals[: csr.nnz]), csr.shape


def _triplets_from_tjds_host(tjds):
    """Host (numpy) TJDS → COO triplets, in the TJDS storage order (the
    decode of ``formats/tjds.py`` on the host)."""
    sp = tjds.start_pos.cpu().numpy().astype(np.int64)
    j = np.arange(tjds.nnz, dtype=np.int64)
    d = np.searchsorted(sp, j, side="right") - 1
    offset = j - sp[d]
    perm = tjds.perm.cpu().numpy()
    cols = perm[np.clip(offset, 0, max(tjds.ncols - 1, 0))]
    rows = tjds.row_ind[: tjds.nnz].cpu().numpy()
    return rows, cols, host_array(tjds.vals[: tjds.nnz]), tjds.shape


def _triplets_from_coo_host(coo):
    """Host (numpy) COO triplets, in storage order, padding dropped."""
    return (*coo.to_numpy(), coo.shape)


def _triplets_from_cisr_host(cisr):
    """Host CISR schedule → COO triplets (live cells only, in beat-major
    order: a channel emits a row's entries in CSR order, so the stable
    planner gives the CSR replan's plan)."""
    rows = np.asarray(cisr.row_of)
    mask = rows >= 0
    return (
        rows[mask].astype(np.int64),
        np.asarray(cisr.col_ind)[mask].astype(np.int64),
        np.asarray(cisr.vals)[mask],
        cisr.shape,
    )


def _cached_op(matrix, triplets_fn=_triplets_from_csr_host,
               device=None) -> SellSpMV:
    """Per-matrix operator cache keyed weakly: a collected matrix drops
    its operator and the operator's device planes with it. The operator
    lives on the matrix's device, or on ``device`` for a host matrix (a
    CISR schedule); a schedule asked for on another device is replanned
    there. The plan is the autotuned one (``autotune.tuned_plan``) for
    the matrix's value dtype."""
    op = _CACHE.get(matrix)
    if op is not None and (device is None or op.device == device):
        return op
    dev = resolve_device(matrix.device if device is None else device)
    if op is None or op.device != dev:
        r, c, v, shape = triplets_fn(matrix)
        # A bfloat16 matrix runs the kernels in bf16 value mode.
        vdt = (torch.bfloat16
               if getattr(matrix, "dtype", None) == torch.bfloat16
               else torch.float32)
        plan, cost = tuned_plan(r, c, v, shape,
                                bf16=vdt == torch.bfloat16)
        op = SellSpMV(plan, value_dtype=vdt, device=dev,
                      triplets=(r, c, v), plan_cost_us=cost)
        _CACHE[matrix] = op
    return op


def spmv_csr_sell(csr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from CSR via the SELL kernels (operator cached per matrix)."""
    return _cached_op(csr)(x)


def sell_op_csr(csr) -> SellSpMV:
    """The cached SELL operator for a CSR matrix."""
    return _cached_op(csr)


def spmv_tjds_sell(tjds, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from TJDS via the SELL kernels (operator cached per
    matrix): the TJDS triplets are replanned, so TJDS runs on whichever
    kernel its plan's route demands."""
    return _cached_op(tjds, _triplets_from_tjds_host)(x)


def sell_op_tjds(tjds) -> SellSpMV:
    """The cached SELL operator for a TJDS matrix."""
    return _cached_op(tjds, _triplets_from_tjds_host)


def spmv_coo_sell(coo, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from COO via the SELL kernels (operator cached per matrix),
    the JAX ``spmv_coo_pallas``: the triplets are planned in storage
    order, so a COO in CSR order runs CSR's plan."""
    return _cached_op(coo, _triplets_from_coo_host)(x)


def sell_op_coo(coo) -> SellSpMV:
    """The cached SELL operator for a COO matrix, the JAX
    ``sell_op_coo``: host planning and one upload, no CSR encode."""
    return _cached_op(coo, _triplets_from_coo_host)


def spmv_cisr_sell(cisr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from a CISR schedule via the SELL kernels, on x's device:
    the schedule's live cells are replanned into SELL (cached per
    schedule), so CISR runs on whichever kernel its plan's route demands,
    under the same ``SMVP_SELL_*`` switches as CSR. The schedule-faithful
    lane-per-channel SpMV is ``ops/spmv_cisr.py``."""
    return _cached_op(cisr, _triplets_from_cisr_host, x.device)(x)


def sell_op_cisr(cisr, device=None) -> SellSpMV:
    """The cached SELL operator for a CISR schedule on ``device``
    (default: the card)."""
    return _cached_op(cisr, _triplets_from_cisr_host, device)


class CoClusteredSellSpMV:
    """SELL-T1 operator on jointly co-clustered coordinates.

    The co-clustering planner (``ops/cocluster.py``) re-derives the
    row->slice and col->tile assignments jointly, which lifts occupancy
    (the linear factor of the kernels' slot rate) beyond what a
    natural-order plan reaches. The price is a coordinate change: the
    inner operator computes y' = A'·x' with x' = scatter(x, col_map) and
    y = y'[row_map].

    Fast path (solvers, benchmarks): stay in PERMUTED space through
    ``to_permuted`` / ``from_permuted`` at the boundaries and call
    ``inner`` or ``bench_loop`` (K2 on the permuted planes: K2-cocluster,
    or K2-packed under ``SMVP_SELL_PACK=1``). Convenience path:
    ``__call__`` takes and returns natural coordinates (one scatter and
    one gather on the device per call).

    ``chunk=None`` (the default, as in the JAX class) lets the card's
    autotuner pick the chunk on the permuted coordinates
    (``cocluster_plan``); an explicit chunk plans at it. ``cocluster_kw``
    pass through to ``cocluster``, which keeps its last results in the process,
    so the f32 and bf16 operators of one matrix share one refinement
    (minutes of host work for 10M non-zeros).
    """

    def __init__(self, coo, value_dtype: Optional[torch.dtype] = None,
                 chunk: Optional[int] = None, device=None, **cocluster_kw):
        from smvp_toolkit_tpu_torch.ops.cocluster import cocluster_plan

        r, c, v = coo.to_numpy()
        r, c = np.asarray(r, np.int64), np.asarray(c, np.int64)
        vdt = torch.float32 if value_dtype is None else value_dtype
        try:
            out = cocluster_plan(r, c, v, coo.shape, chunk=chunk,
                                 bf16=vdt == torch.bfloat16, **cocluster_kw)
        except _build.KernelBuildError as e:
            raise RuntimeError(
                "co-clustering needs csrc/cocluster.cpp built with the host "
                "C++ compiler: python -c \"from smvp_toolkit_tpu_torch.ops "
                "import _build; _build.build(['cocluster'])\""
            ) from e
        if out is None:
            raise ValueError("co-clustering needs a matrix with non-zeros")
        self.result, plan, _ = out
        self.shape = coo.shape  # NATURAL shape (inner.shape is padded)
        rm, cm = self.result.row_map, self.result.col_map
        self.inner = SellSpMV(plan, value_dtype=vdt,
                              device=coo.device if device is None else device,
                              triplets=(rm[r], cm[c], v))
        dev = self.inner.device
        self._col_map = torch.tensor(cm, device=dev)
        self._row_map = torch.tensor(rm, device=dev)

    @property
    def occupancy(self) -> float:
        return self.inner.plan.nnz / float(self.inner.plan.slots())

    def to_permuted(self, x: torch.Tensor) -> torch.Tensor:
        """Natural x -> permuted, padded x' (one scatter on the device)."""
        m_pad = self.result.shape_padded[1]
        out = torch.zeros((m_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[self._col_map] = x[: self.shape[1]]
        return out

    def from_permuted(self, y: torch.Tensor) -> torch.Tensor:
        """Permuted y' -> natural y (one gather on the device)."""
        return y[self._row_map]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.from_permuted(self.inner(self.to_permuted(x)))

    def bench_loop(self, x_permuted: torch.Tensor,
                   iterations: int) -> torch.Tensor:
        """N SpMVs in one launch in permuted coordinates (K2-cocluster):
        the inner operator's ``bench_loop``; y' in permuted order."""
        return self.inner.bench_loop(x_permuted, iterations)


def sell_op_coo_coclustered(coo, **kw) -> CoClusteredSellSpMV:
    """Co-clustered SELL operator for a COO matrix (host planning and
    refinement, then one upload)."""
    return CoClusteredSellSpMV(coo, **kw)
