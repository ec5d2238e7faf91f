"""SELL-T1 SpMV operator over the hand-written CUDA kernels.

Counterpart of the main-path part of the JAX package's
``ops/spmv_pallas.py``
(``relsl_plane_host``, ``SellSpMV``, ``_auto_plan``, ``_cached_op``,
``spmv_csr_pallas``/``sell_op_csr``, ``spmv_tjds_pallas``). The operator
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
  with k > 1, split planes): Y = A·X in one launch for all k columns;
* ``sell_bench_spmm`` (K2 with k > 1, merged word): N of those sweeps in
  one cooperative launch;
* ``sell_vals_grad`` (K7): the cotangent of the values plane, on either
  kind of planes.

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

Each wrapper launches its kernel for a CUDA tensor, or raises; only a
tensor that lies on the CPU goes to the plain PyTorch version beside it
(``<wrapper>_plain``). Each wrapper counts its launches in a plain integer
attribute, ``launches``, which the smoke test reads to show that the main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import weakref
from typing import Optional

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_tensor
from smvp_toolkit_tpu_torch.ops import _build, spmv_autograd
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
    "sell_spmm",
    "sell_spmm_plain",
    "sell_split_spmm",
    "sell_split_spmm_plain",
    "sell_bench_spmm",
    "sell_bench_spmm_plain",
    "sell_vals_grad",
    "sell_vals_grad_plain",
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
]

# Above this many bytes of y the JAX operator leaves its resident-y plan
# (``_RESIDENT_Y_LIMIT`` there, a TPU VMEM limit) for a streamed-y plan
# with y blocks of ``_STREAM_Y_BLOCK_ROWS`` rows. The card has no VMEM, but
# the port keeps the same cut so that both packages run the same plan and
# compare plan by plan.
_RESIDENT_Y_LIMIT = 8 * 2**20
_STREAM_Y_BLOCK_ROWS = 512 * LANES

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
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_VALS_GRAD_SIGNATURES = {
    "sell_vals_grad_launch": (ctypes.c_int, [
        ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _VP,
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


def _launch(route: str, *, vals, lidx, tile_base, x, n_slices: int,
            chunk: int, relsl=None, rel=None, slice_of=None,
            y_block_id=None, nsb: int = 0,
            iterations: Optional[int] = None) -> torch.Tensor:
    """One launch of the route's forward kernel (``iterations`` None) or
    its bench kernel; returns y (float32, ``n_slices * 128``)."""
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
        y = torch.empty(n_out, dtype=torch.float32, device=dev)
        rc = lib.sell_bench_launch(
            _ROUTE_IDS[route], *planes, x.data_ptr(), y.data_ptr(),
            vals.numel(), n_out, chunk, nsb, iterations, vk, lk, dev.index,
            stream)
        _check_rc(lib, rc, f"{name} cooperative launch")
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
    """K1: y = A·x over the SELL planes, y float32 of ``n_slices * 128``."""
    return _dispatch(sell_spmv, sell_spmv_plain, "relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk)


def sell_streamy_relsl(vals, lidx, relsl, tile_base, y_block_id, x, *,
                       n_slices: int, chunk: int, nsb: int) -> torch.Tensor:
    """K3-relsl: y = A·x, merged word, y in blocks of ``nsb`` slices."""
    return _dispatch(sell_streamy_relsl, sell_streamy_relsl_plain,
                     "streamy_relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb)


def sell_streamy(vals, lidx, rel, slice_of, tile_base, y_block_id, x, *,
                 n_slices: int, chunk: int, nsb: int) -> torch.Tensor:
    """K3-split: y = A·x, split planes, y in blocks of ``nsb`` slices."""
    return _dispatch(sell_streamy, sell_streamy_plain, "streamy",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb)


def sell_split(vals, lidx, rel, slice_of, tile_base, x, *, n_slices: int,
               chunk: int) -> torch.Tensor:
    """K4: y = A·x, split planes, resident y."""
    return _dispatch(sell_split, sell_split_plain, "split",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk)


def sell_bench_loop(vals, lidx, relsl, tile_base, x, *, n_slices: int,
                    chunk: int, iterations: int) -> torch.Tensor:
    """K2: ``iterations`` K1 SpMVs in one cooperative launch; the last y."""
    return _dispatch(sell_bench_loop, sell_bench_loop_plain, "relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk,
                     iterations=iterations)


def sell_bench_streamy_relsl(vals, lidx, relsl, tile_base, y_block_id, x, *,
                             n_slices: int, chunk: int, nsb: int,
                             iterations: int) -> torch.Tensor:
    """K2 on the streamed merged-word route: ``iterations`` K3-relsl SpMVs
    in one cooperative launch; the last y."""
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
    cooperative launch; the last y."""
    return _dispatch(sell_bench_streamy, sell_bench_streamy_plain, "streamy",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb,
                     iterations=iterations)


def sell_bench_split(vals, lidx, rel, slice_of, tile_base, x, *,
                     n_slices: int, chunk: int,
                     iterations: int) -> torch.Tensor:
    """K2 on the split route: ``iterations`` K4 SpMVs in one cooperative
    launch; the last y."""
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
        Y = torch.empty(n_slices * LANES, k, dtype=torch.float32, device=dev)
        rc = lib.sell_bench_spmm_launch(
            vals.data_ptr(), planes["lidx"].data_ptr(), meta.data_ptr(),
            planes["tile_base"].data_ptr(), X.data_ptr(), Y.data_ptr(),
            n_slots, Y.numel(), chunk, k, iterations, vk, lk, dev.index,
            stream)
    _check_rc(lib, rc, f"{wrapper.kernel} launch")
    wrapper.launches += 1
    return Y


def sell_spmm(vals, lidx, relsl, tile_base, X, *, n_slices: int,
              n_coltiles: int, chunk: int) -> torch.Tensor:
    """K1 with k columns: Y = A·X over the merged-word planes; X is (at
    least CT·128, k) in the value dtype, Y float32 (n_slices·128, k)."""
    return _spmm_dispatch(sell_spmm, sell_spmm_plain, "relsl",
                          dict(vals=vals, lidx=lidx, relsl=relsl,
                               tile_base=tile_base),
                          X, n_slices=n_slices, n_coltiles=n_coltiles,
                          chunk=chunk)


def sell_split_spmm(vals, lidx, rel, slice_of, tile_base, X, *,
                    n_slices: int, n_coltiles: int,
                    chunk: int) -> torch.Tensor:
    """K4 with k columns: Y = A·X over the split planes."""
    return _spmm_dispatch(sell_split_spmm, sell_split_spmm_plain, "split",
                          dict(vals=vals, lidx=lidx, rel=rel,
                               slice_of=slice_of, tile_base=tile_base),
                          X, n_slices=n_slices, n_coltiles=n_coltiles,
                          chunk=chunk)


def sell_bench_spmm(vals, lidx, relsl, tile_base, X, *, n_slices: int,
                    n_coltiles: int, chunk: int,
                    iterations: int) -> torch.Tensor:
    """K2 with k columns: ``iterations`` K1 SpMMs in one cooperative
    launch (merged word); the last Y."""
    return _spmm_dispatch(sell_bench_spmm, sell_bench_spmm_plain, "relsl",
                          dict(vals=vals, lidx=lidx, relsl=relsl,
                               tile_base=tile_base),
                          X, n_slices=n_slices, n_coltiles=n_coltiles,
                          chunk=chunk, iterations=iterations)


def sell_vals_grad(lidx, tile_base, X, G, *, n_slices: int, n_coltiles: int,
                   chunk: int, relsl=None, rel=None,
                   slice_of=None) -> torch.Tensor:
    """K7: the (S, 128) float32 cotangent of the values plane of Y = A·X
    for output cotangent G (float32, at least NS·128 rows, as many columns
    as X). It decodes whichever planes it is given: the merged ``relsl``
    word or the split ``rel`` and ``slice_of``."""
    planes = dict(lidx=lidx, tile_base=tile_base, relsl=relsl, rel=rel,
                  slice_of=slice_of)
    check_planes(**planes, chunk=chunk)
    dev = lidx.device
    k = check_block("X", X, rows=n_coltiles * LANES, dtypes=VALUE_DTYPES,
                    device=dev)
    if check_block("G", G, rows=n_slices * LANES, dtypes=(torch.float32,),
                   device=dev) != k:
        raise ValueError(f"X has {k} columns, G {G.shape[1]}")
    kw = dict(n_slices=n_slices, n_coltiles=n_coltiles, chunk=chunk)
    if dev.type == "cpu":
        return sell_vals_grad_plain(lidx, tile_base, X, G, relsl=relsl,
                                    rel=rel, slice_of=slice_of, **kw)
    if dev.type != "cuda":
        raise ValueError(
            f"the SELL kernels run on cuda tensors (got {dev}); only CPU "
            "tensors take the plain version"
        )
    vk, lk = _kinds(X, lidx)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("sell_vals_grad", _VALS_GRAD_SIGNATURES)
    out = torch.empty(lidx.shape, dtype=torch.float32, device=dev)
    route = "relsl" if relsl is not None else "split"
    rc = lib.sell_vals_grad_launch(
        _ROUTE_IDS[route], lidx.data_ptr(),
        (relsl if relsl is not None else rel).data_ptr(), _ptr(slice_of),
        tile_base.data_ptr(), X.data_ptr(), G.data_ptr(), out.data_ptr(),
        lidx.numel(), chunk, k, vk, lk, dev.index, stream)
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
        y = torch.empty(n_out, dtype=torch.float32, device=dev)
        rc = lib.sell_bench_packed_launch(*planes, x.data_ptr(), y.data_ptr(),
                                          n_slots, n_out, chunk, iterations,
                                          dev.index, stream)
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
    is (at least CT·128, k) bf16, Y float32 (n_slices·128, k)."""
    return _packed_dispatch(sell_packed_spmm, sell_packed_spmm_plain, packed,
                            slice_of, tile_base, X, n_slices=n_slices,
                            chunk=chunk, n_coltiles=n_coltiles)


def sell_bench_packed(packed, slice_of, tile_base, x, *, n_slices: int,
                      chunk: int, iterations: int) -> torch.Tensor:
    """K2-packed: ``iterations`` K5 SpMVs in one cooperative launch
    (resident y); the last y."""
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
                      device=None) -> int:
    """Blocks of one ``sell_bench_spmm_kernel`` launch on ``device`` (SMs ×
    co-resident blocks)."""
    dev = resolve_device(device)
    lib = _build.load("sell_spmm", _SPMM_SIGNATURES)
    out = ctypes.c_int(0)
    rc = lib.sell_bench_spmm_blocks(int(value_dtype == torch.bfloat16),
                                    int(lidx_dt == torch.int32), dev.index,
                                    ctypes.byref(out))
    _check_rc(lib, rc, "sell_bench_spmm_kernel occupancy query")
    return out.value


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


class SellSpMV:
    """Encoded SELL-T1 operator: ``y = op(x)`` through the route's kernel,
    on one device.

    Build once per matrix (host planning + one upload), call many times.
    ``value_dtype`` is float32 or bfloat16; in bf16 mode vals and x are
    stored as bf16 and products accumulate in float32, as in the JAX
    operator. Only the planes the route reads are uploaded: ``relsl`` on
    merged-word routes, ``rel`` and ``slice_of`` (int32 per sublane, -1 =
    dead) on split ones, ``y_block_id`` on streamed ones; the others are
    None. ``base_route`` is the plan's route; ``route`` is the route a call
    takes now: ``packed`` or ``streamy_packed`` while ``SMVP_SELL_PACK=1``
    and the packed gates pass (bf16 values, ``window_tiles <= 511``),
    whose planes (``packed_planes``) are built and uploaded at first use.

    ``triplets`` are the host (rows, cols, values) the plan was built
    from, kept for the training hooks: ``transpose`` plans Aᵀ from them
    and ``slot_map`` finds each triplet's slot. ``from_coo`` and the CSR
    and TJDS caches pass them.
    """

    def __init__(self, plan: SellPlan, value_dtype: Optional[torch.dtype] = None,
                 device=None, *, triplets=None):
        self.device = resolve_device(device)
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
        self.kernel, self.bench_kernel = _ROUTE_FNS[self.base_route]
        self.spmm_kernel = _SPMM_FNS.get(self.base_route)
        self._packed: Optional[tuple] = None
        self._triplets = triplets
        self._t_op: Optional[SellSpMV] = None
        self._slot_map: Optional[np.ndarray] = None
        self._slot_index: Optional[torch.Tensor] = None

    def packed_on(self, vals: Optional[torch.Tensor] = None) -> bool:
        """Whether a call takes the packed route: ``SMVP_SELL_PACK=1``,
        bf16 values, a window that fits the 9-bit rel field, and the
        operator's own values plane (a ``vals`` plane passed by the
        training hooks never does), the JAX operator's gates."""
        return (os.environ.get("SMVP_SELL_PACK") == "1"
                and self.value_dtype == torch.bfloat16
                and self.plan.window_tiles <= REL_DEAD
                and vals is None)

    @property
    def route(self) -> str:
        """The route a call takes now (class docstring)."""
        if self.packed_on():
            return PACKED_ROUTES[int(bool(self.plan.y_block_slices))]
        return self.base_route

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

    @staticmethod
    def from_coo(coo, value_dtype: Optional[torch.dtype] = None,
                 device=None) -> "SellSpMV":
        r, c, v = coo.to_numpy()
        return SellSpMV(_auto_plan(r, c, v, coo.shape),
                        value_dtype=value_dtype,
                        device=coo.device if device is None else device,
                        triplets=(r, c, v))

    def _x_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """x cast to the value dtype and zero-padded to CT·128."""
        if x.device != self.device:
            raise ValueError(
                f"x is on {x.device}, the operator on {self.device}"
            )
        ncols_pad = self.plan.n_coltiles * LANES
        x = x.reshape(-1)
        if x.shape[0] > ncols_pad:
            raise ValueError(f"x has {x.shape[0]} entries, the matrix "
                             f"{self.shape[1]} columns")
        out = torch.zeros(ncols_pad, dtype=self.value_dtype, device=x.device)
        out[: x.shape[0]] = x.to(self.value_dtype)
        return out

    def _planes(self):
        """The route's planes, in its wrappers' positional order."""
        return tuple(t for t in (self.vals, self.lidx, self.relsl, self.rel,
                                 self.slice_of, self.tile_base,
                                 self.y_block_id) if t is not None)

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
        """The values plane, or ``vals`` in its place, in the value dtype."""
        if vals is None:
            return self.vals
        if vals.device != self.device or vals.numel() != self.vals.numel():
            raise ValueError(
                f"vals must hold {self.vals.numel()} slots on "
                f"{self.device}, got {vals.numel()} on {vals.device}"
            )
        return vals.detach().reshape(self.vals.shape).to(
            self.value_dtype).contiguous()

    def _mat_kw(self):
        return dict(n_slices=self.plan.n_slices,
                    n_coltiles=self.plan.n_coltiles, chunk=self.plan.chunk)

    def _apply(self, x: torch.Tensor,
               vals: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.packed_on(vals):
            y = sell_packed(*self.packed_planes(), self.tile_base,
                            self._x_tiles(x), y_block_id=self.y_block_id,
                            **self._kw())
            return y[: self.shape[0]]
        planes = (self._vals_plane(vals),) + self._planes()[1:]
        y = self.kernel(*planes, self._x_tiles(x), **self._kw())
        return y[: self.shape[0]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(x)

    def matmat(self, X: torch.Tensor,
               vals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Y = A·X for a dense block X (ncols, k); Y float32 (nrows, k).

        k == 1 is one SpMV (``__call__``). A resident-y plan runs one
        k-wide launch of its route's SpMM kernel (K1 or K4 with k
        columns, or K5 with k columns on the packed route); a streamed-y
        plan runs column by column on its K3 (or K5) kernel. X is rounded
        to the value dtype first (bf16 mode rounds it to bf16, as the JAX
        operator does). ``vals`` (S·128 values in
        the planner's slot order) replaces the values plane for this
        call, as the trainable-edge path needs.
        """
        if X.dim() != 2:
            raise ValueError(f"X must be (ncols, k), got {tuple(X.shape)}")
        k = int(X.shape[1])
        if k == 1:
            return self._apply(X[:, 0], vals)[:, None]
        if self.spmm_kernel is None:  # streamed y: per column
            return torch.stack([self._apply(X[:, j], vals)
                                for j in range(k)], dim=1)
        Xt = self._block(X, self.plan.n_coltiles * LANES, self.value_dtype,
                         "X")
        if self.packed_on(vals):
            return sell_packed_spmm(*self.packed_planes(), self.tile_base, Xt,
                                    **self._mat_kw())[: self.shape[0]]
        planes = (self._vals_plane(vals),) + self._planes()[1:]
        return self.spmm_kernel(*planes, Xt, **self._mat_kw())[
            : self.shape[0]]

    def bench_loop_mat(self, X: torch.Tensor,
                       iterations: int) -> torch.Tensor:
        """N SpMMs in ONE launch of the k-column bench kernel (K2 with k
        columns; merged word, resident y); returns the last Y. k > 1
        ignores ``SMVP_SELL_PACK``, as the JAX ``bench_loop_mat`` does."""
        if self.plan.y_block_slices:
            raise ValueError("bench_loop_mat requires a resident-y plan")
        if X.dim() != 2:
            raise ValueError(f"X must be (ncols, k), got {tuple(X.shape)}")
        if X.shape[1] == 1:
            return self.bench_loop(X[:, 0], iterations)[:, None]
        if self.base_route != "relsl":
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
        ``Σ_j G[row(s, l), j]·X[col(s, l), j]`` in one K7 launch. X is
        rounded to the value dtype, G taken as float32."""
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
                              slice_of=self.slice_of, **self._mat_kw())

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
        """N SpMVs in ONE launch of the route's bench kernel; returns the
        last iteration's y. On the packed route that is K2-packed: a
        streamed plan raises there (``bench_loop_refusal``), as the JAX
        operator does, rather than fall back to the unpacked kernel."""
        why = self.bench_loop_refusal()
        if why:
            raise ValueError(why)
        if self.packed_on():
            y = sell_bench_packed(*self.packed_planes(), self.tile_base,
                                  self._x_tiles(x), iterations=iterations,
                                  **self._kw())
            return y[: self.shape[0]]
        y = self.bench_kernel(*self._planes(), self._x_tiles(x),
                              iterations=iterations, **self._kw())
        return y[: self.shape[0]]


# ---------------------------------------------------------------------------
# Format-level wrappers with per-matrix operator caching
# ---------------------------------------------------------------------------


def _auto_plan(rows, cols, vals, shape, chunk: int = 2048) -> SellPlan:
    """The plan at chunk 2048: flat while y fits ``_RESIDENT_Y_LIMIT``,
    streamed-y beyond it.

    This is the JAX package's ``_auto_plan``, which its operator uses
    under ``SMVP_SELL_AUTOTUNE=0``. By default the JAX operator autotunes
    the chunk per matrix (``_tuned_plan``); the port has no autotuner yet,
    so its plan equals the JAX default plan only where the autotuner also
    picks chunk 2048. Both give the same y within tolerance.
    """
    if shape[0] * 4 > _RESIDENT_Y_LIMIT:  # NS·128·4 ≈ nrows·4 bytes
        return build_streamed_sell_plan(
            rows, cols, vals, shape, chunk=chunk,
            y_block_rows=_STREAM_Y_BLOCK_ROWS,
        )
    return build_sell_plan(rows, cols, vals, shape, chunk=chunk)


_CACHE: "weakref.WeakKeyDictionary[object, SellSpMV]" = (
    weakref.WeakKeyDictionary()
)


def _host_vals(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _triplets_from_csr_host(csr):
    """Host (numpy) CSR → COO triplets."""
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col = csr.col_ind[: csr.nnz].cpu().numpy()
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(row_ptr))
    return rows, col, _host_vals(csr.vals[: csr.nnz]), csr.shape


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
    return rows, cols, _host_vals(tjds.vals[: tjds.nnz]), tjds.shape


def _cached_op(matrix, triplets_fn=_triplets_from_csr_host) -> SellSpMV:
    """Per-matrix operator cache keyed weakly: a collected matrix drops
    its operator and the operator's device planes with it."""
    op = _CACHE.get(matrix)
    if op is None:
        r, c, v, shape = triplets_fn(matrix)
        # A bfloat16 matrix runs the kernels in bf16 value mode.
        vdt = (torch.bfloat16 if matrix.dtype == torch.bfloat16
               else torch.float32)
        op = SellSpMV(_auto_plan(r, c, v, shape), value_dtype=vdt,
                      device=matrix.device, triplets=(r, c, v))
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
