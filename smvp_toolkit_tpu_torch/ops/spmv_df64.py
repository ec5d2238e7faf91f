"""Double-float SpMV on the SELL planes: float64-class accuracy on the card.

Counterpart of the JAX package's ``ops/spmv_df64.py``. ``SellDf64SpMV``
holds a resident-y SELL plan whose values are a float32 pair: ``vals_hi``
(the plan's values) and ``vals_lo`` (the low words of float64 values,
planned over the same coordinates), and returns ``(y_hi, y_lo) ≈
A·(x_hi + x_lo)``. Two kernels of ``csrc/sell_df64.cu`` carry it:

* ``sell_df64`` (K8, ``sell_df64_kernel``): one SpMV;
* ``sell_bench_df64`` (``sell_bench_df64_kernel``): N of them in one
  cooperative launch, the last pair returned, bit for bit equal to one
  call.

The TPU kernel reaches double-float accuracy through exact bf16
expansions and quantized MXU sums; the card has float64, so the kernel
takes each product and row sum in float64 (exact products, one rounding
per cross term and per add) in a fixed order, one thread per row walking
its slice's live sublanes through a host-built index (``slice_index``).
A block stages each slice's index entries once in shared memory (the
sublane and its x tile, ``tile_base[s / chunk] + rel``) and its threads
walk them a few steps at a time, so each step's loads are independent;
the order of the adds is the index's. The plain version
(``sell_df64_plain``) is the same function in float64 PyTorch over the
same planes and index, in the same order.

Each wrapper launches its kernel for CUDA tensors, or raises; only CPU
tensors take the plain version. Each counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_tensor
from smvp_toolkit_tpu_torch.ops import _build
from smvp_toolkit_tpu_torch.ops.plan_checks import check_planes
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    build_sell_plan,
)
from smvp_toolkit_tpu_torch.ops.spmv_sell import (
    _check_rc,
    _decode_word,
    _launch_device,
    _repeat,
    lidx_dtype,
    relsl_plane_host,
)
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = [
    "SellDf64SpMV",
    "sell_df64_op",
    "slice_index",
    "sell_df64",
    "sell_df64_plain",
    "sell_bench_df64",
    "sell_bench_df64_plain",
    "bench_df64_blocks",
    "DF64_KERNELS",
]

Pair = Tuple[torch.Tensor, torch.Tensor]


def slice_index(plan: SellPlan) -> Tuple[np.ndarray, np.ndarray]:
    """``(slice_ptr, sublanes)``, int32: the live sublanes of each slice in
    plan order, ``sublanes[slice_ptr[s]:slice_ptr[s + 1]]`` for slice s
    (dead sublanes left out)."""
    rel = plan.rel_tile.reshape(-1)
    sl = plan.slice_of.reshape(-1)
    live = np.flatnonzero((rel >= 0) & (sl >= 0))
    order = np.argsort(sl[live], kind="stable")
    sublanes = live[order]
    ptr = np.zeros(plan.n_slices + 1, dtype=np.int64)
    np.cumsum(np.bincount(sl[live], minlength=plan.n_slices), out=ptr[1:])
    return ptr.astype(np.int32), sublanes.astype(np.int32)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------


def sell_df64_plain(vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr,
                    sublanes, x_hi, x_lo, *, n_slices: int,
                    chunk: int) -> Pair:
    """K8's function in float64 PyTorch, in K8's order: each slot's
    ``vh·xh + e`` with ``e = vh·xl (+ vl·xh + vl·xl)`` (``vals_lo`` may be
    None), each row's sum taken left to right over its slice's live
    sublanes in the index's order (one vectorized add per position), each
    row split once into the float32 pair. Every operation rounds on its
    own, as the kernel's intrinsics do, so the two agree bit for bit."""
    rel, _ = _decode_word(relsl)
    s = sublanes.long()
    col = ((tile_base.long()[s // chunk] + rel[s]) * LANES)[:, None] \
        + lidx[s].long()
    vh = vals_hi[s].double()
    gh = x_hi.double()[col]
    gl = x_lo.double()[col]
    e = vh * gl
    if vals_lo is not None:
        vl = vals_lo[s].double()
        e = e + vl * gh
        e = e + vl * gl
    prod = vh * gh + e
    ptr = slice_ptr.long()
    count = ptr[1:] - ptr[:-1]
    acc = torch.zeros(n_slices, LANES, dtype=torch.float64,
                      device=x_hi.device)
    for k in range(int(count.max()) if n_slices else 0):
        rows = (count > k).nonzero().squeeze(1)
        acc[rows] = acc[rows] + prod[ptr[rows] + k]
    y = acc.reshape(-1)
    hi = y.float()
    return hi, (y - hi.double()).float()


def sell_bench_df64_plain(*args, iterations: int, **kw) -> Pair:
    """The N-iteration kernel's function: ``iterations`` fresh K8 SpMVs,
    the last pair."""
    return _repeat(sell_df64_plain, iterations, *args, **kw)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_PLANES = [_VP] * 11  # vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr,
#                       sublanes, x_hi, x_lo, y_hi, y_lo
_SIGNATURES = {
    "sell_df64_launch": (ctypes.c_int, _PLANES + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP]),
    "sell_bench_df64_launch": (ctypes.c_int, _PLANES + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP]),
    "sell_bench_df64_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check(vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr, sublanes,
           x_hi, x_lo, *, n_slices: int, chunk: int) -> None:
    """The planes as ``check_planes`` takes them, plus the float32 lo
    plane, the index and the x pair."""
    if vals_hi.dtype != torch.float32:
        raise TypeError(f"vals_hi must be float32, got {vals_hi.dtype}")
    check_planes(vals=vals_hi, lidx=lidx, relsl=relsl, tile_base=tile_base,
                 x=x_hi, chunk=chunk)
    named = dict(vals_lo=vals_lo, x_lo=x_lo, slice_ptr=slice_ptr,
                 sublanes=sublanes)
    for name, t in named.items():
        if t is None:
            continue
        if not t.is_contiguous() or t.device != vals_hi.device:
            raise ValueError(f"{name} must be contiguous, on "
                             f"{vals_hi.device}")
    if vals_lo is not None and (vals_lo.dtype != torch.float32
                                or vals_lo.shape != vals_hi.shape):
        raise ValueError("vals_lo must be float32 of the vals_hi shape")
    if x_lo.dtype != torch.float32 or x_lo.shape != x_hi.shape:
        raise ValueError("x_lo must be float32 of the x_hi shape")
    if slice_ptr.dtype != torch.int32 or sublanes.dtype != torch.int32:
        raise TypeError("slice_ptr and sublanes must be int32")
    if slice_ptr.numel() != n_slices + 1:
        raise ValueError(f"slice_ptr has {slice_ptr.numel()} entries, the "
                         f"plan {n_slices} slices")


def _dispatch(wrapper, plain, planes, *, n_slices: int, chunk: int,
              iterations: Optional[int] = None) -> Pair:
    if iterations is not None and iterations < 1:
        raise ValueError("iterations must be >= 1")
    _check(*planes, n_slices=n_slices, chunk=chunk)
    vals_hi = planes[0]
    kw = dict(n_slices=n_slices, chunk=chunk)
    if vals_hi.device.type == "cpu":
        if iterations is not None:
            kw["iterations"] = iterations
        return plain(*planes, **kw)
    dev = _launch_device(vals_hi)
    lib = _build.load("sell_df64", _SIGNATURES)
    n_rows = n_slices * LANES
    y_hi = torch.empty(n_rows, dtype=torch.float32, device=dev)
    y_lo = torch.empty(n_rows, dtype=torch.float32, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in planes]
    lk = int(planes[2].dtype == torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if iterations is None:
        rc = lib.sell_df64_launch(*ptrs, y_hi.data_ptr(), y_lo.data_ptr(),
                                  n_rows, chunk, lk, dev.index, stream)
    else:
        rc = lib.sell_bench_df64_launch(*ptrs, y_hi.data_ptr(),
                                        y_lo.data_ptr(), n_rows, chunk,
                                        iterations, lk, dev.index, stream)
    _check_rc(lib, rc, f"{wrapper.kernel} launch")
    wrapper.launches += 1
    return y_hi, y_lo


def sell_df64(vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr, sublanes,
              x_hi, x_lo, *, n_slices: int, chunk: int) -> Pair:
    """K8: ``(y_hi, y_lo)``, float32 of ``n_slices * 128`` each, ≈ A·(x_hi
    + x_lo) over the planes (``vals_lo`` None: no lo plane)."""
    return _dispatch(sell_df64, sell_df64_plain,
                     (vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr,
                      sublanes, x_hi, x_lo),
                     n_slices=n_slices, chunk=chunk)


def sell_bench_df64(vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr,
                    sublanes, x_hi, x_lo, *, n_slices: int, chunk: int,
                    iterations: int) -> Pair:
    """``iterations`` K8 SpMVs in one cooperative launch; the last pair."""
    return _dispatch(sell_bench_df64, sell_bench_df64_plain,
                     (vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr,
                      sublanes, x_hi, x_lo),
                     n_slices=n_slices, chunk=chunk, iterations=iterations)


# The wrappers by kernel name, each with its launch counter.
DF64_KERNELS = {
    "sell_df64_kernel": sell_df64,
    "sell_bench_df64_kernel": sell_bench_df64,
}
for _name, _fn in DF64_KERNELS.items():
    _fn.kernel = _name
    _fn.launches = 0


def bench_df64_blocks(lidx_dt: torch.dtype, device=None) -> int:
    """Blocks of one ``sell_bench_df64_kernel`` launch on ``device``."""
    dev = resolve_device(device)
    lib = _build.load("sell_df64", _SIGNATURES)
    out = ctypes.c_int(0)
    rc = lib.sell_bench_df64_blocks(int(lidx_dt == torch.int32), dev.index,
                                    ctypes.byref(out))
    _check_rc(lib, rc, "sell_bench_df64_kernel occupancy query")
    return out.value


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


class SellDf64SpMV:
    """Double-float SELL operator: ``y_hi, y_lo = op(x_hi, x_lo)``.

    Built from float64 host values (split into hi/lo float32 planes) or
    float32 values (lo plane elided, ``vals_lo is None``). The plan must be
    resident-y with a window of at most 511 tiles (the merged rel‖slice
    word), as in the JAX package. Runs on the card unless ``device="cpu"``.
    """

    def __init__(self, plan: SellPlan, vals_lo: Optional[np.ndarray] = None,
                 device=None):
        if plan.y_block_slices:
            raise ValueError("df64 kernel requires a resident-y plan")
        if not plan.merged_word:  # WT <= 511 and NS below the dead id
            raise ValueError("window too wide for the rel-slice packing")
        self.device = dev = resolve_device(device)
        self.plan = plan
        self.shape = plan.shape

        def upload(a, dtype=np.int32):
            return host_tensor(np.ascontiguousarray(a), dtype).to(dev)

        self.vals_hi = upload(plan.vals, np.float32)
        self.vals_lo = (None if vals_lo is None
                        else upload(np.asarray(vals_lo).reshape(
                            plan.vals.shape), np.float32))
        self.lidx = upload(plan.lane_idx).to(lidx_dtype(plan.chunk))
        self.relsl = upload(relsl_plane_host(plan).reshape(-1))
        self.tile_base = upload(plan.tile_base)
        ptr, sub = slice_index(plan)
        self.slice_ptr, self.sublanes = upload(ptr), upload(sub)

    @staticmethod
    def from_coo_f64(rows, cols, vals64, shape, chunk: int = 2048,
                     device=None) -> "SellDf64SpMV":
        """Build from float64 triplets: the hi plane from the float32
        rounding, the lo plane through a second planner pass over the same
        coordinates (the planner is deterministic, so the slots match bit
        for bit); no lo plane when every low word is zero."""
        vals64 = np.asarray(vals64, np.float64)
        hi = vals64.astype(np.float32)
        lo = (vals64 - hi.astype(np.float64)).astype(np.float32)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        plan = build_sell_plan(rows, cols, hi, shape, chunk=chunk)
        vals_lo = None
        if np.any(lo):
            plan_lo = build_sell_plan(rows, cols, lo, shape, chunk=chunk)
            if plan_lo.vals.shape != plan.vals.shape:
                raise RuntimeError("the lo plan's slots differ from the hi "
                                   "plan's")
            vals_lo = plan_lo.vals
        return SellDf64SpMV(plan, vals_lo=vals_lo, device=device)

    def _padded_x(self, x_hi: torch.Tensor,
                  x_lo: Optional[torch.Tensor]) -> Pair:
        """The x pair as float32, zero-padded to CT·128 (no x_lo: zeros)."""
        n_pad = self.plan.n_coltiles * LANES

        def pad(t):
            if t.device != self.device:
                raise ValueError(f"x is on {t.device}, the operator on "
                                 f"{self.device}")
            t = t.reshape(-1)
            if t.shape[0] > n_pad:
                raise ValueError(f"x has {t.shape[0]} entries, the matrix "
                                 f"{self.shape[1]} columns")
            out = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
            out[: t.shape[0]] = t.float()
            return out

        xh = pad(x_hi)
        return xh, (torch.zeros_like(xh) if x_lo is None else pad(x_lo))

    def _planes(self, x_hi, x_lo):
        return (self.vals_hi, self.vals_lo, self.lidx, self.relsl,
                self.tile_base, self.slice_ptr, self.sublanes,
                *self._padded_x(x_hi, x_lo))

    def _trim(self, pair: Pair) -> Pair:
        n = self.shape[0]
        return pair[0][:n], pair[1][:n]

    def __call__(self, x_hi: torch.Tensor,
                 x_lo: Optional[torch.Tensor] = None) -> Pair:
        return self._trim(sell_df64(*self._planes(x_hi, x_lo),
                                    n_slices=self.plan.n_slices,
                                    chunk=self.plan.chunk))

    def bench_loop(self, x_hi: torch.Tensor, x_lo: Optional[torch.Tensor],
                   iterations: int) -> Pair:
        """N SpMVs in ONE launch of the N-iteration kernel (the pair
        recomputed each iteration, the planes re-read); returns the last
        pair, bit for bit equal to one call."""
        return self._trim(sell_bench_df64(*self._planes(x_hi, x_lo),
                                          n_slices=self.plan.n_slices,
                                          chunk=self.plan.chunk,
                                          iterations=iterations))

    def traffic_bytes(self) -> int:
        """Device-memory bytes of one K8 launch, each input read once and
        each output written once: ``vals_hi`` (and ``vals_lo``) and the
        lane plane per slot, the merged word per sublane, ``tile_base``
        per chunk, the slice index (one word per live sublane and per
        slice), the x pair and the y pair."""
        plan = self.plan
        slots = plan.n_sublanes * LANES
        planes = 4 if self.vals_lo is None else 8
        return int(
            slots * (planes + self.lidx.element_size())
            + plan.n_sublanes * 4 + plan.n_chunks * 4
            + self.sublanes.numel() * 4 + self.slice_ptr.numel() * 4
            + 2 * plan.n_coltiles * LANES * 4
            + 2 * plan.n_slices * LANES * 4
        )


def sell_df64_op(coo, chunk: int = 2048) -> SellDf64SpMV:
    """The df64 SELL operator of a COO matrix (its values taken in
    float64), on the COO's device."""
    r, c, v = coo.to_numpy()
    return SellDf64SpMV.from_coo_f64(r, c, v, coo.shape, chunk=chunk,
                                     device=coo.device)
