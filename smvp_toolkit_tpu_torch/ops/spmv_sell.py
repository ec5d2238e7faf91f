"""SELL-T1 SpMV operator over the hand-written CUDA kernels.

Counterpart of the main-path part of the JAX package's
``ops/spmv_pallas.py``
(``relsl_plane_host``, ``SellSpMV``, ``_auto_plan``, ``_cached_op``,
``spmv_csr_pallas``/``sell_op_csr``). Two kernels from
``csrc/sell_spmv.cu`` carry it:

* ``sell_spmv`` launches K1 (``sell_spmv_kernel``), one y = A·x;
* ``sell_bench_loop`` launches K2 (``sell_bench_kernel``), N SpMVs in one
  cooperative launch, returning the last y.

Each wrapper launches its kernel for a CUDA tensor, or raises; only a
tensor that lies on the CPU goes to the plain PyTorch version beside it
(``sell_spmv_plain``, ``sell_bench_loop_plain``). Each wrapper counts its
launches in a plain integer attribute, ``launches``, which the smoke test
reads to show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_tensor
from smvp_toolkit_tpu_torch.ops import _build
from smvp_toolkit_tpu_torch.ops.plan_checks import (
    REL_DEAD,
    SLICE_DEAD,
    SLICE_SHIFT,
    check_plan,
    check_planes,
)
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    build_sell_plan,
    lidx_bytes_for_chunk,
)
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = [
    "SellSpMV",
    "relsl_plane_host",
    "lidx_dtype",
    "sell_spmv",
    "sell_spmv_plain",
    "sell_bench_loop",
    "sell_bench_loop_plain",
    "bench_blocks",
    "spmv_csr_sell",
    "sell_op_csr",
]

# Rows above which y no longer fits the resident-y plan on the TPU
# (``_RESIDENT_Y_LIMIT`` there): the JAX operator switches to streamed-y
# plans, whose kernel (K3) the port does not have yet. The same cut keeps
# both packages on the same plan, so they compare plan by plan.
_RESIDENT_Y_LIMIT = 8 * 2**20


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


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------


def sell_spmv_plain(vals, lidx, relsl, tile_base, x, *, n_slices: int,
                    chunk: int) -> torch.Tensor:
    """K1's function in plain PyTorch: direct gather, ``index_add_`` reduce.

    Returns y as float32 of length ``n_slices * 128``. Values and x are
    read in their storage dtype and multiplied in float32.
    """
    word = relsl.reshape(-1).long() & 0xFFFFFFFF
    rel = word & REL_DEAD
    sl = word >> SLICE_SHIFT
    live = ((rel != REL_DEAD) & (sl != SLICE_DEAD)).nonzero().squeeze(1)
    tile = tile_base.long()[live // chunk] + rel[live]
    col = (tile * LANES)[:, None] + lidx[live].long()
    prod = vals[live].float() * x.reshape(-1)[col].float()
    row = (sl[live] * LANES)[:, None] + torch.arange(LANES, device=x.device)
    y = torch.zeros(n_slices * LANES, dtype=torch.float32, device=x.device)
    return y.index_add_(0, row.reshape(-1), prod.reshape(-1))


def sell_bench_loop_plain(vals, lidx, relsl, tile_base, x, *,
                          n_slices: int, chunk: int,
                          iterations: int) -> torch.Tensor:
    """K2's function in plain PyTorch: ``iterations`` fresh SpMVs, last y."""
    y = None
    for _ in range(iterations):
        y = sell_spmv_plain(vals, lidx, relsl, tile_base, x,
                            n_slices=n_slices, chunk=chunk)
    return y


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_SIGNATURES = {
    "sell_spmv_launch": (ctypes.c_int, [
        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_bench_launch": (ctypes.c_int, [
        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _VP,
    ]),
    "sell_bench_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib() -> ctypes.CDLL:
    return _build.load("sell_spmv", _SIGNATURES)


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


def sell_spmv(vals, lidx, relsl, tile_base, x, *, n_slices: int,
              chunk: int) -> torch.Tensor:
    """K1: y = A·x over the SELL planes, y float32 of ``n_slices * 128``."""
    check_planes(vals=vals, lidx=lidx, relsl=relsl, tile_base=tile_base,
                 x=x, chunk=chunk)
    if vals.device.type == "cpu":
        return sell_spmv_plain(vals, lidx, relsl, tile_base, x,
                               n_slices=n_slices, chunk=chunk)
    dev = _launch_device(vals)
    lib = _lib()
    y = torch.zeros(n_slices * LANES, dtype=torch.float32, device=dev)
    vk, lk = _kinds(vals, lidx)
    rc = lib.sell_spmv_launch(
        vals.data_ptr(), lidx.data_ptr(), relsl.data_ptr(),
        tile_base.data_ptr(), x.data_ptr(), y.data_ptr(), vals.numel(),
        chunk, vk, lk, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_rc(lib, rc, "sell_spmv_kernel launch")
    sell_spmv.launches += 1
    return y


sell_spmv.launches = 0


def sell_bench_loop(vals, lidx, relsl, tile_base, x, *, n_slices: int,
                    chunk: int, iterations: int) -> torch.Tensor:
    """K2: ``iterations`` SpMVs in one cooperative launch; the last y."""
    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    check_planes(vals=vals, lidx=lidx, relsl=relsl, tile_base=tile_base,
                 x=x, chunk=chunk)
    if vals.device.type == "cpu":
        return sell_bench_loop_plain(vals, lidx, relsl, tile_base, x,
                                     n_slices=n_slices, chunk=chunk,
                                     iterations=iterations)
    dev = _launch_device(vals)
    lib = _lib()
    y = torch.empty(n_slices * LANES, dtype=torch.float32, device=dev)
    vk, lk = _kinds(vals, lidx)
    rc = lib.sell_bench_launch(
        vals.data_ptr(), lidx.data_ptr(), relsl.data_ptr(),
        tile_base.data_ptr(), x.data_ptr(), y.data_ptr(), vals.numel(),
        y.numel(), chunk, iterations, vk, lk, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_rc(lib, rc, "sell_bench_kernel cooperative launch")
    sell_bench_loop.launches += 1
    return y


sell_bench_loop.launches = 0


def bench_blocks(value_dtype: torch.dtype, lidx_dt: torch.dtype,
                 device=None) -> int:
    """Blocks of one K2 launch on ``device`` (SMs × co-resident blocks)."""
    dev = resolve_device(device)
    lib = _lib()
    out = ctypes.c_int(0)
    rc = lib.sell_bench_blocks(int(value_dtype == torch.bfloat16),
                               int(lidx_dt == torch.int32), dev.index,
                               ctypes.byref(out))
    _check_rc(lib, rc, "sell_bench_kernel occupancy query")
    return out.value


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


class SellSpMV:
    """Encoded SELL-T1 operator: ``y = op(x)`` through K1, on one device.

    Build once per matrix (host planning + one upload), call many times.
    ``value_dtype`` is float32 or bfloat16; in bf16 mode vals and x are
    stored as bf16 and products accumulate in float32, as in the JAX
    operator.
    """

    def __init__(self, plan: SellPlan, value_dtype: Optional[torch.dtype] = None,
                 device=None):
        self.device = resolve_device(device)
        check_plan(plan)
        self.value_dtype = torch.float32 if value_dtype is None else value_dtype
        if self.value_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("value_dtype must be float32 or bfloat16")
        self.plan = plan
        self.shape = plan.shape
        dev = self.device
        self.vals = host_tensor(plan.vals, np.float32).to(
            self.value_dtype).to(dev)
        self.lidx = host_tensor(plan.lane_idx, np.int32).to(
            lidx_dtype(plan.chunk)).to(dev)
        self.relsl = host_tensor(relsl_plane_host(plan).reshape(-1),
                                 np.int32).to(dev)
        self.tile_base = host_tensor(plan.tile_base, np.int32).to(dev)

    @staticmethod
    def from_coo(coo, value_dtype: Optional[torch.dtype] = None,
                 device=None) -> "SellSpMV":
        r, c, v = coo.to_numpy()
        return SellSpMV(_auto_plan(r, c, v, coo.shape),
                        value_dtype=value_dtype,
                        device=coo.device if device is None else device)

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
        return (self.vals, self.lidx, self.relsl, self.tile_base)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = sell_spmv(*self._planes(), self._x_tiles(x),
                      n_slices=self.plan.n_slices, chunk=self.plan.chunk)
        return y[: self.shape[0]]

    def bench_loop(self, x: torch.Tensor, iterations: int) -> torch.Tensor:
        """N SpMVs in ONE launch (K2); returns the last iteration's y."""
        y = sell_bench_loop(*self._planes(), self._x_tiles(x),
                            n_slices=self.plan.n_slices,
                            chunk=self.plan.chunk, iterations=iterations)
        return y[: self.shape[0]]


# ---------------------------------------------------------------------------
# Format-level wrappers with per-matrix operator caching
# ---------------------------------------------------------------------------


def _auto_plan(rows, cols, vals, shape, chunk: int = 2048) -> SellPlan:
    """The flat plan at chunk 2048, as the JAX operator picks it.

    Above ``_RESIDENT_Y_LIMIT`` the JAX operator takes a streamed-y plan,
    which needs the K3 kernel."""
    if shape[0] * 4 > _RESIDENT_Y_LIMIT:
        raise NotImplementedError(
            f"{shape[0]} rows need a streamed-y plan (above "
            f"{_RESIDENT_Y_LIMIT // 4} rows) and its kernel (K3), which "
            "is not ported yet"
        )
    return build_sell_plan(rows, cols, vals, shape, chunk=chunk)


_CACHE: "weakref.WeakKeyDictionary[object, SellSpMV]" = (
    weakref.WeakKeyDictionary()
)


def _triplets_from_csr_host(csr):
    """Host (numpy) CSR → COO triplets."""
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col = csr.col_ind[: csr.nnz].cpu().numpy()
    val = csr.vals[: csr.nnz]
    val = (val.float() if val.dtype == torch.bfloat16 else val).cpu().numpy()
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(row_ptr))
    return rows, col, val, csr.shape


def _cached_op(matrix) -> SellSpMV:
    """Per-matrix operator cache keyed weakly: a collected matrix drops
    its operator and the operator's device planes with it."""
    op = _CACHE.get(matrix)
    if op is None:
        r, c, v, shape = _triplets_from_csr_host(matrix)
        # A bfloat16 matrix runs the kernels in bf16 value mode.
        vdt = (torch.bfloat16 if matrix.dtype == torch.bfloat16
               else torch.float32)
        op = SellSpMV(_auto_plan(r, c, v, shape), value_dtype=vdt,
                      device=matrix.device)
        _CACHE[matrix] = op
    return op


def spmv_csr_sell(csr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from CSR via the SELL kernels (operator cached per matrix)."""
    return _cached_op(csr)(x)


def sell_op_csr(csr) -> SellSpMV:
    """The cached SELL operator for a CSR matrix."""
    return _cached_op(csr)
