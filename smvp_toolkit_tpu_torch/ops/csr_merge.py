"""The ``csr`` route: merge-path CSR SpMV (K12) for scattered plans.

The SELL plan gives each sublane one (128-row slice, 128-column tile)
cell. On a matrix whose rows scatter their nonzeros over the tiles (a
power-law graph with permuted ids) nearly every nonzero takes a 128-slot
sublane of its own, so K1 streams some 500 bytes of planes per nonzero
where the SpMV needs the nonzero's column and value. The card gathers x
at any address, so such a matrix runs best on its nonzeros alone:

* ``csr_planes``: the planes, built from the operator's triplets on its
  device (a stable sort by row, then a row pointer): the row pointer
  (int32, nrows + 1), each nonzero's column (int32) and value (the value
  dtype) in row order, both padded with zeros to a multiple of four, and
  the merge-path coordinates (``merge_coords``);
* ``csr_merge_spmv`` (K12, ``csrc/csr_spmv.cu``): one launch, a warp per
  ``WARP_PATH`` items of the merged path of rows' ends and nonzeros
  (Merrill and Garland, SC'16), products in float32 in both value dtypes;
  its plain version ``csr_merge_spmv_plain`` computes the same sums
  share by share and runs on CPU tensors.

``SellSpMV.__call__`` takes the route where the card's cost model prices
it at most half the plan's (``autotune.takes_csr``); the planes are built
at the first such call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_tensor
from smvp_toolkit_tpu_torch.ops import _build

__all__ = ["ITEMS", "WARP_PATH", "CsrPlanes", "csr_fits", "merge_coords",
           "csr_planes", "csr_merge_spmv", "csr_merge_spmv_plain",
           "CSR_KERNELS"]

# Path items a lane and a warp (csrc/csr_spmv.cu, kItems and kWarpPath).
ITEMS = 4
WARP_PATH = 32 * ITEMS


@dataclasses.dataclass
class CsrPlanes:
    """A matrix's CSR planes and merge coordinates on one device."""

    row_ptr: torch.Tensor  # int32 (nrows + 1,)
    cols: torch.Tensor     # int32 (nnz rounded up to 4,), padding 0
    vals: torch.Tensor     # value dtype, as cols
    coords: torch.Tensor   # int32 (n_warps + 1, 2): (row, nonzero) at each
    nnz: int               # warp's start on the merged path
    shape: Tuple[int, int]

    @property
    def n_warps(self) -> int:
        return self.coords.shape[0] - 1


def csr_fits(nnz: int, nrows: int) -> bool:
    """Whether the merged path's coordinates fit the kernel's int32."""
    return nnz + nrows + WARP_PATH < 2**31


def merge_coords(row_ptr: torch.Tensor, nnz: int,
                 warp_path: int = WARP_PATH) -> torch.Tensor:
    """Where each share of ``warp_path`` items of the merged path starts,
    and where the last ends: (n_warps + 1, 2) int32 (row, nonzero) on
    ``row_ptr``'s device.

    The path merges the rows' ends ``row_ptr[1:]`` with the nonzeros'
    indices, a row's end after its last nonzero; after d items it has
    passed the ends of the rows i with ``row_ptr[i + 1] + i < d`` (a
    strictly increasing key), so the row coordinate is a search of d in
    that key and the nonzero coordinate d less it."""
    nrows = row_ptr.shape[0] - 1
    path = nrows + nnz
    n_warps = -(-path // warp_path)
    dev = row_ptr.device
    d = torch.clamp(torch.arange(n_warps + 1, dtype=torch.int64,
                                 device=dev) * warp_path, max=path)
    key = row_ptr[1:].to(torch.int64) + torch.arange(nrows, device=dev)
    rows = torch.searchsorted(key, d)
    return torch.stack([rows, d - rows], dim=1).to(torch.int32)


def csr_planes(rows, cols, vals, shape: Tuple[int, int],
               value_dtype: torch.dtype, device) -> CsrPlanes:
    """The CSR planes of host triplets (duplicates kept as they are: their
    products add), sorted by row on ``device``; values rounded to float32,
    then to ``value_dtype``, as the SELL planes round them."""
    nrows = int(shape[0])
    r = host_tensor(rows, np.int32).to(device)
    c = host_tensor(cols, np.int32).to(device)
    v = host_tensor(vals, np.float32).to(device)
    nnz = int(r.shape[0])
    order = torch.sort(r, stable=True).indices
    r, c, v = r[order], c[order], v[order]
    row_ptr = torch.zeros(nrows + 1, dtype=torch.int32, device=device)
    if nnz:
        row_ptr[1:] = torch.cumsum(torch.bincount(r, minlength=nrows), 0)
    pad = -(-nnz // 4) * 4
    cp = torch.zeros(pad, dtype=torch.int32, device=device)
    vp = torch.zeros(pad, dtype=value_dtype, device=device)
    cp[:nnz] = c
    vp[:nnz] = v.to(value_dtype)
    return CsrPlanes(row_ptr, cp, vp, merge_coords(row_ptr, nnz), nnz,
                     (nrows, int(shape[1])))


def csr_merge_spmv_plain(planes: CsrPlanes, x: torch.Tensor) -> torch.Tensor:
    """K12's function, y (float32, nrows): each nonzero's float32 product,
    summed per row inside each share of the merged path, then the shares'
    sums of a row that they cut added together, as the kernel adds them."""
    nrows, nnz = planes.shape[0], planes.nnz
    y = torch.zeros(nrows, dtype=torch.float32, device=x.device)
    if nnz == 0:
        return y
    dev = planes.cols.device
    p = planes.vals[:nnz].float() * x[planes.cols[:nnz].long()].float()
    rows = torch.repeat_interleave(
        torch.arange(nrows, device=dev),
        (planes.row_ptr[1:] - planes.row_ptr[:-1]).long())
    share = torch.searchsorted(planes.coords[:, 1].contiguous(),
                               torch.arange(nnz, dtype=torch.int32,
                                            device=dev), right=True) - 1
    head = torch.ones(nnz, dtype=torch.bool, device=dev)
    head[1:] = (rows[1:] != rows[:-1]) | (share[1:] != share[:-1])
    seg = torch.cumsum(head, 0) - 1
    part = torch.zeros(int(seg[-1]) + 1, dtype=torch.float32,
                       device=dev).index_add_(0, seg, p)
    return y.index_add_(0, rows[head], part)


_SIGNATURES = {
    "csr_merge_spmv_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "csr_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def csr_merge_spmv(planes: CsrPlanes, x: torch.Tensor) -> torch.Tensor:
    """K12: y = A·x over the CSR planes, y float32 of nrows.

    ``x`` is a contiguous vector in the planes' value dtype on their
    device, with at least ncols entries. CPU tensors take the plain
    version; CUDA ones launch the kernel (counted on ``.launches``) into a
    zeroed y, or raise."""
    if x.device != planes.cols.device or x.dtype != planes.vals.dtype:
        raise ValueError(f"x must be {planes.vals.dtype} on "
                         f"{planes.cols.device}, got {x.dtype} on {x.device}")
    if x.dim() != 1 or x.shape[0] < planes.shape[1] or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous vector of at least "
                         f"{planes.shape[1]} entries, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return csr_merge_spmv_plain(planes, x)
    if x.device.type != "cuda":
        raise ValueError(f"K12 runs on cuda tensors (got {x.device})")
    dev = x.device
    y = torch.zeros(planes.shape[0], dtype=torch.float32, device=dev)
    if planes.n_warps < 1:
        return y
    lib = _build.load("csr_spmv", _SIGNATURES)
    rc = lib.csr_merge_spmv_launch(
        planes.row_ptr.data_ptr(), planes.cols.data_ptr(),
        planes.vals.data_ptr(), planes.coords.data_ptr(), x.data_ptr(),
        y.data_ptr(), planes.n_warps, WARP_PATH,
        int(x.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.csr_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"csr_merge_spmv_kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    csr_merge_spmv.launches += 1
    return y


csr_merge_spmv.launches = 0
csr_merge_spmv.kernel = "csr_merge_spmv_kernel"
CSR_KERNELS = {"csr_merge_spmv_kernel": csr_merge_spmv}
