"""COO (coordinate) sparse matrix — the interchange format.

Counterpart of the JAX package's ``formats/coo.py`` on torch tensors: the
triplets live in three flat tensors (``rows``/``cols`` int32, ``vals`` in
the value dtype) on an explicit device. ``nnz`` carries the true count;
entries beyond it are padding with the out-of-range sentinel
``row == nrows`` and ``val == 0``, exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.io.mtx import MMTypeCode
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = ["COOMatrix", "host_array", "host_tensor", "values_to_tensor"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def host_tensor(a, dtype) -> torch.Tensor:
    """A CPU tensor of a numpy array, copied only where it must be
    (another dtype, non-contiguous or read-only input)."""
    return torch.from_numpy(np.require(a, dtype=dtype, requirements="CW"))


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16, which numpy lacks, as its
    exact float32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def values_to_tensor(v: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Host values → CPU tensor of ``dtype``, rounded as the JAX package
    rounds them (float64 → float32 → bfloat16, to nearest even)."""
    v = np.asarray(v)
    if dtype.is_complex:
        return host_tensor(v, np.complex64)
    if v.dtype.kind == "c":
        raise TypeError("complex values need a complex dtype")
    t = host_tensor(v, np.float32)
    return t if dtype == torch.float32 else t.to(dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class COOMatrix:
    """Sparse matrix in coordinate (triplet) form on one device.

    ``eq=False`` keeps identity hashing, so a matrix can key the
    operator cache weakly (``ops.spmv_sell._cached_op``).
    """

    rows: torch.Tensor  # int32[nnz_padded]
    cols: torch.Tensor  # int32[nnz_padded]
    vals: torch.Tensor  # dtype[nnz_padded]
    shape: Tuple[int, int]
    nnz: int
    typecode: MMTypeCode = MMTypeCode()

    @staticmethod
    def from_numpy(
        r: np.ndarray,
        c: np.ndarray,
        v: np.ndarray,
        *,
        shape: Tuple[int, int],
        typecode: Optional[MMTypeCode] = None,
        dtype: Optional[torch.dtype] = None,
        pad_to: Optional[int] = None,
        device=None,
    ) -> "COOMatrix":
        """Build a COO from host triplets (file order preserved)."""
        dev = resolve_device(device)
        nnz = int(len(r))
        dtype = torch.float32 if dtype is None else dtype
        r = np.asarray(r, dtype=np.int32)
        c = np.asarray(c, dtype=np.int32)
        v = np.asarray(v)
        if pad_to is not None and pad_to > 1:
            total = max(_round_up(max(nnz, 1), pad_to), pad_to)
            if total > nnz:
                pad = total - nnz
                r = np.concatenate([r, np.full(pad, shape[0], dtype=np.int32)])
                c = np.concatenate([c, np.zeros(pad, dtype=np.int32)])
                v = np.concatenate([v, np.zeros(pad, dtype=v.dtype)])
        return COOMatrix(
            rows=host_tensor(r, np.int32).to(dev),
            cols=host_tensor(c, np.int32).to(dev),
            vals=values_to_tensor(v, dtype).to(dev),
            shape=(int(shape[0]), int(shape[1])),
            nnz=nnz,
            typecode=typecode or MMTypeCode(),
        )

    @property
    def nnz_padded(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def pad(self, multiple: int) -> "COOMatrix":
        """Pad the nnz dimension to a multiple (same rule as the JAX COO)."""
        total = max(_round_up(max(self.nnz, 1), multiple), multiple)
        extra = total - self.nnz_padded
        if extra <= 0:
            return self
        dev = self.device
        return dataclasses.replace(
            self,
            rows=torch.cat([self.rows, torch.full(
                (extra,), self.shape[0], dtype=torch.int32, device=dev)]),
            cols=torch.cat([self.cols, torch.zeros(
                extra, dtype=torch.int32, device=dev)]),
            vals=torch.cat([self.vals, torch.zeros(
                extra, dtype=self.dtype, device=dev)]),
        )

    def canonical_order(self) -> "COOMatrix":
        """Sort entries row-major (row, then col), stable; padding last."""
        key = self.rows.long() * max(self.ncols, 1) + self.cols.long()
        order = torch.sort(key, stable=True).indices
        return dataclasses.replace(
            self, rows=self.rows[order], cols=self.cols[order],
            vals=self.vals[order],
        )

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The true (unpadded) triplets on the host. bfloat16 values come
        back as float32 (exact), since numpy has no bfloat16."""
        v = self.vals[: self.nnz]
        if v.dtype == torch.bfloat16:
            v = v.float()
        return (
            self.rows[: self.nnz].cpu().numpy(),
            self.cols[: self.nnz].cpu().numpy(),
            v.cpu().numpy(),
        )

    def __repr__(self) -> str:
        return (
            f"COOMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"padded={self.nnz_padded}, dtype={self.dtype}, "
            f"device={self.device}, typecode='{self.typecode}')"
        )
