"""COO (coordinate) sparse matrix — the interchange format.

Counterpart of the JAX package's ``formats/coo.py`` on torch tensors: the
triplets live in three flat tensors (``rows``/``cols`` int32, ``vals`` in
the value dtype) on an explicit device. ``nnz`` carries the true count;
entries beyond it are padding with the out-of-range sentinel
``row == nrows`` and ``val == 0``, exactly as in the JAX package.

The interop bridges of the JAX class are methods here too:
``from_scipy``/``to_scipy`` (any object with ``.tocoo()``),
``from_torch``/``to_torch`` (``torch.sparse`` tensors, the bridge inside
this ecosystem, in the role of the JAX class's BCOO bridge) and
``to_dense`` (the host oracle).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.io.mtx import MMTypeCode, expand_symmetric
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

    The JAX class's ``from_bcoo``/``to_bcoo`` take and give JAX types;
    here ``from_torch``/``to_torch`` bridge to ``torch.sparse`` in their
    place. Every bridge, as every entry point, builds on ``cuda`` unless
    given ``device="cpu"``.
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

    @staticmethod
    def from_scipy(
        mat,
        *,
        typecode: Optional[MMTypeCode] = None,
        dtype: Optional[torch.dtype] = None,
        pad_to: Optional[int] = None,
        device=None,
    ) -> "COOMatrix":
        """Build from any ``scipy.sparse`` matrix or array (anything with
        ``.tocoo()``), as the JAX ``COOMatrix.from_scipy``. Duplicate
        entries are kept (both sides sum them on materialization); complex
        values go to complex64 unless ``dtype`` says otherwise."""
        coo = mat.tocoo()
        if dtype is None and np.iscomplexobj(coo.data):
            dtype = torch.complex64
        return COOMatrix.from_numpy(
            coo.row, coo.col, coo.data, shape=coo.shape, typecode=typecode,
            dtype=dtype, pad_to=pad_to, device=device,
        )

    @staticmethod
    def from_torch(
        tensor: torch.Tensor,
        *,
        typecode: Optional[MMTypeCode] = None,
        dtype: Optional[torch.dtype] = None,
        pad_to: Optional[int] = None,
        device=None,
    ) -> "COOMatrix":
        """Build from a 2-D torch tensor: sparse COO, CSR or CSC, or dense.

        As the JAX ``COOMatrix.from_torch``: the tensor is coalesced first
        (duplicates summed), a dense one keeps its explicit zeros out, and
        complex values go to complex64 unless ``dtype`` says otherwise.
        Real values are rounded as ``from_numpy`` rounds them (through
        float32). The work happens on the tensor's own device, so a CUDA
        tensor coalesces on the card; its triplets equal the host path's
        (summed duplicates up to the order of their sum).
        """
        dev = resolve_device(device)
        t = tensor.detach()
        if t.dim() != 2:
            raise ValueError(f"need a 2-D tensor, got {t.dim()} dimensions")
        if t.layout != torch.sparse_coo:
            t = t.to_sparse_coo()
        t = t.coalesce()
        idx, v = t.indices(), t.values()
        if dtype is None:
            dtype = torch.complex64 if v.is_complex() else torch.float32
        if dtype.is_complex:
            v = v.to(torch.complex64)
        elif v.is_complex():
            raise TypeError("complex values need a complex dtype")
        else:
            v = v.to(torch.float32).to(dtype)
        coo = COOMatrix(
            rows=idx[0].to(dev, torch.int32),
            cols=idx[1].to(dev, torch.int32),
            vals=v.to(dev),
            shape=(int(t.shape[0]), int(t.shape[1])),
            nnz=int(v.shape[0]),
            typecode=typecode or MMTypeCode(),
        )
        return coo.pad(pad_to) if pad_to is not None and pad_to > 1 else coo

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

    def _export_triplets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The true triplets on the host for ecosystems without symmetry
        metadata: one-triangle storage (symmetric, skew, Hermitian) is
        expanded to the full matrix, or export would hand over another
        operator; bfloat16 values come as their exact float32."""
        return expand_symmetric(self.typecode, *self.to_numpy())

    def to_scipy(self):
        """The true (unpadded) entries as a ``scipy.sparse.coo_matrix``,
        one-triangle storage expanded and bfloat16 as float32 (the JAX
        ``COOMatrix.to_scipy``)."""
        import scipy.sparse

        r, c, v = self._export_triplets()
        return scipy.sparse.coo_matrix((v, (r, c)), shape=self.shape)

    def to_torch(self) -> torch.Tensor:
        """The true (unpadded) entries as a coalesced ``torch`` sparse COO
        tensor, with the export rules of :meth:`to_scipy`, built with
        ``check_invariants=True`` as the JAX ``COOMatrix.to_torch`` builds
        it. It lies on this matrix's device (the JAX method, which has no
        torch device, gives a CPU tensor)."""
        r, c, v = self._export_triplets()
        idx = torch.from_numpy(np.stack([r, c]).astype(np.int64))
        t = torch.sparse_coo_tensor(idx, torch.from_numpy(v),
                                    size=self.shape, check_invariants=True)
        return t.to(self.device).coalesce()

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        """Dense host oracle in ``dtype``, duplicates summed (per
        MatrixMarket), as the JAX ``COOMatrix.to_dense``."""
        r, c, v = self.to_numpy()
        dense = np.zeros(self.shape, dtype=dtype)
        np.add.at(dense, (r, c), v.astype(dtype))
        return dense

    def __repr__(self) -> str:
        return (
            f"COOMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"padded={self.nnz_padded}, dtype={self.dtype}, "
            f"device={self.device}, typecode='{self.typecode}')"
        )
