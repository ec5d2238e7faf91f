"""Native CPU SpMV backend: ctypes binding to ``csrc/spmv.cpp``.

Counterpart of the JAX package's ``ops/spmv_native.py``: the reference's
CSR traversal and the TJDS jagged-diagonal loop in host C++, compiled
``-O3 -march=native`` (the JAX Makefile's flags, ``_build.SPMV_CXX_FLAGS``),
serial or threaded. It is the CLI's ``--kernel native``, an explicit
request for the host, never a fallback: the library builds into
``build/kernels`` at first use and a failed build raises.

The operators take the port's CSR or TJDS matrix (on any device: the
arrays are copied to the host once, at construction) and an x as a host
tensor or numpy array, and return y as a float32 numpy array, as the JAX
operators do.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from smvp_toolkit_tpu_torch.formats.coo import host_array
from smvp_toolkit_tpu_torch.ops import _build

__all__ = [
    "native_spmv_available",
    "NativeCsrSpMV",
    "NativeTjdsSpMV",
    "spmv_csr_native",
    "spmv_tjds_native",
]


def _ptr(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


_SIGNATURES = {
    "csr_spmv_f32": (None, [
        _ptr(np.int64), _ptr(np.int32), _ptr(np.float32), _ptr(np.float32),
        _ptr(np.float32), ctypes.c_longlong, ctypes.c_int, ctypes.c_int]),
    "tjds_spmv_f32": (None, [
        _ptr(np.int64), _ptr(np.int32), _ptr(np.float32), _ptr(np.float32),
        _ptr(np.float32), ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int]),
}


def _lib():
    return _build.load("spmv", _SIGNATURES)


def native_spmv_available() -> bool:
    """Whether the library builds and loads here (a host C++ compiler)."""
    try:
        _lib()
    except (_build.KernelBuildError, OSError):
        return False
    return True


def _threads(threads: Optional[int], nnz: int) -> int:
    """The JAX rule: ``None`` is 1 below 32,768 nnz (thread start-up costs
    more than it saves there), else the core count; at most 16."""
    if threads is None:
        threads = 1 if nnz < 32768 else (os.cpu_count() or 1)
    return min(threads, 16)


def _host_x(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = host_array(x)
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


class NativeCsrSpMV:
    """Encoded CSR operator on the native CPU backend.

    ``threads=None`` uses every core (at most 16) from 32,768 nnz up;
    ``threads=1`` is the reference's serial loop.
    """

    def __init__(self, csr, threads: Optional[int] = None):
        self._lib = _lib()
        self.shape = tuple(csr.shape)
        self.nnz = int(csr.nnz)
        self.row_ptr = np.ascontiguousarray(host_array(csr.row_ptr),
                                            dtype=np.int64)
        self.col = np.ascontiguousarray(host_array(csr.col_ind)[: self.nnz],
                                        dtype=np.int32)
        self.val = np.ascontiguousarray(host_array(csr.vals)[: self.nnz],
                                        dtype=np.float32)
        self.threads = _threads(threads, self.nnz)

    def __call__(self, x, iterations: int = 1) -> np.ndarray:
        x = _host_x(x)
        if x.shape[0] < self.shape[1]:
            raise ValueError("x too short")
        y = np.zeros(self.shape[0], dtype=np.float32)
        self._lib.csr_spmv_f32(self.row_ptr, self.col, self.val, x, y,
                               self.shape[0], self.threads, iterations)
        return y


def spmv_csr_native(csr, x) -> np.ndarray:
    """One-shot native CSR SpMV (builds the operator each call)."""
    return NativeCsrSpMV(csr)(x)


class NativeTjdsSpMV:
    """Encoded TJDS operator on the native CPU backend: the jagged
    diagonals in order, x read by position within each (the reference
    hot loop, main-cli.c:1013-1020, with the per-position index fixed).
    ``threads > 1`` stripes the positions of every diagonal over the
    workers, each summing into its own partial y, reduced at the end."""

    def __init__(self, tjds, threads: Optional[int] = None):
        self._lib = _lib()
        self.shape = tuple(tjds.shape)
        self.nnz = int(tjds.nnz)
        nd = int(tjds.num_diags)
        self.num_diags = nd
        self.start_pos = np.ascontiguousarray(
            host_array(tjds.start_pos)[: nd + 1], dtype=np.int64)
        self.row_ind = np.ascontiguousarray(
            host_array(tjds.row_ind)[: self.nnz], dtype=np.int32)
        self.val = np.ascontiguousarray(host_array(tjds.vals)[: self.nnz],
                                        dtype=np.float32)
        self.perm = host_array(tjds.perm).astype(np.int64)
        self.threads = _threads(threads, self.nnz)

    def __call__(self, x, iterations: int = 1) -> np.ndarray:
        x = _host_x(x)
        xp = np.ascontiguousarray(x[self.perm])
        y = np.zeros(self.shape[0], dtype=np.float32)
        self._lib.tjds_spmv_f32(self.start_pos, self.row_ind, self.val, xp,
                                y, self.shape[0], self.num_diags, iterations,
                                self.threads)
        return y


def spmv_tjds_native(tjds, x) -> np.ndarray:
    """One-shot native TJDS SpMV (builds the operator each call)."""
    return NativeTjdsSpMV(tjds)(x)
