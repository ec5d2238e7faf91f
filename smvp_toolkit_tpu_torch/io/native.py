"""ctypes binding to the C++ MatrixMarket fast-path parser.

Counterpart of the JAX package's ``io/native.py``. ``csrc/mtxio.cpp``
reads the whole file in one call and tokenizes it with a branch-light
scanner, filling numpy buffers directly, where the Python parser
(``io/mtx.py``) splits the payload into Python strings. It is built by
``ops/_build.py`` on first use; a failed build raises.

It takes coordinate real, integer and pattern files and gives the same
triplets as the Python reader, bit for bit. Array and complex files raise
:class:`NativeUnavailable`, and ``read_mtx`` then takes the Python
parser, as the JAX reader does. Unlike the JAX package's native parser it
reads a coordinate written as a number (``1.0``), as both Python readers
do.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from smvp_toolkit_tpu_torch.io.mtx import (
    MMTypeCode,
    MTXError,
    MTXNoHeader,
    MTXPrematureEOF,
)

__all__ = ["NativeUnavailable", "read_mtx_raw_native"]


class NativeUnavailable(Exception):
    """The native parser does not take this file's format."""


# Error codes shared with mtxio.cpp (mirroring mmio.h:76-83 codes).
_OK = 0
_ERR_OPEN = 1
_ERR_NO_HEADER = 2
_ERR_PREMATURE_EOF = 3
_ERR_UNSUPPORTED = 4
_ERR_BAD_DATA = 5

_FIELDS = ("real", "integer", "pattern", "complex")
_SYMS = ("general", "symmetric", "skew-symmetric", "hermitian")

_LLP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "mtx_read_header": (ctypes.c_int, [ctypes.c_char_p, _LLP, _LLP, _LLP,
                                       _IP, _IP]),
    "mtx_read_coo": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.c_int, _I32P, _I32P, _F64P]),
}


def _lib() -> ctypes.CDLL:
    """The library of ``csrc/mtxio.cpp``, built on first use
    (``KernelBuildError`` when no host compiler is found or it fails)."""
    from smvp_toolkit_tpu_torch.ops import _build

    return _build.load("mtxio", _SIGNATURES)


def read_mtx_raw_native(path: str):
    """Native-parser equivalent of :func:`io.mtx.read_mtx_raw` for
    coordinate real, integer and pattern files: ``(typecode, rows, cols,
    r, c, v)`` with int32 indices and float64 values."""
    lib = _lib()
    rows, cols, nnz = (ctypes.c_longlong() for _ in range(3))
    field, sym = ctypes.c_int(), ctypes.c_int()
    bpath = os.fsencode(path)
    rc = lib.mtx_read_header(bpath, ctypes.byref(rows), ctypes.byref(cols),
                             ctypes.byref(nnz), ctypes.byref(field),
                             ctypes.byref(sym))
    if rc == _ERR_UNSUPPORTED:
        # Array format, complex field, another object: the Python parser
        # takes it (or names what it refuses).
        raise NativeUnavailable("format not handled by native parser")
    if rc == _ERR_OPEN:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        raise MTXError(f"could not open {path!r}")
    if rc == _ERR_NO_HEADER:
        raise MTXNoHeader(f"{path!r}: missing %%MatrixMarket banner")
    if rc == _ERR_PREMATURE_EOF:
        raise MTXPrematureEOF(f"{path!r}: truncated header")
    if rc != _OK:
        raise MTXError(f"{path!r}: native parser error {rc}")

    nr, nc, n = int(rows.value), int(cols.value), int(nnz.value)
    if nr < 0 or nc < 0 or n < 0:
        raise MTXError(f"{path!r}: negative dimension in size line")
    # An entry takes at least four bytes ("1 1\n"): a count beyond that
    # is a truncated file, whatever buffer it would ask for.
    if 4 * n > os.path.getsize(path):
        raise MTXPrematureEOF(f"{path!r}: fewer than {n} entries")
    r = np.empty(n, dtype=np.int32)
    c = np.empty(n, dtype=np.int32)
    v = np.empty(n, dtype=np.float64)
    rc = lib.mtx_read_coo(bpath, n, field.value, r, c, v)
    if rc == _ERR_PREMATURE_EOF:
        raise MTXPrematureEOF(f"{path!r}: fewer than {n} entries")
    if rc == _ERR_BAD_DATA:
        raise MTXError(f"{path!r}: malformed coordinate data")
    if rc != _OK:
        raise MTXError(f"{path!r}: native parser error {rc}")

    typecode = MMTypeCode("matrix", "coordinate", _FIELDS[field.value],
                          _SYMS[sym.value])
    if n and (r.min() < 0 or int(r.max()) >= nr or c.min() < 0
              or int(c.max()) >= nc):
        raise MTXError("coordinate index out of declared bounds")
    return typecode, nr, nc, r, c, v
