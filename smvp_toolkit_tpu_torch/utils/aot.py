"""Ahead-of-time export of sparse programs on ``torch.export`` (serving).

Counterpart of the JAX package's ``utils/aot.py``. A deployment encodes a
matrix once and then serves ``y = A·x`` many times, from processes that
should need neither the encoder nor the planner: ``torch.export`` records
the program as an ``ExportedProgram`` with the encoded arrays as module
buffers, and ``torch.export.save`` writes it as one ``.pt2`` file that a
serving process loads with ``torch.export.load`` alone (it imports only
``torch``) and calls.

Departures from the JAX module, each forced by the framework:

* the artifact is a ``.pt2`` archive, not a serialized StableHLO module
  (the CLI writes ``PREFIX_csr.pt2`` / ``PREFIX_tjds.pt2`` where the JAX
  CLI writes ``PREFIX_{csr,tjds}.jaxexport``);
* a loaded program runs the recorded ATen graph eagerly on the device the
  arrays were exported from; nothing is compiled ahead of time;
* the SELL operator cannot be exported: its CUDA kernels launch through
  ctypes, which ``torch.export`` cannot trace, and exporting its plain
  PyTorch version instead would serve another program than the one asked
  for. :func:`export_spmv` raises ``TypeError`` for it.

Typical flow::

    blob = export_spmv(csr)              # encode time, once
    write_blob("spmv.pt2", blob)
    ...
    call = load_program("spmv.pt2")      # serving process
    y = call(x)
"""

from __future__ import annotations

import dataclasses
import io
import os
from typing import Callable

import torch

__all__ = [
    "export_program",
    "import_program",
    "export_spmv",
    "save_program",
    "load_program",
    "write_blob",
]


class _Program(torch.nn.Module):
    """``fn`` as a module: what ``torch.export`` records."""

    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _MatrixProgram(torch.nn.Module):
    """``x -> kernel(matrix, x)`` with the matrix's tensors as buffers."""

    def __init__(self, kernel: Callable, matrix):
        super().__init__()
        self._kernel = kernel
        self._cls = type(matrix)
        self._static = {}
        self._buffers_of = []
        for f in dataclasses.fields(matrix):
            v = getattr(matrix, f.name)
            if isinstance(v, torch.Tensor):
                self.register_buffer(f.name, v)
                self._buffers_of.append(f.name)
            else:
                self._static[f.name] = v

    def forward(self, x):
        fields = {n: getattr(self, n) for n in self._buffers_of}
        return self._kernel(self._cls(**fields, **self._static), x)


def _example(a):
    """A tensor for tracing from a tensor or a ``(shape, dtype[, device])``
    spec (the counterpart of ``jax.ShapeDtypeStruct``)."""
    if isinstance(a, torch.Tensor):
        return a
    shape, dtype, *device = a
    return torch.zeros(shape, dtype=dtype,
                       device=device[0] if device else None)


def _serialize(module: torch.nn.Module, args) -> bytes:
    exported = torch.export.export(module, tuple(args))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def export_program(fn: Callable, *example_args) -> bytes:
    """Serialize ``fn`` recorded for the example arguments' shapes and
    dtypes (tensors, or ``(shape, dtype[, device])`` tuples). Tensors that
    ``fn`` closes over are stored in the program as constants."""
    return _serialize(_Program(fn), [_example(a) for a in example_args])


def import_program(blob: bytes) -> Callable:
    """Deserialize an exported program into a callable, which checks its
    arguments' shapes and dtypes against the export and runs the recorded
    graph: no tracing, no dependency on the encoding code."""
    return torch.export.load(io.BytesIO(blob)).module()


def _refuse_sell(kernel) -> None:
    owner = getattr(kernel, "__self__", kernel)
    mod = getattr(type(owner), "__module__", "") or ""
    names = (getattr(kernel, "__module__", "") or "", mod)
    if any(n.endswith((".spmv_sell", ".spmv_df64")) for n in names):
        raise TypeError(
            "the SELL operator cannot be exported: its CUDA kernels launch "
            "through ctypes, which torch.export cannot trace; export the "
            "plain PyTorch SpMV of the matrix's format (kernel=None)")


def export_spmv(matrix, kernel=None, x_dtype=None) -> bytes:
    """Export ``x -> A·x`` with the encoded matrix's arrays as buffers.

    ``kernel`` defaults to the plain PyTorch SpMV of the matrix's format
    (``ops.spmv_torch``: CSR, TJDS or COO), as the JAX function defaults
    to its XLA kernel. The SELL operator and its functions raise
    ``TypeError`` (module docstring). ``x_dtype`` defaults to the values'
    dtype where it is floating or complex (a complex matrix exports a
    complex signature), else float32; x lives on the matrix's device.
    """
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix
    from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix
    from smvp_toolkit_tpu_torch.ops import spmv_torch

    if kernel is None:
        kernel = {
            CSRMatrix: spmv_torch.spmv_csr,
            TJDSMatrix: spmv_torch.spmv_tjds,
            COOMatrix: spmv_torch.spmv_coo,
        }.get(type(matrix))
        if kernel is None:
            raise TypeError(f"no default SpMV for {type(matrix).__name__}")
    _refuse_sell(kernel)
    if x_dtype is None:
        vd = matrix.vals.dtype
        x_dtype = vd if (vd.is_floating_point or vd.is_complex) \
            else torch.float32
    x = torch.zeros(matrix.shape[1], dtype=x_dtype, device=matrix.vals.device)
    return _serialize(_MatrixProgram(kernel, matrix), [x])


def write_blob(path: str, blob: bytes) -> None:
    """Write an artifact atomically (a temporary file, then a rename): a
    crash mid-write must not leave a truncated file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def save_program(path: str, fn: Callable, *example_args) -> None:
    """Export and write to ``path`` (atomic rename)."""
    write_blob(path, export_program(fn, *example_args))


def load_program(path: str) -> Callable:
    with open(path, "rb") as f:
        return import_program(f.read())
