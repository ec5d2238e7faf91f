"""SpMV that consumes the CISR interleaved-channel schedule.

Counterpart of the JAX package's ``ops/spmv_cisr.py``. The reference only
ever *encodes* CISR for a 16-channel FPGA consumer (main-cli.c:542-612
scheduling, 690-728 emission); this module runs the schedule as the FPGA
would, channel per lane:

    for each beat g (slot group), each channel s in parallel:
        y[row_of[g, s]] += vals[g, s] * x[col_ind[g, s]]

The JAX package writes it in XLA (a gather and a ``segment_sum`` into
``nrows + 1`` buckets), not as a Pallas kernel, so its counterpart here is
plain PyTorch: a gather and ``index_add_`` into ``nrows + 1`` buckets on
the operator's device, idle slots sent to the sentinel bucket ``nrows``,
which is sliced off. It is what the CLI's ``--kernel torch`` (and
``df64``) runs for CISR; ``--kernel auto`` replans the schedule into SELL
(``ops/spmv_sell.spmv_cisr_sell``).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.cisr import CISRMatrix
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = ["spmv_cisr", "CisrSpMV"]


class CisrSpMV:
    """Device operator executing a CISR schedule: build once, call many.

    Idle slots (row_of == -1) are retargeted to a sentinel row ``nrows``
    whose accumulator bucket is sliced off; their value is 0 anyway (the
    schedule zero-pads exhausted channels). Values are float32 (complex64
    for a complex schedule) on ``device`` (default: the card).
    """

    def __init__(self, cisr: CISRMatrix, dtype=None, device=None):
        self.shape = cisr.shape
        self.nnz = cisr.nnz
        self.slot_count = cisr.slot_count
        self.device = resolve_device(device)
        rows = np.asarray(cisr.row_of).reshape(-1)
        live = rows >= 0
        if dtype is None:
            dtype = (torch.complex64 if np.iscomplexobj(cisr.vals)
                     else torch.float32)
        vals = np.where(live, np.asarray(cisr.vals).reshape(-1), 0.0)
        self.vals = torch.from_numpy(vals).to(dtype).to(self.device)
        self.cols = torch.from_numpy(np.where(
            live, np.asarray(cisr.col_ind).reshape(-1), 0).astype(
                np.int64)).to(self.device)
        self.rows = torch.from_numpy(np.where(
            live, rows, self.shape[0]).astype(np.int64)).to(self.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, self.vals.dtype)
        y = torch.zeros(self.shape[0] + 1, dtype=self.vals.dtype,
                        device=self.device)
        y.index_add_(0, self.rows, self.vals * x[self.cols])
        return y[: self.shape[0]]


_CACHE: "weakref.WeakKeyDictionary[CISRMatrix, CisrSpMV]" = (
    weakref.WeakKeyDictionary()
)


def spmv_cisr(cisr: CISRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x executed from the CISR schedule on x's device (operator
    cached weakly per schedule)."""
    op = _CACHE.get(cisr)
    if op is None or op.device != x.device:
        op = CisrSpMV(cisr, device=x.device)
        _CACHE[cisr] = op
    return op(x)
