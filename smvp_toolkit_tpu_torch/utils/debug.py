"""Debug dumps of encoded formats.

Counterpart of the JAX package's ``utils/debug.py``: parity with the
reference's printf harness, ``smvp_csr_debug`` (main-cli.c:1166-1191,
enabled by ``SMVP_CSR_DEBUG`` main-cli.c:10) and the TJDS phase dumps
behind ``SMVP_TJDS_DEBUG`` (main-cli.c:747-992). One function per format,
enabled by the ``SMVP_DEBUG`` environment variable or the CLI ``--debug``
flag, writing to any stream (default stderr); the text is the JAX
package's for the same arrays.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_array

__all__ = ["debug_enabled", "dump_coo", "dump_csr", "dump_tjds"]


def debug_enabled() -> bool:
    return os.environ.get("SMVP_DEBUG", "0") not in ("", "0", "false")


def _fmt(arr, limit=32) -> str:
    if isinstance(arr, torch.Tensor):
        arr = host_array(arr)
    a = np.asarray(arr).reshape(-1)
    if len(a) <= limit:
        return np.array2string(a, max_line_width=100)
    head = np.array2string(a[: limit // 2], max_line_width=100)
    tail = np.array2string(a[-limit // 2:], max_line_width=100)
    return f"{head} ... {tail} (len={len(a)})"


def dump_coo(coo, file=None) -> None:
    file = file or sys.stderr
    print(f"[DEBUG]\tCOO {coo.shape} nnz={coo.nnz} (padded {coo.nnz_padded})",
          file=file)
    print(f"[DEBUG]\trows:  {_fmt(coo.rows[:coo.nnz])}", file=file)
    print(f"[DEBUG]\tcols:  {_fmt(coo.cols[:coo.nnz])}", file=file)
    print(f"[DEBUG]\tvals:  {_fmt(coo.vals[:coo.nnz])}", file=file)


def dump_csr(csr, file=None) -> None:
    """CSR dump: row_ptr / col_ind / val (smvp_csr_debug parity)."""
    file = file or sys.stderr
    print(f"[DEBUG]\tCSR {csr.shape} nnz={csr.nnz}", file=file)
    print(f"[DEBUG]\trow_ptr: {_fmt(csr.row_ptr)}", file=file)
    print(f"[DEBUG]\tcol_ind: {_fmt(csr.col_ind[:csr.nnz])}", file=file)
    print(f"[DEBUG]\tval:     {_fmt(csr.vals[:csr.nnz])}", file=file)


def dump_tjds(tjds, file=None) -> None:
    """TJDS dump: packed arrays + per-diagonal segments (phase-dump parity)."""
    file = file or sys.stderr
    nd = int(tjds.num_diags)
    sp = tjds.start_pos.cpu().numpy()
    print(f"[DEBUG]\tTJDS {tjds.shape} nnz={tjds.nnz} diags={nd}", file=file)
    print(f"[DEBUG]\tperm:      {_fmt(tjds.perm)}", file=file)
    print(f"[DEBUG]\tstart_pos: {_fmt(sp[: nd + 1])}", file=file)
    print(f"[DEBUG]\trow_ind:   {_fmt(tjds.row_ind[:tjds.nnz])}", file=file)
    print(f"[DEBUG]\tval:       {_fmt(tjds.vals[:tjds.nnz])}", file=file)
    for d in range(min(nd, 8)):
        lo, hi = int(sp[d]), int(sp[d + 1])
        print(f"[DEBUG]\t  diag {d}: entries [{lo},{hi}) len={hi - lo}",
              file=file)
    if nd > 8:
        print(f"[DEBUG]\t  ... {nd - 8} more diagonals", file=file)
