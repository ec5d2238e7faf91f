"""Roofline accounting: bytes moved per SpMV and the memory speed-of-light.

Counterpart of the JAX package's ``bench/roofline.py``. SpMV is
memory-bound (about 0.1 flop per byte), so its roofline is bytes per
iteration over the device's memory bandwidth. The bandwidth is keyed on
the CUDA device name; an unknown GPU raises rather than borrowing another
card's figure.
"""

from __future__ import annotations

import torch

__all__ = [
    "hbm_bandwidth_gbs",
    "spmv_bytes_csr",
    "spmv_bytes_tjds",
    "roofline_fraction",
]

# Published memory bandwidth (GB/s) by device-name fragment, most
# specific first (NVIDIA data sheets). "H100 80GB HBM3" is the SXM part.
_GPU_GBS = (
    ("H100 NVL", 3900.0),
    ("H100 PCIe", 2000.0),
    ("H100 80GB HBM3", 3350.0),
)
_CPU_GBS = 50.0  # nominal DRAM figure for runs on the host


def hbm_bandwidth_gbs(device=None) -> float:
    """Memory speed-of-light of ``device`` (default: the current card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return _CPU_GBS
    name = torch.cuda.get_device_name(dev)
    for key, gbs in _GPU_GBS:
        if key in name:
            return gbs
    raise ValueError(
        f"no memory bandwidth on record for {name!r}; add it to "
        "bench/roofline.py"
    )


def spmv_bytes_csr(nnz: int, nrows: int, value_bytes: int = 4) -> float:
    """Bytes touched per CSR SpMV iteration.

    val + col_ind + x-gather per nnz; row_ptr read + y write per row.
    """
    return nnz * (value_bytes + 4 + value_bytes) + nrows * (4 + value_bytes)


def spmv_bytes_tjds(nnz: int, nrows: int, ndiags: int,
                    value_bytes: int = 4) -> float:
    """Bytes touched per TJDS SpMV iteration.

    val + row_ind + x-stream per nnz; start_pos per diagonal; y write per
    row (the x permutation is a one-time encode cost, not per-iteration).
    """
    return (nnz * (value_bytes + 4 + value_bytes) + (ndiags + 1) * 4
            + nrows * value_bytes)


def roofline_fraction(gbs: float, device=None) -> float:
    return gbs / hbm_bandwidth_gbs(device)
