"""Benchmark harness: device-synchronised timing, roofline and report files.

The JAX package's ``bench`` exports, where the port has them (its
``bench_spmv_fused`` is the port's ``bench_fused``, which times an
N-iteration launch); loaded lazily, as the top-level package's are.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "TimingStats": "harness",
    "time_fn": "harness",
    "bench_spmv": "harness",
    "bench_fused": "harness",
    "bench_native_batched": "harness",
    "generate_report_text": "report",
    "write_report": "report",
    "hbm_bandwidth_gbs": "roofline",
    "roofline_fraction": "roofline",
    "spmv_bytes_csr": "roofline",
    "spmv_bytes_tjds": "roofline",
    "spmv_bytes_cisr": "roofline",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
