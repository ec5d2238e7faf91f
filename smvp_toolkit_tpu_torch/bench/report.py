"""Benchmark report writer — reference-compatible format plus device metrics.

Counterpart of the JAX package's ``bench/report.py``: the same layout, byte
for byte, apart from the package name on the header line. Mirrors
``generateReportText`` (main-cli.c:246-320): same filename scheme
``smvp-toolbox_report_{ALG}_{unixtime}.txt``, same
section order (version header, matrix path, nnz, five timing stats, full
output vector one value per line in ``[`` ``]`` brackets, ``%g``
formatting), with an optional device metrics block (nnz/s, effective GB/s,
roofline fraction, device) the reference lacks.

Intentional fixes: files are opened in write mode (the reference appends,
so two runs in one second interleave — SURVEY.md §5 checkpoint note).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from smvp_toolkit_tpu_torch import __version__
from smvp_toolkit_tpu_torch.bench.harness import TimingStats

__all__ = ["generate_report_text", "write_report"]


def _g(x: float) -> str:
    """C ``%g`` formatting (6 significant digits, like main-cli.c:308)."""
    return f"{x:g}"


def generate_report_text(
    *,
    alg_name: str,
    input_file: str,
    nnz: int,
    iterations: int,
    stats: TimingStats,
    output_vector: np.ndarray,
    unix_time: Optional[int] = None,
    extra_metrics: Optional[dict] = None,
) -> str:
    """Render the report body (format per main-cli.c:294-317)."""
    unix_time = int(time.time()) if unix_time is None else unix_time
    lines = [
        f"Execution results for smvp-toolkit-tpu-torch v.{__version__}, "
        f"{alg_name} algorithm",
        f"Generated on {unix_time} (Unix time)",
        "",
        "Sparse matrix file in use:",
        str(input_file),
        "",
        f"Non-zero numbers contained in matrix: {nnz}",
        "",
        f"Compute times for {iterations} iterations:",
        "",
        f"Total Time: {_g(stats.total_ms)} ms",
        f"Average Time: {_g(stats.avg_ms)} ms",
        f"Fastest Time: {_g(stats.min_ms)} ms",
        f"Slowest Time: {_g(stats.max_ms)} ms",
        f"Time StDev: {_g(stats.stdev_ms)} ms",
    ]
    if getattr(stats, "per_launch", False):
        lines.append(
            "(fused device loop: Fastest/Slowest/StDev describe "
            "per-launch averages, not individual iterations)"
        )
    lines.append("")
    if extra_metrics:
        lines.append("Device metrics:")
        for key, val in extra_metrics.items():
            lines.append(f"{key}: {val}")
        lines.append("")
    lines.append("Output vector (one cell per line):")
    lines.append("[")
    vec = np.asarray(output_vector).reshape(-1)
    if np.iscomplexobj(vec):
        # Complex cells print as re+imj with the same %g formatting (the
        # JAX report's extension of the reference format).
        for v in vec:
            lines.append(f"{_g(float(v.real))}{float(v.imag):+g}j")
    else:
        for v in vec:
            lines.append(_g(float(v)))
    lines.append("]")
    lines.append("")
    return "\n".join(lines) + "\n"


def write_report(
    report_dir: str,
    *,
    alg_name: str,
    input_file: str,
    nnz: int,
    iterations: int,
    stats: TimingStats,
    output_vector: np.ndarray,
    extra_metrics: Optional[dict] = None,
) -> str:
    """Write the report file; returns its path.

    Filename: ``smvp-toolbox_report_{ALG}_{unixtime}.txt``
    (main-cli.c:266-287).
    """
    unix_time = int(time.time())
    name = f"smvp-toolbox_report_{alg_name}_{unix_time}.txt"
    path = os.path.join(report_dir or ".", name)
    text = generate_report_text(
        alg_name=alg_name,
        input_file=input_file,
        nnz=nnz,
        iterations=iterations,
        stats=stats,
        output_vector=output_vector,
        unix_time=unix_time,
        extra_metrics=extra_metrics,
    )
    with open(path, "w") as f:
        f.write(text)
    return path
