"""Command line: the reference's CSR benchmark (``-c``) on the port.

Counterpart of the JAX package's ``cli.py`` for the flags this slice of the
port has: positional ``file`` (a ``.mtx`` path or ``synth:N:NNZ``),
``-c``, ``-n``, ``-d``, ``--no-report``, ``--dtype``, ``--kernel``,
``--fused``, ``--x``, ``--json-out`` and ``--device``. Validation and
exit codes match the JAX CLI for those flags (``-n 0`` and ``-d /nope``
give 2, a missing or unreadable file 1); argparse rejects every other
flag with 2.

``--kernel auto`` runs the SELL CUDA kernels (K1 per call, K2 under
``--fused``); ``--kernel torch`` runs the plain-PyTorch CSR SpMV. The run
is on ``cuda`` unless ``--device cpu`` is given, where each kernel's plain
version runs instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

__all__ = ["main", "build_parser"]

ALG_CSR = "CSR"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smvp-toolkit-tpu-torch",
        description="Sparse-matrix codec + CSR SpMV benchmark (PyTorch/CUDA)",
    )
    p.add_argument("file", help="input MatrixMarket (.mtx) file, or "
                   "synth:N:NNZ for a synthetic banded matrix")
    p.add_argument("-c", "--csr", action="store_true",
                   help="benchmark CSR SpMV")
    p.add_argument(
        "-n", "--iter", type=int, default=1000, metavar="ITERATIONS",
        help="number of timed SpMV iterations (default 1000)",
    )
    p.add_argument(
        "-d", "--dir", default="", metavar="DIR",
        help="report output directory (default: current directory)",
    )
    p.add_argument("--no-report", action="store_true",
                   help="skip writing the report file")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32", help="device value dtype")
    p.add_argument(
        "--kernel", choices=["auto", "torch"], default="auto",
        help="SpMV implementation (auto: the SELL CUDA kernels; torch: "
             "plain-PyTorch CSR gather + index_add_)",
    )
    p.add_argument(
        "--fused", action="store_true",
        help="time the N iterations as one launch of the N-iteration "
             "kernel (SELL kernels only)",
    )
    p.add_argument(
        "--x", default="ones", metavar="MODE",
        help="input vector: 'ones' (reference protocol, main-cli.c:368), "
             "'random' or 'random:SEED' (standard normal)",
    )
    p.add_argument(
        "--json-out", default=None, metavar="FILE",
        help="append one JSON line per benchmarked algorithm",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="run on the card (default) or on the CPU, where each kernel's "
             "plain PyTorch version runs",
    )
    return p


def _validate(args) -> Optional[str]:
    """Reference-equivalent validation (main-cli.c:1274-1386)."""
    if not args.csr:
        return "no algorithm selected (use -c)"
    if args.iter < 1:
        return "iteration count must be >= 1"
    if args.dir and not os.path.isdir(args.dir):
        return f"report directory does not exist: {args.dir}"
    if args.fused and args.kernel != "auto":
        return "--fused needs the SELL kernels (--kernel auto)"
    return None


def _make_x(mode: str, n: int, dtype, device):
    """x = ones (the reference protocol) or the JAX CLI's random stream."""
    import torch

    if mode == "ones":
        return torch.ones(n, dtype=dtype, device=device)
    if mode == "random" or mode.startswith("random:"):
        seed = int(mode.split(":", 1)[1]) if ":" in mode else 0
        x = np.random.default_rng(seed).standard_normal(n)
        # float64 -> float32 -> dtype, as the JAX CLI rounds it.
        return torch.from_numpy(x.astype(np.float32)).to(dtype).to(device)
    raise ValueError(f"unknown --x mode: {mode!r}")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    err = _validate(args)

    from smvp_toolkit_tpu_torch.utils.logging import log

    if err:
        log("ERROR", err)
        return 2

    log("START", "smvp-toolkit-tpu-torch benchmark run starting.")

    import torch

    from smvp_toolkit_tpu_torch.bench.harness import (
        bench_spmv,
        bench_spmv_fused,
    )
    from smvp_toolkit_tpu_torch.bench.report import write_report
    from smvp_toolkit_tpu_torch.bench.roofline import (
        roofline_fraction,
        spmv_bytes_csr,
    )
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.io.mtx import (
        MTXError,
        MTXUnsupportedType,
        read_mtx,
    )
    from smvp_toolkit_tpu_torch.utils.device import (
        device_label,
        resolve_device,
    )

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        log("ERROR", str(e))
        return 1
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    if args.file.startswith("synth:"):
        from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

        log("FILE", f"Generating synthetic banded matrix {args.file}")
        try:
            coo = parse_synth_spec(args.file, dtype=dtype, device=device)
        except ValueError as e:
            log("ERROR", str(e))
            return 2
    else:
        log("FILE", f"Loading matrix: {args.file}")
        try:
            coo = read_mtx(args.file, dtype=dtype, device=device)
        except FileNotFoundError:
            log("ERROR", f"could not open file: {args.file}")
            return 1
        except MTXUnsupportedType as e:
            if "complex" not in str(e):
                log("ERROR", f"MatrixMarket read failed: {e}")
                return 1
            log("ERROR", "complex matrices are not supported: the port's "
                "SELL kernels are real-valued")
            return 1
        except MTXError as e:
            log("ERROR", f"MatrixMarket read failed: {e}")
            return 1

    coo = coo.pad(128)
    log(
        "DATA",
        f"{coo.shape[0]}x{coo.shape[1]} matrix, {coo.nnz} non-zeros "
        f"({coo.typecode}).",
    )
    label = device_label(device)
    log("INFO", f"Device: {label}")

    try:
        x = _make_x(args.x, coo.shape[1], dtype, device)
    except ValueError:
        log("ERROR", f"bad --x mode (want ones, random or random:INT): "
            f"{args.x!r}")
        return 2

    csr = csr_encode(coo)
    if args.kernel == "torch":
        from smvp_toolkit_tpu_torch.ops.spmv_torch import spmv_csr as spmv_fn

        kernel = "torch"
    else:
        from smvp_toolkit_tpu_torch.ops.spmv_sell import (
            sell_op_csr,
            spmv_csr_sell as spmv_fn,
        )

        kernel = "sell-cuda" if device.type == "cuda" else "sell-plain"

    log("INFO", f"Benchmarking {ALG_CSR} SpMV ({kernel} kernel), "
        f"{args.iter} iterations.")
    try:
        if args.fused:
            stats, y = bench_spmv_fused(sell_op_csr(csr), x,
                                        iterations=args.iter)
        else:
            stats = bench_spmv(spmv_fn, csr, x, iterations=args.iter)
            y = spmv_fn(csr, x)
    except (NotImplementedError, ValueError) as e:
        # Plans the ported kernels cannot run yet (streamed-y, WT > 511).
        log("ERROR", f"{ALG_CSR} SpMV unavailable on the port: {e}")
        return 1
    y = y.float().cpu().numpy()

    vbytes = torch.finfo(dtype).bits // 8
    nnzs = stats.nnz_per_s(coo.nnz)
    gbs = stats.gb_per_s(spmv_bytes_csr(coo.nnz, coo.shape[0], vbytes))
    frac = roofline_fraction(gbs, device)
    log(
        "DATA",
        f"{ALG_CSR}: avg {stats.avg_ms:.6f} ms  "
        f"({nnzs/1e9:.3f} Gnnz/s, {gbs:.1f} GB/s eff, "
        f"{100*frac:.1f}% of roofline)",
    )
    if args.json_out:
        rec = {
            "alg": ALG_CSR,
            "file": args.file,
            "nnz": coo.nnz,
            "iterations": args.iter,
            "kernel": kernel,
            "dtype": args.dtype,
            "device": label,
            "avg_ms": stats.avg_ms,
            "min_ms": stats.min_ms,
            "max_ms": stats.max_ms,
            "stdev_ms": stats.stdev_ms,
            "per_launch_stats": stats.per_launch,
            "nnz_per_s": nnzs,
            "eff_gb_s": gbs,
            "roofline_frac": frac,
        }
        with open(args.json_out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        log("FILE", f"JSON record appended: {args.json_out}")
    if not args.no_report:
        path = write_report(
            args.dir,
            alg_name=ALG_CSR,
            input_file=args.file,
            nnz=coo.nnz,
            iterations=args.iter,
            stats=stats,
            output_vector=y[: coo.shape[0]],
            extra_metrics={
                "Device": label,
                "Kernel": kernel,
                "nnz/s": f"{nnzs:.4g}",
                "Effective GB/s": f"{gbs:.4g}",
                "Roofline fraction": f"{frac:.4g}",
            },
        )
        log("FILE", f"Execution report file saved as:\n\t{path}")

    log("STOP", "smvp-toolkit-tpu-torch run complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
