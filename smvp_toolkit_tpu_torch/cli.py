"""Command line: the reference's CSR and TJDS benchmarks on the port.

Counterpart of the JAX package's ``cli.py`` for the flags the port has:
positional ``file`` (a ``.mtx`` path or ``synth:N:NNZ``), ``-c``, ``-t``,
``-n``, ``-d``, ``--no-report``, ``--decode-check``, ``--dtype``,
``--kernel``, ``--fused``, ``--x``, ``--json-out`` and ``--device``.
Validation and exit codes match the JAX CLI for those flags (``-n 0`` and
``-d /nope`` give 2, a missing or unreadable file 1, a failed decode
check 3); argparse rejects every other flag (``-a``, ``-g``,
``--shards``, ...) with 2.

``--kernel auto`` runs the SELL CUDA kernels: CSR and TJDS are both
replanned into SELL and run on the route their plan demands (K1, K3 or K4
per call, the matching N-iteration kernel under ``--fused``);
``--kernel torch`` runs the plain-PyTorch CSR or TJDS SpMV. The run is on
``cuda`` unless ``--device cpu`` is given, where each kernel's plain
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
ALG_TJDS = "TJDS"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smvp-toolkit-tpu-torch",
        description="Sparse-matrix codec + SpMV benchmark (CSR / TJDS, "
                    "PyTorch/CUDA)",
    )
    p.add_argument("file", help="input MatrixMarket (.mtx) file, or "
                   "synth:N:NNZ for a synthetic banded matrix")
    p.add_argument("-c", "--csr", action="store_true",
                   help="benchmark CSR SpMV")
    p.add_argument("-t", "--tjds", action="store_true",
                   help="benchmark TJDS SpMV")
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
    p.add_argument(
        "--decode-check", action="store_true",
        help="verify each encoded format decodes bit-exactly to the input",
    )
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
    if not (args.csr or args.tjds):
        return "no algorithm selected (use -c and/or -t)"
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
        spmv_bytes_tjds,
    )
    from smvp_toolkit_tpu_torch.formats.csr import csr_decode, csr_encode
    from smvp_toolkit_tpu_torch.formats.tjds import tjds_decode, tjds_encode
    from smvp_toolkit_tpu_torch.io.mtx import (
        MTXError,
        MTXUnsupportedType,
        read_mtx,
    )
    from smvp_toolkit_tpu_torch.ops import spmv_sell, spmv_torch
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

    vbytes = torch.finfo(dtype).bits // 8
    if args.kernel == "torch":
        kernel = "torch"
    else:
        kernel = "sell-cuda" if device.type == "cuda" else "sell-plain"

    def run(alg_name, encoded, spmv_fn, op_fn, bytes_per_iter):
        log("INFO", f"Benchmarking {alg_name} SpMV ({kernel} kernel), "
            f"{args.iter} iterations.")
        if args.fused:
            stats, y = bench_spmv_fused(op_fn(encoded), x,
                                        iterations=args.iter)
        else:
            stats = bench_spmv(spmv_fn, encoded, x, iterations=args.iter)
            y = spmv_fn(encoded, x)
        y = y.float().cpu().numpy()
        nnzs = stats.nnz_per_s(coo.nnz)
        gbs = stats.gb_per_s(bytes_per_iter)
        frac = roofline_fraction(gbs, device)
        log(
            "DATA",
            f"{alg_name}: avg {stats.avg_ms:.6f} ms  "
            f"({nnzs/1e9:.3f} Gnnz/s, {gbs:.1f} GB/s eff, "
            f"{100*frac:.1f}% of roofline)",
        )
        if args.json_out:
            rec = {
                "alg": alg_name,
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
                alg_name=alg_name,
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

    if args.csr:
        csr = csr_encode(coo)
        if args.decode_check and not _decode_check(ALG_CSR, csr_decode(csr),
                                                   coo, log):
            return 3
        if args.kernel == "torch":
            spmv_fn, op_fn = spmv_torch.spmv_csr, None
        else:
            spmv_fn, op_fn = spmv_sell.spmv_csr_sell, spmv_sell.sell_op_csr
        run(ALG_CSR, csr, spmv_fn, op_fn,
            spmv_bytes_csr(coo.nnz, coo.shape[0], vbytes))

    if args.tjds:
        tj = tjds_encode(coo)
        if args.decode_check and not _decode_check(ALG_TJDS, tjds_decode(tj),
                                                   coo, log):
            return 3
        if args.kernel == "torch":
            spmv_fn, op_fn = spmv_torch.spmv_tjds, None
        else:
            spmv_fn, op_fn = spmv_sell.spmv_tjds_sell, spmv_sell.sell_op_tjds
        run(ALG_TJDS, tj, spmv_fn, op_fn,
            spmv_bytes_tjds(coo.nnz, coo.shape[0], tj.num_diags, vbytes))

    log("STOP", "smvp-toolkit-tpu-torch run complete.")
    return 0


def _decode_check(alg, decoded, coo, log) -> bool:
    """Decoded triplets against the input, both in canonical row-major
    order: indices equal and values equal bit for bit."""
    r, c, v = decoded.canonical_order().to_numpy()
    R, C, V = coo.canonical_order().to_numpy()
    ok = (np.array_equal(r, R) and np.array_equal(c, C)
          and v.dtype == V.dtype and v.tobytes() == V.tobytes())
    if ok:
        log("INFO", f"{alg} decode round-trip: bit-exact ✓")
    else:
        log("ERROR", f"{alg} decode round-trip FAILED")
    return ok


if __name__ == "__main__":
    sys.exit(main())
