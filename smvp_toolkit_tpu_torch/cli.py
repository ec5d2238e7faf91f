"""Command line: the reference's CSR and TJDS benchmarks on the port.

Counterpart of the JAX package's ``cli.py`` for the flags the port has:
positional ``file`` (a ``.mtx`` path or ``synth:N:NNZ``), ``-c``, ``-t``,
``-n``, ``-d``, ``--no-report``, ``--decode-check``, ``--dtype``,
``--kernel``, ``--fused``, ``--x``, ``--json-out``, ``--spmm``,
``--solve``, ``--expand-symmetry``, ``--cocluster``, ``--analyze``, ``--shards``,
``--shard-balance`` and ``--device``, plus the port's
``--out-dir``, which writes the run's results as float32 ``.npy`` files.
Validation and exit codes match the JAX CLI for those flags (``-n 0`` and
``-d /nope`` give 2, a missing or unreadable file 1, a failed decode
check 3); argparse rejects every other flag (``-a``, ``-g``, ...) with 2.

``--kernel auto`` runs the SELL CUDA kernels: CSR and TJDS are both
replanned into SELL and run on the route their plan demands (K1, K3 or K4
per call, the matching N-iteration kernel under ``--fused``);
``--kernel torch`` runs the plain-PyTorch CSR or TJDS SpMV. ``--kernel df64``
runs CSR in double-float on K8 (``ops/spmv_df64.py``, a ``SellDf64SpMV``
built once from the CSR's host triplets) and reports ``hi + lo`` as
float32, as the JAX CLI does; ``SMVP_DF64_XLA=1`` takes the plain-PyTorch
``precision.spmv_csr_df64`` instead. TJDS has no double-float variant and
runs its ordinary SELL kernel, and ``--spmm`` runs on ``spmm_csr``; their
records name the kernel that ran. Under ``--fused`` the N df64 iterations
are one launch of K8's N-iteration kernel, where the JAX CLI falls back to
its loop protocol. The run is on ``cuda`` unless ``--device cpu`` is
given, where each kernel's plain version runs instead. In bfloat16,
``SMVP_SELL_PACK=1`` runs the SELL kernels on the packed plane (K5,
K2-packed; ``ops/spmv_sell.py``); ``--fused`` on a streamed-y plan then
fails, as the JAX operator's ``bench_loop`` does.

``--cocluster`` runs CSR on a ``CoClusteredSellSpMV`` (``ops/cocluster.py``
joint row and column maps, chunk 2048) built once from the CSR's host
triplets in the run's value dtype; its occupancy and chunk are logged.
Each call scatters x into the permuted coordinates, runs the inner
operator's kernel and gathers y back; under ``--fused`` the N iterations
are one K2 launch on the permuted planes (K2-cocluster), x scattered once
and y gathered once per launch. The JAX CLI builds its co-clustered
operator in float32 with its autotuned chunk and times its loop protocol
under ``--fused`` (its grid-fused timer never finds the co-clustered
operator in its cache). TJDS, ``--spmm`` and ``--solve`` keep the natural
operator; ``--kernel torch`` and ``df64`` ignore the flag, as the JAX CLI
does off its Pallas kernels. Co-clustering a 10M-nnz matrix is minutes of
host work. ``--analyze`` prints the JAX CLI's matrix analysis
(``utils/analyze.py``) before the benchmarks.

``--spmm K`` (with ``-c``) also times Y = A·X for K right-hand sides X
(standard normal from ``default_rng(0)``, as the JAX CLI draws them) on
the CSR matrix's SELL operator: one k-wide launch of the route's SpMM
kernel per call on a resident-y plan, one SpMV launch per column on a
streamed one; ``--fused`` times the N-iteration SpMM kernel on a
merged-word plan, and N ``matmat`` calls between one pair of CUDA events
on any other.

``--solve METHOD[:ITERS[:TOL]]`` (with ``-c``) then solves A x = b, b the
``--x`` vector, with one of the SPD methods the port has (``cg``,
``cg-fused``, ``pcg``, ``pcg-ic0``, ``pcg-ic0-fused``, ``chebyshev``,
``chebyshev-fused``); the JAX CLI's other methods exit 2 as not ported
yet. The scan-loop methods launch one SpMV per step (``--kernel auto``:
the SELL kernels; ``torch``: the plain-PyTorch CSR SpMV), the ``-fused``
ones the whole solve in one launch of their CUDA kernel. The relative
residual is checked in float64 through the run's SpMV kernel, and a
``SOLVE-<METHOD>`` report and JSON record are written.

``--shards N`` (N > 1) times the CSR and TJDS SpMVs sharded over N ranks
of a process group, one per device (``parallel/``): run it under
``torchrun`` with N processes (NCCL on cards; gloo with ``--device cpu``).
``--kernel auto`` runs each rank's SELL kernel on its row block
(``sell_dist.spmv_sell_sharded``), ``--kernel torch`` the plain-PyTorch
row-block CSR (``--shard-balance rows|nnz``) or striped TJDS sums; every
timed call includes the all-gather (all-reduce for stripes). A group of
fewer ranks fails as the JAX CLI fails with fewer devices (exit 1,
"requested N devices, only M present"); ``--fused`` with ``--shards > 1``
exits 2. ``--kernel df64`` (CSR) has no sharded variant and runs
unsharded, as the JAX CLI's forced kernels do; ``--cocluster``, ``--spmm``
and ``--solve`` run unsharded on each rank. Only rank 0 writes reports,
JSON records and ``--out-dir`` files.
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

# The JAX CLI's --solve methods (its cli.py SOLVE_METHODS) and the ones
# the port has.
SOLVE_METHODS = ("cg", "cg-fused", "pcg", "pcg-amg", "pcg-cheb",
                 "pcg-neumann", "pcg-ic0", "pcg-ic0-fused",
                 "pcg-ssor", "pcg-bjac", "bicgstab", "bicgstab-ilu",
                 "bicgstab-amg", "gmres", "gmres-ilu", "gmres-amg",
                 "minres", "chebyshev", "chebyshev-fused")
PORTED_SOLVE_METHODS = ("cg", "cg-fused", "pcg", "pcg-ic0", "pcg-ic0-fused",
                        "chebyshev", "chebyshev-fused")


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
        "--expand-symmetry", action="store_true",
        help="expand symmetric/skew/hermitian storage to the full matrix "
             "(the reference multiplies stored entries only)",
    )
    p.add_argument(
        "--kernel", choices=["auto", "torch", "df64"], default="auto",
        help="SpMV implementation (auto: the SELL CUDA kernels; torch: "
             "plain-PyTorch CSR gather + index_add_; df64: double-float "
             "CSR SpMV on the df64 SELL kernel, SMVP_DF64_XLA=1 for the "
             "plain-PyTorch float64 CSR path; TJDS and --spmm then run "
             "their ordinary kernels)",
    )
    p.add_argument(
        "--fused", action="store_true",
        help="time the N iterations as one launch of the N-iteration "
             "kernel (SELL kernels; with --kernel df64 the df64 kernel's "
             "N-iteration launch, where the JAX CLI times a loop)",
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
        "--spmm", type=int, default=None, metavar="K",
        help="also benchmark the SpMM Y = A·X with K right-hand sides on "
             "the CSR encoding (needs -c)",
    )
    p.add_argument(
        "--solve", default=None, metavar="METHOD[:ITERS[:TOL]]",
        help="after benchmarking, solve A x = b (b = the --x vector) with "
             f"one of {', '.join(PORTED_SOLVE_METHODS)}; default 100 "
             "iterations; an optional relative-residual target stops the "
             "scan-loop methods early (e.g. cg:200:1e-6); needs -c",
    )
    p.add_argument(
        "--out-dir", default=None, metavar="DIR",
        help="write the run's results in full float32 precision as .npy "
             "files in DIR: the CSR output vector (y.npy), the --spmm "
             "result Y (spmm.npy, nrows x K) and the --solve solution "
             "(solve.npy); needs -c",
    )
    p.add_argument(
        "--cocluster", action="store_true",
        help="run CSR on the joint row x column co-clustering planner's "
             "coordinates (ops/cocluster.py; minutes of host work for a "
             "10M-nnz matrix); --fused then times the N-iteration kernel on "
             "the permuted planes",
    )
    p.add_argument(
        "--analyze", action="store_true",
        help="print matrix structure statistics and kernel plan metrics",
    )
    p.add_argument(
        "--shards", type=int, default=1, metavar="N",
        help="data-parallel shards (row blocks), one rank each: run under "
             "torchrun with N processes (NCCL on cards, gloo with --device "
             "cpu)",
    )
    p.add_argument(
        "--shard-balance", choices=("rows", "nnz"), default="rows",
        help="row-block boundaries: equal rows (default) or equal-nnz "
             "quantiles (balances skewed matrices; --kernel torch CSR "
             "shards only)",
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
    if args.shards < 1:
        return "shard count must be >= 1"
    if args.fused and args.shards > 1:
        return "--fused is not supported together with --shards"
    if args.fused and args.kernel == "torch":
        return "--fused needs the SELL kernels (--kernel auto or df64)"
    if args.out_dir and not args.csr:
        return "--out-dir needs the CSR algorithm (-c)"
    if args.out_dir and not os.path.isdir(args.out_dir):
        return f"--out-dir does not exist: {args.out_dir}"
    if args.spmm is not None:
        if args.spmm < 1:
            return "--spmm K must be >= 1"
        if not args.csr:
            return "--spmm requires the CSR algorithm (-c)"
    if args.solve:
        return _validate_solve(args)
    return None


def _validate_solve(args) -> Optional[str]:
    """The JAX CLI's --solve checks, then the port's method list."""
    if not args.csr:
        return "--solve requires the CSR encoding (-c)"
    parts = args.solve.split(":")
    method = parts[0].lower()
    if method not in SOLVE_METHODS:
        return (f"--solve method must be one of {', '.join(SOLVE_METHODS)} "
                f"(got {method!r})")
    if len(parts) > 3:
        return f"--solve takes METHOD[:ITERS[:TOL]] (got {args.solve!r})"
    if len(parts) > 1:
        try:
            if int(parts[1]) < 1:
                return f"bad --solve iteration count: {args.solve!r}"
        except ValueError:
            return f"bad --solve iteration count: {args.solve!r}"
    if len(parts) > 2:
        try:
            if not 0 < float(parts[2]) < 1:
                return f"bad --solve tolerance: {args.solve!r}"
        except ValueError:
            return f"bad --solve tolerance: {args.solve!r}"
    if method not in PORTED_SOLVE_METHODS:
        return (f"--solve {method} is not ported yet; the port has "
                f"{', '.join(PORTED_SOLVE_METHODS)}")
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
    joined = []
    try:
        return _main(args, joined)
    finally:
        if joined:  # the process group this run joined
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args, joined: list) -> int:
    err = _validate(args)

    from smvp_toolkit_tpu_torch.utils.logging import log

    if err:
        log("ERROR", err)
        return 2

    log("START", "smvp-toolkit-tpu-torch benchmark run starting.")

    import torch

    from smvp_toolkit_tpu_torch.bench.harness import (
        bench_fused,
        bench_spmv,
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
    mesh = None
    if args.shards > 1:
        from smvp_toolkit_tpu_torch.parallel.mesh import (
            distributed_init,
            make_mesh,
        )

        import torch.distributed as dist

        if not dist.is_initialized() and distributed_init(device=device):
            joined.append(True)
        try:
            mesh = make_mesh(args.shards, device=device)
        except ValueError as e:
            log("ERROR", str(e))
            return 1
        if mesh.rank < 0:
            log("INFO", f"this rank is outside the {args.shards}-shard "
                "mesh; nothing to run")
            return 0
        device = mesh.device
    lead = mesh is None or mesh.group is None or \
        dist.get_rank() == 0
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
            coo = read_mtx(args.file, expand_symmetry=args.expand_symmetry,
                           dtype=dtype, device=device)
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

    if args.analyze:
        from smvp_toolkit_tpu_torch.utils.analyze import (
            analyze,
            format_analysis,
        )

        log("DATA", "Matrix analysis:")
        for line in format_analysis(analyze(coo)).splitlines():
            print(f"\t{line}")

    vbytes = torch.finfo(dtype).bits // 8
    on_card = device.type == "cuda"
    sell_kernel = "sell-cuda" if on_card else "sell-plain"

    def run(alg_name, encoded, spmv_fn, loop_fn, bytes_per_iter, kernel,
            shardable=True):
        """Benchmark one format; ``loop_fn(x, n)`` runs ``--fused``'s N
        iterations. With ``--shards > 1`` a shardable format runs its
        sharded SpMV."""
        sharded = mesh is not None and shardable
        if mesh is not None and not shardable:
            log("INFO", f"{alg_name} SpMV runs on the {kernel} kernel (no "
                "sharded variant).")
        log("INFO", f"Benchmarking {alg_name} SpMV ({kernel} kernel"
            f"{f', {args.shards} shards' if sharded else ''}), "
            f"{args.iter} iterations.")
        if sharded:
            from smvp_toolkit_tpu_torch.parallel.spmv_dist import (
                shard_and_bench,
            )

            stats, y = shard_and_bench(
                alg_name, encoded, x, args.shards, iterations=args.iter,
                kernel="torch" if args.kernel == "torch" else "auto",
                balance=args.shard_balance, mesh=mesh)
        elif args.fused:
            stats, y = bench_fused(loop_fn, x, iterations=args.iter)
        else:
            stats = bench_spmv(spmv_fn, encoded, x, iterations=args.iter)
            y = spmv_fn(encoded, x)
        y = y.float().cpu().numpy()
        if args.out_dir and alg_name == ALG_CSR and lead:
            _save(args.out_dir, "y.npy", y[: coo.shape[0]], log)
        nnzs = stats.nnz_per_s(coo.nnz)
        gbs = stats.gb_per_s(bytes_per_iter)
        frac = roofline_fraction(gbs, device)
        log(
            "DATA",
            f"{alg_name}: avg {stats.avg_ms:.6f} ms  "
            f"({nnzs/1e9:.3f} Gnnz/s, {gbs:.1f} GB/s eff, "
            f"{100*frac:.1f}% of roofline)",
        )
        if args.json_out and lead:
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
            if sharded:
                rec["shards"] = args.shards
            with open(args.json_out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            log("FILE", f"JSON record appended: {args.json_out}")
        if not args.no_report and lead:
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

    def refused(op_fn) -> bool:
        """``--fused`` on an operator (built by ``op_fn``) whose
        ``bench_loop`` refuses it now (``SMVP_SELL_PACK=1`` on a
        streamed-y plan): the run fails with the JAX operator's message."""
        why = args.fused and op_fn().bench_loop_refusal()
        if why:
            log("ERROR", why)
        return bool(why)

    if args.csr:
        csr = csr_encode(coo)
        if args.decode_check and not _decode_check(ALG_CSR, csr_decode(csr),
                                                   coo, log):
            return 3
        nbytes = spmv_bytes_csr(coo.nnz, coo.shape[0], vbytes)
        if args.kernel == "torch":
            spmv_fn, loop_fn, kernel = spmv_torch.spmv_csr, None, "torch"
        elif args.kernel == "df64":
            spmv_fn, loop_fn, kernel, nb = _df64_csr(csr, on_card)
            nbytes = nb or nbytes
        elif args.cocluster and mesh is not None:
            log("INFO", "--cocluster has no sharded variant; the sharded "
                "run plans the natural order.")
            spmv_fn, loop_fn, kernel = None, None, sell_kernel
        elif args.cocluster:
            spmv_fn, loop_fn, op = _cocluster_csr(csr, log)
            kernel = sell_kernel + "-cocluster"
            if refused(lambda: op.inner):
                return 2
        else:
            spmv_fn, kernel = spmv_sell.spmv_csr_sell, sell_kernel

            def loop_fn(xx, n):
                return spmv_sell.sell_op_csr(csr).bench_loop(xx, n)
            if refused(lambda: spmv_sell.sell_op_csr(csr)):
                return 2
        if args.cocluster and args.kernel != "auto":
            log("INFO", "--cocluster applies to the SELL kernels (--kernel "
                "auto) only; ignored on this path.")
        run(ALG_CSR, csr, spmv_fn, loop_fn, nbytes, kernel,
            shardable=args.kernel != "df64")
        if args.spmm:
            _run_spmm(args, coo, csr, device, label, log)
        if args.solve:
            # The solves step with the run's CSR SpMV; df64 solves on the
            # SELL kernels, as the JAX CLI solves df64 runs on its default.
            rc = _run_solve(args, coo, csr, x, device, label, log,
                            spmv_sell.spmv_csr_sell
                            if args.kernel == "df64" else spmv_fn)
            if rc:
                return rc

    if args.tjds:
        tj = tjds_encode(coo)
        if args.decode_check and not _decode_check(ALG_TJDS, tjds_decode(tj),
                                                   coo, log):
            return 3
        if args.kernel == "torch":
            spmv_fn, loop_fn, kernel = spmv_torch.spmv_tjds, None, "torch"
        else:
            if args.kernel == "df64":
                log("INFO", "df64 is CSR-only; TJDS runs its ordinary SELL "
                    "kernel.")
            spmv_fn, kernel = spmv_sell.spmv_tjds_sell, sell_kernel

            def loop_fn(xx, n):
                return spmv_sell.sell_op_tjds(tj).bench_loop(xx, n)
            if refused(lambda: spmv_sell.sell_op_tjds(tj)):
                return 2
        run(ALG_TJDS, tj, spmv_fn, loop_fn,
            spmv_bytes_tjds(coo.nnz, coo.shape[0], tj.num_diags, vbytes),
            kernel)

    log("STOP", "smvp-toolkit-tpu-torch run complete.")
    return 0


def _save(out_dir: str, name: str, arr: np.ndarray, log) -> None:
    """One ``--out-dir`` result as a float32 ``.npy`` file."""
    path = os.path.join(out_dir, name)
    np.save(path, np.asarray(arr, dtype=np.float32))
    log("FILE", f"Result saved as:\n\t{path}")


def _cocluster_csr(csr, log):
    """``--cocluster`` on CSR: ``(spmv_fn, loop_fn, operator)`` over a
    ``CoClusteredSellSpMV`` built once from the CSR's host triplets in the
    CSR's value dtype, chunk 2048. ``spmv_fn`` takes and returns natural
    coordinates; ``loop_fn`` scatters x once, runs ``bench_loop``
    (K2-cocluster) and gathers y once."""
    import torch

    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.ops import spmv_sell

    r, c, v, shape = spmv_sell._triplets_from_csr_host(csr)
    coo = COOMatrix.from_numpy(r, c, v, shape=shape, device="cpu")
    vdt = torch.bfloat16 if csr.dtype == torch.bfloat16 else torch.float32
    op = spmv_sell.CoClusteredSellSpMV(coo, value_dtype=vdt,
                                       device=csr.device)
    p = op.inner.plan
    log("INFO", f"co-clustered plan: occupancy {op.occupancy:.3f} (chunk "
        f"{p.chunk}; S {p.n_sublanes}, natural-order sublanes "
        f"{op.result.s_true_natural}, co-clustered "
        f"{op.result.s_true})")

    def csr_cc(encoded, xx):
        return op(xx)

    def loop(xx, n):
        return op.from_permuted(op.bench_loop(op.to_permuted(xx), n))

    return csr_cc, loop, op


def _df64_csr(csr, on_card: bool):
    """``--kernel df64`` on CSR: ``(spmv_fn, loop_fn, kernel label, bytes
    per iteration or None)``, each SpMV returning ``hi + lo`` as float32
    (the JAX CLI's displayed result). K8 through a ``SellDf64SpMV`` built
    once from the CSR's host triplets, its bytes
    ``SellDf64SpMV.traffic_bytes()``; under ``SMVP_DF64_XLA=1`` the
    plain-PyTorch ``spmv_csr_df64``, ``--fused`` then timing N calls."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell
    from smvp_toolkit_tpu_torch.ops.precision import spmv_csr_df64
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    if os.environ.get("SMVP_DF64_XLA") == "1":
        def csr_df64(encoded, xx):
            xx = xx.float()
            hi, lo = spmv_csr_df64(encoded, xx, xx.new_zeros(xx.shape))
            return hi + lo

        def loop(xx, n):
            for _ in range(n):
                y = csr_df64(csr, xx)
            return y

        return csr_df64, loop, "df64-torch", None
    r, c, v, shape = spmv_sell._triplets_from_csr_host(csr)
    op = SellDf64SpMV.from_coo_f64(r, c, v, shape, device=csr.device)

    def csr_df64(encoded, xx):
        hi, lo = op(xx.float(), None)
        return hi + lo

    def loop(xx, n):
        hi, lo = op.bench_loop(xx.float(), None, n)
        return hi + lo

    return (csr_df64, loop, "df64-cuda" if on_card else "df64-plain",
            op.traffic_bytes())


def _run_spmm(args, coo, csr, device, label, log) -> None:
    """``--spmm K``: time Y = A·X with K right-hand sides.

    The kernel label says what ran: ``sell-cuda-fused`` (one k-wide SpMM
    launch per call), ``sell-cuda-percolumn`` (a streamed-y plan: one
    SpMV launch per column), their ``sell-plain-*`` versions on the CPU,
    or ``torch`` (``spmm_csr``, also under ``--kernel df64``, which has no
    SpMM variant). The aggregate rate is K·nnz per call.
    """
    import torch

    from smvp_toolkit_tpu_torch.bench.harness import bench_fused, time_fn
    from smvp_toolkit_tpu_torch.ops import spmv_sell, spmv_torch

    k = args.spmm
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (coo.shape[1], k)).astype(np.float32)).to(device)
    timing = "per call"
    op = None
    if args.kernel in ("torch", "df64"):
        kernel = "torch"
        if args.kernel == "df64":
            log("INFO", "--spmm runs on the plain-PyTorch kernel (no df64 "
                "SpMM variant).")

        def spmm(XX):
            return spmv_torch.spmm_csr(csr, XX)
    else:
        op = spmv_sell.sell_op_csr(csr)
        spmm = op.matmat
        kernel = ("sell-cuda" if device.type == "cuda" else "sell-plain") + (
            "-percolumn" if op.plan.y_block_slices else "-fused")
    log("INFO", f"Benchmarking CSR SpMM ({kernel} kernel), K={k} right-hand "
        f"sides, {args.iter} iterations.")
    if args.fused:
        if op is not None and op.base_route == "relsl":
            timing = "N-iteration kernel"
            loop = op.bench_loop_mat
        else:
            timing = "N calls between one pair of events"

            def loop(XX, n):
                for _ in range(n):
                    Y = spmm(XX)
                return Y
        log("INFO", f"--fused SpMM timing: {timing}.")
        stats, Y = bench_fused(loop, X, iterations=args.iter)
    else:
        stats = time_fn(lambda: spmm(X), device=device, iterations=args.iter)
        Y = spmm(X)
    nnzs = stats.nnz_per_s(k * coo.nnz)
    log("DATA", f"SPMM k={k}: avg {stats.avg_ms:.6f} ms  "
        f"({nnzs/1e9:.3f} Gnnz/s across {k} RHS)")
    if args.out_dir:
        _save(args.out_dir, "spmm.npy", Y.float().cpu().numpy(), log)
    if args.json_out:
        rec = {
            "alg": "SPMM-CSR",
            "file": args.file,
            "nnz": coo.nnz,
            "k": k,
            "iterations": args.iter,
            "kernel": kernel,
            "timing": timing,
            "dtype": args.dtype,
            "device": label,
            "avg_ms": stats.avg_ms,
            "nnz_per_s_krhs": nnzs,
        }
        with open(args.json_out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        log("FILE", f"JSON record appended: {args.json_out}")


def _run_solve(args, coo, csr, x, device, label, log, spmv) -> int:
    """``--solve METHOD[:ITERS[:TOL]]``: solve A x = b, b = the --x vector
    (the JAX CLI's ``_run_solve`` for the ported methods).

    ``spmv`` is the run's CSR SpMV (the SELL kernels or the plain-PyTorch
    one): the scan-loop methods step with it and the residual check uses
    it. The fused methods run on the matrix's cached SELL operator.
    """
    import time

    import torch

    from smvp_toolkit_tpu_torch.models import solvers
    from smvp_toolkit_tpu_torch.ops import spmv_sell

    if coo.shape[0] != coo.shape[1]:
        log("ERROR", "--solve needs a square system")
        return 2
    spec = args.solve.split(":")
    method = spec[0].lower()
    iters = int(spec[1]) if len(spec) > 1 else 100
    tol = float(spec[2]) if len(spec) > 2 else None
    n = coo.shape[0]
    b = x[:n].float()

    def lanczos_bounds(safety_lo=0.3, safety_hi=1.1):
        """Chebyshev's spectrum bounds: 30 Lanczos steps from a random
        start (ones is an eigenvector of constant-row-sum matrices), with
        a deliberately low lower cushion (single-pass Lanczos tends to
        overestimate lambda_min, and an interval that misses the bottom
        of the spectrum makes the iteration diverge)."""
        v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
            n).astype(np.float32)).to(device)
        lows, highs = solvers.lanczos_eigsh(csr, v0, num_iters=min(30, n),
                                            k=1, spmv=spmv)
        return float(lows[0]) * safety_lo, float(highs[0]) * safety_hi

    def factors():
        from smvp_toolkit_tpu_torch.ops.ilu import ic0

        try:
            return ic0(csr)
        except ValueError as e:  # shift ladder exhausted: nowhere near SPD
            log("ERROR", str(e))
            return None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    res = None
    if method == "cg":
        xs, res = solvers.conjugate_gradient(csr, b, num_iters=iters,
                                             spmv=spmv, tol=tol)
    elif method == "pcg":
        from smvp_toolkit_tpu_torch.ops.algebra import diagonal

        xs, res = solvers.pcg(csr, b, diagonal(coo), num_iters=iters,
                              spmv=spmv, tol=tol)
    elif method == "pcg-ic0":
        f = factors()
        if f is None:
            return 2
        # The factors get their own SELL operators on the SELL path; the
        # plain-PyTorch path applies them with its CSR SpMV.
        m = solvers.ic0_preconditioner(
            f, sweeps=4, spmv=spmv,
            op_builder=None if args.kernel == "torch"
            else spmv_sell.sell_op_csr)
        xs, res = solvers.pcg_precond(csr, b, m, num_iters=iters, spmv=spmv,
                                      tol=tol)
    elif method == "chebyshev":
        lo, hi = lanczos_bounds()
        xs, _ = solvers.chebyshev(csr, b, lo, hi, num_iters=iters, spmv=spmv)
    else:  # the fused methods: the whole solve in one kernel launch
        from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg
        from smvp_toolkit_tpu_torch.ops.pcg_fused import (
            fused_chebyshev,
            fused_pcg_ic0,
        )

        op = spmv_sell.sell_op_csr(csr)
        if method == "cg-fused":
            xs = fused_cg(op, b, iters)
        elif method == "pcg-ic0-fused":
            f = factors()
            if f is None:
                return 2
            xs = fused_pcg_ic0(op, f, b, iters, sweeps=4)
        else:
            lo, hi = lanczos_bounds()
            xs = fused_chebyshev(op, b, lo, hi, iters)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    if tol is not None and res is not None:
        # The achieved count: history entries past the stopping step
        # repeat the final norm, so the first one at or below the target
        # is the stopping step. The fused methods and chebyshev take no
        # tolerance and run the count they were given.
        rn = res.double().cpu().numpy()
        tgt = tol * max(float(torch.linalg.vector_norm(b)), 1e-30)
        hit = np.nonzero(rn <= tgt * (1.0 + 1e-6))[0]
        iters = int(hit[0]) + 1 if hit.size else rn.shape[0]

    b64 = b.double().cpu().numpy()
    r = b64 - spmv(csr, xs).double().cpu().numpy()
    relres = float(np.linalg.norm(r) / max(np.linalg.norm(b64), 1e-30))
    log("DATA", f"SOLVE {method}: {iters} iterations in {ms:.2f} ms, "
        f"relative residual {relres:.3e}")
    if args.out_dir:
        _save(args.out_dir, "solve.npy", xs.float().cpu().numpy(), log)
    if not np.isfinite(relres) or relres > 1.0:
        log("INFO", f"solve did not converge — {method} assumes an SPD "
            "system; try more iterations")
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps({
                "alg": f"SOLVE-{method.upper()}",
                "file": args.file,
                "iterations": iters,
                "wall_ms": ms,
                "relative_residual": relres,
                "device": label,
            }) + "\n")
        log("FILE", f"JSON record appended: {args.json_out}")
    if not args.no_report:
        from smvp_toolkit_tpu_torch.bench.harness import TimingStats
        from smvp_toolkit_tpu_torch.bench.report import write_report

        path = write_report(
            args.dir,
            alg_name=f"SOLVE-{method.upper()}",
            input_file=args.file,
            nnz=coo.nnz,
            iterations=iters,
            stats=TimingStats(times_ms=np.asarray([ms]), iterations=1,
                              per_launch=True),
            output_vector=xs.float().cpu().numpy(),
            extra_metrics={"Device": label,
                           "Relative residual": f"{relres:.6g}"},
        )
        log("FILE", f"Solve report saved as:\n\t{path}")
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
