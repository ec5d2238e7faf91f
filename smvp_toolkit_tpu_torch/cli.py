"""Command line: the reference's CSR, TJDS and CISR workflow on the port.

Counterpart of the JAX package's ``cli.py`` for the flags the port has:
positional ``file`` (a ``.mtx`` path or ``synth:N:NNZ``), ``-a``, ``-c``,
``-t``, ``-g``, ``-n``, ``-s``, ``-d``, ``--no-report``, ``--decode-check``,
``--coe-out``, ``--debug``, ``--lut-out``, ``--save-encoded``, ``--dtype``,
``--kernel``, ``--fused``, ``--x``, ``--json-out``, ``--spmm``,
``--solve``, ``--eigs``, ``--expand-symmetry``, ``--cocluster``,
``--analyze``, ``--export-aot``, ``--profile``,
``--shards``, ``--shard-balance`` and ``--device``, plus the port's
``--out-dir``, which writes the run's results as ``.npy`` files (the CSR
and CISR output vectors, the SpMM result, the solution; float32, or
complex64 for a complex matrix). Validation and exit codes match the JAX
CLI (``-a`` with ``-c``, ``-t`` or ``-g``, ``-n 0``, ``-s`` outside
1..255, ``--lut-out`` without TJDS, ``--save-encoded`` or ``--export-aot``
without ``-c``, ``-t`` or ``-a``, and ``-d /nope`` give 2; a missing or
unreadable file and a failed ``.coe`` export 1; a failed decode check 3).

``--kernel native`` runs CSR and TJDS on the host C++ backend
(``ops/spmv_native.py`` over ``csrc/spmv.cpp``, built ``-O3
-march=native`` at first use): the user's explicit request for the host,
as in the JAX CLI, with the iterations batched inside the C loop, per
call and under ``--fused`` alike (``bench.harness.bench_native_batched``;
host wall time). CISR, ``--spmm`` and ``--shards`` have no native variant:
CISR and ``--spmm`` run the plain PyTorch kernels and ``--shards`` the
sharded plain PyTorch kernels, each logged, as the JAX CLI runs its XLA
kernels there; the solves run on the SELL kernels.

A complex ``.mtx`` is read in complex64 (the JAX CLI's promotion, logged)
and x is complex64. The SELL kernels are real-valued, so CSR and TJDS run
the plain PyTorch SpMVs (``ops/spmv_torch.py``) on the run's device,
logged, and the reports name the ``torch`` kernel and print ``re+imj``
cells; ``--fused`` times N of those calls between one pair of events.
``--solve cg|pcg|bicgstab|gmres|minres`` run in complex arithmetic
(``models/solvers.py``'s inner products conjugate); the other methods and
``--eigs`` exit 2 with the JAX CLI's message after the CSR benchmark, as
the JAX CLI refuses them (``_complex_refusal``).

``--export-aot PREFIX`` writes each format's SpMV program with the matrix
in it as ``PREFIX_csr.pt2`` / ``PREFIX_tjds.pt2`` (``utils/aot.py`` on
``torch.export``; the JAX CLI writes ``.jaxexport`` files): the plain
PyTorch SpMV of the format, since the SELL kernels' ctypes launches cannot
be traced, on the run's device. ``--profile DIR`` records each format's
SpMV, ten calls after the timed ones (the N-iteration kernel under
``--fused``), with ``torch.profiler`` into ``DIR/<ALG>/trace.json``
(``bench/profile.py``).

``-a`` runs CSR, TJDS and CISR; ``-g`` CISR alone, the reference's
``smvp_cisr_coegen`` (main-cli.c:542-728): the rows are scheduled onto
``-s`` channels (``formats/cisr.py``, the C++ scheduler
``csrc/cisr.cpp``), the Vivado ``.coe`` image goes to ``--coe-out`` or to
stdout, and then the SpMV from the schedule is timed: ``--kernel auto``
replans the schedule's live cells into SELL (``spmv_sell.spmv_cisr_sell``:
K1 per call, K2 under ``--fused``, or whatever kernel the plan's route
demands), ``--kernel torch`` runs it channel per lane (``ops/spmv_cisr.py``,
plain PyTorch, as the JAX CLI runs its XLA CISR path), and so does
``--kernel df64``, which has no CISR variant; the record names the kernel
that ran. ``--decode-check`` also holds the schedule's decode
(``cisr_decode``) to the input, which the JAX CLI does not. ``--debug``
(or ``SMVP_DEBUG=1``) dumps the COO, CSR and TJDS arrays to stderr
(``utils/debug.py``), ``--save-encoded PREFIX`` writes ``PREFIX_csr.npz``
and ``PREFIX_tjds.npz`` (``utils/checkpoint.py``, loadable by either
package) and ``--lut-out`` the TJDS Verilog LUT (``formats/vivado.py``),
at the JAX CLI's points of the run. ``--kernel`` also takes the JAX names
``pallas`` (= ``auto``) and ``xla`` (= ``torch``).

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
joint row and column maps, the autotuned chunk) built once from the CSR's host
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
``--x`` vector, with any of the JAX CLI's nineteen methods: CG and its
preconditioned forms (``pcg`` Jacobi, ``pcg-cheb`` and ``pcg-neumann``
polynomials, ``pcg-ic0``, ``pcg-ssor``, ``pcg-bjac`` block Jacobi,
``pcg-amg``), ``chebyshev``, ``minres``, ``bicgstab`` and ``gmres`` (20
steps a restart; its count is rounded up to whole restarts), the latter
two right-preconditioned by ILU(0) (``-ilu``) or by AMG on the symmetric
part (A + Aᵀ)/2 (``-amg``), and the fused ``cg-fused``,
``pcg-ic0-fused`` and ``chebyshev-fused``. The scan-loop methods launch
one SpMV per step (``--kernel auto``: the SELL kernels, the triangular
factors, SSOR's parts and every AMG level on their own SELL operators;
``torch``: the plain-PyTorch CSR SpMV throughout), the ``-fused`` ones
the whole solve in one launch of their CUDA kernel. The relative residual
is checked in float64 through the run's SpMV kernel, and a
``SOLVE-<METHOD>`` report and JSON record are written. ``--eigs
K[:ITERS]`` (with ``-c``; 60 iterations by default) runs LOBPCG for the K
smallest eigenpairs before the solve, AMG-preconditioned when the
hierarchy builds (its SpMMs on the k-column SELL kernels) and
unpreconditioned when the set-up refuses the matrix; the JAX CLI falls
back on any exception there, the port only on the set-up's own refusal
(a ValueError), so a kernel's build or launch failure still stops the
run. A refused solve or ``--eigs`` exits 2 with the JAX CLI's message
(a non-square system, an ILU shift ladder or an AMG coarsening that
fails, K above the dimension); on a complex matrix, a ``--solve``
method or ``--eigs`` that the JAX CLI refuses for complex systems exits 2
with the JAX message, as the JAX CLI does after its benchmark.

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
ALG_CISR = "CISR"

# The --out-dir file of each format's output vector.
OUT_NAMES = {ALG_CSR: "y.npy", ALG_CISR: "cisr.npy"}

# The JAX CLI's --kernel names for the port's kernels.
KERNEL_ALIASES = {"pallas": "auto", "xla": "torch"}

# The JAX CLI's --solve methods (its cli.py SOLVE_METHODS).
SOLVE_METHODS = ("cg", "cg-fused", "pcg", "pcg-amg", "pcg-cheb",
                 "pcg-neumann", "pcg-ic0", "pcg-ic0-fused",
                 "pcg-ssor", "pcg-bjac", "bicgstab", "bicgstab-ilu",
                 "bicgstab-amg", "gmres", "gmres-ilu", "gmres-amg",
                 "minres", "chebyshev", "chebyshev-fused")
# The methods the JAX CLI runs on SPD systems only, and its right-
# preconditioned general ones (their refusals and non-convergence hints).
SPD_METHODS = ("cg", "cg-fused", "pcg", "pcg-amg", "pcg-cheb", "pcg-neumann",
               "pcg-ic0", "pcg-ssor", "pcg-bjac", "chebyshev")
PRECONDITIONED_GENERAL = ("bicgstab-ilu", "bicgstab-amg", "gmres-ilu",
                          "gmres-amg")
# The methods the JAX CLI also solves in complex arithmetic.
COMPLEX_METHODS = ("cg", "pcg", "bicgstab", "gmres", "minres")
GMRES_RESTART = 20  # the JAX CLI's GMRES(m)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smvp-toolkit-tpu-torch",
        description="Sparse-matrix codec + SpMV benchmark (CSR / TJDS / "
                    "CISR, PyTorch/CUDA)",
    )
    p.add_argument("file", help="input MatrixMarket (.mtx) file, or "
                   "synth:N:NNZ for a synthetic banded matrix")
    p.add_argument("-a", "--all-algs", action="store_true",
                   help="benchmark all algorithms (CSR + TJDS + CISR export)")
    p.add_argument("-c", "--csr", action="store_true",
                   help="benchmark CSR SpMV")
    p.add_argument("-t", "--tjds", action="store_true",
                   help="benchmark TJDS SpMV")
    p.add_argument("-g", "--cisr-gen", action="store_true",
                   help="generate a CISR .coe memory image and benchmark "
                        "the SpMV from its schedule")
    p.add_argument(
        "-n", "--iter", type=int, default=1000, metavar="ITERATIONS",
        help="number of timed SpMV iterations (default 1000)",
    )
    p.add_argument("-s", "--slots", type=int, default=16, metavar="SLOTS",
                   help="CISR slot/channel count (default 16)")
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
        "--coe-out", default=None, metavar="FILE",
        help="write the CISR .coe image to FILE instead of stdout",
    )
    p.add_argument(
        "--debug", action="store_true",
        help="dump encoded-format internals to stderr (reference "
             "SMVP_CSR_DEBUG/SMVP_TJDS_DEBUG printf harness analog)",
    )
    p.add_argument(
        "--lut-out", default=None, metavar="FILE",
        help="write the TJDS Verilog LUT image to FILE (needs -t or -a)",
    )
    p.add_argument(
        "--save-encoded", default=None, metavar="PREFIX",
        help="checkpoint encoded matrices to PREFIX_{csr,tjds}.npz",
    )
    p.add_argument(
        "--kernel", choices=["auto", "torch", "df64", "native",
                             *KERNEL_ALIASES],
        default="auto",
        help="SpMV implementation (auto or pallas: the SELL CUDA kernels; "
             "torch or xla: plain-PyTorch CSR gather + index_add_, and the "
             "CISR schedule channel per lane; df64: double-float CSR SpMV "
             "on the df64 SELL kernel, SMVP_DF64_XLA=1 for the "
             "plain-PyTorch float64 CSR path; TJDS, CISR and --spmm then "
             "run their ordinary kernels; native: the host C++ CSR and TJDS "
             "backend, iterations batched in the C loop)",
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
             f"one of {', '.join(SOLVE_METHODS)}; default 100 iterations; "
             "an optional relative-residual target stops the scan-loop "
             "methods early (per step; per restart for gmres), e.g. "
             "cg:200:1e-6; needs -c",
    )
    p.add_argument(
        "--eigs", default=None, metavar="K[:ITERS]",
        help="after benchmarking, compute the K smallest eigenpairs of the "
             "(symmetric) matrix with LOBPCG (default 60 iterations), "
             "AMG-preconditioned when the hierarchy builds; logs the Ritz "
             "values and eigen-residuals; needs -c",
    )
    p.add_argument(
        "--out-dir", default=None, metavar="DIR",
        help="write the run's results in full float32 precision as .npy "
             "files in DIR: the CSR output vector (y.npy), the CISR one "
             "(cisr.npy, with -a), the --spmm result Y (spmm.npy, nrows x "
             "K) and the --solve solution (solve.npy); needs -c or -a",
    )
    p.add_argument(
        "--cocluster", action="store_true",
        help="run CSR on the joint row x column co-clustering planner's "
             "coordinates (ops/cocluster.py; minutes of host work for a "
             "10M-nnz matrix); --fused then times the N-iteration kernel on "
             "the permuted planes",
    )
    p.add_argument(
        "--export-aot", default=None, metavar="PREFIX",
        help="export each format's SpMV program (matrix inside) with "
             "torch.export to PREFIX_{csr,tjds}.pt2; a serving process "
             "loads it with torch.export.load alone",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="record a torch.profiler trace of each format's SpMV into "
             "DIR/<ALG>/trace.json",
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


def _algs(args):
    """(run CSR, run TJDS, run CISR): ``-a`` runs all three."""
    return (args.csr or args.all_algs, args.tjds or args.all_algs,
            args.cisr_gen or args.all_algs)


def _validate(args) -> Optional[str]:
    """Reference-equivalent validation (main-cli.c:1274-1386), in the JAX
    CLI's order, then the port's own checks."""
    if args.all_algs and (args.csr or args.tjds or args.cisr_gen):
        return "--all-algs cannot be combined with individual algorithm flags"
    if not (args.all_algs or args.csr or args.tjds or args.cisr_gen):
        return "no algorithm selected (use -a, -c, -t and/or -g)"
    if args.iter < 1:
        return "iteration count must be >= 1"
    if args.slots < 1 or args.slots > 255:
        return "slot count must be in 1..255 (8-bit field in the COE format)"
    if args.dir and not os.path.isdir(args.dir):
        return f"report directory does not exist: {args.dir}"
    if args.shards < 1:
        return "shard count must be >= 1"
    if args.fused and args.shards > 1:
        return "--fused is not supported together with --shards"
    run_csr, run_tjds, _ = _algs(args)
    if args.lut_out and not run_tjds:
        return "--lut-out requires the TJDS algorithm (-t or -a)"
    if args.save_encoded and not (run_csr or run_tjds):
        return "--save-encoded requires -c, -t or -a"
    if args.export_aot and not (run_csr or run_tjds):
        return "--export-aot requires -c, -t or -a"
    if args.fused and args.kernel == "torch":
        return "--fused needs the SELL kernels (--kernel auto or df64)"
    if args.out_dir and not run_csr:
        return "--out-dir needs the CSR algorithm (-c or -a)"
    if args.out_dir and not os.path.isdir(args.out_dir):
        return f"--out-dir does not exist: {args.out_dir}"
    if args.spmm is not None:
        if args.spmm < 1:
            return "--spmm K must be >= 1"
        if not run_csr:
            return "--spmm requires the CSR algorithm (-c or -a)"
    if args.eigs is not None:
        parts = args.eigs.split(":")
        if len(parts) > 2:
            return f"--eigs takes K[:ITERS] (got {args.eigs!r})"
        try:
            if int(parts[0]) < 1 or (len(parts) > 1 and int(parts[1]) < 1):
                return f"bad --eigs spec: {args.eigs!r}"
        except ValueError:
            return f"bad --eigs spec: {args.eigs!r}"
        if not run_csr:
            return "--eigs requires the CSR algorithm (-c or -a)"
    if args.solve:
        err = _validate_solve(args, run_csr)
        if err:
            return err
    if args.decode_check and not (run_csr or run_tjds):
        return "--decode-check requires -c, -t or -a"
    return None


def _validate_solve(args, run_csr: bool) -> Optional[str]:
    """The JAX CLI's --solve checks."""
    if not run_csr:
        return "--solve requires the CSR encoding (-c or -a)"
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
    return None


def _complex_refusal(args) -> Optional[str]:
    """The JAX CLI's refusal of this run's ``--eigs`` or ``--solve`` on a
    complex system (in its order: the eigenpairs first), or None."""
    if args.eigs is not None:
        return "--eigs supports real symmetric systems only"
    if not args.solve:
        return None
    method = args.solve.split(":", 1)[0].lower()
    if method in COMPLEX_METHODS:
        return None
    if method in PRECONDITIONED_GENERAL:
        return f"--solve {method} supports real systems only"
    return f"--solve {method} needs a real SPD system"


def _make_x(mode: str, n: int, dtype, device):
    """x = ones (the reference protocol) or the JAX CLI's random stream
    (a complex dtype takes the same draws as its real parts)."""
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
    args.kernel = KERNEL_ALIASES.get(args.kernel, args.kernel)
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
        bench_native_batched,
        bench_spmv,
    )
    from smvp_toolkit_tpu_torch.bench.report import write_report
    from smvp_toolkit_tpu_torch.bench.roofline import (
        roofline_fraction,
        spmv_bytes_cisr,
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
            try:
                coo = read_mtx(args.file,
                               expand_symmetry=args.expand_symmetry,
                               dtype=dtype, device=device)
            except MTXUnsupportedType as e:
                if "complex" not in str(e):
                    raise
                # A complex matrix under a real --dtype: promote, as the
                # JAX CLI does.
                log("INFO", "complex matrix: using complex64 values.")
                coo = read_mtx(args.file,
                               expand_symmetry=args.expand_symmetry,
                               dtype=None, device=device)
        except FileNotFoundError:
            log("ERROR", f"could not open file: {args.file}")
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

    is_complex = coo.dtype.is_complex
    try:
        x = _make_x(args.x, coo.shape[1],
                    torch.complex64 if is_complex else dtype, device)
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

    if is_complex:
        # The SELL, df64 and native kernels are real-valued: CSR and TJDS
        # run the plain PyTorch SpMVs, as the JAX CLI runs its XLA ones.
        if args.kernel not in ("auto", "torch"):
            log("INFO", f"complex matrix: --kernel {args.kernel} "
                "unsupported, using the plain PyTorch kernels.")
        else:
            log("INFO", "complex matrix: the SELL kernels are real-valued; "
                "CSR and TJDS run the plain PyTorch kernels.")

    vbytes = torch.finfo(dtype).bits // 8
    on_card = device.type == "cuda"
    sell_kernel = "sell-cuda" if on_card else "sell-plain"
    run_csr, run_tjds, run_cisr = _algs(args)

    from smvp_toolkit_tpu_torch.utils import debug

    debug_on = args.debug or debug.debug_enabled()
    if debug_on:
        debug.dump_coo(coo)

    def save_encoded(alg, encoded):
        if args.save_encoded and lead:
            from smvp_toolkit_tpu_torch.utils.checkpoint import save_matrix

            path = f"{args.save_encoded}_{alg.lower()}.npz"
            save_matrix(path, encoded)
            log("FILE", f"{alg} checkpoint: {path}")

    def run(alg_name, encoded, spmv_fn, loop_fn, bytes_per_iter, kernel,
            shardable=True, native_op=None):
        """Benchmark one format; ``loop_fn(x, n)`` runs ``--fused``'s N
        iterations, ``native_op`` (``--kernel native``) batches them in its
        C loop. With ``--shards > 1`` a shardable format runs its sharded
        SpMV (the plain PyTorch one for ``torch``, ``native`` and complex
        runs)."""
        sharded = mesh is not None and shardable
        if mesh is not None and not shardable:
            log("INFO", f"{alg_name} SpMV runs on the {kernel} kernel (no "
                "sharded variant).")
        if sharded and native_op is not None:
            native_op, kernel = None, "torch"
            log("INFO", "--shards does not support the native backend; "
                "benchmarking the torch kernel instead.")
        log("INFO", f"Benchmarking {alg_name} SpMV ({kernel} kernel"
            f"{f', {args.shards} shards' if sharded else ''}), "
            f"{args.iter} iterations.")
        if sharded:
            from smvp_toolkit_tpu_torch.parallel.spmv_dist import (
                shard_and_bench,
            )

            stats, y = shard_and_bench(
                alg_name, encoded, x, args.shards, iterations=args.iter,
                kernel="torch" if kernel == "torch" else "auto",
                balance=args.shard_balance, mesh=mesh)
        elif native_op is not None:
            stats = bench_native_batched(native_op, x, iterations=args.iter)
            y = torch.from_numpy(native_op(x))
        elif args.fused:
            stats, y = bench_fused(loop_fn, x, iterations=args.iter)
        else:
            stats = bench_spmv(spmv_fn, encoded, x, iterations=args.iter)
            y = spmv_fn(encoded, x)
        if args.profile and lead:
            from smvp_toolkit_tpu_torch.bench.profile import profile_fn

            where = os.path.join(args.profile, alg_name)
            if args.fused and native_op is None and not sharded:
                profile_fn(loop_fn, x, args.iter, log_dir=where,
                           iterations=1)
            else:
                profile_fn(spmv_fn, encoded, x, log_dir=where)
            log("FILE", f"Profiler trace: {where}")
        y = (y if y.is_complex() else y.float()).cpu().numpy()
        if args.out_dir and alg_name in OUT_NAMES and lead:
            _save(args.out_dir, OUT_NAMES[alg_name], y[: coo.shape[0]], log)
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
            _append_json(args.json_out, rec, log)
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

    if run_csr:
        csr = csr_encode(coo)
        if debug_on:
            debug.dump_csr(csr)
        if args.decode_check and not _decode_check(ALG_CSR, csr_decode(csr),
                                                   coo, log):
            return 3
        save_encoded(ALG_CSR, csr)
        nbytes = spmv_bytes_csr(coo.nnz, coo.shape[0], vbytes)
        if args.export_aot and lead:
            _export_aot(args.export_aot, ALG_CSR, csr, log)
        native_op = None
        if is_complex:
            spmv_fn, kernel = spmv_torch.spmv_csr, "torch"
            loop_fn = _calls(spmv_fn, csr)
        elif args.kernel == "torch":
            spmv_fn, loop_fn, kernel = spmv_torch.spmv_csr, None, "torch"
        elif args.kernel == "native":
            spmv_fn, native_op = _native(ALG_CSR, csr)
            loop_fn, kernel = None, "native"
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
        if args.cocluster and (args.kernel != "auto" or is_complex):
            log("INFO", "--cocluster applies to the SELL kernels (--kernel "
                "auto) only; ignored on this path.")
        run(ALG_CSR, csr, spmv_fn, loop_fn, nbytes, kernel,
            shardable=is_complex or args.kernel != "df64",
            native_op=native_op)
        if args.spmm:
            _run_spmm(args, coo, csr, device, label, log)
        if is_complex:
            refusal = _complex_refusal(args)
            if refusal:
                log("ERROR", refusal)
                return 2
        # The solves and LOBPCG step with the run's CSR SpMV; df64 and
        # native runs solve on the SELL kernels, as the JAX CLI solves
        # them on its default kernel.
        solve_spmv = spmv_fn
        if spmv_fn is None or (args.kernel in ("df64", "native")
                               and not is_complex):
            solve_spmv = spmv_sell.spmv_csr_sell
        if args.eigs:
            rc = _run_eigs(args, coo, csr, label, log, solve_spmv)
            if rc:
                return rc
        if args.solve:
            rc = _run_solve(args, coo, csr, x, device, label, log,
                            solve_spmv)
            if rc:
                return rc

    if run_tjds:
        tj = tjds_encode(coo)
        if debug_on:
            debug.dump_tjds(tj)
        if args.decode_check and not _decode_check(ALG_TJDS, tjds_decode(tj),
                                                   coo, log):
            return 3
        save_encoded(ALG_TJDS, tj)
        if args.lut_out and lead:
            from smvp_toolkit_tpu_torch.formats.vivado import write_tjds_lut

            write_tjds_lut(tj, args.lut_out)
            log("FILE", f"TJDS Verilog LUT image saved as:\n\t{args.lut_out}")
        if args.export_aot and lead:
            _export_aot(args.export_aot, ALG_TJDS, tj, log)
        native_op = None
        if is_complex:
            spmv_fn, kernel = spmv_torch.spmv_tjds, "torch"
            loop_fn = _calls(spmv_fn, tj)
        elif args.kernel == "torch":
            spmv_fn, loop_fn, kernel = spmv_torch.spmv_tjds, None, "torch"
        elif args.kernel == "native":
            spmv_fn, native_op = _native(ALG_TJDS, tj)
            loop_fn, kernel = None, "native"
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
            kernel, native_op=native_op)

    if run_cisr:
        # The schedule, its .coe image, then the SpMV from the schedule.
        from smvp_toolkit_tpu_torch.formats.cisr import (
            cisr_decode,
            cisr_encode,
            write_coe,
        )
        from smvp_toolkit_tpu_torch.ops import spmv_cisr

        log("INFO", f"Generating CISR schedule with {args.slots} slots.")
        cisr = cisr_encode(coo, slot_count=args.slots)
        if lead:
            try:
                text = write_coe(cisr, args.coe_out)
            except ValueError as e:
                log("ERROR", f"COE export failed: {e}")
                return 1
            if args.coe_out:
                log("FILE", f"CISR COE image saved as:\n\t{args.coe_out}")
            else:
                print(text)
        if args.decode_check and not _decode_check(
                ALG_CISR, cisr_decode(cisr, device="cpu"), coo, log):
            return 3
        if args.kernel == "auto" and not is_complex:
            spmv_fn, kernel = spmv_sell.spmv_cisr_sell, sell_kernel

            def loop_fn(xx, n):
                return spmv_sell.sell_op_cisr(cisr, device).bench_loop(xx, n)
            if refused(lambda: spmv_sell.sell_op_cisr(cisr, device)):
                return 2
        else:
            if args.kernel == "df64":
                log("INFO", "df64 is CSR-only; CISR runs the plain-PyTorch "
                    "schedule SpMV.")
            elif args.kernel == "native":
                log("INFO", "CISR SpMV runs on the torch kernel (no "
                    "sharded/native variant).")
            spmv_fn, kernel = spmv_cisr.spmv_cisr, "torch"
            loop_fn = _calls(spmv_fn, cisr)
        run(ALG_CISR, cisr, spmv_fn, loop_fn,
            spmv_bytes_cisr(cisr.num_groups, cisr.slot_count, coo.shape[0],
                            vbytes),
            kernel, shardable=False)

    log("STOP", "smvp-toolkit-tpu-torch run complete.")
    return 0


def _save(out_dir: str, name: str, arr: np.ndarray, log) -> None:
    """One ``--out-dir`` result as a float32 (complex: complex64) ``.npy``
    file."""
    path = os.path.join(out_dir, name)
    np.save(path, np.asarray(
        arr, dtype=np.complex64 if np.iscomplexobj(arr) else np.float32))
    log("FILE", f"Result saved as:\n\t{path}")


def _calls(spmv_fn, encoded):
    """``--fused``'s loop on a kernel with no N-iteration launch: N calls
    (between one pair of CUDA events in ``bench_fused``)."""
    def loop(xx, n):
        for _ in range(n):
            y = spmv_fn(encoded, xx)
        return y
    return loop


def _native(alg: str, encoded):
    """``--kernel native``: ``(spmv_fn, operator)`` over the host C++
    backend, the operator built once (it copies the format's arrays to the
    host); ``spmv_fn`` returns y as a host tensor."""
    import torch

    from smvp_toolkit_tpu_torch.ops.spmv_native import (
        NativeCsrSpMV,
        NativeTjdsSpMV,
    )

    op = (NativeCsrSpMV if alg == ALG_CSR else NativeTjdsSpMV)(encoded)

    def spmv_native(_encoded, xx):
        return torch.from_numpy(op(xx))

    return spmv_native, op


def _export_aot(prefix: str, alg: str, matrix, log) -> None:
    """``--export-aot``: the format's plain PyTorch SpMV with the matrix
    inside, as ``PREFIX_<alg>.pt2`` (``utils/aot.py``)."""
    from smvp_toolkit_tpu_torch.utils.aot import export_spmv, write_blob

    path = f"{prefix}_{alg.lower()}.pt2"
    write_blob(path, export_spmv(matrix))
    log("FILE", f"{alg} AOT program: {path}")


def _cocluster_csr(csr, log):
    """``--cocluster`` on CSR: ``(spmv_fn, loop_fn, operator)`` over a
    ``CoClusteredSellSpMV`` built once from the CSR's host triplets in the
    CSR's value dtype, at the chunk the autotuner picks. ``spmv_fn`` takes and returns natural
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

        return csr_df64, _calls(csr_df64, csr), "df64-torch", None
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
    if args.kernel in ("torch", "df64", "native") or csr.dtype.is_complex:
        kernel = "torch"
        if args.kernel in ("df64", "native"):
            log("INFO", "--spmm runs on the plain-PyTorch kernel (no "
                f"{args.kernel} SpMM variant).")

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
        if (op is not None and op.base_route == "relsl"
                and op._merged_route()):
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
        _save(args.out_dir, "spmm.npy",
              (Y if Y.is_complex() else Y.float()).cpu().numpy(), log)
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
        _append_json(args.json_out, rec, log)


def _append_json(path: str, record: dict, log) -> None:
    """Append one JSON line to the metrics sink (``--json-out``)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    log("FILE", f"JSON record appended: {path}")


def _run_solve(args, coo, csr, x, device, label, log, spmv) -> int:
    """``--solve METHOD[:ITERS[:TOL]]``: solve A x = b, b = the --x vector
    (the JAX CLI's ``_run_solve``).

    ``spmv`` is the run's CSR SpMV (the SELL kernels or the plain-PyTorch
    one): the scan-loop methods step with it and the residual check uses
    it. The fused methods run on the matrix's cached SELL operator. On
    the SELL path the triangular factors, SSOR's parts and every AMG level
    get SELL operators of their own (``spmv_sell.sell_op_csr``); the
    plain-PyTorch path applies them with its CSR SpMV.
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
    per = 1  # iterations per residual-history entry (GMRES: a restart)
    n = coo.shape[0]
    # A complex system solves in complex64 (the JAX CLI's b dtype).
    is_complex = csr.dtype.is_complex
    b = x[:n] if is_complex else x[:n].float()
    op_builder = None if args.kernel == "torch" else spmv_sell.sell_op_csr

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

    def setup(build):
        """A preconditioner's set-up (a factorization, a hierarchy, its
        operators' plans), its time logged, or None after logging its
        refusal (a ValueError: a shift or ridge ladder exhausted, an AMG
        coarsening stalled)."""
        t = time.perf_counter()
        try:
            out = build()
        except ValueError as e:
            log("ERROR", str(e))
            return None
        log("INFO", f"{method} set-up: {time.perf_counter() - t:.3f} s")
        return out

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
    elif method in SPD_METHODS and method.startswith("pcg-"):
        # The preconditioned CG family: the preconditioner, then PCG.
        if method == "pcg-cheb":
            m = setup(lambda: solvers.chebyshev_preconditioner(
                csr, *lanczos_bounds(), degree=8, spmv=spmv))
        elif method == "pcg-neumann":
            from smvp_toolkit_tpu_torch.ops.algebra import diagonal

            m = solvers.jacobi_preconditioner(csr, diagonal(coo), order=3,
                                              spmv=spmv)
        elif method == "pcg-ic0":
            from smvp_toolkit_tpu_torch.ops.ilu import ic0

            m = setup(lambda: solvers.ic0_preconditioner(
                ic0(csr), sweeps=4, spmv=spmv, op_builder=op_builder))
        elif method == "pcg-amg":
            from smvp_toolkit_tpu_torch.models.amg import amg_preconditioner

            m = setup(lambda: amg_preconditioner(
                csr, sweeps=1, op_builder=op_builder, spmv=spmv))
        elif method == "pcg-ssor":
            m = setup(lambda: solvers.ssor_preconditioner(
                csr, omega=1.0, sweeps=4, op_builder=op_builder, spmv=spmv))
        else:  # pcg-bjac
            m = setup(lambda: solvers.block_jacobi_preconditioner(
                csr, block=64))
        if m is None:
            return 2
        xs, res = solvers.pcg_precond(csr, b, m, num_iters=iters, spmv=spmv,
                                      tol=tol)
    elif method in PRECONDITIONED_GENERAL:
        # Right-preconditioned Krylov: solve (A·M⁻¹) u = b, then x = M⁻¹u;
        # the residual b − A·M⁻¹·u the solver tracks is x's true residual.
        # The -ilu methods factor A, the -amg ones build the hierarchy on
        # the symmetric part (A + Aᵀ)/2.
        if method.endswith("-ilu"):
            from smvp_toolkit_tpu_torch.ops.ilu import ilu0

            m_apply = setup(lambda: solvers.ilu_preconditioner(
                ilu0(csr), sweeps=4, spmv=spmv, op_builder=op_builder))
        else:
            from smvp_toolkit_tpu_torch.formats.csr import csr_encode
            from smvp_toolkit_tpu_torch.models.amg import amg_preconditioner
            from smvp_toolkit_tpu_torch.ops.algebra import (
                _as_general,
                add,
                scale,
                transpose,
            )

            def build():
                # One-triangle storage is expanded first: the transpose of
                # a symmetric-typecode COO transposes only the stored
                # triangle.
                g = _as_general(coo)
                sym = csr_encode(scale(add(g, transpose(g)), 0.5))
                return amg_preconditioner(sym, op_builder=op_builder,
                                          spmv=spmv)

            m_apply = setup(build)
        if m_apply is None:
            return 2
        wrapped = lambda mat, v: spmv(mat, m_apply(v))  # noqa: E731
        if method.startswith("gmres"):
            iters, per, us, res = _gmres(csr, b, iters, wrapped, tol)
        else:
            us, res = solvers.bicgstab(csr, b, num_iters=iters, spmv=wrapped,
                                       tol=tol)
        xs = m_apply(us)
    elif method == "bicgstab":
        xs, res = solvers.bicgstab(csr, b, num_iters=iters, spmv=spmv,
                                   tol=tol)
    elif method == "minres":
        xs, res = solvers.minres(csr, b, num_iters=iters, spmv=spmv, tol=tol)
    elif method == "gmres":
        iters, per, xs, res = _gmres(csr, b, iters, spmv, tol)
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
            from smvp_toolkit_tpu_torch.ops.ilu import ic0

            f = setup(lambda: ic0(csr))
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
        iters = (int(hit[0]) + 1 if hit.size else rn.shape[0]) * per

    wide = torch.complex128 if is_complex else torch.float64
    b64 = b.to(wide).cpu().numpy()
    r = b64 - spmv(csr, xs).to(wide).cpu().numpy()
    relres = float(np.linalg.norm(r) / max(np.linalg.norm(b64), 1e-30))
    log("DATA", f"SOLVE {method}: {iters} iterations in {ms:.2f} ms, "
        f"relative residual {relres:.3e}")
    xs_host = (xs if is_complex else xs.float()).cpu().numpy()
    if args.out_dir:
        _save(args.out_dir, "solve.npy", xs_host, log)
    if not np.isfinite(relres) or relres > 1.0:
        hint = ("more iterations, a tighter preconditioner (larger ILU "
                "sweeps), or gmres" if method in PRECONDITIONED_GENERAL
                else "bicgstab or gmres for general matrices")
        log("INFO", f"solve did not converge — {method} assumes "
            + ("an SPD system" if method in SPD_METHODS + ("cg-fused",)
               else "a symmetric system" if method == "minres"
               else "a well-conditioned system")
            + f"; try {hint}")
    if args.json_out:
        _append_json(args.json_out, {
            "alg": f"SOLVE-{method.upper()}",
            "file": args.file,
            "iterations": iters,
            "wall_ms": ms,
            "relative_residual": relres,
            "device": label,
        }, log)
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
            output_vector=xs_host,
            extra_metrics={"Device": label,
                           "Relative residual": f"{relres:.6g}"},
        )
        log("FILE", f"Solve report saved as:\n\t{path}")
    return 0


def _gmres(csr, b, iters: int, spmv, tol):
    """GMRES(20) with the count rounded up to whole restarts, as the JAX
    CLI runs it: ``(iterations, per, x, residual per restart)``."""
    from smvp_toolkit_tpu_torch.models import solvers

    restart = min(GMRES_RESTART, iters)
    num_restarts = max(1, -(-iters // restart))
    x, res = solvers.gmres(csr, b, restart=restart,
                           num_restarts=num_restarts, spmv=spmv, tol=tol)
    return restart * num_restarts, restart, x, res


def _run_eigs(args, coo, csr, label, log, spmv) -> int:
    """``--eigs K[:ITERS]``: the K smallest eigenpairs by LOBPCG (the JAX
    CLI's ``_run_eigs``).

    AMG-preconditioned when the hierarchy builds; when its set-up refuses
    the matrix (a ValueError), LOBPCG runs unpreconditioned. The JAX CLI
    falls back on any exception; the port lets any other one (a kernel's
    build or launch) stop the run. On the SELL path the SpMMs run on the
    k-column kernels and the AMG levels on SELL operators of their own;
    ``--kernel torch`` runs the plain-PyTorch CSR SpMV and SpMM.
    """
    import time

    import torch

    from smvp_toolkit_tpu_torch.models import solvers
    from smvp_toolkit_tpu_torch.models.amg import amg_preconditioner
    from smvp_toolkit_tpu_torch.ops import spmv_sell, spmv_torch

    if coo.shape[0] != coo.shape[1]:
        log("ERROR", "--eigs needs a square (symmetric) matrix")
        return 2
    spec = args.eigs.split(":")
    k = int(spec[0])
    iters = int(spec[1]) if len(spec) > 1 else 60
    n = coo.shape[0]
    if k > n:
        log("ERROR", f"--eigs K={k} exceeds the matrix dimension {n}")
        return 2
    on_sell = args.kernel != "torch"
    spmm = None if on_sell else spmv_torch.spmm_csr
    m = None
    t0 = time.perf_counter()
    try:
        m = amg_preconditioner(
            csr, op_builder=spmv_sell.sell_op_csr if on_sell else None,
            spmv=spmv)
        log("INFO", "LOBPCG preconditioner: smoothed-aggregation AMG "
            f"(set-up: {time.perf_counter() - t0:.3f} s)")
    except ValueError as e:
        log("INFO", f"AMG setup declined ({str(e)[:120]}); "
            "running unpreconditioned LOBPCG")
    dev = csr.device
    X0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, k)).astype(np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    theta, _, res = solvers.lobpcg(csr, X0, num_iters=iters, m=m, spmm=spmm)
    tvals = theta.double().cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    rlast = res[-1].double().cpu().numpy()
    log("DATA", f"EIGS k={k}: {iters} LOBPCG iterations in {ms:.2f} ms; "
        "smallest Ritz values " + " ".join(f"{t:.6g}" for t in tvals)
        + "  (residual norms " + " ".join(f"{r:.2e}" for r in rlast) + ")")
    if args.json_out:
        _append_json(args.json_out, {
            "alg": "EIGS-LOBPCG",
            "file": args.file,
            "k": k,
            "iterations": iters,
            "wall_ms": ms,
            "eigenvalues": [float(t) for t in tvals],
            "residual_norms": [float(r) for r in rlast],
            "preconditioner": "amg" if m is not None else "none",
            "device": label,
        }, log)
    return 0


def _decode_check(alg, decoded, coo, log) -> bool:
    """Decoded triplets against the input, both in canonical row-major
    order: indices equal and values equal bit for bit (a CISR schedule
    holds float64 values: the input's widen to float64 exactly)."""
    r, c, v = decoded.canonical_order().to_numpy()
    R, C, V = coo.canonical_order().to_numpy()
    if v.dtype == np.float64 != V.dtype:
        V = V.astype(np.float64)
    ok = (np.array_equal(r, R) and np.array_equal(c, C)
          and v.dtype == V.dtype and v.tobytes() == V.tobytes())
    if ok:
        log("INFO", f"{alg} decode round-trip: bit-exact ✓")
    else:
        log("ERROR", f"{alg} decode round-trip FAILED")
    return ok


if __name__ == "__main__":
    sys.exit(main())
