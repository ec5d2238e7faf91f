"""Readings of the numbers that decide ``correct``, for setting limits.

``python3 portbench/control.py --workload <name>[,<name>…] --seeds
<n>[,<n>…] [--dtype bfloat16] [--fault <fault>] [--seconds 2]`` runs each
cell once per seed in this one process, each run set up afresh through
the benchmark's own set-up, window and check, and prints one JSON line per
run with the numbers compared. With ``--dtype`` below the configuration's
own (bfloat16 for float32) the port runs its lower-precision path: the
control, which has to come out not correct. The benchmark's own runs
never run it.

Faults planted in the port's solvers, to show what the solves' check
sees:

* ``diagonal_factor``: the IC(0) factor's strict triangle zeroed, so the
  IC(0)-PCG is CG preconditioned by the diagonal alone;
* ``steps:<fraction>``: ``fused_cg`` and ``fused_pcg_ic0`` run that
  fraction of the mix's iterations (a solve cut short);
* ``sweeps:<n>``: ``fused_pcg_ic0`` applies the preconditioner with
  ``n`` sweeps (2 or more) in place of the mix's.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402

from portbench.harness import Benchmark, forbidden_modules, run_cell  # noqa: E402


def diagonal_factor(_arg=None):
    """Replace ``ops.ilu.ic0`` by its factor with the strict triangle
    zeroed."""
    import dataclasses

    import torch
    from smvp_toolkit_tpu_torch.ops import ilu

    real = ilu.ic0

    def weak(csr):
        f = real(csr)
        return dataclasses.replace(
            f, strict=dataclasses.replace(
                f.strict, vals=torch.zeros_like(f.strict.vals)),
            strict_t=dataclasses.replace(
                f.strict_t, vals=torch.zeros_like(f.strict_t.vals)))

    ilu.ic0 = weak


def steps(fraction):
    """Run each fused solve for ``fraction`` of its iterations."""
    from smvp_toolkit_tpu_torch.ops import cg_fused, pcg_fused

    frac = float(fraction)
    cg, pcg = cg_fused.fused_cg, pcg_fused.fused_pcg_ic0

    @functools.wraps(cg)  # keeps the launch counter the port updates
    def short_cg(op, b, iterations, *a, **k):
        return cg(op, b, max(1, round(iterations * frac)), *a, **k)

    @functools.wraps(pcg)
    def short_pcg(op, factors, b, iterations, *a, **k):
        return pcg(op, factors, b, max(1, round(iterations * frac)), *a, **k)

    cg_fused.fused_cg, pcg_fused.fused_pcg_ic0 = short_cg, short_pcg


def sweeps(n):
    """Apply IC(0) with ``n`` sweeps in each fused PCG solve."""
    from smvp_toolkit_tpu_torch.ops import pcg_fused

    pcg = pcg_fused.fused_pcg_ic0

    @functools.wraps(pcg)
    def fewer(op, factors, b, iterations, *a, **k):
        k["sweeps"] = int(n)
        return pcg(op, factors, b, iterations, *a, **k)

    pcg_fused.fused_pcg_ic0 = fewer


FAULTS = {"diagonal_factor": diagonal_factor, "steps": steps,
          "sweeps": sweeps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--dtype", default=None)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None,
                   help="diagonal_factor, steps:<fraction> or sweeps:<n>")
    args = p.parse_args(argv)
    import torch

    if args.fault:
        name, _, arg = args.fault.partition(":")
        if name not in FAULTS:
            p.error(f"no fault {name!r}")
        FAULTS[name](arg or None)

    bench = Benchmark()
    dtype = getattr(torch, args.dtype) if args.dtype else None
    for w in args.workload.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = run_cell(bench, w, seed, args.seconds, False, "cuda:0",
                         value_dtype=dtype)
            print(json.dumps({
                "workload": w, "seed": seed, "dtype": args.dtype or "config",
                "fault": args.fault, "correct": r["correct"],
                "requests": r["attempted"],
                "checks": {k: c["value"] for k, c in r["checks"].items()},
                "limits": {k: c["limit"] for k, c in r["checks"].items()},
            }), flush=True)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"[control] loaded {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
