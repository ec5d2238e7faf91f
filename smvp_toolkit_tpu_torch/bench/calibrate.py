"""Fit the chunk autotuner's rates on a card.

Run from the root of a checkout on a machine with one CUDA card:

    python -m smvp_toolkit_tpu_torch.bench.calibrate [--out DIR]

For each calibration matrix it builds the autotuner's candidate plans
(``autotune.sweep_plans``: chunks 512 to 8192, the sweep stopping where
the planner shrinks the chunk) and, in float32 and bfloat16, times the
forward kernel of each plan's route (K1, K3-relsl, K4 or K3-split):
``LAUNCHES`` launches queued back to back behind a spin kernel, so that
the host's work per call does not pace the card, timed with CUDA events,
the median of ``REPEATS`` repeats kept; each record also carries the
host seconds of ``_tuned_plan`` on its matrix and dtype at the rates
shipped when it ran. Each candidate's kernel is first held to its plain
version (``err``, max |kernel - plain| / max |plain|, within ``tol``:
max(1e-6, 2·2^-24·√n), n the most entries of one row, as a float32 sum
of n products in two orders differs by about 2^-24·√n of its size;
gcn_arxiv's Aᵀ has a row of 168,430). It writes one
record per (matrix, chunk, dtype) to ``DIR/autotune_records.jsonl`` and
the rates fitted on them (``autotune.calibrate_rates``) with the card's
name and power limit to ``DIR/autotune_rates.json``, and prints
``autotune.check_pick_plan``'s verdicts. ``DIR`` defaults to the
package's ``ops/``, the files the operators read.

The matrices are the repo's own generated configurations, made from
their seeds: smoke (``synth:1000000:10000000``), L1
(``synth:4194304:41943040``), L2 and L3 (``synth_powerlaw`` at 1M / 10M
and 4M / 40M, seed 0), gcn_arxiv's normalised adjacency A and its
transpose (``gcn_norm(synth_powerlaw(169_343, 2_315_598, seed=0))``),
hpcg104 (``utils.synth.hpcg_stencil(104)``) and poisson1024
(``utils.synth.poisson2d(1024)``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

MATRICES = ("smoke", "L1", "L2", "L3", "gcn_arxiv:A", "gcn_arxiv:At",
            "hpcg104", "poisson1024")
LAUNCHES = 20
REPEATS = 7
SPIN_CYCLES = 50_000_000  # about 25 ms: longer than the host takes to queue
TOL = 1e-6


def tolerance(rows) -> float:
    """max(1e-6, 2·2^-24·√n), n the most entries one row sums."""
    n = int(np.bincount(np.asarray(rows, np.int64)).max()) if len(rows) \
        else 0
    return max(TOL, 2 * 2.0 ** -24 * n ** 0.5)


def _gcn(transpose: bool):
    from smvp_toolkit_tpu_torch.models.graph import gcn_norm
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _triplets_from_csr_host
    from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

    r, c, v, shape = _triplets_from_csr_host(gcn_norm(synth_powerlaw(
        169_343, 2_315_598, seed=0, device="cpu")))
    return (c, r, v, shape[::-1]) if transpose else (r, c, v, shape)


def _scipy(make: Callable):
    a = make().tocoo()
    return a.row.astype(np.int64), a.col.astype(np.int64), a.data, a.shape


def matrix(name: str):
    """Host triplets ``(rows, cols, vals, shape)`` of a calibration
    matrix."""
    from smvp_toolkit_tpu_torch.utils import synth

    coo = {
        "smoke": lambda: synth.parse_synth_spec("synth:1000000:10000000",
                                                device="cpu"),
        "L1": lambda: synth.parse_synth_spec("synth:4194304:41943040",
                                             device="cpu"),
        "L2": lambda: synth.synth_powerlaw(1_000_000, 10_000_000, seed=0,
                                           device="cpu"),
        "L3": lambda: synth.synth_powerlaw(4_000_000, 40_000_000, seed=0,
                                           device="cpu"),
    }.get(name)
    if coo is not None:
        m = coo()
        return (*m.to_numpy(), m.shape)
    if name.startswith("gcn_arxiv:"):
        return _gcn(name.endswith(":At"))
    if name == "hpcg104":
        return _scipy(lambda: synth.hpcg_stencil(104))
    if name == "poisson1024":
        return _scipy(lambda: synth.poisson2d(1024))
    raise ValueError(f"unknown calibration matrix {name!r}; one of "
                     f"{', '.join(MATRICES)}")


def queued_us(torch, fn, launches: int, repeats: int) -> List[float]:
    """µs per launch of ``fn``, once per repeat: ``launches`` calls queued
    behind a spin kernel between two CUDA events. Raises if the host took
    longer to queue them than the card spun (host pacing would enter the
    time)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spin_ms = spin.elapsed_time(start)
        if host_ms >= spin_ms:
            raise RuntimeError(f"the host took {host_ms:.3f} ms to queue "
                               f"{launches} launches, the card spun "
                               f"{spin_ms:.3f} ms")
        out.append(start.elapsed_time(end) / launches * 1e3)
    return out


def time_plan(torch, plan, dtype, *, device="cuda", tol: float = TOL) -> dict:
    """One record: ``plan``'s geometry (``autotune.plan_record``), its
    forward kernel held to the plain version (``err`` <= ``tol``, else it
    raises) and its queued
    time (``us`` the median of ``us_repeats``; ``spread`` their
    (max - min) / median)."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.autotune import plan_record

    op = S.SellSpMV(plan, value_dtype=dtype, device=device)
    rec = plan_record(plan, op.vals.element_size())
    route = op.route
    if route != rec["route"]:
        raise AssertionError(f"the model prices route {rec['route']}, the "
                             f"operator takes {route}")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        plan.shape[1]).astype(np.float32)).to(op.device)
    xt = op._x_tiles(x)
    fn = S._ROUTE_FNS[route][0]
    plain = getattr(S, fn.__name__ + "_plain")
    planes, kw = op._planes(route), op._kw()
    got = fn(*planes, xt, **kw)
    want = plain(*planes, xt, **kw)
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    rec.update(err=diff / scale if scale else diff, tol=tol)
    if rec["err"] > tol:
        raise AssertionError(f"chunk {rec['chunk']} {rec['dtype']}: kernel "
                             f"vs plain {rec['err']}, over {tol}")
    reps = queued_us(torch, lambda: fn(*planes, xt, **kw), LAUNCHES, REPEATS)
    med = statistics.median(reps)
    rec.update(us=med, us_repeats=reps,
               spread=(max(reps) - min(reps)) / med, kernel=fn.__name__)
    return rec


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def run(card: str) -> List[dict]:
    """The records of every candidate plan of ``MATRICES`` in both
    dtypes."""
    import torch

    from smvp_toolkit_tpu_torch.ops.autotune import _tuned_plan, sweep_plans

    records = []
    for name in MATRICES:
        t0 = time.perf_counter()
        r, c, v, shape = matrix(name)
        tol = tolerance(r)
        t1 = time.perf_counter()
        tuned_s = {}
        for dtype in (torch.float32, torch.bfloat16):
            ts = time.perf_counter()
            _tuned_plan(r, c, v, shape, bf16=dtype == torch.bfloat16)
            tuned_s[dtype] = time.perf_counter() - ts
        t2 = time.perf_counter()
        plans = sweep_plans(r, c, v, shape)
        while True:
            tp = time.perf_counter()
            plan = next(plans, None)
            if plan is None:
                break
            plan_s = time.perf_counter() - tp
            for dtype in (torch.float32, torch.bfloat16):
                rec = time_plan(torch, plan, dtype, tol=tol)
                rec.update(name=name, nnz=plan.nnz, plan_s=plan_s,
                           tuned_plan_s=tuned_s[dtype], device=card)
                records.append(rec)
                print(f"[calibrate] {name} chunk {rec['chunk']} "
                      f"{rec['dtype']}: route {rec['route']}, S {rec['S']}, "
                      f"WT {rec['WT']}, {rec['traffic_bytes']} bytes, "
                      f"{rec['us']:.3f} us (spread {rec['spread']:.3f}), "
                      f"err {rec['err']:.2e}; plan {plan_s:.2f} s",
                      flush=True)
            del plan
        print(f"[calibrate] {name}: {shape[0]}x{shape[1]}, nnz {len(r)}; "
              f"made in {t1 - t0:.1f} s, _tuned_plan (the shipped rates) "
              f"{tuned_s[torch.float32]:.2f} / {tuned_s[torch.bfloat16]:.2f} "
              f"s (f32 / bf16), swept in {time.perf_counter() - t2:.1f} s",
              flush=True)
    return records


def write(records: List[dict], out: Path, card: str) -> dict:
    """Fit the rates on ``records`` and write both files into ``out``."""
    from smvp_toolkit_tpu_torch.ops.autotune import calibrate_rates

    out.mkdir(parents=True, exist_ok=True)
    with open(out / "autotune_records.jsonl", "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    rates = calibrate_rates(records)
    name, _, limit = card.partition(", ")
    rates["device"] = {"name": name, "power_limit": limit}
    rates["fitted_by"] = "python -m smvp_toolkit_tpu_torch.bench.calibrate"
    (out / "autotune_rates.json").write_text(
        json.dumps(rates, indent=1, sort_keys=True) + "\n")
    return rates


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from smvp_toolkit_tpu_torch.ops.autotune import check_pick_plan

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path,
                   default=Path(__file__).resolve().parent.parent / "ops",
                   help="directory of the records and rates files")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    records = run(card)
    rates = write(records, args.out, card)
    print(f"[calibrate] {len(records)} records, {rates['calibrated_on']} "
          f"fitted, in {time.perf_counter() - t0:.1f} s; rates "
          f"{json.dumps(rates, sort_keys=True)}", flush=True)
    for line in check_pick_plan(records, rates):
        print(f"[calibrate] {line}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
