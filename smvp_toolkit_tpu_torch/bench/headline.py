"""The port's headline benchmark: N SpMVs in one launch on the card.

Run from the root of a checkout on a machine with a CUDA card:

    python -m smvp_toolkit_tpu_torch.bench.headline

The counterpart of the grid-fused rungs of the repository's ``bench.py``
(its memplus input is not in the repository, so this runs BASELINE.json's
synthetic 10M-nnz matrix, ``synth:1000000:10000000``, at chunk 2048, the
chunk of its earlier runs, whatever the autotuner picks).
Three rungs, each K2 (the N-iteration kernel) with x = ones, as bench.py
times them:

1. ``sell-cuda-gridfused-cc-bf16``: co-clustered coordinates
   (``CoClusteredSellSpMV``) in bf16 value mode, x scattered through
   ``col_map``, the oracle gathered through ``row_map`` with the padded
   rows held at zero;
2. ``sell-cuda-gridfused-bf16``: natural coordinates, bf16 values;
3. ``sell-cuda-gridfused``: natural coordinates, float32 values.

Each rung's time per SpMV is the least-squares slope of the launch time
over N = 1000, 2000 and 4000 (the best of three CUDA-event samples each),
which cancels the launch and one-time costs, as bench.py fits it. Each
rung's last y is validated against a float64 oracle (the bf16 rungs' with
bf16-rounded values) with bench.py's limit: max |y - oracle| / max
|oracle| < 1e-3. Every rung runs and must pass: there is no fallback
ladder, and a rung that fails makes the module exit non-zero with no
result line.

It prints ONE JSON line with bench.py's field names: the co-clustered
rung's ``metric``, ``value`` (Mnnz/s), ``unit``, ``mode``,
``validation_err``, ``occupancy`` and ``coordinates`` at the top, every
rung under ``rungs``, and the card's name and power limit (``nvidia-smi``)
under ``device`` and ``power_limit``. Co-clustering the matrix is minutes
of host work before the first rung.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

__all__ = ["SPEC", "CHUNK", "LIMIT", "run", "main"]

SPEC = "synth:1000000:10000000"
CHUNK = 2048
LIMIT = 1e-3  # bench.py's validation limit
FIT_POINTS = (1000, 2000, 4000)
SAMPLES = 3


class RungFailed(RuntimeError):
    """A rung did not build, launch or validate."""


def _power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _fit(torch, loop, x) -> tuple:
    """(ms per SpMV, intercept ms, best launch ms per N, last y)."""
    loop(x, FIT_POINTS[0])  # warm-up
    times, y = [], None
    for n in FIT_POINTS:
        best = None
        for _ in range(SAMPLES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = loop(x, n)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            best = ms if best is None else min(best, ms)
        times.append(best)
    A = np.vstack([FIT_POINTS, np.ones(len(FIT_POINTS))]).T
    (slope, intercept), *_ = np.linalg.lstsq(A, np.asarray(times),
                                             rcond=None)
    return float(slope), float(intercept), times, y


def _rung(torch, mode, op, x, oracle, nnz, extra) -> dict:
    """One rung: fit, validate, and its record."""
    from smvp_toolkit_tpu_torch.bench.roofline import hbm_bandwidth_gbs

    inner = getattr(op, "inner", op)
    slope, intercept, times, y = _fit(torch, op.bench_loop, x)
    y = y.double().cpu().numpy()
    scale = float(np.abs(oracle).max())
    err = float(np.abs(y - oracle).max()) / scale
    if not np.isfinite(y).all() or not err < LIMIT:
        raise RungFailed(f"{mode}: validation rel err {err} (limit {LIMIT})")
    if slope <= 0:
        raise RungFailed(f"{mode}: non-positive fitted slope {slope} ms "
                         f"(launch times {times})")
    plan = inner.plan
    vb = inner.vals.element_size()
    nbytes = plan.traffic_bytes(vb, x_bytes=vb)
    bound_ms = nbytes / (hbm_bandwidth_gbs(inner.device) * 1e9) * 1e3
    return {
        "mode": mode,
        "method": "grid-fused",
        "value": nnz / (slope * 1e-3) / 1e6,
        "unit": "Mnnz/s",
        "avg_ms": slope,
        "value_dtype": str(inner.value_dtype).replace("torch.", ""),
        "route": inner.bench_route,
        "fit_points": list(FIT_POINTS),
        "fit_times_ms": times,
        "intercept_ms": intercept,
        "validation_err": err,
        "chunk": plan.chunk,
        "plan_occupancy": plan.nnz / plan.slots(),
        "traffic_bytes": nbytes,
        "roofline_frac": bound_ms / slope,
        **extra,
    }


def run(spec: str = SPEC, *, device: str = "cuda") -> dict:
    """The three rungs on the card; the record ``main`` prints."""
    import torch

    from smvp_toolkit_tpu_torch.ops.spmv_sell import (
        CoClusteredSellSpMV,
        SellSpMV,
        _auto_plan,
    )
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    dev = torch.device(device)
    coo = parse_synth_spec(spec, device="cpu")
    r, c, v = coo.to_numpy()
    n, m = coo.shape
    y_ref = np.zeros(n)
    np.add.at(y_ref, r, v.astype(np.float64))
    v16 = torch.from_numpy(v).to(torch.bfloat16).double().numpy()
    y_ref16 = np.zeros(n)
    np.add.at(y_ref16, r, v16)
    ones = torch.ones(m, device=dev)

    t0 = time.perf_counter()
    cc = CoClusteredSellSpMV(coo, value_dtype=torch.bfloat16, chunk=CHUNK,
                             device=dev)
    cc_secs = time.perf_counter() - t0
    res = cc.result
    xp = torch.zeros(res.shape_padded[1], device=dev)
    xp[torch.tensor(res.col_map, device=dev)] = 1.0
    yp = np.zeros(res.shape_padded[0])
    yp[res.row_map] = y_ref16
    natural_occ = coo.nnz / (res.s_true_natural * 128)
    rungs = [_rung(torch, "sell-cuda-gridfused-cc-bf16", cc, xp, yp,
                   coo.nnz, {"occupancy": cc.occupancy,
                             "coordinates": "coclustered",
                             "s_true": res.s_true,
                             "s_true_natural": res.s_true_natural,
                             "natural_occupancy": natural_occ,
                             "cocluster_s": cc_secs})]
    del cc, xp
    plan = _auto_plan(r, c, v, coo.shape, chunk=CHUNK)
    for mode, vdt, oracle in (
            ("sell-cuda-gridfused-bf16", torch.bfloat16, y_ref16),
            ("sell-cuda-gridfused", torch.float32, y_ref)):
        op = SellSpMV(plan, value_dtype=vdt, device=dev)
        rungs.append(_rung(torch, mode, op, ones, oracle, coo.nnz,
                           {"occupancy": op.plan.nnz / op.plan.slots(),
                            "coordinates": "natural"}))
        del op
    name = torch.cuda.get_device_name(dev)
    head = rungs[0]
    return {
        "metric": f"{spec} CSR SpMV throughput ({head['mode']} kernel, "
                  f"{name})",
        "value": head["value"],
        "unit": head["unit"],
        "mode": head["mode"],
        "validation_err": head["validation_err"],
        "occupancy": head["occupancy"],
        "coordinates": head["coordinates"],
        "avg_ms": head["avg_ms"],
        "matrix": spec,
        "nnz": coo.nnz,
        "device": name,
        "power_limit": _power_limit(),
        "rungs": rungs,
    }


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    if argv:
        print(f"headline: takes no arguments (got {argv})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("headline: no CUDA device is available; this benchmark runs "
              "on the card", file=sys.stderr)
        return 1
    try:
        rec = run()
    except RungFailed as e:
        print(f"headline: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
