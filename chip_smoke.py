#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smvp_toolkit_tpu_torch) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. The card's name and power limit, then the kernels' build from
   ``smvp_toolkit_tpu_torch/csrc`` with its time.
2. Each kernel against its plain PyTorch version on the card, in float32
   and bfloat16, on four plans: a random rectangular matrix with empty
   rows, a matrix with no nonzeros, a plan whose chunk is not a multiple
   of 32 (int32 lane indices) and the smoke matrix. Tolerance:
   max |kernel - plain| / max |plain| <= 1e-6 (atomics change the
   summation order, so never bitwise). K2 with N = 3 against K1 likewise.
3. The main path through the port's CLI at full size, on BASELINE.json's
   synthetic 10M-nnz matrix (``synth:1000000:10000000``, 9,658,208 nnz
   after dedup): ``-c -n 200 --x random:1``, per call (K1) and ``--fused``
   (K2), each in float32 and bfloat16. Launch counts are zeroed just
   before each run and read just after; the run fails unless its kernel
   launched. The report's output vector is checked against a float64
   scipy CSR oracle: max |y - oracle| / max |oracle| <= 1e-5 (bfloat16:
   the oracle takes bf16-rounded vals and x; the report prints 6
   significant digits, which fits the bound).
4. One ``{"kernels": [...]}`` line: per kernel and value dtype, its time
   per launch from CUDA events, its launches in the main-path run, its
   bound, the plain version's time and a library yardstick
   (``torch.sparse.mm`` on a float32 CSR tensor, never called by the
   port). Then the card's name and power limit again and, last, the
   ``{"ok": true, "device": ...}`` line.

Needs no network and one card; it stops with an error when
``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

SPEC = "synth:1000000:10000000"
ITERATIONS = 200
TOL_KERNEL = 1e-6
TOL_ORACLE = 1e-5
# H100 SXM peak for float32 arithmetic outside the tensor cores (NVIDIA's
# data sheet); the kernels' multiply-adds run there in both value modes.
F32_PEAK_FLOPS = 67e12
SOURCE = "smvp_toolkit_tpu_torch/csrc/sell_spmv.cu"
REPLACES = {
    "sell_spmv_kernel": "smvp_toolkit_tpu/ops/spmv_pallas.py:389",
    "sell_bench_kernel": "smvp_toolkit_tpu/ops/spmv_pallas.py:718",
}
DTYPE_NAMES = ("float32", "bfloat16")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _rel_err(got, ref) -> float:
    scale = ref.abs().max().item() if ref.numel() else 0.0
    diff = (got - ref).abs().max().item() if ref.numel() else 0.0
    if scale == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return diff / scale


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_plans(np):
    """The four phase-2 plans, (name, plan)."""
    from smvp_toolkit_tpu_torch.ops.sell_plan import build_sell_plan
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    rng = np.random.RandomState(7)
    nrows, ncols, nnz = 30000, 47000, 400000
    live_rows = rng.choice(nrows, size=nrows // 2, replace=False)
    r = live_rows[rng.randint(0, len(live_rows), size=nnz)]
    c = rng.randint(0, ncols, size=nnz)
    v = rng.randn(nnz)
    plans = [
        ("random-rect-empty-rows",
         build_sell_plan(r, c, v, (nrows, ncols), chunk=2048)),
        ("nnz0", build_sell_plan(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                 np.zeros(0), (5000, 3000), chunk=2048)),
        ("chunk200-int32-lidx",
         build_sell_plan(r, c, v, (nrows, ncols), chunk=200,
                         allow_small_chunk=False)),
    ]
    t0 = time.perf_counter()
    coo = parse_synth_spec(SPEC, device="cpu")
    rr, cc, vv = coo.to_numpy()
    smoke = _auto_plan(rr, cc, vv, coo.shape)
    print(f"[plan] {SPEC}: nnz {coo.nnz}, S {smoke.n_sublanes}, chunk "
          f"{smoke.chunk}, WT {smoke.window_tiles}, NS {smoke.n_slices}, "
          f"CT {smoke.n_coltiles}, planned in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    plans.append(("smoke", smoke))
    return plans, (rr, cc, vv, coo.shape)


def phase_kernels(np, torch, plans):
    """Phase 2: every kernel against its plain version; returns the smoke
    plan's operators and absolute errors per value dtype."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device("cuda", 0)
    smoke_ops, errs = {}, {}
    for name, plan in plans:
        for dname in DTYPE_NAMES:
            vd = getattr(torch, dname)
            op = S.SellSpMV(plan, value_dtype=vd, device=dev)
            x = torch.from_numpy(
                np.random.default_rng(3).standard_normal(plan.shape[1])
                .astype(np.float32)).to(dev)
            xt = op._x_tiles(x)
            args = (op.vals, op.lidx, op.relsl, op.tile_base, xt)
            kw = dict(n_slices=plan.n_slices, chunk=plan.chunk)
            y1 = S.sell_spmv(*args, **kw)
            y2 = S.sell_bench_loop(*args, iterations=3, **kw)
            yp = S.sell_spmv_plain(*args, **kw)
            torch.cuda.synchronize()
            e1, e2, e21 = _rel_err(y1, yp), _rel_err(y2, yp), _rel_err(y2, y1)
            print(f"[check] {name:24s} {dname:9s} lidx {str(op.lidx.dtype):11s}"
                  f" K1 vs plain {e1:.3e}  K2(N=3) vs plain {e2:.3e}"
                  f"  K2 vs K1 {e21:.3e}", flush=True)
            _check(torch.isfinite(y1).all().item(), f"K1 finite on {name}")
            _check(e1 <= TOL_KERNEL, f"K1 vs plain on {name} {dname}: {e1}")
            _check(e2 <= TOL_KERNEL, f"K2 vs plain on {name} {dname}: {e2}")
            _check(e21 <= TOL_KERNEL, f"K2 vs K1 on {name} {dname}: {e21}")
            if name == "smoke":
                smoke_ops[dname] = (op, x)
                errs[dname] = ((y1 - yp).abs().max().item(),
                               (y2 - yp).abs().max().item())
    return smoke_ops, errs


def _oracle(np, torch, triplets, dname):
    import scipy.sparse as sp

    r, c, v, shape = triplets
    x = np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32)
    v = np.asarray(v, dtype=np.float32)
    if dname == "bfloat16":
        v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=shape)
    return a @ x.astype(np.float64)


def _report_vector(np, path):
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("[")
    end = lines.index("]", start)
    return np.array([float(t) for t in lines[start + 1:end]])


def phase_main_path(np, torch, triplets):
    """Phase 3: the CLI at full size; returns launches per (kernel, dtype)."""
    from smvp_toolkit_tpu_torch.cli import main as cli_main
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    launches = {}
    for dname in DTYPE_NAMES:
        ref = _oracle(np, torch, triplets, dname)
        scale = float(np.abs(ref).max())
        for fused in (False, True):
            kernel = "sell_bench_kernel" if fused else "sell_spmv_kernel"
            with tempfile.TemporaryDirectory() as tmp:
                argv = ["-c", "-n", str(ITERATIONS), "-d", tmp,
                        "--json-out", os.path.join(tmp, "run.jsonl"),
                        "--x", "random:1", "--dtype", dname]
                argv += ["--fused"] if fused else []
                S.sell_spmv.launches = 0
                S.sell_bench_loop.launches = 0
                t0 = time.perf_counter()
                rc = cli_main(argv + [SPEC])
                wall = time.perf_counter() - t0
                counts = {"sell_spmv_kernel": S.sell_spmv.launches,
                          "sell_bench_kernel": S.sell_bench_loop.launches}
                _check(rc == 0, f"CLI {argv} returned {rc}")
                reports = glob.glob(os.path.join(tmp, "smvp-toolbox_report_*"))
                _check(len(reports) == 1, f"one report file, got {reports}")
                y = _report_vector(np, reports[0])
                with open(os.path.join(tmp, "run.jsonl")) as f:
                    rec = json.loads(f.readline())
            _check(y.shape == ref.shape, f"report vector shape {y.shape}")
            _check(bool(np.isfinite(y).all()), "report vector finite")
            err = float(np.abs(y - ref).max()) / scale
            print(f"[main] {' '.join(argv[:3] + argv[7:])} {SPEC}: rc {rc}, "
                  f"{wall:.1f} s, avg {rec['avg_ms']:.6f} ms/iter, "
                  f"launches {counts}, report vs float64 oracle {err:.3e}",
                  flush=True)
            _check(err <= TOL_ORACLE, f"oracle error {err} ({dname}, "
                   f"fused={fused})")
            _check(counts[kernel] >= 1,
                   f"{kernel} never launched in the {dname} run")
            launches[(kernel, dname)] = counts[kernel]
    return launches


def phase_timings(np, torch, smoke_ops, errs, launches, triplets):
    """Phase 4: one entry per kernel and value dtype."""
    from smvp_toolkit_tpu_torch.bench.roofline import hbm_bandwidth_gbs
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device("cuda", 0)
    bw = hbm_bandwidth_gbs(dev) * 1e9
    r, c, v, shape = triplets
    order = np.lexsort((c, r))
    a = torch.sparse_csr_tensor(
        torch.from_numpy(np.concatenate(
            [[0], np.cumsum(np.bincount(r, minlength=shape[0]))])).to(dev),
        torch.from_numpy(c[order].astype(np.int64)).to(dev),
        torch.from_numpy(np.asarray(v, np.float32)[order]).to(dev),
        size=shape, check_invariants=True,
    )
    entries = []
    for dname in DTYPE_NAMES:
        op, x = smoke_ops[dname]
        plan = op.plan
        xt = op._x_tiles(x)
        args = (op.vals, op.lidx, op.relsl, op.tile_base, xt)
        kw = dict(n_slices=plan.n_slices, chunk=plan.chunk)
        vb = op.vals.element_size()
        nbytes = plan.traffic_bytes(vb, x_bytes=vb)
        x2 = x.float()[:, None]
        lib_one = _time_ms(lambda: torch.sparse.mm(a, x2), reps=50)
        for kernel, n_iter in (("sell_spmv_kernel", 1),
                               ("sell_bench_kernel", ITERATIONS)):
            if kernel == "sell_spmv_kernel":
                ms = _time_ms(lambda: S.sell_spmv(*args, **kw), reps=50)
                plain_ms = _time_ms(lambda: S.sell_spmv_plain(*args, **kw),
                                    reps=10)
                lib_ms = lib_one
                err = errs[dname][0]
            else:
                ms = _time_ms(lambda: S.sell_bench_loop(
                    *args, iterations=n_iter, **kw), reps=3, warmup=1)
                plain_ms = _time_ms(lambda: S.sell_bench_loop_plain(
                    *args, iterations=n_iter, **kw), reps=1, warmup=0)
                # N library calls in a row: the same N SpMVs.
                lib_ms = _time_ms(lambda: [torch.sparse.mm(a, x2)
                                           for _ in range(n_iter)],
                                  reps=1, warmup=1)
                err = errs[dname][1]
            t_bytes = nbytes / bw * 1e3
            t_ops = 2.0 * plan.nnz * n_iter / F32_PEAK_FLOPS * 1e3
            entries.append({
                "name": f"{kernel}[{dname}]",
                "route": "cuda",
                "source": SOURCE,
                "replaces": REPLACES[kernel],
                "launches": launches[(kernel, dname)],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms,
                "iterations_per_launch": n_iter,
                "traffic_bytes_per_iteration": nbytes,
                "reread_bound_ms": n_iter * t_bytes,
            })
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this test needs "
              "one card", file=sys.stderr)
        return 1
    import numpy as np

    from smvp_toolkit_tpu_torch.ops import _build

    t_start = time.perf_counter()
    print(_card_line(), flush=True)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    regs = [ln.split("Used", 1)[1].strip() for text in logs.values()
            for ln in text.splitlines() if "Used" in ln]
    print(f"[build] {len(logs)} source(s) built in "
          f"{time.perf_counter() - t0:.2f} s; ptxas per entry: {regs}",
          flush=True)
    from smvp_toolkit_tpu_torch.ops.spmv_sell import bench_blocks

    grid = {d: bench_blocks(getattr(torch, d), torch.int8)
            for d in DTYPE_NAMES}
    print(f"[grid] sell_bench_kernel cooperative grid (blocks of 256 "
          f"threads, int8 lane indices): {grid}", flush=True)

    plans, triplets = _kernel_plans(np)
    smoke_ops, errs = phase_kernels(np, torch, plans)
    launches = phase_main_path(np, torch, triplets)
    entries = phase_timings(np, torch, smoke_ops, errs, launches, triplets)

    print(json.dumps({"kernels": entries}))
    print(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
