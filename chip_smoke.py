#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smvp_toolkit_tpu_torch) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. The card's name and power limit, then the kernels' build from
   ``smvp_toolkit_tpu_torch/csrc`` (one nvcc per source, in parallel) with
   its time, and each bench kernel's cooperative grid.
2. Every kernel against its plain PyTorch version on the card, in float32
   and bfloat16: the forward kernel of the plan's route, its N-iteration
   kernel with N = 3, and the two against each other. Tolerance:
   max |kernel - plain| / max |plain| <= 1e-6 (atomics change the
   summation order, so never bitwise). Plans: a random rectangular matrix
   with empty rows, a matrix with no nonzeros, a plan with int32 lane
   indices (chunk 200), a streamed-y plan with an empty middle y block, a
   streamed-y plan with int32 lane indices, a small streamed split plan, a
   resident split plan (WT > 511), and the four full-size configurations:
   - smoke: BASELINE.json's synthetic 10M-nnz matrix,
     ``synth:1000000:10000000`` (resident y, merged word: K1, K2);
   - L1: ``synth:4194304:41943040``, 64 y blocks (streamed y, merged word:
     K3-relsl and its N-iteration kernel);
   - L2: ``synth_powerlaw(1_000_000, 10_000_000, seed=0)``, WT 2000
     (resident y, split planes: K4 and its N-iteration kernel);
   - L3: ``synth_powerlaw(4_000_000, 40_000_000, seed=0)``, WT 30,880
     (streamed y, split planes: K3-split and its N-iteration kernel).
3. The main path at full size, each run with every launch count zeroed
   just before it and read just after; a run fails unless its route's
   kernel launched and no other kernel did:
   - smoke through the CLI, ``-c -n 200 --x random:1``, per call and
     ``--fused``, float32 and bfloat16;
   - L1 through the CLI, ``-c -t --decode-check -n 100 --x random:1``,
     per call and ``--fused``, float32 and bfloat16;
   - L2 likewise, on a MatrixMarket file the port's ``write_mtx`` writes
     into a temporary directory (its write and read times printed);
   - L3 through the operator API (``SellSpMV.from_coo``, ``__call__``,
     ``bench_loop`` with N = 100), float32 and bfloat16.
   Every output vector (both reports of a ``-c -t`` run) is checked
   against a float64 scipy CSR oracle: max |y - oracle| / max |oracle|
   <= 1e-5 (bfloat16: the oracle takes bf16-rounded vals and x; the
   report prints 6 significant digits, which fits the bound).
4. One ``{"kernels": [...]}`` line: per kernel, configuration and value
   dtype, its time per launch from CUDA events, its launches in the
   main-path run, its bound (bytes of its route over the card's memory
   rate, or 2·nnz·N flops over the float32 rate, the larger), the plain
   version's time and a library yardstick (``torch.sparse.mm`` on a
   float32 CSR tensor of the same matrix, never called by the port).
   Then the card's name and power limit again and, last, the
   ``{"ok": true, "device": ...}`` line.

Each phase prints its time. Needs no network and one card; it stops with
an error when ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

SMOKE_SPEC = "synth:1000000:10000000"
L1_SPEC = "synth:4194304:41943040"
L2_POWERLAW = (1_000_000, 10_000_000)
L3_POWERLAW = (4_000_000, 40_000_000)
ITERATIONS = {"smoke": 200, "L1": 100, "L2": 100, "L3": 100}
TOL_KERNEL = 1e-6
TOL_ORACLE = 1e-5
# H100 SXM peak for float32 arithmetic outside the tensor cores (NVIDIA's
# data sheet); the kernels' multiply-adds run there in both value modes.
F32_PEAK_FLOPS = 67e12
CSRC = "smvp_toolkit_tpu_torch/csrc/"
PALLAS = "smvp_toolkit_tpu/ops/spmv_pallas.py:"
# Per kernel: source, and the TPU kernel it replaces.
KERNELS = {
    "sell_spmv_kernel": ("sell_spmv.cu", 389),
    "sell_streamy_relsl_kernel": ("sell_spmv.cu", 864),
    "sell_streamy_kernel": ("sell_spmv.cu", 824),
    "sell_split_kernel": ("sell_spmv.cu", 592),
    "sell_bench_kernel": ("sell_bench.cu", 718),
    "sell_bench_streamy_relsl_kernel": ("sell_bench.cu", 742),
    "sell_bench_streamy_kernel": ("sell_bench.cu", 797),
    "sell_bench_split_kernel": ("sell_bench.cu", 797),
}
# The route each full-size configuration must run on.
ROUTE = {"smoke": "relsl", "L1": "streamy_relsl", "L2": "split",
         "L3": "streamy"}
DTYPE_NAMES = ("float32", "bfloat16")
DEVICE = "cuda:0"


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


def _ptxas_summary(logs):
    """Registers per kernel (most over its value/index types) and the
    spill stores of all kernels, from ptxas -v output."""
    regs, spills = {}, 0
    for text in logs.values():
        entry = None
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                entry = max((k for k in KERNELS if k in m.group(1)),
                            key=len, default=m.group(1))
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                spills += int(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                regs[entry] = max(regs.get(entry, 0), int(m.group(1)))
    return regs, spills


class _Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
        return False


def _wrappers(S):
    """Every kernel's wrapper by kernel name."""
    return {S.KERNEL_NAMES[(route, bench)]: S._ROUTE_FNS[route][bench]
            for route in S.ROUTES for bench in (False, True)}


def _zero_counts(S):
    for fn in _wrappers(S).values():
        fn.launches = 0


def _counts(S):
    return {name: fn.launches for name, fn in _wrappers(S).items()}


def _check_launched(S, counts, route, bench, what):
    """The route's forward (or bench) kernel launched, no other kernel."""
    want = S.KERNEL_NAMES[(route, bench)]
    _check(counts[want] >= 1, f"{want} never launched in {what}")
    others = {k: v for k, v in counts.items() if k != want and v}
    _check(not others, f"{what} launched other kernels: {others}")
    return counts[want]


def _configs():
    """Host triplets of the four full-size configurations and their plans."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan
    from smvp_toolkit_tpu_torch.utils.synth import (
        parse_synth_spec,
        synth_powerlaw,
    )

    out = {}
    for name, make in (
        ("smoke", lambda: parse_synth_spec(SMOKE_SPEC, device="cpu")),
        ("L1", lambda: parse_synth_spec(L1_SPEC, device="cpu")),
        ("L2", lambda: synth_powerlaw(*L2_POWERLAW, seed=0, device="cpu")),
        ("L3", lambda: synth_powerlaw(*L3_POWERLAW, seed=0, device="cpu")),
    ):
        t0 = time.perf_counter()
        coo = make()
        rr, cc, vv = coo.to_numpy()
        t1 = time.perf_counter()
        plan = _auto_plan(rr, cc, vv, coo.shape)
        t2 = time.perf_counter()
        occ = coo.nnz / plan.slots()
        print(f"[plan] {name}: {coo.shape[0]}x{coo.shape[1]}, nnz {coo.nnz}, "
              f"S {plan.n_sublanes} in {plan.n_chunks} chunks of "
              f"{plan.chunk}, WT {plan.window_tiles}, NS {plan.n_slices}, "
              f"CT {plan.n_coltiles}, y blocks of {plan.y_block_slices} "
              f"slices, occupancy {occ:.3f}; made in {t1 - t0:.2f} s, "
              f"planned in {t2 - t1:.2f} s", flush=True)
        out[name] = (plan, (rr, cc, vv, coo.shape))
    return out


def _small_plans(np):
    """The small phase-2 plans, (name, plan)."""
    from smvp_toolkit_tpu_torch.ops.sell_plan import (
        build_sell_plan,
        build_streamed_sell_plan,
    )

    rng = np.random.RandomState(7)
    nrows, ncols, nnz = 30000, 47000, 400000
    live_rows = rng.choice(nrows, size=nrows // 2, replace=False)
    r = live_rows[rng.randint(0, len(live_rows), size=nnz)]
    c = rng.randint(0, ncols, size=nnz)
    v = rng.randn(nnz)
    # streamed: rows only in y blocks 0 and 2 of three
    blk = 512 * 128
    rs = np.concatenate([rng.randint(0, blk, 200000),
                         rng.randint(2 * blk, 3 * blk, 200000)])
    cs = np.clip(rs + rng.randint(-300, 301, 400000), 0, 3 * blk - 1)
    vs = rng.randn(400000)
    # few entries spread over 547 column tiles: WT > 511
    rw, cw = rng.randint(0, 200000, 6000), rng.randint(0, 70000, 6000)
    vw = rng.randn(6000)
    stream = dict(y_block_rows=blk)
    return [
        ("random-rect-empty-rows",
         build_sell_plan(r, c, v, (nrows, ncols), chunk=2048)),
        ("nnz0", build_sell_plan(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                 np.zeros(0), (5000, 3000), chunk=2048)),
        ("chunk200-int32-lidx",
         build_sell_plan(r, c, v, (nrows, ncols), chunk=200,
                         allow_small_chunk=False)),
        ("streamed-empty-middle-block",
         build_streamed_sell_plan(rs, cs, vs, (3 * blk, 3 * blk),
                                  chunk=2048, **stream)),
        ("streamed-int32-lidx",
         build_streamed_sell_plan(rs, cs, vs, (3 * blk, 3 * blk),
                                  chunk=200, **stream)),
        ("streamed-split",
         build_streamed_sell_plan(rw, cw, vw, (200000, 70000), chunk=2048,
                                  **stream)),
        ("resident-split",
         build_sell_plan(rw[:1500], cw[:1500], vw[:1500], (200000, 70000),
                         chunk=2048)),
    ]


def phase_kernels(np, torch, plans):
    """Phase 2: every route's kernels against their plain version; returns
    the operators and max abs errors of the full-size configurations."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device(DEVICE)
    ops, errs = {}, {}
    for name, plan in plans:
        for dname in DTYPE_NAMES:
            op = S.SellSpMV(plan, value_dtype=getattr(torch, dname),
                            device=dev)
            fwd, bench = S._ROUTE_FNS[op.route]
            plain = getattr(S, fwd.__name__ + "_plain")
            x = torch.from_numpy(
                np.random.default_rng(3).standard_normal(plan.shape[1])
                .astype(np.float32)).to(dev)
            xt = op._x_tiles(x)
            y1 = fwd(*op._planes(), xt, **op._kw())
            y2 = bench(*op._planes(), xt, iterations=3, **op._kw())
            yp = plain(*op._planes(), xt, **op._kw())
            torch.cuda.synchronize()
            e1, e2, e21 = _rel_err(y1, yp), _rel_err(y2, yp), _rel_err(y2, y1)
            names = (S.KERNEL_NAMES[(op.route, False)],
                     S.KERNEL_NAMES[(op.route, True)])
            print(f"[check] {name:28s} {dname:9s} {op.route:13s} lidx "
                  f"{str(op.lidx.dtype):11s} {names[0]} vs plain {e1:.3e}  "
                  f"{names[1]}(N=3) vs plain {e2:.3e}  bench vs forward "
                  f"{e21:.3e}", flush=True)
            _check(torch.isfinite(y1).all().item(), f"{names[0]} finite on "
                   f"{name}")
            _check(e1 <= TOL_KERNEL, f"{names[0]} vs plain on {name} {dname}: "
                   f"{e1}")
            _check(e2 <= TOL_KERNEL, f"{names[1]} vs plain on {name} {dname}: "
                   f"{e2}")
            _check(e21 <= TOL_KERNEL, f"{names[1]} vs {names[0]} on {name} "
                   f"{dname}: {e21}")
            if name in ROUTE:
                _check(op.route == ROUTE[name], f"{name} runs on {op.route}, "
                       f"not {ROUTE[name]}")
                ops[(name, dname)] = (op, x)
                errs[(name, dname)] = ((y1 - yp).abs().max().item(),
                                       (y2 - yp).abs().max().item())
    return ops, errs


def _oracle(np, torch, triplets, dname):
    import scipy.sparse as sp

    r, c, v, shape = triplets
    x = np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32)
    v = np.asarray(v, dtype=np.float32)
    if dname == "bfloat16":
        v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=shape)
    return a @ x.astype(np.float64), x


def _report_vector(np, path):
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("[")
    end = lines.index("]", start)
    return np.array([float(t) for t in lines[start + 1:end]])


def _cli_runs(np, torch, name, source, argv0, triplets, launches):
    """The CLI on ``source``, per call and fused, in both dtypes."""
    from smvp_toolkit_tpu_torch.cli import main as cli_main
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    algs = ["CSR", "TJDS"] if "-t" in argv0 else ["CSR"]
    for dname in DTYPE_NAMES:
        ref, _ = _oracle(np, torch, triplets, dname)
        scale = float(np.abs(ref).max())
        for fused in (False, True):
            with tempfile.TemporaryDirectory() as tmp:
                argv = argv0 + ["-n", str(ITERATIONS[name]), "-d", tmp,
                                "--device", torch.device(DEVICE).type,
                                "--json-out", os.path.join(tmp, "run.jsonl"),
                                "--x", "random:1", "--dtype", dname]
                argv += ["--fused"] if fused else []
                log = io.StringIO()
                _zero_counts(S)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(log):
                    rc = cli_main(argv + [source])
                wall = time.perf_counter() - t0
                counts = _counts(S)
                what = f"{name} CLI {' '.join(argv0)} {dname} fused={fused}"
                _check(rc == 0, f"{what} returned {rc}:\n{log.getvalue()}")
                if "--decode-check" in argv0:
                    for alg in algs:
                        _check(f"{alg} decode round-trip: bit-exact"
                               in log.getvalue(), f"{what}: {alg} decode")
                n = _check_launched(S, counts, ROUTE[name], fused, what)
                launches[(S.KERNEL_NAMES[(ROUTE[name], fused)], name,
                          dname)] = n
                with open(os.path.join(tmp, "run.jsonl")) as f:
                    recs = [json.loads(ln) for ln in f]
                errs = []
                for alg in algs:
                    (path,) = glob.glob(os.path.join(
                        tmp, f"smvp-toolbox_report_{alg}_*"))
                    y = _report_vector(np, path)
                    _check(y.shape == ref.shape, f"{what} {alg} report "
                           f"vector shape {y.shape}")
                    _check(bool(np.isfinite(y).all()), f"{what} {alg} finite")
                    errs.append(float(np.abs(y - ref).max()) / scale)
            rates = ", ".join(f"{r['alg']} avg {r['avg_ms']:.6f} ms/iter"
                              for r in recs)
            print(f"[main] {name} {' '.join(argv0)} {dname}"
                  f"{' --fused' if fused else ''}: rc {rc}, {wall:.1f} s, "
                  f"{rates}, launches {S.KERNEL_NAMES[(ROUTE[name], fused)]} "
                  f"{n}, reports vs float64 oracle "
                  f"{', '.join(f'{e:.3e}' for e in errs)}", flush=True)
            for alg, e in zip(algs, errs):
                _check(e <= TOL_ORACLE, f"{what} {alg} oracle error {e}")


def _operator_runs(np, torch, name, triplets, launches):
    """L3 through the operator API, in both dtypes."""
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device(DEVICE)
    r, c, v, shape = triplets
    for dname in DTYPE_NAMES:
        vd = getattr(torch, dname)
        ref, x_ref = _oracle(np, torch, triplets, dname)
        scale = float(np.abs(ref).max())
        coo = COOMatrix.from_numpy(r, c, v, shape=shape, dtype=vd, device=dev)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            shape[1]).astype(np.float32)).to(vd).to(dev)
        t0 = time.perf_counter()
        op = S.SellSpMV.from_coo(coo, value_dtype=vd)
        t1 = time.perf_counter()
        for bench in (False, True):
            _zero_counts(S)
            y = op.bench_loop(x, ITERATIONS[name]) if bench else op(x)
            torch.cuda.synchronize()
            counts = _counts(S)
            what = f"{name} operator {dname} bench={bench}"
            n = _check_launched(S, counts, ROUTE[name], bench, what)
            launches[(S.KERNEL_NAMES[(ROUTE[name], bench)], name, dname)] = n
            y = y.double().cpu().numpy()
            _check(y.shape == ref.shape and bool(np.isfinite(y).all()),
                   f"{what}: y shape {y.shape} or not finite")
            err = float(np.abs(y - ref).max()) / scale
            print(f"[main] {name} SellSpMV.from_coo ({t1 - t0:.1f} s) "
                  f"{'bench_loop' if bench else '__call__'} {dname}: "
                  f"launches {n}, vs float64 oracle {err:.3e}", flush=True)
            _check(err <= TOL_ORACLE, f"{what} oracle error {err}")
        del op, coo


def phase_main_path(np, torch, configs):
    """Phase 3: the main path at full size; returns launches per (kernel,
    config, dtype)."""
    from smvp_toolkit_tpu_torch.io.mtx import read_mtx, write_mtx

    launches = {}
    with _Phase("main path: smoke"):
        _cli_runs(np, torch, "smoke", SMOKE_SPEC, ["-c"],
                  configs["smoke"][1], launches)
    with _Phase("main path: L1"):
        _cli_runs(np, torch, "L1", L1_SPEC, ["-c", "-t", "--decode-check"],
                  configs["L1"][1], launches)
    with _Phase("main path: L2"), tempfile.TemporaryDirectory() as tmp:
        r, c, v, shape = configs["L2"][1]
        path = os.path.join(tmp, "powerlaw_1M_10M.mtx")
        t0 = time.perf_counter()
        write_mtx(path, r, c, np.asarray(v, np.float64), shape)
        t1 = time.perf_counter()
        back = read_mtx(path, device=DEVICE)
        t2 = time.perf_counter()
        rb, cb, vb = back.to_numpy()
        _check(rb.tobytes() == r.tobytes() and cb.tobytes() == c.tobytes()
               and vb.tobytes() == np.asarray(v, np.float32).tobytes(),
               "L2 .mtx round trip")
        print(f"[mtx] L2 {path}: {os.path.getsize(path)} bytes, written in "
              f"{t1 - t0:.1f} s, read in {t2 - t1:.1f} s", flush=True)
        del back
        _cli_runs(np, torch, "L2", path, ["-c", "-t", "--decode-check"],
                  configs["L2"][1], launches)
    with _Phase("main path: L3"):
        _operator_runs(np, torch, "L3", configs["L3"][1], launches)
    return launches


def _library_csr(np, torch, triplets):
    r, c, v, shape = triplets
    order = np.lexsort((c, r))
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.concatenate(
            [[0], np.cumsum(np.bincount(r, minlength=shape[0]))])).to(DEVICE),
        torch.from_numpy(c[order].astype(np.int64)).to(DEVICE),
        torch.from_numpy(np.asarray(v, np.float32)[order]).to(DEVICE),
        size=shape, check_invariants=True,
    )


def phase_timings(np, torch, ops, errs, launches, configs):
    """Phase 4: one entry per kernel, configuration and value dtype."""
    from smvp_toolkit_tpu_torch.bench.roofline import hbm_bandwidth_gbs
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    bw = hbm_bandwidth_gbs(torch.device(DEVICE)) * 1e9
    entries = []
    for name, route in ROUTE.items():
        plan, triplets = configs[name]
        a = _library_csr(np, torch, triplets)
        n_iter = ITERATIONS[name]
        for dname in DTYPE_NAMES:
            op, x = ops[(name, dname)]
            xt = op._x_tiles(x)
            planes, kw = op._planes(), op._kw()
            vb = op.vals.element_size()
            nbytes = plan.traffic_bytes(vb, x_bytes=vb)
            x2 = x.float()[:, None]
            for bench in (False, True):
                kname = S.KERNEL_NAMES[(route, bench)]
                fn = S._ROUTE_FNS[route][bench]
                plain = getattr(S, fn.__name__ + "_plain")
                if bench:
                    ms = _time_ms(lambda: fn(*planes, xt, iterations=n_iter,
                                             **kw), reps=3, warmup=1)
                    plain_ms = _time_ms(lambda: plain(
                        *planes, xt, iterations=n_iter, **kw), reps=1,
                        warmup=0)
                    # N library calls in a row: the same N SpMVs.
                    lib_ms = _time_ms(lambda: [torch.sparse.mm(a, x2)
                                               for _ in range(n_iter)],
                                      reps=1, warmup=1)
                else:
                    ms = _time_ms(lambda: fn(*planes, xt, **kw), reps=20)
                    plain_ms = _time_ms(lambda: plain(*planes, xt, **kw),
                                        reps=3)
                    lib_ms = _time_ms(lambda: torch.sparse.mm(a, x2), reps=20)
                iters = n_iter if bench else 1
                t_bytes = nbytes / bw * 1e3
                t_ops = 2.0 * plan.nnz * iters / F32_PEAK_FLOPS * 1e3
                src, line = KERNELS[kname]
                entries.append({
                    "name": f"{kname}[{name},{dname}]",
                    "config": name,
                    "route": "cuda",
                    "source": CSRC + src,
                    "replaces": f"{PALLAS}{line}",
                    "launches": launches[(kname, name, dname)],
                    "max_abs_err": errs[(name, dname)][int(bench)],
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib_ms,
                    "iterations_per_launch": iters,
                    "traffic_bytes_per_iteration": nbytes,
                    "reread_bound_ms": iters * t_bytes,
                })
                print(f"[time] {kname} {name} {dname}: {ms:.6f} ms per launch "
                      f"({iters} SpMV), bound {max(t_bytes, t_ops):.6f} ms, "
                      f"plain {plain_ms:.6f} ms, library {lib_ms:.6f} ms",
                      flush=True)
        del a
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

    with _Phase("build"):
        logs = _build.build()
        regs, spills = _ptxas_summary(logs)
        print(f"[build] {len(logs)} source(s) built: {sorted(logs)}; "
              f"registers per thread: {regs}; spill stores {spills} bytes",
              flush=True)
        from smvp_toolkit_tpu_torch.ops import spmv_sell as S

        grid = {(r, d): S.bench_blocks(getattr(torch, d), torch.int8,
                                       route=r)
                for r in S.ROUTES for d in DTYPE_NAMES}
        print(f"[grid] bench kernels' cooperative grid (blocks of 256 "
              f"threads, int8 lane indices): {grid}", flush=True)

    with _Phase("plans"):
        configs = _configs()
        plans = _small_plans(np) + [(n, p) for n, (p, _) in configs.items()]
    with _Phase("kernels vs plain"):
        ops, errs = phase_kernels(np, torch, plans)
    del plans
    launches = phase_main_path(np, torch, configs)
    with _Phase("timings"):
        entries = phase_timings(np, torch, ops, errs, launches, configs)

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
