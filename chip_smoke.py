#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smvp_toolkit_tpu_torch) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. The card's name and power limit, then the kernels' build from
   ``smvp_toolkit_tpu_torch/csrc`` (one nvcc per source, in parallel) with
   its time, and each bench kernel's cooperative grid. The plans of the
   four full-size matrices and of the ``gcn_arxiv`` graph (its normalised
   adjacency A and its transpose).
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
   The k-column kernels (K1 and K4 with k > 1, their N-iteration kernel
   with N = 3 on merged-word plans, and the values-gradient kernel K7) on
   every resident-y small plan with k = 2, 8 and 17, on smoke and L2 with
   k = 8, and on gcn_arxiv's A (split planes: K4, K7) and Aᵀ (merged
   word: K1, K2) with k = 8 and, in float32, k = 256, the GCN's width.
   The fused solvers (K9 CG, K10 Chebyshev, K11 IC(0)-PCG at sweeps 2 and
   4) against their plain versions, 30 steps, on 2-D Poisson 64² and HPCG
   16³, float32 and bfloat16, and K9 on split planes (Poisson 256², its
   plan widened past 511 tiles): max |x - x_plain| / max |x_plain| <= 1e-4;
   in bfloat16 after 3 steps, where a control (K9 against a plain CG whose
   SpMV input skips the bf16 rounding) must exceed it, and after 30 steps
   <= 2^-7, since a one-ulp float32 difference now and then flips the bf16
   rounding of an SpMV input entry and CG carries the jump on.
3. The main path at full size, each run with every launch count zeroed
   just before it and read just after; a run fails unless its route's
   kernels launched and no other kernel did:
   - smoke through the CLI, ``-c -n 200 --x random:1 --spmm 8``, per call
     and ``--fused``, float32 and bfloat16 (K1 and K1 with k = 8; K2 and
     K2 with k = 8);
   - L1 through the CLI, ``-c -t --decode-check -n 100 --x random:1``,
     per call and ``--fused``, float32 and bfloat16;
   - L2 likewise with ``--spmm 8`` (K4 and K4 with k = 8; under
     ``--fused`` K4's N-iteration kernel and N SpMM launches), on a
     MatrixMarket file the port's ``write_mtx`` writes into a temporary
     directory (its write and read times printed);
   - L3 through the operator API (``SellSpMV.from_coo``, ``__call__``,
     ``bench_loop`` with N = 100), float32 and bfloat16;
   - gcn_arxiv: a 3-layer GCN at the width of the OGB ogbn-arxiv GCN
     baseline (169,343 nodes, dims [128, 256, 256, 40]) on
     ``gcn_norm(synth_powerlaw(169_343, 2_315_598, seed=0))``, features
     and labels from ``default_rng(0)``, the first 90,941 nodes (arxiv's
     train split size) in the loss: three ``gcn_train_step`` steps (K4
     with k > 1 forward, K1 with k > 1 backward) and three
     ``gcn_train_step_edges`` steps (the same plus K7), lr 0.01, each
     step's time printed, then one of each under ``torch.profiler``.
     Step 1 must agree with the same step through ``spmm_csr`` on the
     card (the edge step: with a float64 ``spmm_csr`` step) within rtol
     1e-4 / atol 1e-5, and every loss must be finite.
   - hpcg104: the HPCG benchmark's 27-point stencil on its default
     104³ grid (1,124,864 rows, 29,791,000 nnz), built with scipy and
     written once as a symmetric ``.mtx`` (15,457,932 stored entries),
     then the CLI with ``-c -n 10 --expand-symmetry --x random:1 --solve
     cg-fused:300`` and ``--solve pcg-ic0-fused:100`` (each launches its
     fused kernel once, and K1 for the benchmark and the residual check
     only), and the API on the same matrix: ``chebyshev-fused:600``
     (bounds from ``lanczos_eigsh`` as the CLI takes them), the scan
     loops ``cg:300``, ``cg:100``, ``pcg:300``, ``pcg-ic0:100`` and
     ``chebyshev:600``, and ``cg:1000:1e-6`` (its stopping step printed).
     Every float64 relative residual (scipy CSR of the full matrix) must
     be <= 1e-4 (``cg:100`` is only compared), each fused solve within 3x
     of its scan loop (or both <= 1e-5), and IC(0)-PCG below CG at 100
     steps. The A, L and Lᵀ plans and their common window are printed.
   Every output vector (both reports of a ``-c -t`` run) and every SpMM
   result (``--spmm-out``) is checked against a float64 scipy CSR
   oracle: max |y - oracle| / max |oracle| <= 1e-5 (bfloat16: the oracle
   takes bf16-rounded vals and x; the report prints 6 significant digits,
   which fits the bound).
4. One ``{"kernels": [...]}`` line: per kernel, configuration and value
   dtype, its time per launch from CUDA events, its launches in the
   main-path run, its bound (bytes of its route over the card's memory
   rate, or 2·nnz·k·N flops over the float32 rate, the larger; K7 counts
   2·k flops per slot of a live sublane), the plain version's time and a
   library yardstick (``torch.sparse.mm`` on a float32 CSR tensor of the
   same matrix with the same k, and for K7 ``torch.sparse.sampled_addmm``
   on its pattern with beta 0; never called by the port). The k-column
   kernels are timed at k = 8 on smoke and L2 and at k = 256 on
   gcn_arxiv. The fused solvers at hpcg104 in float32 (K9 300 steps, K10
   600, K11 100 at sweeps 4): bound = one step's bytes (the planes of each
   SpMV phase, K11: A + 3·(L + Lᵀ), and each state vector once) times the
   steps over the memory rate; yardstick: the same solve by the port's
   scan-loop solver (``models.solvers``) with ``torch.sparse.mm`` on
   float32 CSR tensors as its SpMV.
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
SPMM_K = 8          # --spmm K of the smoke and L2 CLI runs
GCN_NODES, GCN_EDGES = 169_343, 2_315_598  # ogbn-arxiv, symmetrised
GCN_DIMS = [128, 256, 256, 40]  # the OGB arxiv GCN baseline's widths
GCN_TRAIN_NODES = 90_941        # arxiv's train split
GCN_STEPS, GCN_LR = 3, 0.01
GCN_K = 256                     # the width the GCN kernels are timed at
TOL_STEP = dict(rtol=1e-4, atol=1e-5)
TOL_KERNEL = 1e-6
TOL_ORACLE = 1e-5
# H100 SXM peak for float32 arithmetic outside the tensor cores (NVIDIA's
# data sheet); the kernels' multiply-adds run there in both value modes.
F32_PEAK_FLOPS = 67e12
CSRC = "smvp_toolkit_tpu_torch/csrc/"
JAX_OPS = "smvp_toolkit_tpu/ops/"
# Per kernel: source, and the TPU kernel it replaces (file:line).
KERNELS = {
    "sell_spmv_kernel": ("sell_spmv.cu", "spmv_pallas.py:389"),
    "sell_streamy_relsl_kernel": ("sell_spmv.cu", "spmv_pallas.py:864"),
    "sell_streamy_kernel": ("sell_spmv.cu", "spmv_pallas.py:824"),
    "sell_split_kernel": ("sell_spmv.cu", "spmv_pallas.py:592"),
    "sell_bench_kernel": ("sell_bench.cu", "spmv_pallas.py:718"),
    "sell_bench_streamy_relsl_kernel": ("sell_bench.cu", "spmv_pallas.py:742"),
    "sell_bench_streamy_kernel": ("sell_bench.cu", "spmv_pallas.py:797"),
    "sell_bench_split_kernel": ("sell_bench.cu", "spmv_pallas.py:797"),
    "sell_spmm_kernel": ("sell_spmm.cu", "spmv_pallas.py:389"),
    "sell_split_spmm_kernel": ("sell_spmm.cu", "spmv_pallas.py:592"),
    "sell_bench_spmm_kernel": ("sell_spmm.cu", "spmv_pallas.py:718"),
    "sell_vals_grad_kernel": ("sell_vals_grad.cu", "spmv_pallas.py:935"),
    "sell_cg_kernel": ("sell_solvers.cu", "cg_fused.py:64"),
    "sell_chebyshev_kernel": ("sell_solvers.cu", "pcg_fused.py:188"),
    "sell_pcg_ic0_kernel": ("sell_solvers.cu", "pcg_fused.py:343"),
}
# hpcg104: the HPCG benchmark's 27-point stencil (GenerateProblem_ref.cpp:
# diagonal 26, each neighbour -1) on hpcg.dat's default local grid.
HPCG_N = 104
HPCG_ROWS, HPCG_NNZ, HPCG_STORED = 1_124_864, 29_791_000, 15_457_932
HPCG_BENCH_N = 10   # -n of the hpcg104 CLI runs
HPCG_CLI = (("cg-fused", 300), ("pcg-ic0-fused", 100))
SOLVE_RESIDUAL = 1e-4   # float64 relative residual of every hpcg104 solve
# Fused kernel vs its plain version: 1e-4 of max |x|, the JAX package's
# own tolerance for its fused solvers against their scan loops (the
# reductions re-associate). In bfloat16 it binds after 3 steps; a control
# (K9 against a plain CG whose SpMV input skips the bf16 rounding) must
# miss it there. After 30 bf16 steps the limit is two units of bf16
# rounding: a one-ulp float32 difference between two summation orders now
# and then flips the bf16 rounding of an SpMV input entry (a 2^-9 jump)
# that CG's scalars carry into every later step. That check only bounds
# the drift; it cannot tell a missing rounding from a sound run.
TOL_SOLVER = 1e-4
TOL_SOLVER_BF16 = 2.0 ** -7
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
    names = [*KERNELS, "sell_cg_split_kernel"]
    regs, spills = {}, 0
    for text in logs.values():
        entry = None
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                entry = max((k for k in names if k in m.group(1)),
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
    from smvp_toolkit_tpu_torch.ops.pcg_fused import SOLVER_KERNELS

    return {**{S.KERNEL_NAMES[(route, bench)]: S._ROUTE_FNS[route][bench]
               for route in S.ROUTES for bench in (False, True)},
            **S.MAT_KERNELS, **SOLVER_KERNELS}


def _zero_counts(S):
    for fn in _wrappers(S).values():
        fn.launches = 0


def _counts(S):
    return {name: fn.launches for name, fn in _wrappers(S).items()}


def _check_only(counts, want, what):
    """Each kernel in ``want`` launched, no other kernel; their counts."""
    for name in want:
        _check(counts[name] >= 1, f"{name} never launched in {what}")
    others = {k: v for k, v in counts.items() if k not in want and v}
    _check(not others, f"{what} launched other kernels: {others}")
    return {name: counts[name] for name in want}


def _check_launched(S, counts, route, bench, what):
    """The route's forward (or bench) kernel launched, no other kernel."""
    want = S.KERNEL_NAMES[(route, bench)]
    return _check_only(counts, [want], what)[want]


def _spmm_kernel_name(route, fused):
    """The k-column kernel a ``--spmm`` run of this route launches."""
    if route == "relsl":
        return "sell_bench_spmm_kernel" if fused else "sell_spmm_kernel"
    return "sell_split_spmm_kernel"  # --fused: N matmat calls


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


def _gcn_graph(np, torch):
    """gcn_arxiv's normalised adjacency on the card with its SELL operator
    (A) and the transpose's (Aᵀ), planned as the training path plans them."""
    from smvp_toolkit_tpu_torch.models import gcn_norm
    from smvp_toolkit_tpu_torch.ops.spmv_sell import sell_op_csr
    from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

    t0 = time.perf_counter()
    coo = synth_powerlaw(GCN_NODES, GCN_EDGES, seed=0, device=DEVICE)
    s = gcn_norm(coo)
    t1 = time.perf_counter()
    op = sell_op_csr(s)
    t2 = time.perf_counter()
    op_t = op.transpose()
    t3 = time.perf_counter()
    print(f"[plan] gcn_arxiv: {GCN_NODES} nodes, {coo.nnz} edges after "
          f"de-duplication, {s.nnz} nnz with self loops; made and "
          f"normalised in {t1 - t0:.2f} s", flush=True)
    for label, o, secs in (("A", op, t2 - t1), ("At", op_t, t3 - t2)):
        p = o.plan
        print(f"[plan] gcn_arxiv {label}: route {o.route}, S {p.n_sublanes} "
              f"in {p.n_chunks} chunks of {p.chunk}, WT {p.window_tiles}, "
              f"NS {p.n_slices}, CT {p.n_coltiles}, occupancy "
              f"{p.nnz / p.slots():.3f}; planned in {secs:.2f} s", flush=True)
    _check(op.route == "split" and op_t.route == "relsl",
           f"gcn_arxiv routes {op.route} / {op_t.route}, not split / relsl")
    return {"s": s, "A": op, "At": op_t}


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


def _spmm_tolerance(torch, S, op):
    """max(1e-6, 2·u·sqrt(n)) with n the most products any output element
    sums and u = 2^-24: a float32 sum of n products in random order is off
    by about u·sqrt(n) of its size, and the kernel's atomics and the plain
    version's index_add_ are two such orders. Only a long row lifts it
    above 1e-6 (n > 70): gcn_arxiv's Aᵀ has a hub row of about 490,000."""
    if op.relsl is not None:
        rel, sl = S._decode_word(op.relsl)
    else:
        rel, sl = op.rel.long(), op.slice_of.long()
    _, _, row = S._live_slots(op.lidx, rel, sl, op.tile_base,
                              chunk=op.plan.chunk, vals=op.vals)
    n = int(torch.bincount(row).max().item()) if row.numel() else 0
    return max(TOL_KERNEL, 2 * 2.0 ** -24 * n ** 0.5), n


def _check_mat_kernels(np, torch, name, op, ks, errs):
    """The k-column kernels of the operator's route against their plain
    versions: the SpMM kernel, the N-iteration one (N = 3, merged word)
    and K7, for each k; records each max abs error in ``errs``. K7 sums k
    products per slot and is held to 1e-6; the SpMM kernels to
    ``_spmm_tolerance`` of the plan."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    kw = op._mat_kw()
    meta = dict(relsl=op.relsl, rel=op.rel, slice_of=op.slice_of)
    dname = str(op.value_dtype).replace("torch.", "")
    plan = op.plan
    dead = torch.from_numpy((plan.rel_tile.reshape(-1) < 0)
                            | (plan.slice_of.reshape(-1) < 0)).to(op.device)
    tol, n_max = _spmm_tolerance(torch, S, op)
    for k in ks:
        rng = np.random.default_rng(k)
        X = torch.from_numpy(rng.standard_normal(
            (plan.n_coltiles * 128, k)).astype(np.float32)).to(op.device).to(
            op.value_dtype)
        G = torch.from_numpy(rng.standard_normal(
            (plan.n_slices * 128, k)).astype(np.float32)).to(op.device)
        fwd = op.spmm_kernel
        plain = getattr(S, fwd.__name__ + "_plain")
        yp = plain(*op._planes(), X, **kw)
        got = {fwd.kernel: (fwd(*op._planes(), X, **kw), yp)}
        if op.route == "relsl":
            got["sell_bench_spmm_kernel"] = (
                S.sell_bench_spmm(*op._planes(), X, iterations=3, **kw), yp)
        got["sell_vals_grad_kernel"] = (
            S.sell_vals_grad(op.lidx, op.tile_base, X, G, **meta, **kw),
            S.sell_vals_grad_plain(op.lidx, op.tile_base, X, G, **meta, **kw))
        torch.cuda.synchronize()
        line = []
        for kname, (y, ref) in got.items():
            e = _rel_err(y, ref)
            what = f"{kname} vs plain on {name} {dname} k={k}"
            _check(torch.isfinite(y).all().item(), f"{what}: not finite")
            t = TOL_KERNEL if kname == "sell_vals_grad_kernel" else tol
            _check(e <= t, f"{what}: {e} > {t}")
            errs[(kname, name, dname, k)] = (y - ref).abs().max().item()
            line.append(f"{kname} {e:.3e}")
        _check(not got["sell_vals_grad_kernel"][0].reshape(-1, 128)[
            dead].any(), f"K7 on {name} {dname}: a dead sublane is not 0")
        print(f"[check] {name:28s} {dname:9s} {op.route:5s} k={k:<3d} "
              f"vs plain: {', '.join(line)} (SpMM tolerance {tol:.2e}: rows "
              f"of up to {n_max} products)", flush=True)


def phase_kernels(np, torch, plans, gcn):
    """Phase 2: every route's kernels against their plain version; returns
    the operators and max abs errors of the full-size configurations (the
    k-column kernels' keyed by kernel, configuration, dtype and k)."""
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
            if not plan.y_block_slices:
                ks = (SPMM_K,) if name in ROUTE else (2, 8, 17)
                _check_mat_kernels(np, torch, name, op, ks, errs)
    for label in ("A", "At"):
        base = gcn[label]
        for dname in DTYPE_NAMES:
            op = base if dname == "float32" else S.SellSpMV(
                base.plan, value_dtype=torch.bfloat16, device=dev)
            ks = (SPMM_K, GCN_K) if dname == "float32" else (SPMM_K,)
            _check_mat_kernels(np, torch, f"gcn_arxiv:{label}", op, ks, errs)
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


def _spmm_oracle(np, torch, triplets, dname):
    """Float64 Y = A·X for the CLI's --spmm X (default_rng(0))."""
    import scipy.sparse as sp

    r, c, v, shape = triplets
    X = np.random.default_rng(0).standard_normal(
        (shape[1], SPMM_K)).astype(np.float32)
    v = np.asarray(v, dtype=np.float32)
    if dname == "bfloat16":
        v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        X = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=shape)
    return a @ X.astype(np.float64)


def _cli_runs(np, torch, name, source, argv0, triplets, launches,
              spmm=False):
    """The CLI on ``source``, per call and fused, in both dtypes; with
    ``spmm``, each run also times ``--spmm 8`` and its Y is checked."""
    from smvp_toolkit_tpu_torch.cli import main as cli_main
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    algs = ["CSR", "TJDS"] if "-t" in argv0 else ["CSR"]
    route = ROUTE[name]
    for dname in DTYPE_NAMES:
        ref, _ = _oracle(np, torch, triplets, dname)
        scale = float(np.abs(ref).max())
        ref_mat = _spmm_oracle(np, torch, triplets, dname) if spmm else None
        for fused in (False, True):
            with tempfile.TemporaryDirectory() as tmp:
                argv = argv0 + ["-n", str(ITERATIONS[name]), "-d", tmp,
                                "--device", torch.device(DEVICE).type,
                                "--json-out", os.path.join(tmp, "run.jsonl"),
                                "--x", "random:1", "--dtype", dname]
                argv += ["--fused"] if fused else []
                if spmm:
                    argv += ["--spmm", str(SPMM_K), "--spmm-out",
                             os.path.join(tmp, "y.npy")]
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
                want = [S.KERNEL_NAMES[(route, fused)]]
                if spmm:
                    want.append(_spmm_kernel_name(route, fused))
                got = _check_only(counts, want, what)
                for kname, n in got.items():
                    key = (kname, name, dname)
                    launches[key] = launches.get(key, 0) + n
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
                if spmm:
                    Y = np.load(os.path.join(tmp, "y.npy")).astype(np.float64)
                    _check(Y.shape == ref_mat.shape and bool(
                        np.isfinite(Y).all()), f"{what} SpMM Y {Y.shape}")
                    errs.append(float(np.abs(Y - ref_mat).max())
                                / float(np.abs(ref_mat).max()))
            rates = ", ".join(
                f"{r['alg']} avg {r['avg_ms']:.6f} ms/iter"
                + (f" ({r['kernel']}, {r['timing']})" if "k" in r else "")
                for r in recs)
            print(f"[main] {name} {' '.join(argv0)} {dname}"
                  f"{' --fused' if fused else ''}: rc {rc}, {wall:.1f} s, "
                  f"{rates}, launches {got}, vs float64 oracle "
                  f"{', '.join(f'{e:.3e}' for e in errs)}", flush=True)
            for e in errs:
                _check(e <= TOL_ORACLE, f"{what} oracle error {e}")


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
                  configs["smoke"][1], launches, spmm=True)
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
                  configs["L2"][1], launches, spmm=True)
    with _Phase("main path: L3"):
        _operator_runs(np, torch, "L3", configs["L3"][1], launches)
    return launches


def _close_step(torch, what, got, want):
    got, want = got.detach().double(), want.detach().double()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    _check(got.shape == want.shape and torch.allclose(got, want, **TOL_STEP),
           f"{what}: max |Δ| {err}")
    return err


def _profile_step(torch, label, step):
    """One step under torch.profiler: wall time, device busy time (the sum
    of its kernels, copies and fills) and the ten that took most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = {}
    for e in prof.key_averages():  # device-side events only: an operator
        # on the host also reports the device time of what it launched
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.key] = per_name.get(e.key, 0.0) + (
                e.self_device_time_total / 1e3)
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of wall); by kernel: "
          + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top), flush=True)


def phase_gcn(np, torch, gcn, launches):
    """Phase 3 on the training path: gcn_arxiv's train and edge steps."""
    import dataclasses

    from smvp_toolkit_tpu_torch.models import (
        gcn_init,
        gcn_train_step,
        gcn_train_step_edges,
    )
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.spmv_torch import spmm_csr

    dev = torch.device(DEVICE)
    s = gcn["s"]
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal(
        (GCN_NODES, GCN_DIMS[0])).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, GCN_DIMS[-1], GCN_NODES)).to(
        dev)
    mask = torch.arange(GCN_NODES, device=dev) < GCN_TRAIN_NODES
    layers = len(GCN_DIMS) - 1
    fwd, bwd = gcn["A"].spmm_kernel.kernel, gcn["At"].spmm_kernel.kernel

    def fresh():
        return gcn_init(torch.Generator().manual_seed(0), GCN_DIMS,
                        device=dev)

    def timed(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # Step 1 through spmm_csr on the card: what the kernels' step 1 must give.
    ref = fresh()
    (_, ref_loss), ref_ms = timed(lambda: gcn_train_step(
        s, ref, h, labels, mask, GCN_LR, spmm=spmm_csr))
    model = fresh()
    _zero_counts(S)
    for step in range(1, GCN_STEPS + 1):
        (_, loss), ms = timed(lambda: gcn_train_step(s, model, h, labels,
                                                      mask, GCN_LR))
        _check(bool(torch.isfinite(loss)), f"gcn train step {step} loss")
        note = ""
        if step == 1:
            errs = [_close_step(torch, "gcn train step 1 loss", loss,
                                ref_loss)]
            for i, (p, q) in enumerate(zip(model.parameters(),
                                           ref.parameters())):
                errs.append(_close_step(torch, f"gcn train step 1 param {i}",
                                        p, q))
            note = (f"; vs spmm_csr step ({ref_ms:.3f} ms): max |Δ| "
                    f"{max(errs):.3e}")
        print(f"[gcn] gcn_train_step {step}: {ms:.3f} ms, loss "
              f"{loss.item():.6f}{note}", flush=True)
    got = _check_only(_counts(S), [fwd, bwd], "gcn_arxiv train steps")
    _check(got == {fwd: layers * GCN_STEPS, bwd: layers * GCN_STEPS},
           f"gcn train steps launched {got}")
    for kname, n in got.items():
        launches[(kname, "gcn_arxiv", "float32")] = n

    # Edge step 1 in float64 through spmm_csr: the oracle of edge step 1.
    s64 = dataclasses.replace(s, vals=s.vals.double())
    m64 = fresh().double()
    _, ev64, loss64 = gcn_train_step_edges(s64, m64, s64.vals, h.double(),
                                           labels, mask, GCN_LR,
                                           spmm=spmm_csr)
    model_e, ev = fresh(), s.vals
    _zero_counts(S)
    for step in range(1, GCN_STEPS + 1):
        (_, ev, loss), ms = timed(lambda: gcn_train_step_edges(
            s, model_e, ev, h, labels, mask, GCN_LR))
        _check(bool(torch.isfinite(loss)) and bool(torch.isfinite(ev).all()),
               f"gcn edge step {step}: loss or edge values not finite")
        note = ""
        if step == 1:
            errs = [_close_step(torch, "gcn edge step 1 edge values", ev,
                                ev64),
                    _close_step(torch, "gcn edge step 1 loss", loss, loss64)]
            for i, (p, q) in enumerate(zip(model_e.parameters(),
                                           m64.parameters())):
                errs.append(_close_step(torch, f"gcn edge step 1 param {i}",
                                        p, q))
            note = f"; vs float64 spmm_csr step: max |Δ| {max(errs):.3e}"
        print(f"[gcn] gcn_train_step_edges {step}: {ms:.3f} ms, loss "
              f"{loss.item():.6f}{note}", flush=True)
    kv = "sell_vals_grad_kernel"
    got = _check_only(_counts(S), [fwd, bwd, kv], "gcn_arxiv edge steps")
    _check(got == {fwd: layers * GCN_STEPS, bwd: layers * GCN_STEPS,
                   kv: layers * GCN_STEPS}, f"gcn edge steps launched {got}")
    for kname, n in got.items():
        key = (kname, "gcn_arxiv", "float32")
        launches[key] = launches.get(key, 0) + n
    del s64, m64, ev64, ref

    _profile_step(torch, "gcn_train_step", lambda: gcn_train_step(
        s, model, h, labels, mask, GCN_LR))
    _profile_step(torch, "gcn_train_step_edges", lambda: gcn_train_step_edges(
        s, model_e, ev, h, labels, mask, GCN_LR))


def _library_csr(np, torch, triplets):
    """A float32 CSR tensor of the triplets on the card, duplicates summed
    (gcn_norm's self loops repeat a graph's own (i, i) edges)."""
    import scipy.sparse as sp

    r, c, v, shape = triplets
    a = sp.csr_matrix((np.asarray(v, np.float32), (r, c)), shape=shape)
    a.sum_duplicates()
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)).to(DEVICE),
        torch.from_numpy(a.indices.astype(np.int64)).to(DEVICE),
        torch.from_numpy(a.data.astype(np.float32)).to(DEVICE),
        size=shape, check_invariants=True,
    )


def _entry(kname, config, dname, *, launches, err, ms, plain_ms, lib_ms,
           nbytes, flops, bw, iters=1, per_iteration=False, **extra):
    """One ``kernels`` entry: ``nbytes`` (each input once, each output
    once) over the memory rate, or ``flops`` over the float32 rate. With
    ``per_iteration`` (the fused solvers) ``nbytes`` is one iteration's
    traffic, which every iteration moves again."""
    t_bytes = nbytes / bw * 1e3 * (iters if per_iteration else 1)
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    src, line = KERNELS[kname]
    print(f"[time] {kname} {config} {dname} {extra}: {ms:.6f} ms per launch "
          f"({iters} iterations), bound {max(t_bytes, t_ops):.6f} ms, plain "
          f"{plain_ms:.6f} ms, library {lib_ms:.6f} ms", flush=True)
    return {
        "name": f"{kname}[{config},{dname}]",
        "config": config,
        "route": "cuda",
        "source": CSRC + src,
        "replaces": f"{JAX_OPS}{line}",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "iterations_per_launch": iters,
        "traffic_bytes_per_iteration": nbytes,
        "reread_bound_ms": t_bytes if per_iteration else iters * t_bytes,
        **extra,
    }


def phase_timings(np, torch, ops, errs, launches, configs, bw):
    """Phase 4: one entry per k = 1 kernel, configuration and value dtype."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

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
                entries.append(_entry(
                    kname, name, dname,
                    launches=launches[(kname, name, dname)],
                    err=errs[(name, dname)][int(bench)], ms=ms,
                    plain_ms=plain_ms, lib_ms=lib_ms,
                    nbytes=plan.traffic_bytes(vb, x_bytes=vb),
                    flops=2.0 * plan.nnz * iters, bw=bw, iters=iters))
        del a
    return entries


def phase_mat_timings(np, torch, ops, errs, launches, configs, gcn, bw):
    """Phase 4 for the k-column kernels: at k = 8 on smoke and L2 (both
    dtypes, the N-iteration kernel with the CLI's N), at k = 256 on
    gcn_arxiv (float32)."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device(DEVICE)
    entries = []
    for name in ("smoke", "L2"):
        plan, triplets = configs[name]
        a = _library_csr(np, torch, triplets)
        X = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (plan.shape[1], SPMM_K)).astype(np.float32)).to(dev)
        for dname in DTYPE_NAMES:
            op = ops[(name, dname)][0]
            Xt = op._block(X, plan.n_coltiles * 128, op.value_dtype, "X")
            planes, kw = op._planes(), op._mat_kw()
            vb = op.vals.element_size()
            runs = [(op.spmm_kernel, 1)]
            if op.route == "relsl":
                runs.append((S.sell_bench_spmm, ITERATIONS[name]))
            for fn, n in runs:
                plain = getattr(S, fn.__name__ + "_plain")
                if n > 1:
                    ms = _time_ms(lambda: fn(*planes, Xt, iterations=n, **kw),
                                  reps=3, warmup=1)
                    plain_ms = _time_ms(lambda: plain(
                        *planes, Xt, iterations=n, **kw), reps=1, warmup=0)
                    lib_ms = _time_ms(lambda: [torch.sparse.mm(a, X)
                                               for _ in range(n)],
                                      reps=1, warmup=1)
                else:
                    ms = _time_ms(lambda: fn(*planes, Xt, **kw), reps=20)
                    plain_ms = _time_ms(lambda: plain(*planes, Xt, **kw),
                                        reps=3)
                    lib_ms = _time_ms(lambda: torch.sparse.mm(a, X), reps=20)
                entries.append(_entry(
                    fn.kernel, name, dname,
                    launches=launches[(fn.kernel, name, dname)],
                    err=errs[(fn.kernel, name, dname, SPMM_K)], ms=ms,
                    plain_ms=plain_ms, lib_ms=lib_ms,
                    nbytes=plan.traffic_bytes(vb, x_bytes=vb, k=SPMM_K),
                    flops=2.0 * plan.nnz * SPMM_K * n, bw=bw, iters=n,
                    k=SPMM_K))
        del a
    rng = np.random.default_rng(GCN_K)
    X = torch.from_numpy(rng.standard_normal((GCN_NODES, GCN_K)).astype(
        np.float32)).to(dev)
    G = torch.from_numpy(rng.standard_normal((GCN_NODES, GCN_K)).astype(
        np.float32)).to(dev)
    for label in ("A", "At"):
        o = gcn[label]
        plan, kw = o.plan, o._mat_kw()
        r, c, v = o._triplets
        a = _library_csr(np, torch, (r, c, v, o.shape))
        Xt = o._block(X, plan.n_coltiles * 128, torch.float32, "X")
        fn = o.spmm_kernel
        plain = getattr(S, fn.__name__ + "_plain")
        common = dict(launches=launches[(fn.kernel, "gcn_arxiv", "float32")],
                      nbytes=plan.traffic_bytes(4, x_bytes=4, k=GCN_K),
                      bw=bw, k=GCN_K, plan=label)
        entries.append(_entry(
            fn.kernel, "gcn_arxiv", "float32",
            err=errs[(fn.kernel, f"gcn_arxiv:{label}", "float32", GCN_K)],
            ms=_time_ms(lambda: fn(*o._planes(), Xt, **kw), reps=10),
            plain_ms=_time_ms(lambda: plain(*o._planes(), Xt, **kw), reps=1,
                              warmup=1),
            lib_ms=_time_ms(lambda: torch.sparse.mm(a, X), reps=10),
            flops=2.0 * plan.nnz * GCN_K, **common))
        if label == "A":  # K7 runs on A's planes in the edge steps
            kname = "sell_vals_grad_kernel"
            Gt = o._block(G, plan.n_slices * 128, torch.float32, "G")
            meta = dict(relsl=o.relsl, rel=o.rel, slice_of=o.slice_of)
            Xtr = X.t().contiguous()
            live = int(((plan.rel_tile.reshape(-1) >= 0)
                        & (plan.slice_of.reshape(-1) >= 0)).sum()) * 128
            common["launches"] = launches[(kname, "gcn_arxiv", "float32")]
            entries.append(_entry(
                kname, "gcn_arxiv", "float32",
                err=errs[(kname, "gcn_arxiv:A", "float32", GCN_K)],
                ms=_time_ms(lambda: S.sell_vals_grad(
                    o.lidx, o.tile_base, Xt, Gt, **meta, **kw), reps=10),
                plain_ms=_time_ms(lambda: S.sell_vals_grad_plain(
                    o.lidx, o.tile_base, Xt, Gt, **meta, **kw), reps=1,
                    warmup=1),
                lib_ms=_time_ms(lambda: torch.sparse.sampled_addmm(
                    a, G, Xtr, beta=0.0), reps=10),
                flops=2.0 * live * GCN_K, **common))
        del a
    return entries


def _card_coo(np, torch, a, dtype=None):
    """The port's COO of a scipy matrix on the card, values in ``dtype``."""
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    a = a.tocoo()
    return COOMatrix.from_numpy(a.row, a.col, a.data, shape=a.shape,
                                dtype=dtype, pad_to=128, device=DEVICE)


def _card_csr(np, torch, a, dtype=None):
    """The port's CSR of a scipy matrix on the card, values in ``dtype``."""
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode

    return csr_encode(_card_coo(np, torch, a, dtype))


def _bounds(torch, csr, spmv=None):
    """Chebyshev's interval as the CLI takes it: 30 Lanczos steps from a
    default_rng(0) start, lambda_min x 0.3, lambda_max x 1.1."""
    import numpy as np

    from smvp_toolkit_tpu_torch.models.solvers import lanczos_eigsh

    n = csr.shape[0]
    v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(
        np.float32)).to(DEVICE)
    lows, highs = lanczos_eigsh(csr, v0, num_iters=min(30, n), k=1,
                                spmv=spmv)
    return float(lows[0]) * 0.3, float(highs[0]) * 1.1


def _solver_runs(op, factors, b, it, lo, hi):
    """(kernel, label, fused, plain) of each solver kernel at ``it`` steps
    (K11 at sweeps 2 and 4)."""
    from smvp_toolkit_tpu_torch.ops import cg_fused as C
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P

    runs = [("sell_cg_kernel", "", lambda: C.fused_cg(op, b, it),
             lambda: C.fused_cg_plain(op, b, it)),
            ("sell_chebyshev_kernel", "",
             lambda: P.fused_chebyshev(op, b, lo, hi, it),
             lambda: P.fused_chebyshev_plain(op, b, lo, hi, it))]
    for sw in (2, 4):
        runs.append(("sell_pcg_ic0_kernel", f" sweeps {sw}",
                     lambda sw=sw: P.fused_pcg_ic0(op, factors, b, it,
                                                   sweeps=sw),
                     lambda sw=sw: P.fused_pcg_ic0_plain(op, factors, b, it,
                                                         sweeps=sw)))
    return runs


def _cg_unrounded(torch, op, b, it):
    """x of ``it`` CG steps on ``op``'s plain sweep with the SpMV input
    left in float32: what K9 would give in bfloat16 mode if it skipped
    rounding its input (the control of the bf16 check)."""
    from smvp_toolkit_tpu_torch.models.solvers import conjugate_gradient
    from smvp_toolkit_tpu_torch.ops import cg_fused as C
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    plain = getattr(S, op.kernel.__name__ + "_plain")
    kw, n_in = op._kw(), op.plan.n_coltiles * 128

    def spmv(planes, v):
        y = plain(*planes, v[:n_in], **kw)
        return torch.nn.functional.pad(y, (0, v.numel() - y.numel()))

    bt = C.pad_state(b, C.state_tiles(op.plan))
    x, _ = conjugate_gradient(op._planes(), bt, num_iters=it, spmv=spmv)
    return x[:b.numel()]


def phase_solver_kernels(np, torch):
    """Phase 2 for the fused solvers: K9, K10 and K11 (sweeps 2 and 4)
    against their plain versions on Poisson 64² and HPCG 16³, float32 and
    bfloat16, 30 steps (bfloat16 also 3); K9 on split planes."""
    import dataclasses

    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg, fused_cg_plain
    from smvp_toolkit_tpu_torch.ops.ilu import ic0
    from smvp_toolkit_tpu_torch.ops.sell_plan import rewindow_plan
    from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

    for name, a in (("poisson64", poisson2d(64)),
                    ("hpcg16", hpcg_stencil(16))):
        csr32 = _card_csr(np, torch, a, torch.float32)
        lo, hi = _bounds(torch, csr32)
        b = torch.from_numpy(np.random.default_rng(0).standard_normal(
            a.shape[0]).astype(np.float32)).to(DEVICE)
        for dname in DTYPE_NAMES:
            csr = dataclasses.replace(csr32, vals=csr32.vals.to(
                getattr(torch, dname)))
            op = S.sell_op_csr(csr)
            factors = ic0(csr)
            for it in ((3, 30) if dname == "bfloat16" else (30,)):
                tol = (TOL_SOLVER_BF16 if dname == "bfloat16" and it == 30
                       else TOL_SOLVER)
                line = []
                for kname, label, fused, plain in _solver_runs(
                        op, factors, b, it, lo, hi):
                    x, xp = fused(), plain()
                    torch.cuda.synchronize()
                    e = _rel_err(x, xp)
                    what = f"{kname}{label} vs plain on {name} {dname} {it}"
                    _check(bool(torch.isfinite(x).all()), f"{what}: finite")
                    _check(e <= tol, f"{what}: {e} > {tol}")
                    line.append(f"{kname}{label} {e:.3e}")
                print(f"[check] {name:9s} {dname:9s} {it:2d} steps vs plain "
                      f"(tolerance {tol:.1e}): {', '.join(line)}",
                      flush=True)
                if dname == "bfloat16":
                    e = _rel_err(fused_cg(op, b, it),
                                 _cg_unrounded(torch, op, b, it))
                    _check(it != 3 or e > TOL_SOLVER,
                           f"{name}: the bf16 check misses an unrounded "
                           f"SpMV input ({e} <= {TOL_SOLVER})")
                    print(f"[check] {name:9s} control: sell_cg_kernel vs CG "
                          f"with an unrounded SpMV input, {it} steps: "
                          f"{e:.3e}", flush=True)
    # K9 on split planes: 256² is the smallest Poisson grid whose 512
    # column tiles let a widened window pass 511 (a window never exceeds
    # CT; Poisson 64² has CT 128).
    csr = _card_csr(np, torch, poisson2d(256), torch.float32)
    op = S.SellSpMV(rewindow_plan(S.sell_op_csr(csr).plan, 512),
                    device=DEVICE)
    _check(op.route == "split", f"poisson256 widened runs on {op.route}")
    b = torch.ones(csr.shape[0], device=DEVICE)
    e = _rel_err(fused_cg(op, b, 30), fused_cg_plain(op, b, 30))
    _check(e <= TOL_SOLVER, f"sell_cg_kernel split vs plain: {e}")
    print(f"[check] poisson256 float32 split planes (WT "
          f"{op.plan.window_tiles}) 30 steps: sell_cg_kernel vs plain "
          f"{e:.3e}", flush=True)


def _hpcg_solve(torch, S, label, fn, want, relres, out):
    """One hpcg104 solve through the API, launch counts zeroed before and
    read after: ``want`` maps each kernel that may launch to its exact
    count (None: any count >= 1)."""
    _zero_counts(S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    x, res = got if isinstance(got, tuple) else (got, None)
    counts = _check_only(_counts(S), list(want), f"hpcg104 {label}")
    for kname, n in want.items():
        _check(n is None or counts[kname] == n,
               f"hpcg104 {label}: {kname} launched {counts[kname]}, not {n}")
    rr = relres(x)
    out[label] = rr
    print(f"[main] hpcg104 API {label}: {ms:.1f} ms, float64 relative "
          f"residual {rr:.3e}, launches {counts}", flush=True)
    return x, res, counts


def phase_hpcg(np, torch, launches):
    """Phase 3 on the solver path at hpcg104: the CLI's fused solves from a
    symmetric .mtx, then the API's scan-loop and fused solves on the same
    matrix, each held to a float64 residual."""
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.cli import main as cli_main
    from smvp_toolkit_tpu_torch.io.mtx import write_mtx
    from smvp_toolkit_tpu_torch.models import solvers as M
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.algebra import diagonal
    from smvp_toolkit_tpu_torch.ops.ilu import ic0
    from smvp_toolkit_tpu_torch.ops.pcg_fused import (
        fused_chebyshev,
        fused_pcg_ic0,
    )
    from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil

    t0 = time.perf_counter()
    a = hpcg_stencil(HPCG_N)
    print(f"[hpcg] {a.shape[0]}x{a.shape[1]}, nnz {a.nnz}; built with scipy "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    _check(a.shape[0] == HPCG_ROWS and a.nnz == HPCG_NNZ,
           f"hpcg104 shape {a.shape}, nnz {a.nnz}")
    n = a.shape[0]
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    b64 = b.astype(np.float64)

    def relres(x):
        x = x.double().cpu().numpy() if hasattr(x, "cpu") else x
        return float(np.linalg.norm(b64 - a @ np.asarray(x, np.float64))
                     / np.linalg.norm(b64))

    res = {}
    k1 = S.KERNEL_NAMES[("relsl", False)]
    with tempfile.TemporaryDirectory() as tmp:
        low = sp.tril(a).tocoo()
        _check(low.nnz == HPCG_STORED, f"hpcg104 stores {low.nnz} entries")
        path = os.path.join(tmp, "hpcg104.mtx")
        t0 = time.perf_counter()
        write_mtx(path, low.row, low.col, low.data, a.shape,
                  symmetry="symmetric")
        print(f"[mtx] hpcg104 {path}: {os.path.getsize(path)} bytes, "
              f"{low.nnz} stored entries (symmetric), written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del low
        for method, iters in HPCG_CLI:
            kname = {"cg-fused": "sell_cg_kernel",
                     "pcg-ic0-fused": "sell_pcg_ic0_kernel"}[method]
            xpath = os.path.join(tmp, "x.npy")
            jpath = os.path.join(tmp, f"{method}.jsonl")
            argv = ["-c", "-n", str(HPCG_BENCH_N), "--expand-symmetry",
                    "--x", "random:1", "--no-report", "--json-out", jpath,
                    "--solve", f"{method}:{iters}", "--solve-out", xpath,
                    path]
            log = io.StringIO()
            _zero_counts(S)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = cli_main(argv)
            wall = time.perf_counter() - t0
            counts = _counts(S)
            what = f"hpcg104 CLI --solve {method}:{iters}"
            _check(rc == 0, f"{what} returned {rc}:\n{log.getvalue()}")
            # the -c benchmark (N timed, 2 warm-up, 1 result) and the
            # residual check on K1, the solve on its fused kernel
            want = {k1: HPCG_BENCH_N + 4, kname: 1}
            got = _check_only(counts, list(want), what)
            _check(got == want, f"{what} launched {got}, not {want}")
            launches[(kname, "hpcg104", "float32")] = got[kname]
            with open(jpath) as f:
                rec = [json.loads(ln) for ln in f][-1]
            rr = relres(np.load(xpath))
            res[method] = rr
            _check(rec["iterations"] == iters, f"{what}: {rec}")
            print(f"[main] {what}: rc 0, {wall:.1f} s, solve "
                  f"{rec['wall_ms']:.1f} ms, CLI relative residual "
                  f"{rec['relative_residual']:.3e}, float64 {rr:.3e}, "
                  f"launches {got}", flush=True)
    with _Phase("hpcg104 API set-up"):
        from smvp_toolkit_tpu_torch.formats.csr import csr_encode

        coo = _card_coo(np, torch, a)
        csr = csr_encode(coo)
        t0 = time.perf_counter()
        op = S.sell_op_csr(csr)
        t1 = time.perf_counter()
        factors = ic0(csr)
        t2 = time.perf_counter()
        print(f"[hpcg] A planned in {t1 - t0:.1f} s; ic0 (csrc/ilu.cpp) in "
              f"{t2 - t1:.2f} s", flush=True)
    bt = torch.from_numpy(b).to(DEVICE)
    api = {}
    _hpcg_solve(torch, S, "cg:300", lambda: M.conjugate_gradient(
        csr, bt, num_iters=300), {k1: 301}, relres, api)
    _hpcg_solve(torch, S, "cg:100", lambda: M.conjugate_gradient(
        csr, bt, num_iters=100), {k1: 101}, relres, api)
    diag = diagonal(coo)
    _hpcg_solve(torch, S, "pcg:300", lambda: M.pcg(
        csr, bt, diag, num_iters=300), {k1: 301}, relres, api)
    pre = M.ic0_preconditioner(factors, sweeps=4, op_builder=S.sell_op_csr)
    routes = {S.KERNEL_NAMES[(S.sell_op_csr(f).route, False)]
              for f in (factors.strict, factors.strict_t)} | {k1}
    _, _, counts = _hpcg_solve(
        torch, S, "pcg-ic0:100", lambda: M.pcg_precond(
            csr, bt, pre, num_iters=100), dict.fromkeys(routes), relres, api)
    _check(sum(counts.values()) == 101 + 6 * 101,
           f"pcg-ic0:100 launched {counts}")
    lo, hi = _bounds(torch, csr)
    print(f"[hpcg] Chebyshev interval [{lo:.6g}, {hi:.6g}] (Lanczos x0.3, "
          f"x1.1)", flush=True)
    _hpcg_solve(torch, S, "chebyshev:600", lambda: M.chebyshev(
        csr, bt, lo, hi, num_iters=600), {k1: 601}, relres, api)
    _, _, counts = _hpcg_solve(
        torch, S, "chebyshev-fused:600",
        lambda: fused_chebyshev(op, bt, lo, hi, 600),
        {"sell_chebyshev_kernel": 1}, relres, api)
    launches[("sell_chebyshev_kernel", "hpcg104", "float32")] = counts[
        "sell_chebyshev_kernel"]
    res["chebyshev-fused"] = api.pop("chebyshev-fused:600")
    _, hist, counts = _hpcg_solve(
        torch, S, "cg:1000:1e-6", lambda: M.conjugate_gradient(
            csr, bt, num_iters=1000, tol=1e-6), {k1: None}, relres, api)
    print(f"[hpcg] cg:1000:1e-6 stopped after {counts[k1] - 1} steps",
          flush=True)
    # K11 through the API too: it plans and keeps the factor plans
    _hpcg_solve(torch, S, "pcg-ic0-fused:100", lambda: fused_pcg_ic0(
        op, factors, bt, 100), {"sell_pcg_ic0_kernel": 1}, relres, api)
    fp = op._ic0_planes[factors]
    for label, p in zip(("A", "L", "Lt"), fp.plans):
        print(f"[plan] hpcg104 {label}: S {p.n_sublanes} in {p.n_chunks} "
              f"chunks of {p.chunk}, WT {p.window_tiles}, NS {p.n_slices}, "
              f"CT {p.n_coltiles}, occupancy {p.nnz / p.slots():.3f}",
              flush=True)
    print(f"[plan] hpcg104 common window: WT {fp.window_tiles} (<= 511: "
          f"the merged word)", flush=True)

    for label, rr in {**res, **api}.items():
        _check(np.isfinite(rr), f"hpcg104 {label}: residual {rr}")
        if label != "cg:100":  # a comparison run, short of convergence
            _check(rr <= SOLVE_RESIDUAL, f"hpcg104 {label}: residual {rr}")
    for fused, scan in (("cg-fused", "cg:300"),
                        ("pcg-ic0-fused", "pcg-ic0:100"),
                        ("chebyshev-fused", "chebyshev:600")):
        f, s_ = res[fused], api[scan]
        _check(f <= 3 * s_ or max(f, s_) <= 1e-5,
               f"hpcg104 {fused} residual {f} vs {scan} {s_}")
    _check(api["pcg-ic0:100"] < api["cg:100"],
           f"hpcg104 pcg-ic0:100 {api['pcg-ic0:100']} not below cg:100 "
           f"{api['cg:100']}")
    print(f"[hpcg] residuals: fused {res}, API {api}", flush=True)
    return dict(a=a, csr=csr, op=op, factors=factors, b=bt, lo=lo, hi=hi)


def _plane_bytes(plan, vb):
    """The bytes of one sweep's planes on the merged word: values, lane
    indices, the rel‖slice word and tile_base."""
    from smvp_toolkit_tpu_torch.ops.sell_plan import lidx_bytes_for_chunk

    s = plan.n_sublanes
    return s * 128 * (vb + lidx_bytes_for_chunk(plan.chunk)) + s * 4 \
        + plan.n_chunks * 4


def phase_solver_timings(np, torch, hp, launches, bw):
    """Phase 4 for K9-K11 at hpcg104, float32: the kernel, its plain
    version and the yardstick over the same steps: the port's scan-loop
    solver (``models.solvers``) with ``torch.sparse.mm`` on float32 CSR
    tensors as its SpMV."""
    from smvp_toolkit_tpu_torch.models import solvers as M
    from smvp_toolkit_tpu_torch.ops import cg_fused as C
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _triplets_from_csr_host

    op, factors, b = hp["op"], hp["factors"], hp["b"]
    lo, hi = hp["lo"], hp["hi"]
    a = hp["a"].tocoo()
    A = _library_csr(np, torch, (a.row, a.col, a.data, a.shape))

    def mv(m, v):
        return torch.sparse.mm(m, v[:, None])[:, 0]

    def library_op(c):
        m = _library_csr(np, torch, _triplets_from_csr_host(c))
        return lambda v: mv(m, v)

    lib_pre = M.ic0_preconditioner(factors, sweeps=4, op_builder=library_op)
    fp = op._ic0_planes[factors]
    t_vec = max(p.n_slices for p in fp.plans)
    vec = max(t_vec, fp.plans[0].n_coltiles) * 128 * 4
    pa, pl, plt = (_plane_bytes(p, 4) for p in fp.plans)
    nnz_a, nnz_l = fp.plans[0].nnz, fp.plans[1].nnz
    cases = (
        ("sell_cg_kernel", 300, lambda: C.fused_cg(op, b, 300),
         lambda: C.fused_cg_plain(op, b, 300),
         lambda: M.conjugate_gradient(A, b, num_iters=300, spmv=mv),
         pa + 4 * vec, 2.0 * nnz_a, {}),
        ("sell_chebyshev_kernel", 600,
         lambda: P.fused_chebyshev(op, b, lo, hi, 600),
         lambda: P.fused_chebyshev_plain(op, b, lo, hi, 600),
         lambda: M.chebyshev(A, b, lo, hi, num_iters=600, spmv=mv),
         pa + 4 * vec, 2.0 * nnz_a, {}),
        ("sell_pcg_ic0_kernel", 100,
         lambda: P.fused_pcg_ic0(op, factors, b, 100),
         lambda: P.fused_pcg_ic0_plain(op, factors, b, 100),
         lambda: M.pcg_precond(A, b, lib_pre, num_iters=100, spmv=mv),
         pa + 3 * (pl + plt) + 7 * vec, 2.0 * (nnz_a + 6 * nnz_l),
         {"sweeps": 4}),
    )
    entries = []
    for kname, iters, fn, plain, lib, nbytes, flops, extra in cases:
        ms = _time_ms(fn, reps=2, warmup=1)
        x = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xp = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (x - xp).abs().max().item()
        rel = _rel_err(x, xp)
        _check(rel <= TOL_SOLVER, f"{kname} vs plain at hpcg104: {rel}")
        lib_ms = _time_ms(lib, reps=1, warmup=1)
        entries.append(_entry(
            kname, "hpcg104", "float32",
            launches=launches[(kname, "hpcg104", "float32")], err=err,
            ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, nbytes=nbytes,
            flops=flops * iters, bw=bw, iters=iters, per_iteration=True,
            **extra))
    del A, lib_pre
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
        grid.update({("spmm", d): S.bench_spmm_blocks(getattr(torch, d),
                                                      torch.int8)
                     for d in DTYPE_NAMES})
        from smvp_toolkit_tpu_torch.ops.cg_fused import solver_blocks

        grid.update({(k, r, d): solver_blocks(k, getattr(torch, d),
                                              torch.int8, route=r)
                     for k, r in (("sell_cg_kernel", "relsl"),
                                  ("sell_cg_kernel", "split"),
                                  ("sell_chebyshev_kernel", "relsl"),
                                  ("sell_pcg_ic0_kernel", "relsl"))
                     for d in DTYPE_NAMES})
        print(f"[grid] bench kernels' cooperative grid (blocks of 256 "
              f"threads, int8 lane indices): {grid}", flush=True)

    with _Phase("plans"):
        configs = _configs()
        plans = _small_plans(np) + [(n, p) for n, (p, _) in configs.items()]
        gcn = _gcn_graph(np, torch)
    with _Phase("kernels vs plain"):
        ops, errs = phase_kernels(np, torch, plans, gcn)
    del plans
    with _Phase("solver kernels vs plain"):
        phase_solver_kernels(np, torch)
    launches = phase_main_path(np, torch, configs)
    with _Phase("main path: gcn_arxiv"):
        phase_gcn(np, torch, gcn, launches)
    with _Phase("main path: hpcg104"):
        hpcg = phase_hpcg(np, torch, launches)
    with _Phase("timings"):
        from smvp_toolkit_tpu_torch.bench.roofline import hbm_bandwidth_gbs

        bw = hbm_bandwidth_gbs(torch.device(DEVICE)) * 1e9
        entries = phase_timings(np, torch, ops, errs, launches, configs, bw)
        entries += phase_mat_timings(np, torch, ops, errs, launches, configs,
                                     gcn, bw)
        entries += phase_solver_timings(np, torch, hpcg, launches, bw)

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
