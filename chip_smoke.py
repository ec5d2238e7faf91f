#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smvp_toolkit_tpu_torch) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. The card's name and power limit, then the kernels' build from
   ``smvp_toolkit_tpu_torch/csrc`` (one nvcc per source, in parallel) with
   its time, the registers and spills of every warp-per-sublane kernel,
   forward and N-iteration (K2-subwin, K5, K2-packed, and K9 on both
   routes, K10 and K11, whose SpMV phases run that body, among them), of
   K1, K4, K5 and K2 with k columns, of K7 and of K8 on staged slice
   metadata (``[regs]``, the most over their types and column shapes),
   and each bench kernel's
   cooperative grid (the four routes' N-iteration kernels for both value
   and lane-index types on a line of their own). The build covers the
   host sources too (``csrc/*.cpp``: the IC(0) and co-clustering passes,
   the CISR scheduler, the planner's sort, the MatrixMarket reader and the
   encode orders, with the host compiler). The plans of the
   four full-size matrices (the planner's native pass) and of the
   ``gcn_arxiv`` graph (its normalised adjacency A and its transpose), and
   K7's by-slice schedule of A (its units, live sublanes per slice and
   build time on a ``[plan]`` line); smoke's and L2's plans, and later
   hpcg104's A, are planned again by the numpy flow
   (``SMVP_NO_NATIVE_PLAN=1``) and must equal the native plans element for
   element, both times printed.
2. Every kernel against its plain PyTorch version on the card, in float32
   and bfloat16: the forward kernel of the plan's route, its N-iteration
   kernel with N = 3, and the two against each other. Tolerance:
   max |kernel - plain| / max |plain| <= 1e-6 (atomics change the
   summation order, so never bitwise). Plans: a random rectangular matrix
   with empty rows, a matrix with no nonzeros, a plan with int32 lane
   indices (chunk 200), a streamed-y plan with an empty middle y block, a
   streamed-y plan with int32 lane indices, a small streamed split plan, a
   resident split plan (WT > 511), ten streamed plans with the edges of
   the warp-per-sublane walk, five on split planes (547 column tiles) and
   five on the merged word (469 column tiles): a run of dead sublanes
   ending each chunk, an empty middle y block, int32 lane indices, one
   live sublane in a chunk, a chunk of one sublane; and the four
   full-size configurations:
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
   word: K1, K2) with k = 8 and, in float32, k = 256 and 40 (the GCN's
   widths) and 6 (k % 4 != 0: the scalar column form); K2 with k columns
   at N = 1, 2 and 3 (its two Y buffers) against the plain version and
   against one K1-with-k launch, there and on the hub-row plan (merged
   word, both dtypes, k = 2, 8 and 17: 200 duplicate sublanes of one row
   past several work items); K7's dead
   sublanes must be exactly 0 and its padding lanes of live sublanes must
   carry nonzero partials (more nonzero words than nonzero values). K7 on
   the hub-row plans (a row of 200 entries in one column tile, so that its
   slice is cut into several units of the schedule; merged word and split
   planes, both dtypes, k = 1, 8, 40, 256) against its plain version
   (<= 1e-6), with the same two checks. K1 and K4 with k
   columns run the warp-per-sublane k-column body (``sublane_mat_run``),
   and K2 with k columns N sweeps of it in one cooperative launch;
   each ``[check]`` line names the column shape (T threads a row, W
   columns a load, P passes; ``spmv_sell.spmm_shape``). On smoke and L2
   (both dtypes) the zero-value contract: X holds Inf in a column that
   only zero-valued slots read (a padding lane's column, its real entries
   zeroed through the values plane, as an edge step may): Y stays finite
   and within the SpMM tolerance of the plain version, for K2 with k
   columns (N = 3) on smoke too.
   The fused solvers (K9 CG, K10 Chebyshev, K11 IC(0)-PCG at sweeps 2 and
   4) against their plain versions, 30 steps, on 2-D Poisson 64² and HPCG
   16³, float32 and bfloat16, and K9 on split planes (Poisson 256², its
   plan widened past 511 tiles): max |x - x_plain| / max |x_plain| <= 1e-4;
   in bfloat16 after 3 steps, where a control (K9 against a plain CG whose
   SpMV input skips the bf16 rounding) must exceed it, and after 30 steps
   <= 2^-7, since a one-ulp float32 difference now and then flips the bf16
   rounding of an SpMV input entry and CG carries the jump on.
   The warp-per-sublane kernels of all four routes: K3-split and K2
   streamed split on the split planes of every small streamed plan and
   K4 and K2 split on those of every small resident plan (merged-word
   plans through ``split_planes``) and of each streamed plan's resident-y
   variant; K3-relsl and K2 streamed, K1 and K2 on the merged word of
   every small merged-word plan, of the resident-y variants of the
   streamed ones, and of smoke and L1; float32 and bfloat16: N = 1, 2
   and 3 against the plain version (N = 1 and 2 end in K2's two y
   buffers) and N = 3 against one launch (<= 1e-6); with
   Inf in x at a padding lane's
   column (there, at L3, L2, L1 and smoke), their NaN and Inf positions
   must equal the plain version's (a padding slot's 0 · Inf lands NaN in
   its row), with at least one NaN; a plan with no live sublane (nnz0's
   merged word and split planes) must give y = 0. Then K4 through the
   operator against its plain version: on smoke's split planes under
   ``SMVP_SELL_RELSL=0`` (one launch), with ``SMVP_SELL_SPLIT=4`` too,
   and on L2 under ``SMVP_SELL_SPLIT=4`` (four launches on views over
   chunk ranges); and K1 on smoke under ``SMVP_SELL_SPLIT=4`` (four
   launches), and K1 and K2 (N = 3) on smoke's int32 lane planes
   (``SMVP_SELL_LIDX32=1``).
   K8 (double-float) on every small resident merged-word plan, without
   and with a lo plane (the streamed and WT > 511 plans must be refused),
   on the JAX suite's cancelling rows and on its edge scales (exact), and
   on the hub-row plan (``tests/torch_kcol_plans.py``: 258 live sublanes
   in one slice, three staging passes, 8 empty slices): its N-iteration
   kernel with N = 3 bit for bit one launch, K8 bit for bit its plain
   version (float64 in K8's order), against the float64 oracle of the
   planes <= 5e-14 (tests/test_df64_pallas.py:37).
   K5 in bfloat16 on every small merged-word plan (resident: k = 1, 2, 8,
   17 and K2-packed with N = 3; streamed: k = 1) and on smoke (k = 1, 8,
   K2-packed) and L1 (streamed): <= 1e-6 of max |y| against its plain
   version and against K1 (K3) bf16 on the same plan; and K5, K2-packed
   (N = 2 and 3, resident plans) and K5 with k columns (k = 1, 3, 8,
   resident plans) on each of those plans' packed plane with lanes 1..127
   rewritten to another rel than lane 0's
   (``bench_variants.disagreeing_lanes``; odd lanes 511, even lanes
   another tile): <= 1e-6 (k columns: the SpMM tolerance) against the
   plain version on that plane, which reads rel from lane 0 as the JAX
   ``_unpack_plane`` does.
   K6 (``sell_onehot``, the ``SMVP_SELL_COMPAT=1`` kernel, on the plan's
   dense one-hot operands) on every small resident plan and on smoke, and
   K2-subwin (``sell_bench_subwin``, N = 3, the ``SMVP_SELL_SUBWIN=1``
   kernel, K2's warp-per-sublane body under its window rule) on the
   eligible small plan and on smoke, float32 and bfloat16:
   <= 1e-6 of max |y| against the plain version and against K1 (K2 relsl)
   on the same plan; a control, K2-subwin fed ``stb`` shifted by 16 tiles,
   must miss that tolerance.
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
   - smoke-cisr: smoke's matrix scheduled on 16 CISR channels on the host
     (``formats/cisr.py``; its decode round trip bit for bit, the ``.coe``
     text's build timed), then the CLI's ``-a -n 10 --x random:1
     --decode-check --coe-out --lut-out --save-encoded --out-dir`` on the
     card, per call and ``--fused`` (K1 only; K2 only): CSR, TJDS and CISR
     decode bit-exact, CISR's y (``cisr.npy``) within 1e-5 of the float64
     oracle and 1e-6 of CSR's y (``y.npy``), TJDS's report within 1e-5, the
     ``.coe`` byte-equal to the host's text with its start word, end word
     and word count (one value word per beat and channel, one row-length
     word per two rows), one LUT line per non-zero, the CSR checkpoint
     loadable;
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
   - smoke-df64: the CLI with ``-c -t --kernel df64 -n 200 --x random:1
     --out-dir`` on the smoke matrix, per call and ``--fused``: CSR only on
     K8 (its N-iteration kernel), TJDS on its SELL kernel; every CSR entry
     within one float32 ulp of the float64 oracle rounded to float32,
     while K1's float32 y must miss that on some rows;
   - smoke-df64-f64: ``SellDf64SpMV.from_coo_f64`` on the smoke
     coordinates with float64 values (a lo plane), ``__call__`` and
     ``bench_loop`` (N = 100), hi + lo <= 5e-14 of the float64 oracle;
   - smoke-packed: the smoke CLI run under ``SMVP_SELL_PACK=1`` in
     bfloat16 with ``--spmm 8`` (K5 and K5 with k = 8; under ``--fused``
     K2-packed and the k-column K2); L1-packed: L1's operator under the
     switch (K5 on streamed y; ``bench_loop`` refused); L2 under the
     switch keeps K4 (WT 2,000 > 511);
   - hpcg104-refine: ``refine_solve`` on hpcg104 with ``fused_cg(op, r,
     300)`` (K9, three launches) as the inner solve, three sweeps: a
     float64 relative residual <= 1e-10.
   - smoke-cc: smoke's matrix co-clustered once in this process
     (``ops/cocluster.py``, started in a background thread with the plans,
     minutes of host work; s_true must fall below the natural order's),
     the f32 and bf16 ``CoClusteredSellSpMV`` built from that one result:
     K1 and K2 (N = 3) on the permuted planes against their plain versions,
     then ``__call__`` (K1 only) and ``bench_loop(200)`` (K2 only,
     K2-cocluster), natural y against the float64 oracle, the co-clustered
     and natural occupancy printed; the f32 ``bench_loop`` again under
     ``SMVP_SELL_SUBWIN=1`` (K2-subwin only); one CLI run ``-c --cocluster
     -n 200 --x random:1 --fused`` in bf16 (K2 only, reusing the result);
   - the JAX operator's switches on smoke's CLI: smoke-compat (``-c -n
     10`` under ``SMVP_SELL_COMPAT=1``, both dtypes: K6 only, 13 launches),
     smoke-subwin (``-c --fused -n 200`` under ``SMVP_SELL_SUBWIN=1``, both
     dtypes: K2-subwin only), and ``-c -n 10`` in float32 under
     ``SMVP_SELL_RELSL=0`` (K4 only), ``SMVP_SELL_SPLIT=4`` (four K1 launches
     per call), ``SMVP_SELL_SPMM=0`` with ``--spmm 8`` (eight K1 launches per
     SpMM call, no SpMM kernel) and ``SMVP_SELL_LIDX32=1`` (int32 lane
     planes; ``traffic_bytes`` 3 bytes per slot more, printed);
   - the headline module (``bench/headline.py``) in this process: three
     validated K2 rungs on smoke (co-clustered bf16, natural bf16, float32),
     its JSON line printed.
   - distribution (``parallel/``): smoke-dp4, smoke's matrix as 4
     row-block shards at chunk 1024 (``shard_sell``), each rank's shard
     launched in turn on the one card, float32 and bfloat16: first,
     uncounted, per shard K2-sharded (N = 3), K1, K4 on the shard's split
     planes (``SMVP_SELL_RELSL=0``) and K1 with k = 8 against
     their plain versions (<= 1e-6; SpMM: ``_spmm_tolerance``), the
     shards' rows in rank order against smoke's unsharded K2 and K1 (<=
     1e-6) and the float64 oracle (<= 1e-5), a control in reverse order
     that must miss, and the gradient of sum(W ∘ A·X) at k = 8 summed
     over the 4 transpose shards against the plain autograd gradient;
     then the counted run: every rank's K2-sharded at N = 200 (K2 only, 4
     launches per dtype). smoke-dp1: a real one-rank NCCL group in this
     process (``MASTER_ADDR``/``MASTER_PORT``, ``RANK=0``,
     ``WORLD_SIZE=1``, ``distributed_init``): ``spmv_sell_sharded`` and
     ``bench_loop_sharded`` (NCCL all-gather), ``spmm_sell_sharded`` and
     ``differentiable_spmm_sharded``'s gradient (NCCL all-reduce),
     ``spmv_csr_sharded``, ``spmv_tjds_sharded`` and ``spmv_csr_2d``,
     counted (K1, K2 and K1 with k = 8 only) and held to the float64
     oracle, the all-gather of smoke's y timed, the group destroyed. Then
     ``torchrun --standalone --nproc_per_node 1`` on ``parallel.launch``
     (``--alg csr`` and ``tjds``, ``-n 100``: its checksum against the
     float64 sum of the values) and on the CLI (``-c -t --shards 1 -n
     10``), in subprocesses; and L2 as 4 row-block CSR shards with equal
     rows and with equal non-zeros, each shard's non-zeros and local time
     printed, y against the oracle.
   Every output vector (both reports of a ``-c -t`` run) and every SpMM
   result (``--out-dir``'s ``spmm.npy``) is checked against a float64 scipy CSR
   oracle: max |y - oracle| / max |oracle| <= 1e-5 (bfloat16: the oracle
   takes bf16-rounded vals and x; the report prints 6 significant digits,
   which fits the bound).
4. One ``{"kernels": [...]}`` line: per kernel, configuration and value
   dtype, its time per launch from CUDA events (K1's and K3-relsl's, and
   their library calls', with the launches queued behind a spin kernel,
   so that the host's work per call does not pace the card; their
   host-paced times beside, ``host_paced_ms`` and
   ``host_paced_library_ms``), its launches in the
   main-path run (the k = 1 route entries name their ``body``,
   ``warp-per-sublane`` for all eight (the four forward kernels and the
   four routes' N-iteration kernels), and their slot rate
   ``g_slots_per_s``; each N-iteration kernel is first held at its N
   against one plain SpMV, <= 1e-6; a ``[time]`` line gives each
   N-iteration kernel's time per iteration against one launch of its
   forward kernel, on smoke, L1, L2, L3, smoke-cc and every smoke-dp4
   shard; a ``[grid]`` line gives K1's and K3-relsl's blocks and waves,
   and on smoke K1's time over the first one and two waves' chunks;
   smoke-dp4's ``[time]`` lines K1 per shard), its
   bound (bytes of its route over the card's memory rate, or 2·nnz·k·N
   flops over the float32 rate, the larger; K7 counts
   2·k flops per slot of a live sublane), the plain version's time and a
   library yardstick (``torch.sparse.mm`` on a float32 CSR tensor of the
   same matrix with the same k, and for K7 ``torch.sparse.sampled_addmm``
   on its pattern with beta 0; never called by the port). The k-column
   kernels are timed at k = 8 on smoke and L2 and at k = 256 and 40 on
   gcn_arxiv; K1's and K4's forward launches with k columns and their
   library calls queued behind the spin kernel as K1's (the host-paced
   times beside), their entries, and K2 with k columns' (N = 200 on
   smoke), naming their ``body`` and column ``shape``. K7 on gcn_arxiv's A at k = 256 and 40 on its by-slice
   schedule (``body`` ``by-slice``, ``units``), its launches and its
   library call queued behind the spin kernel, the host-paced times
   beside. The fused solvers at hpcg104 in float32 (K9 300 steps, K10
   600, K11 100 at sweeps 4; ``body`` ``warp-per-sublane``): bound = one
   step's bytes (the planes of each
   SpMV phase, K11: A + 3·(L + Lᵀ), and each state vector once) times the
   steps over the memory rate; yardstick: the same solve by the port's
   scan-loop solver (``models.solvers``) with ``torch.sparse.mm`` on
   float32 CSR tensors as its SpMV. K5, K5 with k = 8 and K2-packed (N =
   200) on smoke-packed and K5 on L1-packed: bound the packed route's
   bytes (4 per slot); yardstick the float32 CSR call; K5's launches and
   its library call queued behind the spin kernel, the host-paced times
   beside, its entry's ``body`` ``warp-per-sublane`` (K2-packed too; K5
   with k columns: ``warp-per-sublane k-column`` and its column
   ``shape``, its launches and library call queued too). K8 and its
   N-iteration kernel on smoke-df64 (N = 200) and smoke-df64-f64 (N = 100),
   ``body`` ``staged-slices`` (K8's forward launches and their library
   calls queued behind the spin kernel, the host-paced times beside):
   each first held at those shapes against its plain version (<= 2^-50 of
   max |y|; the N-iteration kernel with N = 3), that error its
   ``max_abs_err``; bound ``SellDf64SpMV.traffic_bytes`` or 4 (8 with a lo
   plane) float64 flops per non-zero over the float64 rate; yardstick
   ``torch.sparse.mm`` on a float64 CSR tensor with x = x_hi + x_lo.
   K6 on smoke (both dtypes, launches from smoke-compat): bound its dense
   operands' bytes (read once), the dense products' time at the float32
   rate printed beside it (``dense_flops_ms``; the kernel skips the
   one-hot zeros, so only 2 flops per non-zero bound it). K2-subwin on
   smoke (``body`` ``warp-per-sublane``; a ``[time]`` line gives it over
   K2 on the same plan and N) and K2-cocluster (``sell_bench_kernel`` on smoke-cc's permuted
   planes, replacing ``CoClusteredSellSpMV.bench_loop``; held at N = 200
   against the plain version, <= 1e-6) at N = 200: bound
   the plan's bytes or 2·nnz·N flops, the larger. Library: the natural
   float32 CSR ``torch.sparse.mm``, N calls for N iterations.
   K2-sharded (``bench_loop_sharded`` → ``sell_bench_kernel``) at N = 200
   per shard launch of smoke-dp4 and smoke-dp1, both dtypes, each first
   held to its plain version at N = 200: bound the shard plan's bytes or
   2·nnz_shard·N flops, the larger; library ``torch.sparse.mm`` on the
   shard's row-block float32 CSR, N calls.
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
    "sell_df64_kernel": ("sell_df64.cu", "spmv_df64.py:307"),
    "sell_bench_df64_kernel": ("sell_df64.cu", "spmv_df64.py:383"),
    "sell_packed_kernel": ("sell_packed.cu", "spmv_pallas.py:672"),
    "sell_packed_spmm_kernel": ("sell_packed.cu", "spmv_pallas.py:672"),
    "sell_bench_packed_kernel": ("sell_packed.cu", "spmv_pallas.py:765"),
    "sell_onehot_kernel": ("sell_onehot.cu", "spmv_pallas.py:903"),
    "sell_bench_subwin_kernel": ("sell_bench.cu", "spmv_pallas.py:782"),
}
# The k = 1 route kernels, which all run the warp-per-sublane body
# (sell_common.cuh, sublane_run): every forward kernel (K1 and K3-relsl
# staging the merged word, K3-split and K4 the split planes), every
# route's N-iteration kernel (K2 and K2 streamed on the merged word, K2
# streamed split and K2 split), K2-subwin (K2's body under its window
# rule) and K5 (the packed word, rel staged from lane 0); K1 and K4 with k
# columns, which run its k-column form (sublane_mat_run); K7, which walks
# the plan by slice; and K8 and its N-iteration kernel, which walk rows on
# staged slice metadata. K2-packed runs K2's body (rel from the loaded
# lane-0 word by a warp shuffle), K9 its SpMV phase (merged word, and
# sell_cg_split_kernel on split planes), K10 its SpMV phase and K11 its
# three on the warp-per-sublane body; K5 with k columns the k-column form
# on the packed word, and K2 with k columns N sweeps of it. No kernel runs
# one thread per slot. Phase 1 prints their registers and spills, and a
# phase-4 entry names its body, so that a time can be told from the
# thread-per-slot (or, K8, per-row chain) times these kernels had before.
WARP_PER_SUBLANE = ("sell_spmv_kernel", "sell_bench_kernel",
                    "sell_streamy_relsl_kernel",
                    "sell_bench_streamy_relsl_kernel",
                    "sell_streamy_kernel", "sell_bench_streamy_kernel",
                    "sell_split_kernel", "sell_bench_split_kernel",
                    "sell_bench_subwin_kernel", "sell_packed_kernel",
                    "sell_bench_packed_kernel", "sell_cg_kernel",
                    "sell_cg_split_kernel", "sell_chebyshev_kernel",
                    "sell_pcg_ic0_kernel")
KCOL_PER_SUBLANE = ("sell_spmm_kernel", "sell_split_spmm_kernel",
                    "sell_packed_spmm_kernel", "sell_bench_spmm_kernel")
BY_SLICE = ("sell_vals_grad_kernel",)
STAGED_SLICES = ("sell_df64_kernel", "sell_bench_df64_kernel")
# K7's hub-row plans (tests/torch_kcol_plans.py): a row of 200 entries in
# one column tile beside random entries, so that its slice's 200 live
# sublanes are cut into several units of the by-slice schedule; on the
# merged word (3000 x 3000, chunk 2048) and the split planes (3000 x
# 70000, chunk 1024), at these k.
HUB_ROW, HUB_ENTRIES, HUB_TILE = 1000, 200, 3
HUB_KS = (1, 8, 40, 256)
# The k values phase 2 holds gcn_arxiv's k-column kernels to in float32:
# the CLI's k, the GCN's widths, and one k % 4 != 0 (the scalar form).
GCN_CHECK_KS = (SPMM_K, GCN_K, 40, 6)
# Clock cycles of the spin kernel behind which ``_time_ms(queued=True)``
# queues its calls: about 25 ms at the H100's clocks, far more than the
# host takes to queue 20 calls of a wrapper.
QUEUE_SPIN_CYCLES = 50_000_000
# The forward kernels' work items (sell_common.cuh: kRun sublanes of one
# chunk per block) and co-resident blocks per SM (kSublaneMinBlocks).
SUBLANE_RUN = 64
SUBLANE_BLOCKS_PER_SM = 8
# The merged-word routes (K1, K3-relsl): their forward kernels and library
# calls are timed queued (``_time_ms``), the host-paced times beside.
MERGED_ROUTES = ("relsl", "streamy_relsl")
# K2-cocluster: K2 on the co-clustered permuted planes, the JAX
# CoClusteredSellSpMV.bench_loop (no pallas_call of its own).
COCLUSTER_REPLACES = "spmv_pallas.py:2727"
# The switch runs: smoke's CLI at this N under each switch (smoke-compat
# with K6 per call; RELSL=0, SPLIT=4, SPMM=0 and LIDX32=1 per call).
SWITCH_N = 10
SPLIT_N = 4
# K8 (double-float): against its plain version <= 2^-50 of max |y| (both
# float64 sums, in other orders); against the float64 oracle <= 5e-14, the
# JAX suite's bound (tests/test_df64_pallas.py:37). hpcg104-refine: a
# float64 relative residual <= 1e-10 after three refinement sweeps.
TOL_DF64_PLAIN = 2.0 ** -50
TOL_DF64_ORACLE = 5e-14
REFINE_RESIDUAL = 1e-10
DF64_F64_ITERATIONS = 100   # bench_loop N of smoke-df64-f64
# H100 SXM peak for float64 outside the tensor cores (NVIDIA's data sheet),
# where K8's products and sums run.
F64_PEAK_FLOPS = 34e12
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
# The packed route's configurations: the full-size plan each reuses and the
# name of its SMVP_SELL_PACK=1 run (smoke through the CLI, L1 through the
# operator API; L2's window of 2,000 tiles keeps K4).
PACKED_CONFIGS = {"smoke": "smoke-packed", "L1": "L1-packed"}
# The route each full-size configuration must run on.
ROUTE = {"smoke": "relsl", "L1": "streamy_relsl", "L2": "split",
         "L3": "streamy"}
DTYPE_NAMES = ("float32", "bfloat16")
DEVICE = "cuda:0"
# Distribution: smoke as 4 row-block shards at the JAX sharder's default
# chunk, launched rank by rank on the one card (smoke-dp4), and as one
# shard over a real one-rank NCCL group (smoke-dp1); K2-sharded is K2 on
# a shard's planes (the JAX bench_loop_sharded's pallas_call).
DIST_SHARDS = 4
DIST_CHUNK = 1024
DIST_CHECK_N = 3
DIST_REPLACES = "smvp_toolkit_tpu/parallel/sell_dist.py:419"
LAUNCH_N = 100      # -n of the torchrun parallel.launch runs
# smoke-cisr: the CLI's -a at smoke's size (-n, -s), and the full-size
# plans whose native pass is held to the numpy flow (hpcg104's A too).
CISR_N, CISR_SLOTS = 10, 16
NATIVE_PLAN_CHECK = ("smoke", "L2")


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


def _time_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean time per call from CUDA events around ``reps`` calls.

    With ``queued``, a spin kernel (``torch.cuda._sleep``) holds the card
    while the host queues the calls behind the start event, so that the
    host's work per call (a wrapper's checks, its ctypes call, the output's
    allocation) does not pace the card, and the events time the card's
    work alone. It fails if the host took longer to queue them than the
    card spun."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        spin.record()
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if queued:
        spin_ms = spin.elapsed_time(start)
        _check(host_ms < spin_ms, f"queued timing: the host took {host_ms:.3f} "
               f"ms to queue {reps} calls, the card spun {spin_ms:.3f} ms")
    return start.elapsed_time(end) / reps


def _ptxas_summary(logs):
    """Registers per kernel (most over its value/index types), the spill
    stores of all kernels, and each spilling kernel's most spill-store
    bytes in one of its type instances, from ptxas -v output."""
    names = [*KERNELS, "sell_cg_split_kernel"]
    regs, spills, spilled = {}, 0, {}
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
                if entry and int(m.group(1)):
                    spilled[entry] = max(spilled.get(entry, 0),
                                         int(m.group(1)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                regs[entry] = max(regs.get(entry, 0), int(m.group(1)))
    return regs, spills, spilled


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
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import DF64_KERNELS

    return {**{S.KERNEL_NAMES[(route, bench)]: S._ROUTE_FNS[route][bench]
               for route in S.ROUTES for bench in (False, True)},
            **S.MAT_KERNELS, **SOLVER_KERNELS, **S.PACKED_KERNELS,
            **DF64_KERNELS, **S.SWITCH_KERNELS}


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


def _configs(np):
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
        if name in NATIVE_PLAN_CHECK:
            _native_vs_numpy(np, name, plan, t2 - t1,
                             lambda: _auto_plan(rr, cc, vv, coo.shape))
        occ = coo.nnz / plan.slots()
        live = float(((plan.rel_tile.reshape(-1) >= 0)
                      & (plan.slice_of.reshape(-1) >= 0)).mean())
        print(f"[plan] {name}: {coo.shape[0]}x{coo.shape[1]}, nnz {coo.nnz}, "
              f"S {plan.n_sublanes} in {plan.n_chunks} chunks of "
              f"{plan.chunk}, WT {plan.window_tiles}, NS {plan.n_slices}, "
              f"CT {plan.n_coltiles}, y blocks of {plan.y_block_slices} "
              f"slices, occupancy {occ:.3f}, live sublanes {live:.4f}; made "
              f"in {t1 - t0:.2f} s, planned in {t2 - t1:.2f} s", flush=True)
        out[name] = (plan, (rr, cc, vv, coo.shape))
    return out


def _same_plan(np, a, b) -> bool:
    """Every field of two SellPlans equal, arrays element for element and
    of one dtype."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if x is None or y is None or x.dtype != y.dtype \
                    or x.shape != y.shape or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _native_vs_numpy(np, name, plan, native_s, replan):
    """The numpy flow's plan (``SMVP_NO_NATIVE_PLAN=1``) against ``plan``
    from the native pass, element for element, both times printed."""
    t0 = time.perf_counter()
    with _env(SMVP_NO_NATIVE_PLAN="1"):
        ref = replan()
    numpy_s = time.perf_counter() - t0
    _check(_same_plan(np, plan, ref),
           f"{name}: native plan differs from the numpy plan")
    print(f"[plan] {name}: native pass (csrc/sellplan.cpp) {native_s:.2f} s, "
          f"numpy flow {numpy_s:.2f} s, plans equal element for element",
          flush=True)


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
    sched = op.vals_grad_schedule()
    per_slice = torch.bincount(sched.unit_slice[sched.unit_slice >= 0].long(),
                               weights=(sched.unit_start[1:]
                                        - sched.unit_start[:-1])[
                                   sched.unit_slice >= 0].double())
    per_slice = per_slice[per_slice > 0]
    print(f"[plan] gcn_arxiv A: K7 schedule of {sched.n_units} units of at "
          f"most {sched.cap} sublanes: {int(per_slice.sum())} live sublanes "
          f"in {per_slice.numel()} slices, {per_slice.mean().item():.1f} a "
          f"slice on average, {int(per_slice.max())} at most; built in "
          f"{sched.seconds:.4f} s", flush=True)
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
        *_streamy_contract_plans(np, build_streamed_sell_plan),
    ]


def _streamy_contract_plans(np, build):
    """Streamed plans in 2048-row y blocks, one chunk per block, with the
    edges of the warp-per-sublane walk (a block per run of sublanes inside
    one chunk): a run of dead sublanes ending every chunk, an empty middle
    y block (an all-dead chunk), int32 lane indices (chunk 200), a chunk
    of a single sublane (chunk 1, whose window is one tile), and a chunk
    whose only live sublane is its first. Over 547 column tiles (WT > 511:
    split planes) and, ``merged-``, over 469 (WT 480: the merged word,
    whose padding sublanes carry a live rel and a dead slice)."""
    rng = np.random.RandomState(8)
    b = 2048

    def coords(blocks, per_block, ncols):
        rows = np.concatenate([rng.randint(k * b, (k + 1) * b, per_block)
                               for k in blocks])
        return rows, rng.randint(0, ncols, rows.size), rng.randn(rows.size)

    def plan(coo, chunk, ncols):
        return build(*coo, (3 * b, ncols), chunk=chunk, y_block_rows=b)

    out = []
    for kind, ncols in (("split", 70000), ("merged", 60000)):
        r, c, v = coords((0, 2), 200, ncols)
        lone = (np.append(r, b + 77), np.append(c, 4097), np.append(v, 2.5))
        out += [
            (f"streamed-{kind}-dead-run-ends-chunk",
             plan(coords((0, 1, 2), 200, ncols), 256, ncols)),
            (f"streamed-{kind}-empty-middle-block",
             plan((r, c, v), 256, ncols)),
            (f"streamed-{kind}-int32-lidx",
             plan(coords((0, 1, 2), 150, ncols), 200, ncols)),
            ("streamed-single-sublane-chunk" if kind == "split" else
             f"streamed-{kind}-single-sublane-chunk",
             plan(coords((0, 1, 2), 200, ncols), 1, ncols)),
            (f"streamed-{kind}-single-live-sublane", plan(lone, 256, ncols)),
        ]
    for name, p in out[5:]:
        _check(p.merged_word and p.window_tiles <= 511,
               f"{name}: not a merged-word plan")
    return out


def _spmm_tolerance(torch, S, op):
    """max(1e-6, 2·u·sqrt(n)) with n the most products any output element
    sums and u = 2^-24: a float32 sum of n products in random order is off
    by about u·sqrt(n) of its size, and the kernel's atomics and the plain
    version's index_add_ are two such orders. Only a long row lifts it
    above 1e-6 (n > 70): gcn_arxiv's Aᵀ has a hub row of 168,430 products
    (counted from the plan here; each ``[check]`` line prints n)."""
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
        y1 = fwd(*op._planes(), X, **kw)
        got = {fwd.kernel: (y1, yp)}
        if op.base_route == "relsl":
            got.update(_kcol_bench_runs(S, op, X, yp, y1))
        got["sell_vals_grad_kernel"] = (
            S.sell_vals_grad(op.lidx, op.tile_base, X, G, **meta, **kw),
            S.sell_vals_grad_plain(op.lidx, op.tile_base, X, G, **meta, **kw))
        torch.cuda.synchronize()
        line = []
        for label, (y, ref) in got.items():
            kname = label.split("(")[0]
            e = _rel_err(y, ref)
            what = f"{label} vs plain on {name} {dname} k={k}"
            _check(torch.isfinite(y).all().item(), f"{what}: not finite")
            t = TOL_KERNEL if kname == "sell_vals_grad_kernel" else tol
            _check(e <= t, f"{what}: {e} > {t}")
            if "vs K1" not in label:  # errs: the kernels against plain
                key = (kname, name, dname, k)
                errs[key] = max(errs.get(key, 0.0),
                                (y - ref).abs().max().item())
            line.append(f"{label} {e:.3e}")
        g7 = got["sell_vals_grad_kernel"][0].reshape(-1, 128)
        _check(not g7[dead].any(), f"K7 on {name} {dname}: a dead sublane "
               "is not 0")
        _check(not (~dead).any() or int((g7[~dead] != 0).sum()) > int(
            (op.vals.reshape(-1, 128)[~dead] != 0).sum()), f"K7 on {name} "
            f"{dname} k={k}: the padding lanes of live sublanes carry no "
            "partials")
        print(f"[check] {name:28s} {dname:9s} {op.route:5s} k={k:<3d} "
              f"shape {S.spmm_shape(k)} vs plain: {', '.join(line)} (SpMM "
              f"tolerance {tol:.2e}: rows of up to {n_max} products)",
              flush=True)


def _kcol_bench_runs(S, op, X, yp, y1):
    """K2 with k columns at N = 1, 2 and 3 (N = 2 ends in its second Y
    buffer) on the operator's merged-word planes, each against the plain
    version ``yp`` and against one K1-with-k launch ``y1``: {label: (Y,
    reference)}."""
    kw, got = op._mat_kw(), {}
    for n in (1, 2, 3):
        y = S.sell_bench_spmm(*op._planes(), X, iterations=n, **kw)
        got[f"sell_bench_spmm_kernel(N={n})"] = (y, yp)
        got[f"sell_bench_spmm_kernel(N={n} vs K1)"] = (y, y1)
    return got


def _check_kcol_bench_hub(np, torch):
    """K1 and K2 with k columns (N = 1, 2, 3) on the merged-word hub-row
    plan, both dtypes, k = 2, 8 and 17: each within the plan's SpMM
    tolerance of the plain version, and K2 of one K1 launch."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    plan = _hub_row_plan(np, "relsl")
    for dname in DTYPE_NAMES:
        op = S.SellSpMV(plan, value_dtype=getattr(torch, dname),
                        device=DEVICE)
        _check(op.route == "relsl", f"hub-row plan on {op.route}")
        tol, n_max = _spmm_tolerance(torch, S, op)
        line = []
        for k in (2, 8, 17):
            X = torch.from_numpy(np.random.default_rng(20 + k).standard_normal(
                (plan.n_coltiles * 128, k)).astype(np.float32)).to(
                DEVICE).to(op.value_dtype)
            yp = S.sell_spmm_plain(*op._planes(), X, **op._mat_kw())
            y1 = S.sell_spmm(*op._planes(), X, **op._mat_kw())
            got = {"sell_spmm_kernel": (y1, yp),
                   **_kcol_bench_runs(S, op, X, yp, y1)}
            torch.cuda.synchronize()
            e = max(_rel_err(y, ref) for y, ref in got.values())
            what = f"K1 / K2 with k columns on hub-row {dname} k={k}"
            _check(all(torch.isfinite(y).all().item()
                       for y, _ in got.values()), f"{what}: not finite")
            _check(e <= tol, f"{what}: {e} > {tol}")
            line.append(f"k={k} {e:.3e}")
        print(f"[check] hub-row-relsl                 {dname:9s} "
              f"sell_spmm_kernel and sell_bench_spmm_kernel (N = 1, 2, 3) "
              f"vs plain and K2 vs K1, worst: {', '.join(line)} (SpMM "
              f"tolerance {tol:.2e}: rows of up to {n_max} products)",
              flush=True)


def _hub_row_plan(np, route):
    """K7's hub-row plan of ``route`` (tests/torch_kcol_plans.py)."""
    from smvp_toolkit_tpu_torch.ops.sell_plan import build_sell_plan

    rng = np.random.RandomState(13)
    if route == "relsl":
        shape, nnz, chunk = (3000, 3000), 20000, 2048
    else:
        shape, nnz, chunk = (3000, 70000), 800, 1024
    r = rng.randint(0, shape[0], nnz)
    c = rng.randint(0, shape[1], nnz)
    hc = rng.randint(HUB_TILE * 128, (HUB_TILE + 1) * 128, HUB_ENTRIES)
    r = np.concatenate([r, np.full(HUB_ENTRIES, HUB_ROW)])
    c = np.concatenate([c, hc])
    return build_sell_plan(r, c, rng.randn(r.size), shape, chunk=chunk)


def _check_vals_grad_hub(np, torch):
    """K7 on the hub-row plans, both routes and dtypes, at ``HUB_KS``: the
    hub slice cut into several units of the schedule; within TOL_KERNEL of
    the plain version, dead sublanes 0, padding lanes carrying partials."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    for route in ("relsl", "split"):
        plan = _hub_row_plan(np, route)
        dead = torch.from_numpy((plan.rel_tile.reshape(-1) < 0)
                                | (plan.slice_of.reshape(-1) < 0)).to(DEVICE)
        for dname in DTYPE_NAMES:
            op = S.SellSpMV(plan, value_dtype=getattr(torch, dname),
                            device=DEVICE)
            _check(op.route == route, f"hub-row plan on {op.route}")
            sched = op.vals_grad_schedule()
            units = int((sched.unit_slice == HUB_ROW // 128).sum())
            _check(units > 1, f"hub-row {route}: the hub slice in {units} "
                   "unit(s)")
            meta = dict(relsl=op.relsl, rel=op.rel, slice_of=op.slice_of)
            errs = []
            for k in HUB_KS:
                rng = np.random.default_rng(k)
                X = torch.from_numpy(rng.standard_normal(
                    (plan.n_coltiles * 128, k)).astype(np.float32)).to(
                    DEVICE).to(op.value_dtype)
                G = torch.from_numpy(rng.standard_normal(
                    (plan.n_slices * 128, k)).astype(np.float32)).to(DEVICE)
                g = S.sell_vals_grad(op.lidx, op.tile_base, X, G,
                                     schedule=sched, **meta, **op._mat_kw())
                gp = S.sell_vals_grad_plain(op.lidx, op.tile_base, X, G,
                                            **meta, **op._mat_kw())
                torch.cuda.synchronize()
                e = _rel_err(g, gp)
                what = f"K7 on hub-row-{route} {dname} k={k}"
                _check(e <= TOL_KERNEL, f"{what}: {e} > {TOL_KERNEL}")
                _check(not g[dead].any(), f"{what}: a dead sublane is not 0")
                _check(int((g[~dead] != 0).sum()) > int(
                    (op.vals[~dead] != 0).sum()), f"{what}: no partials on "
                    "the padding lanes")
                errs.append(f"k={k} {e:.3e}")
            print(f"[check] hub-row-{route:22s} {dname:9s} "
                  f"sell_vals_grad_kernel vs plain ({units} units of the hub "
                  f"slice, {sched.n_units} in all): {', '.join(errs)}",
                  flush=True)


def _padding_column(np, name, plan):
    """The zero-value contracts' column: that of the first padding lane (v
    = 0) of a live sublane. Returns it with each slot's column, the live
    sublanes' padding lanes and the live sublanes."""
    vals = plan.vals.reshape(-1, 128)
    live = (plan.rel_tile.reshape(-1) >= 0) & (plan.slice_of.reshape(-1) >= 0)
    s = np.arange(vals.shape[0])
    cols = ((plan.tile_base.astype(np.int64)[s // plan.chunk]
             + plan.rel_tile.reshape(-1))[:, None] * 128
            + plan.lane_idx.reshape(vals.shape))
    pad = live[:, None] & (vals == 0)
    _check(pad.any(), f"{name}: no padding lane in a live sublane")
    return int(cols[pad][0]), cols, pad, live


def _check_zero_value_contract(np, torch, name, op):
    """K1 / K4 with k columns skip zero-valued slots: X holds Inf in the
    column of a padding lane (v = 0 in a live sublane), and every real
    entry of that column is zeroed through the values plane (as an edge
    step's values may be), so only zero-valued slots read it. Y must stay
    finite and within the SpMM tolerance of the plain version, which
    skips them too."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    plan, kw = op.plan, op._mat_kw()
    vals = plan.vals.reshape(-1, 128)
    col, cols, pad, live = _padding_column(np, name, plan)
    real = live[:, None] & (vals != 0) & (cols == col)
    v = op.vals.clone().reshape(vals.shape)
    v[torch.from_numpy(real).to(op.device)] = 0
    v = v.reshape(op.vals.shape)
    X = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (plan.n_coltiles * 128, SPMM_K)).astype(np.float32)).to(
        op.device).to(op.value_dtype)
    X[col] = float("inf")
    fwd = op.spmm_kernel
    plain = getattr(S, fwd.__name__ + "_plain")
    planes = (v,) + tuple(op._planes()[1:])
    yp = plain(*planes, X, **kw)
    runs = {fwd.kernel: fwd(*planes, X, **kw)}
    if op.base_route == "relsl":
        runs["sell_bench_spmm_kernel(N=3)"] = S.sell_bench_spmm(
            *planes, X, iterations=3, **kw)
    torch.cuda.synchronize()
    tol, _ = _spmm_tolerance(torch, S, op)
    dname = str(op.value_dtype)[6:]
    for label, y in runs.items():
        e = _rel_err(y, yp)
        what = f"{label} zero-value contract on {name} {dname}"
        _check(torch.isfinite(y).all().item(), f"{what}: Y not finite")
        _check(e <= tol, f"{what}: {e} > {tol}")
        print(f"[check] {name:28s} {dname:9s} {label} k={SPMM_K}: Inf in "
              f"X column {col}, read by {int((pad & (cols == col)).sum())} "
              f"padding lanes and {int(real.sum())} zeroed entries: Y "
              f"finite, vs plain {e:.3e}", flush=True)


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
            fwd, bench = S._ROUTE_FNS[op.base_route]
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
            names = (S.KERNEL_NAMES[(op.base_route, False)],
                     S.KERNEL_NAMES[(op.base_route, True)])
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
                if name in ROUTE:
                    _check_zero_value_contract(np, torch, name, op)
    for label in ("A", "At"):
        base = gcn[label]
        for dname in DTYPE_NAMES:
            op = base if dname == "float32" else S.SellSpMV(
                base.plan, value_dtype=torch.bfloat16, device=dev)
            ks = GCN_CHECK_KS if dname == "float32" else (SPMM_K,)
            _check_mat_kernels(np, torch, f"gcn_arxiv:{label}", op, ks, errs)
    _check_vals_grad_hub(np, torch)
    _check_kcol_bench_hub(np, torch)
    return ops, errs


def _inf_at_padding(np, op, xt):
    """x with Inf at the column of the first padding lane (v = 0) of the
    first live sublane that has one: that column's padding lanes land NaN
    (0 · Inf) in their rows, and its real nonzeros ±Inf. None when no live
    sublane has a padding lane."""
    rel, sl = op.plan.rel_tile.reshape(-1), op.plan.slice_of.reshape(-1)
    has = (rel >= 0) & (sl >= 0) & (op.plan.vals == 0).any(axis=1)
    if not has.any():
        return None
    s = int(np.argmax(has))
    lane = int(np.argmax(op.plan.vals[s] == 0))
    col = ((int(op.plan.tile_base[s // op.plan.chunk]) + int(rel[s])) * 128
           + int(op.plan.lane_idx[s, lane]))
    xi = xt.clone()
    xi[col] = float("inf")
    return xi


def _resident(np, plan):
    """The resident-y variant of a streamed plan: the same chunks, planes
    and windows, each chunk's live slices moved to their place in one y."""
    import dataclasses

    sl = plan.slice_of.astype(np.int64)
    glob = plan.y_block_id.astype(np.int64)[:, None] * plan.y_block_slices
    return dataclasses.replace(
        plan, slice_of=np.where(sl >= 0, glob + sl, -1).astype(np.int32),
        slice_base=None, slice_window=0, y_block_id=None, y_block_slices=0)


def _split_cases(np, torch, plans, ops):
    """(name, operator, route) of every warp-per-sublane check: the split
    planes of every small streamed plan and L3 (K3-split, K2 streamed
    split); of every small resident plan (merged-word ones through
    ``split_planes``, as under ``SMVP_SELL_RELSL=0``), of the resident-y
    variants of the streamed contract plans, and L2 (K4, K2 split)."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device(DEVICE)
    small = [(n, p) for n, p in plans if n not in ROUTE]
    small += [(f"resident-y:{n}", _resident(np, p)) for n, p in small
              if p.y_block_slices]
    cases = [(n, S.SellSpMV(p, value_dtype=getattr(torch, d), device=dev),
              "streamy" if p.y_block_slices else "split")
             for n, p in small for d in DTYPE_NAMES]
    cases += [(n, ops[(n, d)][0], ROUTE[n]) for n in ("L3", "L2")
              for d in DTYPE_NAMES]
    return cases


def _merged_cases(np, torch, plans, ops):
    """(name, operator, route) of every merged-word check: every small
    merged-word plan on its own route (K1 and K2 resident, K3-relsl and
    K2 streamed), the resident-y variants of the streamed ones (K1, K2),
    and smoke and L1."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device(DEVICE)
    small = [(n, p) for n, p in plans if n not in ROUTE and p.merged_word]
    small += [(f"resident-y:{n}", _resident(np, p)) for n, p in small
              if p.y_block_slices]
    cases = []
    for n, p in small:
        for d in DTYPE_NAMES:
            op = S.SellSpMV(p, value_dtype=getattr(torch, d), device=dev)
            cases.append((n, op, op.base_route))
    cases += [(n, ops[(n, d)][0], ROUTE[n]) for n in ("L1", "smoke")
              for d in DTYPE_NAMES]
    return cases


def phase_streamy(np, torch, plans, ops):
    """Phase 2 for the warp-per-sublane body on all four routes: K3-split
    and K2 streamed split, K4 and K2 split on the split planes of
    ``_split_cases``, and K3-relsl and K2 streamed, K1 and K2 on the merged
    word of ``_merged_cases``, float32 and bfloat16: the forward kernel and
    the N-iteration kernel at N = 1, 2 and 3 (K2's two y buffers) against
    the plain version and N = 3 against one launch (<= 1e-6 of max |y|;
    phase 2 holds the full-size plans'); with Inf at a padding lane's
    column (small plans, L3, L2, L1 and smoke), the NaN and Inf positions
    of both kernels equal the plain version's, and there is at least one
    NaN; a plan with no live sublane gives y = 0. Then K4 through the
    operator on smoke's split planes (``SMVP_SELL_RELSL=0``) and on four
    chunk ranges of views (``SMVP_SELL_SPLIT=4``, smoke and L2), and K1 on
    smoke's four chunk ranges (``SMVP_SELL_SPLIT=4``), and K1 and K2 (N =
    3) on its int32 lane planes (``SMVP_SELL_LIDX32=1``), against the plain
    version."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    dev = torch.device(DEVICE)
    for name, op, route in (_split_cases(np, torch, plans, ops)
                            + _merged_cases(np, torch, plans, ops)):
        fwd, bench = S._ROUTE_FNS[route]
        plain = getattr(S, fwd.__name__ + "_plain")
        names = f"{S.KERNEL_NAMES[(route, False)]}, " \
                f"{S.KERNEL_NAMES[(route, True)]}"
        planes, kw = op._planes(route), op._kw()
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            op.plan.shape[1]).astype(np.float32)).to(dev)
        xt = op._x_tiles(x)
        dname = str(op.value_dtype).replace("torch.", "")
        what = f"{names} on {name} {dname}"
        errs = []
        if name not in ROUTE:  # phase_kernels holds L2's and L3's
            y1 = fwd(*planes, xt, **kw)
            yb1 = bench(*planes, xt, iterations=1, **kw)
            yb2 = bench(*planes, xt, iterations=2, **kw)
            y3 = bench(*planes, xt, iterations=3, **kw)
            yp = plain(*planes, xt, **kw)
            torch.cuda.synchronize()
            errs = [_rel_err(y1, yp), _rel_err(yb1, yp), _rel_err(yb2, yp),
                    _rel_err(y3, yp), _rel_err(y3, y1)]
            _check(torch.isfinite(y1).all().item(), f"{what}: not finite")
            _check(max(errs) <= TOL_KERNEL, f"{what}: {errs}")
        xi = _inf_at_padding(np, op, xt)
        if xi is None:  # no live sublane: y = 0
            ys = (plain(*planes, xt, **kw), fwd(*planes, xt, **kw),
                  bench(*planes, xt, iterations=3, **kw))
            _check(not any(y.any() for y in ys),
                   f"{what}: a plan with no live sublane gave y != 0")
            inf = "no live sublane, y = 0"
        else:
            want = plain(*planes, xi, **kw)
            got = (fwd(*planes, xi, **kw),
                   bench(*planes, xi, iterations=3, **kw))
            torch.cuda.synchronize()
            n_nan = int(torch.isnan(want).sum())
            _check(n_nan >= 1, f"{what}: Inf at a padding column gave no NaN")
            for y in got:
                _check(torch.equal(torch.isnan(y), torch.isnan(want))
                       and torch.equal(torch.isinf(y), torch.isinf(want)),
                       f"{what}: NaN or Inf positions differ from the plain "
                       f"version's")
            inf = (f"Inf at a padding column: {n_nan} NaN rows, equal "
                   f"positions")
        print(f"[check] {name:40s} {dname:9s} {names} "
              f"forward, N=1, 2, 3 vs plain, N=3 vs one: "
              f"{', '.join(f'{e:.3e}' for e in errs) or 'phase 2 above'}; "
              f"{inf} (chunk {op.plan.chunk}, WT {op.plan.window_tiles}, "
              f"lidx {str(op.lidx.dtype)[6:]})", flush=True)
    for name, env in (("smoke", dict(SMVP_SELL_RELSL="0")),
                      ("smoke", dict(SMVP_SELL_RELSL="0",
                                     SMVP_SELL_SPLIT=str(SPLIT_N))),
                      ("L2", dict(SMVP_SELL_SPLIT=str(SPLIT_N)))):
        for dname in DTYPE_NAMES:
            op, x = ops[(name, dname)]
            with _env(**env):
                _check(op.route == "split", f"{name} under {env} runs on "
                       f"{op.route}")
                before = S.sell_split.launches
                y = op(x)
                n = S.sell_split.launches - before
            yp = S.sell_split_plain(*op._planes("split"), op._x_tiles(x),
                                    **op._kw())[: op.shape[0]]
            torch.cuda.synchronize()
            e = _rel_err(y, yp)
            want = SPLIT_N if "SMVP_SELL_SPLIT" in env else 1
            _check(n == want, f"{name} under {env}: {n} K4 launches, not "
                   f"{want}")
            _check(e <= TOL_KERNEL, f"K4 on {name} {dname} under {env} vs "
                   f"plain: {e}")
            print(f"[check] {name} {dname} under {env}: {n} sell_split_kernel "
                  f"launch(es) vs plain {e:.3e}", flush=True)
    for dname in DTYPE_NAMES:
        op, x = ops[("smoke", dname)]
        with _env(SMVP_SELL_SPLIT=str(SPLIT_N)):
            _check(op.route == "relsl", f"smoke under SPLIT runs on "
                   f"{op.route}")
            before = S.sell_spmv.launches
            y = op(x)
            n = S.sell_spmv.launches - before
        yp = S.sell_spmv_plain(*op._planes(), op._x_tiles(x),
                               **op._kw())[: op.shape[0]]
        with _env(SMVP_SELL_LIDX32="1"):
            op32 = S.SellSpMV(op.plan, value_dtype=op.value_dtype, device=dev)
        _check(op32.lidx.dtype == torch.int32, "LIDX32=1 kept int8 lanes")
        xt = op32._x_tiles(x)
        y32 = S.sell_spmv(*op32._planes(), xt, **op32._kw())
        y32b = S.sell_bench_loop(*op32._planes(), xt, iterations=3,
                                 **op32._kw())
        y32p = S.sell_spmv_plain(*op32._planes(), xt, **op32._kw())
        torch.cuda.synchronize()
        e, e32 = _rel_err(y, yp), _rel_err(y32, y32p)
        e32b = _rel_err(y32b, y32p)
        del op32, y32, y32b, y32p
        _check(n == SPLIT_N, f"smoke under SPLIT={SPLIT_N}: {n} K1 launches")
        _check(e <= TOL_KERNEL, f"K1 on smoke {dname} under SPLIT={SPLIT_N} "
               f"vs plain: {e}")
        _check(e32 <= TOL_KERNEL and e32b <= TOL_KERNEL, f"K1 and K2 (N = 3) "
               f"on smoke {dname} under LIDX32=1 vs plain: {e32}, {e32b}")
        print(f"[check] smoke {dname}: {n} sell_spmv_kernel launches under "
              f"SMVP_SELL_SPLIT={SPLIT_N} vs plain {e:.3e}; on int32 lanes "
              f"(SMVP_SELL_LIDX32=1) K1 vs plain {e32:.3e}, K2 (N = 3) vs "
              f"plain {e32b:.3e}", flush=True)


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
              spmm=False, config=None, dtypes=DTYPE_NAMES, want=None,
              fused_modes=(False, True), n=None, count=None):
    """The CLI on ``source``, per call and fused (``fused_modes``), in
    ``dtypes``; with ``spmm``, each run also times ``--spmm 8`` and its Y
    is checked. ``config`` names the configuration whose route and N it
    takes (default ``name``; ``n`` overrides N); ``want(fused)`` lists the
    kernels the run must launch (default: the route's and, with ``spmm``,
    its SpMM kernel); ``count(fused)``, when given, maps a kernel to the
    exact number of launches the run must make."""
    from smvp_toolkit_tpu_torch.cli import main as cli_main
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    config = config or name
    algs = ["CSR", "TJDS"] if "-t" in argv0 else ["CSR"]
    route = ROUTE[config]
    for dname in dtypes:
        ref, _ = _oracle(np, torch, triplets, dname)
        scale = float(np.abs(ref).max())
        ref_mat = _spmm_oracle(np, torch, triplets, dname) if spmm else None
        for fused in fused_modes:
            with tempfile.TemporaryDirectory() as tmp:
                argv = argv0 + ["-n", str(n or ITERATIONS[config]), "-d", tmp,
                                "--device", torch.device(DEVICE).type,
                                "--json-out", os.path.join(tmp, "run.jsonl"),
                                "--x", "random:1", "--dtype", dname]
                argv += ["--fused"] if fused else []
                if spmm:
                    argv += ["--spmm", str(SPMM_K), "--out-dir", tmp]
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
                if want is None:
                    kernels = [S.KERNEL_NAMES[(route, fused)]]
                    if spmm:
                        kernels.append(_spmm_kernel_name(route, fused))
                else:
                    kernels = want(fused)
                got = _check_only(counts, kernels, what)
                if count is not None:
                    _check(got == count(fused), f"{what}: launches {got}, "
                           f"want {count(fused)}")
                for kname, k in got.items():
                    key = (kname, name, dname)
                    launches[key] = launches.get(key, 0) + k
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
                    Y = np.load(os.path.join(tmp, "spmm.npy")).astype(
                        np.float64)
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


def phase_cisr(np, torch, configs, launches):
    """Phase 3, smoke-cisr: the schedule of smoke's matrix on the host
    (decode round trip, ``.coe`` write timed), then the CLI's ``-a`` at
    full size, per call and ``--fused``."""
    from smvp_toolkit_tpu_torch.cli import main as cli_main
    from smvp_toolkit_tpu_torch.formats.cisr import (
        cisr_decode,
        cisr_encode,
        write_coe,
    )
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.utils.checkpoint import load_matrix

    trip = configs["smoke"][1]
    r, c, v, shape = trip
    coo = COOMatrix.from_numpy(r, c, v, shape=shape, device="cpu")
    t0 = time.perf_counter()
    cisr = cisr_encode(coo, CISR_SLOTS)
    t1 = time.perf_counter()
    rd, cd, vd = cisr_decode(cisr, device="cpu").to_numpy()
    R, C, V = coo.canonical_order().to_numpy()
    _check(rd.tobytes() == R.tobytes() and cd.tobytes() == C.tobytes()
           and vd.tobytes() == V.astype(np.float64).tobytes(),
           "smoke CISR decode round trip")
    t2 = time.perf_counter()
    coe = write_coe(cisr).encode()
    t3 = time.perf_counter()
    n_val = cisr.num_groups * CISR_SLOTS
    n_len = -(-shape[0] // 2)
    print(f"[cisr] smoke: {CISR_SLOTS} slots, {cisr.num_groups} beats, "
          f"{n_val} value words, {n_len} row-length words; scheduled in "
          f"{t1 - t0:.2f} s (csrc/cisr.cpp), decode round trip bit-exact, "
          f".coe text ({len(coe)} bytes) built in {t3 - t2:.2f} s",
          flush=True)
    del coo, rd, cd, vd, R, C, V
    ref, _ = _oracle(np, torch, trip, "float32")
    scale = float(np.abs(ref).max())
    for fused in (False, True):
        kname = S.KERNEL_NAMES[("relsl", fused)]
        with tempfile.TemporaryDirectory() as tmp:
            paths = {k: os.path.join(tmp, k) for k in (
                "smoke.coe", "smoke.lut", "enc", "run.jsonl")}
            argv = ["-a", "-n", str(CISR_N), "--x", "random:1",
                    "--decode-check", "--coe-out", paths["smoke.coe"],
                    "--lut-out", paths["smoke.lut"], "--save-encoded",
                    paths["enc"], "-d", tmp, "--out-dir", tmp, "--json-out",
                    paths["run.jsonl"], "--device",
                    torch.device(DEVICE).type]
            argv += ["--fused"] if fused else []
            log = io.StringIO()
            _zero_counts(S)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = cli_main(argv + [SMOKE_SPEC])
            wall = time.perf_counter() - t0
            counts = _counts(S)
            what = f"smoke-cisr CLI -a fused={fused}"
            _check(rc == 0, f"{what} returned {rc}:\n{log.getvalue()}")
            for alg in ("CSR", "TJDS", "CISR"):
                _check(f"{alg} decode round-trip: bit-exact" in log.getvalue(),
                       f"{what}: {alg} decode")
            got = _check_only(counts, [kname], what)
            launches[(kname, "smoke-cisr", "float32")] = got[kname]
            y_csr = np.load(os.path.join(tmp, "y.npy")).astype(np.float64)
            y_cisr = np.load(os.path.join(tmp, "cisr.npy")).astype(np.float64)
            errs = {"CISR vs oracle": float(np.abs(y_cisr - ref).max()) / scale,
                    "CISR vs CSR": float(np.abs(y_cisr - y_csr).max())
                    / float(np.abs(y_csr).max())}
            (tpath,) = glob.glob(os.path.join(
                tmp, "smvp-toolbox_report_TJDS_*"))
            errs["TJDS vs oracle"] = float(np.abs(
                _report_vector(np, tpath) - ref).max()) / scale
            with open(paths["smoke.coe"], "rb") as f:
                text = f.read()
            # from the newline before the start word: every word's line
            # ends in one
            body = text[text.index(b"\n00aaaaaaaa,\n"):]
            words = (body.count(b"\n01"), body.count(b"\n02"),
                     body.count(b"\n") - 1)
            _check(text == coe and text.endswith(b"\n03ffffffff;\n")
                   and words == (n_val, n_len, n_val + n_len + 2),
                   f"{what}: .coe words {words}, want {n_val} value and "
                   f"{n_len} row-length words between the start and end "
                   f"words")
            with open(paths["smoke.lut"], "rb") as f:
                lut_lines = f.read().count(b"\n")
            _check(lut_lines == len(r), f"{what}: LUT lines {lut_lines}")
            back = load_matrix(paths["enc"] + "_csr.npz", device="cpu")
            _check(back.nnz == len(r) and back.shape == shape,
                   f"{what}: CSR checkpoint {back}")
            with open(paths["run.jsonl"]) as f:
                recs = [json.loads(ln) for ln in f]
        rates = ", ".join(f"{q['alg']} avg {q['avg_ms']:.6f} ms/iter"
                          for q in recs)
        print(f"[main] smoke-cisr -a{' --fused' if fused else ''}: rc 0, "
              f"{wall:.1f} s, {rates}, launches {got}, "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; .coe {len(text)} bytes, LUT {lut_lines} lines",
              flush=True)
        _check(errs["CISR vs oracle"] <= TOL_ORACLE
               and errs["TJDS vs oracle"] <= TOL_ORACLE,
               f"{what} oracle errors {errs}")
        _check(errs["CISR vs CSR"] <= TOL_KERNEL,
               f"{what}: CISR y vs CSR y {errs['CISR vs CSR']}")


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


def _library_csr(np, torch, triplets, dtype=None):
    """A float32 (or ``dtype``) CSR tensor of the triplets on the card,
    duplicates summed (gcn_norm's self loops repeat a graph's own (i, i)
    edges)."""
    import scipy.sparse as sp

    dtype = np.float32 if dtype is None else dtype
    r, c, v, shape = triplets
    a = sp.csr_matrix((np.asarray(v, dtype), (r, c)), shape=shape)
    a.sum_duplicates()
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)).to(DEVICE),
        torch.from_numpy(a.indices.astype(np.int64)).to(DEVICE),
        torch.from_numpy(a.data.astype(dtype)).to(DEVICE),
        size=shape, check_invariants=True,
    )


def _entry(kname, config, dname, *, launches, err, ms, plain_ms, lib_ms,
           nbytes, flops, bw, iters=1, per_iteration=False,
           peak=F32_PEAK_FLOPS, replaces=None, **extra):
    """One ``kernels`` entry: ``nbytes`` (each input once, each output
    once) over the memory rate, or ``flops`` over ``peak`` (the float32
    rate; K8's float64 rate). With ``per_iteration`` (the fused solvers)
    ``nbytes`` is one iteration's traffic, which every iteration moves
    again."""
    t_bytes = nbytes / bw * 1e3 * (iters if per_iteration else 1)
    t_ops = flops / peak * 1e3
    src, line = KERNELS[kname]
    print(f"[time] {kname} {config} {dname} {extra}: {ms:.6f} ms per launch "
          f"({iters} iterations), bound {max(t_bytes, t_ops):.6f} ms, plain "
          f"{plain_ms:.6f} ms, library {lib_ms:.6f} ms", flush=True)
    return {
        "name": f"{kname}[{config},{dname}]",
        "config": config,
        "route": "cuda",
        "source": CSRC + src,
        "replaces": (replaces if replaces and "/" in replaces
                     else f"{JAX_OPS}{replaces or line}"),
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


def _sublane_blocks(plan):
    """Blocks of one warp-per-sublane forward launch: chunks x runs."""
    return plan.n_chunks * -(-plan.chunk // SUBLANE_RUN)


def _sublane_grid(torch, name, op):
    """The forward kernel's grid on a full-size plan, in waves of
    co-resident blocks; on smoke (resident y), K1's time over views of the
    first one and two waves' chunks beside the whole launch, to show what
    the last, partial wave costs."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    plan = op.plan
    runs = -(-plan.chunk // SUBLANE_RUN)
    wave = torch.cuda.get_device_properties(0).multi_processor_count * \
        SUBLANE_BLOCKS_PER_SM
    blocks = _sublane_blocks(plan)
    kname = S.KERNEL_NAMES[(op.base_route, False)]
    dname = str(op.value_dtype)[6:]
    line = (f"[grid] {kname} on {name} {dname}: {plan.n_chunks} chunks x "
            f"{runs} runs = {blocks} blocks of 256 threads, "
            f"{blocks / wave:.2f} waves of {wave}")
    if not plan.y_block_slices:
        per_wave = wave // runs
        xt = op._x_tiles(torch.ones(plan.shape[1], device=op.device))
        parts = []
        for c in (per_wave, 2 * per_wave, plan.n_chunks):
            if c > plan.n_chunks:
                continue
            cut = c * plan.chunk
            args = (op.vals[:cut], op.lidx[:cut], op.relsl[:cut],
                    op.tile_base[:c], xt)
            ms = _time_ms(lambda: S.sell_spmv(
                *args, n_slices=plan.n_slices, chunk=plan.chunk), reps=20,
                queued=True)
            parts.append(f"{c} chunks ({c * runs / wave:.2f} waves) "
                         f"{ms:.6f} ms = {ms / c * 1e3:.4f} us per chunk")
        line += "; " + ", ".join(parts)
    print(line, flush=True)


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
                    e = _rel_err(fn(*planes, xt, iterations=n_iter, **kw),
                                 plain(*planes, xt, iterations=1, **kw))
                    _check(e <= TOL_KERNEL, f"{kname} on {name} {dname} at "
                           f"N = {n_iter} vs one plain SpMV: {e}")
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
                    if route in MERGED_ROUTES:
                        # the card's time alone; the host-paced times beside
                        queued = dict(
                            host_paced_ms=ms, host_paced_library_ms=lib_ms)
                        ms = _time_ms(lambda: fn(*planes, xt, **kw), reps=20,
                                      queued=True)
                        lib_ms = _time_ms(lambda: torch.sparse.mm(a, x2),
                                          reps=20, queued=True)
                iters = n_iter if bench else 1
                extra = {} if bench or route not in MERGED_ROUTES else queued
                entries.append(_entry(
                    kname, name, dname,
                    launches=launches[(kname, name, dname)],
                    err=errs[(name, dname)][int(bench)], ms=ms,
                    plain_ms=plain_ms, lib_ms=lib_ms,
                    nbytes=plan.traffic_bytes(vb, x_bytes=vb),
                    flops=2.0 * plan.nnz * iters, bw=bw, iters=iters,
                    body="warp-per-sublane",
                    g_slots_per_s=plan.slots() * iters / ms * 1e-6, **extra))
            if route in MERGED_ROUTES:
                _sublane_grid(torch, name, op)
            fwd_ms, bench_ms = (e["ms"] for e in entries[-2:])
            print(f"[time] {name} {dname}: {S.KERNEL_NAMES[(route, True)]} "
                  f"{bench_ms / n_iter:.6f} ms per iteration = "
                  f"{bench_ms / n_iter / fwd_ms:.3f} x one "
                  f"{S.KERNEL_NAMES[(route, False)]} launch "
                  f"({fwd_ms:.6f} ms)", flush=True)
            if dname == "bfloat16" and name in PACKED_CONFIGS:
                entries += _packed_timings(torch, S, name, op, xt, a, x2,
                                           errs, launches, bw)
        del a
    return entries


def _packed_timings(torch, S, name, op, xt, a, x2, errs, launches, bw):
    """Phase 4 for K5 (k = 1) and, on a resident plan, K2-packed with the
    CLI's N, on ``name``'s bf16 operator; the library call is the float32
    CSR yardstick ``a`` of the k = 1 entries."""
    pk, sl = op.packed_planes()
    plan, config = op.plan, PACKED_CONFIGS[name]
    kw = op._kw()
    if plan.y_block_slices:
        kw["y_block_id"] = op.y_block_id
    nbytes = plan.traffic_bytes(2, x_bytes=2, packed=True)
    runs = [(S.sell_packed, 1)]
    if not plan.y_block_slices:
        runs.append((S.sell_bench_packed, ITERATIONS[name]))
    out = []
    for fn, n in runs:
        plain = getattr(S, fn.__name__ + "_plain")
        it = {} if n == 1 else {"iterations": n}
        ms = _time_ms(lambda: fn(pk, sl, op.tile_base, xt, **it, **kw),
                      reps=20 if n == 1 else 3, warmup=2 if n == 1 else 1)
        plain_ms = _time_ms(lambda: plain(pk, sl, op.tile_base, xt, **it,
                                          **kw), reps=3 if n == 1 else 1,
                            warmup=2 if n == 1 else 0)
        lib_ms = _time_ms(lambda: [torch.sparse.mm(a, x2) for _ in range(n)],
                          reps=20 if n == 1 else 1, warmup=1)
        extra = {"body": "warp-per-sublane"}
        if n == 1:
            # K5: the card's time alone, the host-paced times beside
            extra = {"body": "warp-per-sublane", "host_paced_ms": ms,
                     "host_paced_library_ms": lib_ms}
            ms = _time_ms(lambda: fn(pk, sl, op.tile_base, xt, **kw),
                          reps=20, queued=True)
            lib_ms = _time_ms(lambda: torch.sparse.mm(a, x2), reps=20,
                              queued=True)
        out.append(_entry(
            fn.kernel, config, "bfloat16",
            launches=launches[(fn.kernel, config, "bfloat16")],
            err=errs[(fn.kernel, name, "bfloat16")], ms=ms,
            plain_ms=plain_ms, lib_ms=lib_ms, nbytes=nbytes,
            flops=2.0 * plan.nnz * n, bw=bw, iters=n, **extra))
    return out


def _mat_forward_times(torch, fn, planes, Xt, kw, a, X, reps):
    """K1, K4 or K5 with k columns and their library call: the card's times
    queued behind the spin kernel (``ms``, ``lib_ms``) and the host-paced
    ones, and the entry's ``body`` and column ``shape``."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    host = dict(host_paced_ms=_time_ms(lambda: fn(*planes, Xt, **kw),
                                       reps=reps),
                host_paced_library_ms=_time_ms(
                    lambda: torch.sparse.mm(a, X), reps=reps))
    ms = _time_ms(lambda: fn(*planes, Xt, **kw), reps=reps, queued=True)
    lib_ms = _time_ms(lambda: torch.sparse.mm(a, X), reps=reps, queued=True)
    k = Xt.shape[1]
    return ms, lib_ms, dict(host, body="warp-per-sublane k-column",
                            shape=list(S.spmm_shape(k)))


def phase_mat_timings(np, torch, ops, errs, launches, configs, gcn, bw):
    """Phase 4 for the k-column kernels: at k = 8 on smoke and L2 (both
    dtypes, the N-iteration kernel with the CLI's N), at k = 256 and 40 on
    gcn_arxiv (float32), and K5 with k columns at k = 8 on smoke-packed.
    K1's, K4's and K5's forward launches with k columns and their library
    calls are timed queued behind the spin kernel."""
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
            if op.base_route == "relsl":
                runs.append((S.sell_bench_spmm, ITERATIONS[name]))
            fwd_ms = None
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
                    extra = dict(body="warp-per-sublane k-column",
                                 shape=list(S.spmm_shape(SPMM_K)))
                    print(f"[time] {fn.kernel} {name} {dname} k={SPMM_K}: "
                          f"an iteration {ms / n:.6f} ms, "
                          f"{ms / n / fwd_ms:.3f}x one "
                          f"{op.spmm_kernel.kernel} launch (queued "
                          f"{fwd_ms:.6f} ms)", flush=True)
                else:
                    ms, lib_ms, extra = _mat_forward_times(
                        torch, fn, planes, Xt, kw, a, X, reps=20)
                    fwd_ms = ms
                    plain_ms = _time_ms(lambda: plain(*planes, Xt, **kw),
                                        reps=3)
                entries.append(_entry(
                    fn.kernel, name, dname,
                    launches=launches[(fn.kernel, name, dname)],
                    err=errs[(fn.kernel, name, dname, SPMM_K)], ms=ms,
                    plain_ms=plain_ms, lib_ms=lib_ms,
                    nbytes=plan.traffic_bytes(vb, x_bytes=vb, k=SPMM_K),
                    flops=2.0 * plan.nnz * SPMM_K * n, bw=bw, iters=n,
                    k=SPMM_K, **extra))
            if dname == "bfloat16" and name in PACKED_CONFIGS:
                pk, sl = op.packed_planes()
                fn = S.sell_packed_spmm
                config = PACKED_CONFIGS[name]
                ms, lib_ms, extra = _mat_forward_times(
                    torch, fn, (pk, sl, op.tile_base), Xt, kw, a, X,
                    reps=20)
                print(f"[time] {fn.kernel} {config} {dname} k={SPMM_K}: "
                      f"{ms:.6f} ms queued, {ms / fwd_ms:.3f}x "
                      f"{op.spmm_kernel.kernel} (queued {fwd_ms:.6f} ms) "
                      f"on the same plan", flush=True)
                entries.append(_entry(
                    fn.kernel, config, dname,
                    launches=launches[(fn.kernel, config, dname)],
                    err=errs[(fn.kernel, name, dname, SPMM_K)], ms=ms,
                    plain_ms=_time_ms(lambda: S.sell_packed_spmm_plain(
                        pk, sl, op.tile_base, Xt, **kw), reps=3),
                    lib_ms=lib_ms,
                    nbytes=plan.traffic_bytes(2, x_bytes=2, k=SPMM_K,
                                              packed=True),
                    flops=2.0 * plan.nnz * SPMM_K, bw=bw, k=SPMM_K, **extra))
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
        fn = o.spmm_kernel
        plain = getattr(S, fn.__name__ + "_plain")
        for k in (GCN_K, 40):  # the GCN's hidden and output widths
            Xk = X[:, :k].contiguous()
            Xt = o._block(Xk, plan.n_coltiles * 128, torch.float32, "X")
            ms, lib_ms, extra = _mat_forward_times(
                torch, fn, o._planes(), Xt, kw, a, Xk, reps=10)
            common = dict(
                launches=launches[(fn.kernel, "gcn_arxiv", "float32")],
                nbytes=plan.traffic_bytes(4, x_bytes=4, k=k), bw=bw, k=k,
                plan=label)
            entries.append(_entry(
                fn.kernel, "gcn_arxiv" if k == GCN_K else f"gcn_arxiv-k{k}",
                "float32",
                err=errs[(fn.kernel, f"gcn_arxiv:{label}", "float32", k)],
                ms=ms,
                plain_ms=_time_ms(lambda: plain(*o._planes(), Xt, **kw),
                                  reps=1, warmup=1),
                lib_ms=lib_ms, flops=2.0 * plan.nnz * k, **common, **extra))
        if label == "A":  # K7 runs on A's planes in the edge steps
            entries += _vals_grad_timings(np, torch, o, a, X, G, errs,
                                          launches, bw)
        del a
    return entries


def _vals_grad_timings(np, torch, o, a, X, G, errs, launches, bw):
    """K7 on gcn_arxiv's A at k = 256 and 40 (the widths of the edge steps'
    launches), on the operator's by-slice schedule: its launches and its
    library call (``sampled_addmm`` on A's pattern, beta 0) queued behind
    the spin kernel, the host-paced times beside."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    kname = "sell_vals_grad_kernel"
    plan, kw = o.plan, o._mat_kw()
    meta = dict(relsl=o.relsl, rel=o.rel, slice_of=o.slice_of)
    sched = o.vals_grad_schedule()
    live = int(((plan.rel_tile.reshape(-1) >= 0)
                & (plan.slice_of.reshape(-1) >= 0)).sum()) * 128
    out = []
    for k in (GCN_K, 40):
        Xt = o._block(X[:, :k], plan.n_coltiles * 128, torch.float32, "X")
        Gt = o._block(G[:, :k], plan.n_slices * 128, torch.float32, "G")
        Gk, Xtr = G[:, :k].contiguous(), X[:, :k].t().contiguous()

        def fn():
            return S.sell_vals_grad(o.lidx, o.tile_base, Xt, Gt,
                                    schedule=sched, **meta, **kw)

        def lib():
            return torch.sparse.sampled_addmm(a, Gk, Xtr, beta=0.0)

        host = dict(host_paced_ms=_time_ms(fn, reps=10),
                    host_paced_library_ms=_time_ms(lib, reps=10))
        out.append(_entry(
            kname, "gcn_arxiv" if k == GCN_K else f"gcn_arxiv-k{k}",
            "float32", launches=launches[(kname, "gcn_arxiv", "float32")],
            err=errs[(kname, "gcn_arxiv:A", "float32", k)],
            ms=_time_ms(fn, reps=10, queued=True),
            plain_ms=_time_ms(lambda: S.sell_vals_grad_plain(
                o.lidx, o.tile_base, Xt, Gt, **meta, **kw), reps=1,
                warmup=1),
            lib_ms=_time_ms(lib, reps=10, queued=True),
            nbytes=plan.traffic_bytes(4, x_bytes=4, k=k), bw=bw,
            flops=2.0 * live * k, k=k, plan="A", body="by-slice",
            units=sched.n_units, **host))
    return out


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
            jpath = os.path.join(tmp, f"{method}.jsonl")
            argv = ["-c", "-n", str(HPCG_BENCH_N), "--expand-symmetry",
                    "--x", "random:1", "--no-report", "--json-out", jpath,
                    "--solve", f"{method}:{iters}", "--out-dir", tmp, path]
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
            rr = relres(np.load(os.path.join(tmp, "solve.npy")))
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
        _native_vs_numpy(np, "hpcg104 A", op.plan, t1 - t0, lambda: (
            S._auto_plan(*S._triplets_from_csr_host(csr))))
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
    routes = {S.KERNEL_NAMES[(S.sell_op_csr(f).base_route, False)]
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
        extra = dict(extra, body="warp-per-sublane")
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


def _plane_oracle(np, plan, vals64, x64):
    """Float64 y of a resident plan's own planes: every live slot's
    ``vals64[s, l]·x64[col(s, l)]`` summed per row (scipy)."""
    import scipy.sparse as sp

    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    live = np.nonzero((rel >= 0) & (sl >= 0))[0]
    c = live // plan.chunk
    rows = (sl[live] * 128)[:, None] + np.arange(128)
    cols = ((plan.tile_base[c].astype(np.int64) + rel[live]) * 128)[:, None] \
        + plan.lane_idx[live]
    v = vals64[live]
    keep = v != 0
    a = sp.csr_matrix((v[keep], (rows[keep], cols[keep])),
                      shape=(plan.n_slices * 128, plan.n_coltiles * 128))
    xp = np.zeros(plan.n_coltiles * 128)
    xp[: len(x64)] = x64
    return (a @ xp)[: plan.shape[0]]


def _check_df64(np, torch, label, op, x64, vals64):
    """K8 and its N-iteration kernel (N = 3) on ``op`` against the plain
    version (bit for bit: the same float64 operations in the same order)
    and the float64 oracle of the same planes (``vals64``) and x pair
    (<= 5e-14); the N = 3 launch bit for bit equal to one launch (the
    fixed summation order). Returns y."""
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
    from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64

    xh, xl = df_split(x64, device=DEVICE)
    kw = dict(n_slices=op.plan.n_slices, chunk=op.plan.chunk)
    planes = op._planes(xh, xl)
    y1 = D.sell_df64(*planes, **kw)
    y3 = D.sell_bench_df64(*planes, iterations=3, **kw)
    yp = D.sell_df64_plain(*planes, **kw)
    torch.cuda.synchronize()
    bits = torch.equal(y1[0], yp[0]) and torch.equal(y1[1], yp[1])
    n = op.shape[0]
    y, p = df_to_f64(y1[0][:n], y1[1][:n]), df_to_f64(yp[0][:n], yp[1][:n])
    want = _plane_oracle(np, op.plan, vals64, df_to_f64(xh, xl))
    e_plain, e_oracle = (_rel_err(torch.from_numpy(y), torch.from_numpy(r))
                         for r in (p, want))
    same = torch.equal(y1[0], y3[0]) and torch.equal(y1[1], y3[1])
    what = f"sell_df64_kernel on {label}"
    _check(bool(np.isfinite(y).all()), f"{what}: not finite")
    _check(bits, f"{what}: not bit for bit its plain version (max rel "
           f"{e_plain:.3e})")
    _check(e_oracle <= TOL_DF64_ORACLE, f"{what} vs float64: {e_oracle}")
    _check(same, f"sell_bench_df64_kernel (N = 3) on {label}: not bit for "
           "bit one launch")
    print(f"[check] {label:28s} df64, lo plane {op.vals_lo is not None}: "
          f"sell_df64_kernel bit-equal to plain, vs float64 "
          f"{e_oracle:.3e}; sell_bench_df64_kernel (N = 3) bit-equal",
          flush=True)
    return y


def _check_packed(np, torch, label, op, ks, errs, config=None):
    """K5 (and on a resident plan K2-packed with N = 3 and K5 with k
    columns for each k in ``ks``) on ``op``'s bf16 planes against the
    plain versions and against the route's K1 (K3) kernels on the same
    plan; with ``config``, the max abs errors go into ``errs``."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    pk, sl = op.packed_planes()
    plan = op.plan
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        plan.shape[1]).astype(np.float32)).to(DEVICE)
    xt = op._x_tiles(x)
    kw = op._kw()
    if plan.y_block_slices:
        kw["y_block_id"] = op.y_block_id
    y1 = op.kernel(*op._planes(), xt, **op._kw())
    yp = S.sell_packed_plain(pk, sl, op.tile_base, xt, **kw)
    got = {"sell_packed_kernel": (S.sell_packed(pk, sl, op.tile_base, xt,
                                                **kw), yp, y1)}
    if not plan.y_block_slices:
        got["sell_bench_packed_kernel"] = (S.sell_bench_packed(
            pk, sl, op.tile_base, xt, iterations=3, **kw), yp, y1)
    mkw = op._mat_kw()
    for k in ks:
        X = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (plan.n_coltiles * 128, k)).astype(np.float32)).to(DEVICE).to(
            torch.bfloat16)
        got[("sell_packed_spmm_kernel", k)] = (
            S.sell_packed_spmm(pk, sl, op.tile_base, X, **mkw),
            S.sell_packed_spmm_plain(pk, sl, op.tile_base, X, **mkw),
            op.spmm_kernel(*op._planes(), X, **mkw))
    torch.cuda.synchronize()
    tol = _spmm_tolerance(torch, S, op)[0] if ks else TOL_KERNEL
    line = []
    for key, (y, ref, k1) in got.items():
        mat = isinstance(key, tuple)
        kname = f"{key[0]} k={key[1]}" if mat else key
        t = tol if mat else TOL_KERNEL
        e, e1 = _rel_err(y, ref), _rel_err(y, k1)
        what = f"{kname} on {label} bfloat16"
        _check(bool(torch.isfinite(y).all()), f"{what}: not finite")
        _check(e <= t, f"{what} vs plain: {e} > {t}")
        _check(e1 <= t, f"{what} vs the route's kernel: {e1} > {t}")
        line.append(f"{kname} vs plain {e:.3e}, vs {op.base_route} {e1:.3e}")
        if config is not None:
            ekey = ((key[0], config, "bfloat16", key[1]) if mat
                    else (key, config, "bfloat16"))
            errs[ekey] = (y - ref).abs().max().item()
    print(f"[check] {label:28s} bfloat16 packed: " + "; ".join(line),
          flush=True)


def _check_packed_zero_value(np, torch, label, op):
    """K5 with k columns skips zero-valued slots, as K1 with k columns
    does: X holds Inf in the column of a padding lane (v = 0 in a live
    sublane), and every real entry of that column gets value bits 0 in its
    packed word (rel and lane kept), so only zero-valued slots read it. Y
    must stay finite and within the SpMM tolerance of the plain version on
    that plane, which skips them too."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    plan, kw = op.plan, op._mat_kw()
    col, cols, pad, live = _padding_column(np, label, plan)
    real = torch.from_numpy(live[:, None] & (plan.vals.reshape(-1, 128) != 0)
                            & (cols == col)).to(op.device)
    pk, sl = op.packed_planes()
    zeroed = pk.clone().reshape(real.shape)
    zeroed[real] = zeroed[real] & 0xFFFF  # value bits 0, rel and lane kept
    zeroed = zeroed.reshape(pk.shape)
    X = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (plan.n_coltiles * 128, SPMM_K)).astype(np.float32)).to(
        op.device).to(torch.bfloat16)
    X[col] = float("inf")
    y = S.sell_packed_spmm(zeroed, sl, op.tile_base, X, **kw)
    yp = S.sell_packed_spmm_plain(zeroed, sl, op.tile_base, X, **kw)
    torch.cuda.synchronize()
    tol, _ = _spmm_tolerance(torch, S, op)
    e = _rel_err(y, yp)
    what = f"sell_packed_spmm_kernel zero-value contract on {label}"
    _check(bool(torch.isfinite(yp).all()), f"{what}: plain Y not finite")
    _check(bool(torch.isfinite(y).all()), f"{what}: Y not finite")
    _check(e <= tol, f"{what}: {e} > {tol}")
    print(f"[check] {label:28s} bfloat16  sell_packed_spmm_kernel "
          f"k={SPMM_K}: Inf in X column {col}, read by "
          f"{int((pad & (cols == col)).sum())} padding lanes and "
          f"{int(real.sum())} zeroed words: Y finite, vs plain {e:.3e}",
          flush=True)


def _check_packed_lanes(np, torch, label, op):
    """K5, and on a resident plan K2-packed (N = 2, 3) and K5 with k
    columns (k = 1, 3, 8), on ``op``'s packed plane with lanes 1..127
    rewritten to another rel than lane 0's: within 1e-6 (k columns: the
    SpMM tolerance) of the plain version on that plane (rel from lane 0)
    and of the plane's own y. A kernel decoding rel per slot, as all three
    did before, misses both by about max |y|."""
    from smvp_toolkit_tpu_torch.bench.bench_variants import (
        disagreeing_lanes,
    )
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    pk, sl = op.packed_planes()
    plan, tb = op.plan, op.tile_base
    bad = torch.from_numpy(disagreeing_lanes(
        pk.cpu().numpy(), sl.cpu().numpy(), tb.cpu().numpy(),
        chunk=plan.chunk, n_coltiles=plan.n_coltiles)).to(DEVICE)
    changed = int((bad != pk).sum())
    n_live = int(((pk.reshape(-1, 128)[:, 0] >> 7 & 511) != 511)
                 .logical_and(sl.reshape(-1) >= 0).sum())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        plan.shape[1]).astype(np.float32)).to(DEVICE)
    xt = op._x_tiles(x)
    kw = op._kw()
    if plan.y_block_slices:
        kw["y_block_id"] = op.y_block_id
    runs = {"sell_packed_kernel": (
        lambda p: S.sell_packed(p, sl, tb, xt, **kw),
        lambda p: S.sell_packed_plain(p, sl, tb, xt, **kw), TOL_KERNEL)}
    if not plan.y_block_slices:
        for n in (2, 3):
            runs[f"sell_bench_packed_kernel N={n}"] = (
                lambda p, n=n: S.sell_bench_packed(p, sl, tb, xt,
                                                   iterations=n, **kw),
                lambda p, n=n: S.sell_bench_packed_plain(
                    p, sl, tb, xt, iterations=n, **kw), TOL_KERNEL)
        mkw = op._mat_kw()
        tol = _spmm_tolerance(torch, S, op)[0]
        for k in (1, 3, 8):
            X = torch.from_numpy(np.random.default_rng(k).standard_normal(
                (plan.n_coltiles * 128, k)).astype(np.float32)).to(
                DEVICE).to(torch.bfloat16)
            runs[f"sell_packed_spmm_kernel k={k}"] = (
                lambda p, X=X: S.sell_packed_spmm(p, sl, tb, X, **mkw),
                lambda p, X=X: S.sell_packed_spmm_plain(p, sl, tb, X, **mkw),
                tol)
    what = f"{label} with disagreeing lanes"
    _check(changed > 0 or n_live == 0, f"{what}: no word rewritten")
    line = []
    for kname, (kernel, plain, tol) in runs.items():
        y, yp, y_own = kernel(bad), plain(bad), plain(pk)
        torch.cuda.synchronize()
        e, e_own = _rel_err(y, yp), _rel_err(y, y_own)
        _check(bool(torch.isfinite(y).all()), f"{kname} on {what}: not "
               "finite")
        _check(e <= tol and e_own <= tol, f"{kname} on {what}: vs plain "
               f"{e}, vs the plane's own y {e_own} (tolerance {tol})")
        line.append(f"{kname} vs plain {e:.3e}, vs own {e_own:.3e}")
    print(f"[check] {label:28s} bfloat16 packed, {changed} words with "
          f"another rel than lane 0's: " + "; ".join(line), flush=True)


def phase_new_kernels(np, torch, plans, ops, errs):
    """Phase 2 for K8, K5 and K2-packed: K8 on every small resident
    merged-word plan with and without a lo plane (the others refused),
    on cancelling rows and on the edge scales; K5 (k = 1, 2, 8, 17;
    streamed: k = 1) and K2-packed (N = 3) on every small merged-word
    plan; K5 on the full-size smoke (k = 1, 8, K2-packed; K5 with k
    columns also with Inf in X at a padding lane's column) and L1
    (streamed) bf16 operators, their errors kept for phase 4."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import (
        SellDf64SpMV,
        slice_index,
    )

    for name, plan in plans:
        if name in ROUTE:
            continue
        if plan.y_block_slices or not plan.merged_word:
            try:
                SellDf64SpMV(plan, device=DEVICE)
            except ValueError:
                print(f"[check] {name:28s} SellDf64SpMV refuses the plan "
                      f"(streamed y, or WT {plan.window_tiles} > 511)",
                      flush=True)
            else:
                _check(False, f"SellDf64SpMV took {name}")
        else:
            x64 = np.random.default_rng(3).standard_normal(plan.shape[1])
            lo = (plan.vals * 2.0 ** -24 * np.random.default_rng(4).uniform(
                -0.5, 0.5, plan.vals.shape)).astype(np.float32)
            for vals_lo in (None, lo):
                vals64 = plan.vals.astype(np.float64)
                if vals_lo is not None:
                    vals64 = vals64 + vals_lo
                _check_df64(np, torch, name, SellDf64SpMV(
                    plan, vals_lo=vals_lo, device=DEVICE), x64, vals64)
        if plan.merged_word:
            op = S.SellSpMV(plan, value_dtype=torch.bfloat16, device=DEVICE)
            _check_packed(np, torch, name, op,
                          () if plan.y_block_slices else (2, 8, 17), errs)
            _check_packed_lanes(np, torch, name, op)
    # the JAX suite's cancelling rows: pairs (b, -b + 1e-4 noise), b ~ 1e4
    rng = np.random.RandomState(3)
    base = rng.randn(128) * 1e4
    v64 = np.empty(256)
    v64[0::2], v64[1::2] = base, -base + 1e-4 * rng.randn(128)
    op = SellDf64SpMV.from_coo_f64(np.repeat(np.arange(128), 2),
                                   np.arange(256), v64, (128, 256), chunk=8,
                                   device=DEVICE)
    held = op.plan.vals.astype(np.float64) + op.vals_lo.cpu().numpy()
    _check_df64(np, torch, "cancelling rows", op, np.ones(256), held)
    # test_df64_edge_scales_no_nan's cases, exact here
    for v, want in (([0.0], 0.0), ([1e30, -1e30, 3.0], 3.0),
                    ([1e30, 1e-30, -1e30, 3.0], 3.0)):
        e = SellDf64SpMV.from_coo_f64(np.zeros(len(v), np.int64),
                                      np.arange(len(v)), np.asarray(v),
                                      (4, 4), chunk=8, device=DEVICE)
        got = df_to_f64(*e(*df_split(np.ones(4), device=DEVICE)))[0]
        _check(got == want, f"sell_df64_kernel on edge scales {v}: {got}")
    print("[check] edge scales (test_df64_edge_scales_no_nan): exact",
          flush=True)
    # the hub-row plan: one slice of 258 live sublanes (three staging
    # passes of K8's walk), 8 empty slices
    hub = _hub_row_plan(np, "relsl")
    ptr = np.diff(slice_index(hub)[0].astype(np.int64))
    _check(ptr.max() == 258 and (ptr == 0).sum() == 8,
           f"hub-row plan: {ptr.max()} live sublanes at most, "
           f"{(ptr == 0).sum()} empty slices")
    x64 = np.random.default_rng(6).standard_normal(hub.shape[1])
    lo = (hub.vals * 2.0 ** -24 * np.random.default_rng(7).uniform(
        -0.5, 0.5, hub.vals.shape)).astype(np.float32)
    for vals_lo in (None, lo):
        vals64 = hub.vals.astype(np.float64)
        if vals_lo is not None:
            vals64 = vals64 + vals_lo
        _check_df64(np, torch, "hub-row", SellDf64SpMV(
            hub, vals_lo=vals_lo, device=DEVICE), x64, vals64)
    for name in PACKED_CONFIGS:
        op, _ = ops[(name, "bfloat16")]
        _check_packed(np, torch, name, op,
                      () if op.plan.y_block_slices else (SPMM_K,), errs,
                      config=name)
        _check_packed_lanes(np, torch, name, op)
        if not op.plan.y_block_slices:
            _check_packed_zero_value(np, torch, name, op)


def _ulp_misses(np, y, ref) -> int:
    """Entries of float32 ``y`` more than one float32 ulp from the float64
    oracle rounded to float32."""
    r32 = ref.astype(np.float32)
    return int((np.abs(y.astype(np.float64) - r32.astype(np.float64))
                > np.spacing(np.abs(r32)).astype(np.float64)).sum())


def phase_df64(np, torch, configs, ops, launches):
    """Phase 3 on the double-float path: smoke-df64 through the CLI (per
    call and --fused; CSR on K8, TJDS on its SELL kernel) and
    smoke-df64-f64 through the API. Returns the operators and x pairs
    that phase 4 times."""
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.cli import main as cli_main
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    plan, triplets = configs["smoke"]
    ref, x32 = _oracle(np, torch, triplets, "float32")  # --x random:1
    op32, _ = ops[("smoke", "float32")]
    y_k1 = op32(torch.from_numpy(x32).to(DEVICE)).double().cpu().numpy()
    control = _ulp_misses(np, y_k1, ref)
    _check(control > 0, "the one-ulp check cannot tell K1's float32 y from "
           "the float64 oracle")
    for fused in (False, True):
        k8 = "sell_bench_df64_kernel" if fused else "sell_df64_kernel"
        tj = S.KERNEL_NAMES[(ROUTE["smoke"], fused)]
        with tempfile.TemporaryDirectory() as tmp:
            jpath = os.path.join(tmp, "r.jsonl")
            argv = ["-c", "-t", "--kernel", "df64", "-n",
                    str(ITERATIONS["smoke"]), "--x", "random:1", "-d", tmp,
                    "--device", torch.device(DEVICE).type,
                    "--json-out", jpath, "--out-dir", tmp,
                    *(["--fused"] if fused else []), SMOKE_SPEC]
            log = io.StringIO()
            _zero_counts(S)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = cli_main(argv)
            wall = time.perf_counter() - t0
            what = f"smoke-df64 CLI fused={fused}"
            _check(rc == 0, f"{what} returned {rc}:\n{log.getvalue()}")
            got = _check_only(_counts(S), [k8, tj], what)
            launches[(k8, "smoke-df64", "df64")] = got[k8]
            y = np.load(os.path.join(tmp, "y.npy"))
            misses = _ulp_misses(np, y, ref)
            _check(y.shape == ref.shape and misses == 0,
                   f"{what}: {misses} CSR entries beyond one float32 ulp")
            (tpath,) = glob.glob(os.path.join(tmp,
                                              "smvp-toolbox_report_TJDS_*"))
            e_tj = float(np.abs(_report_vector(np, tpath) - ref).max()
                         / np.abs(ref).max())
            _check(e_tj <= TOL_ORACLE, f"{what}: TJDS oracle error {e_tj}")
            with open(jpath) as f:
                csr_rec, tj_rec = (json.loads(ln) for ln in f)
            run_on = "cuda" if torch.device(DEVICE).type == "cuda" else "plain"
            _check(csr_rec["kernel"] == f"df64-{run_on}"
                   and tj_rec["kernel"] == f"sell-{run_on}",
                   f"{what}: labels {csr_rec['kernel']}, {tj_rec['kernel']}")
        print(f"[main] smoke-df64 -c -t --kernel df64"
              f"{' --fused' if fused else ''}: rc 0, {wall:.1f} s, CSR avg "
              f"{csr_rec['avg_ms']:.6f} ms/iter ({csr_rec['eff_gb_s']:.1f} "
              f"GB/s of SellDf64SpMV.traffic_bytes), TJDS avg "
              f"{tj_rec['avg_ms']:.6f} ms/iter; launches {got}; CSR y "
              f"within one float32 ulp of float64 on all {len(y)} rows "
              f"(K1's float32 y misses {control}); TJDS vs float64 "
              f"{e_tj:.3e}", flush=True)
    # smoke-df64-f64: float64 values, so a lo plane
    r, c, _, shape = triplets
    v64 = np.random.default_rng(0).standard_normal(len(r))
    x64 = np.random.default_rng(1).standard_normal(shape[1])
    t0 = time.perf_counter()
    op = SellDf64SpMV.from_coo_f64(r, c, v64, shape, device=DEVICE)
    t1 = time.perf_counter()
    _check(op.vals_lo is not None, "smoke-df64-f64 has no lo plane")
    want = sp.csr_matrix((v64, (r, c)), shape=shape) @ x64
    xh, xl = df_split(x64, device=DEVICE)
    for bench in (False, True):
        k = "sell_bench_df64_kernel" if bench else "sell_df64_kernel"
        _zero_counts(S)
        y = (op.bench_loop(xh, xl, DF64_F64_ITERATIONS) if bench
             else op(xh, xl))
        torch.cuda.synchronize()
        what = f"smoke-df64-f64 {'bench_loop' if bench else '__call__'}"
        n = _check_only(_counts(S), [k], what)[k]
        launches[(k, "smoke-df64-f64", "df64")] = n
        err = _rel_err(torch.from_numpy(df_to_f64(*y)),
                       torch.from_numpy(want))
        _check(err <= TOL_DF64_ORACLE, f"{what}: vs float64 {err}")
        print(f"[main] {what} (from_coo_f64, two planner passes, "
              f"{t1 - t0:.1f} s): launches {n}, hi + lo vs float64 "
              f"{err:.3e}", flush=True)
    return {"smoke-df64": (SellDf64SpMV(plan, device=DEVICE),
                           df_split(x32.astype(np.float64), device=DEVICE),
                           np.asarray(triplets[2], np.float64)),
            "smoke-df64-f64": (op, (xh, xl), v64)}


def phase_packed(np, torch, configs, ops, launches):
    """Phase 3 under SMVP_SELL_PACK=1: smoke-packed through the CLI in
    bf16 (K5 and K5 with k = 8 per call; K2-packed and the k-column K2
    under --fused), L1-packed through the API (K5 on streamed y; its
    bench_loop refused), and L2, whose 2,000-tile window keeps K4."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    os.environ["SMVP_SELL_PACK"] = "1"
    try:
        _cli_runs(np, torch, "smoke-packed", SMOKE_SPEC, ["-c"],
                  configs["smoke"][1], launches, spmm=True, config="smoke",
                  dtypes=("bfloat16",), want=lambda fused: (
                      ["sell_bench_packed_kernel", "sell_bench_spmm_kernel"]
                      if fused else ["sell_packed_kernel",
                                     "sell_packed_spmm_kernel"]))
        for name, config, kname in (("L1", "L1-packed", "sell_packed_kernel"),
                                    ("L2", "L2", "sell_split_kernel")):
            op, _ = ops[(name, "bfloat16")]
            ref, x = _oracle(np, torch, configs[name][1], "bfloat16")
            route = "streamy_packed" if name == "L1" else "split"
            _check(op.route == route, f"{name} with the switch runs on "
                   f"{op.route}, not {route}")
            _zero_counts(S)
            y = op(torch.from_numpy(x).to(DEVICE))
            torch.cuda.synchronize()
            what = f"{config} operator bfloat16 SMVP_SELL_PACK=1"
            n = _check_only(_counts(S), [kname], what)[kname]
            if name == "L1":
                launches[(kname, config, "bfloat16")] = n
                try:
                    op.bench_loop(torch.from_numpy(x).to(DEVICE), 2)
                except ValueError:
                    pass
                else:
                    _check(False, "L1-packed bench_loop was not refused")
            err = float(np.abs(y.double().cpu().numpy() - ref).max()
                        / np.abs(ref).max())
            _check(err <= TOL_ORACLE, f"{what}: oracle error {err}")
            print(f"[main] {what}: route {op.route}, launches {n} "
                  f"({kname})" + (", bench_loop refused" if name == "L1"
                                  else "") + f", vs float64 oracle "
                  f"{err:.3e}", flush=True)
    finally:
        del os.environ["SMVP_SELL_PACK"]


def phase_refine(np, torch, hp):
    """Phase 3 on hpcg104: ``refine_solve`` with three sweeps, each inner
    solve ``fused_cg(op, r, 300)`` (K9), the residual from the
    double-float CSR SpMV; held to a float64 relative residual."""
    from smvp_toolkit_tpu_torch.models import refine_solve
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg
    from smvp_toolkit_tpu_torch.ops.precision import df_to_f64

    a, csr, op = hp["a"], hp["csr"], hp["op"]
    b64 = hp["b"].double().cpu().numpy()
    _zero_counts(S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xh, xl, norms = refine_solve(csr, b64, num_refinements=3,
                                 inner=lambda r: fused_cg(op, r, 300))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _check_only(_counts(S), ["sell_cg_kernel"], "hpcg104-refine")
    _check(counts["sell_cg_kernel"] == 3, f"hpcg104-refine: {counts}")
    x64 = df_to_f64(xh, xl)
    rr = float(np.linalg.norm(b64 - a @ x64) / np.linalg.norm(b64))
    _check(bool(np.isfinite(rr)) and rr <= REFINE_RESIDUAL,
           f"hpcg104-refine: float64 relative residual {rr}")
    print(f"[main] hpcg104-refine API refine_solve(inner = fused_cg 300, "
          f"3 sweeps): {ms:.1f} ms, sweep residual norms "
          f"{', '.join(f'{v:.6e}' for v in norms)} (|b| "
          f"{np.linalg.norm(b64):.6e}), float64 relative residual "
          f"{rr:.3e}, launches {counts}", flush=True)


def phase_df64_timings(np, torch, configs, df64, launches, bw):
    """Phase 4 for K8 and its N-iteration kernel on smoke-df64 (N = 200)
    and smoke-df64-f64 (N = 100): the plain version on the card, and the
    library call ``torch.sparse.mm`` on a float64 CSR tensor of the same
    matrix with x = x_hi + x_lo in float64. Bound: the launch's bytes
    (``SellDf64SpMV.traffic_bytes``), or its float64 flops (4 per
    non-zero, 8 with a lo plane) over the float64 rate. Each kernel is
    held here, at these shapes, against its plain version (<= 2^-50 of
    max |y|; the N-iteration kernel with N = 3), and that error is its
    entry's ``max_abs_err``."""
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
    from smvp_toolkit_tpu_torch.ops.precision import df_to_f64

    r, c, _, shape = configs["smoke"][1]
    entries = []
    for config, n_iter in (("smoke-df64", ITERATIONS["smoke"]),
                           ("smoke-df64-f64", DF64_F64_ITERATIONS)):
        op, (xh, xl), v64 = df64[config]
        a = _library_csr(np, torch, (r, c, v64, shape), dtype=np.float64)
        x64 = (xh.double() + xl.double())[:, None]
        planes = op._planes(xh, xl)
        kw = dict(n_slices=op.plan.n_slices, chunk=op.plan.chunk)
        yp = df_to_f64(*D.sell_df64_plain(*planes, **kw))
        scale = float(np.abs(yp).max())
        errs = {}
        for fn, it in ((D.sell_df64, {}), (D.sell_bench_df64,
                                           {"iterations": 3})):
            yk = df_to_f64(*fn(*planes, **it, **kw))
            errs[fn.kernel] = float(np.abs(yk - yp).max())
            _check(bool(np.isfinite(yk).all())
                   and errs[fn.kernel] <= TOL_DF64_PLAIN * scale,
                   f"{fn.kernel} on {config} vs plain: max abs "
                   f"{errs[fn.kernel]} > 2^-50 of {scale}")
        print(f"[check] {config} df64 full size: sell_df64_kernel vs plain "
              f"{errs['sell_df64_kernel']:.3e}, sell_bench_df64_kernel "
              f"(N = 3) vs plain {errs['sell_bench_df64_kernel']:.3e} "
              f"(max abs; max |y| {scale:.6e})", flush=True)
        per_slot = 4 if op.vals_lo is None else 8
        for bench in (False, True):
            fn = D.sell_bench_df64 if bench else D.sell_df64
            plain = D.sell_bench_df64_plain if bench else D.sell_df64_plain
            it = {"iterations": n_iter} if bench else {}
            n = n_iter if bench else 1
            ms = _time_ms(lambda: fn(*planes, **it, **kw),
                          reps=3 if bench else 20, warmup=1 if bench else 2)
            plain_ms = _time_ms(lambda: plain(*planes, **it, **kw),
                                reps=1 if bench else 3,
                                warmup=0 if bench else 2)
            lib_ms = _time_ms(lambda: [torch.sparse.mm(a, x64)
                                       for _ in range(n)],
                              reps=1 if bench else 20, warmup=1)
            extra = {"body": "staged-slices"}
            if not bench:
                # the card's time alone, the host-paced times beside
                extra.update(host_paced_ms=ms, host_paced_library_ms=lib_ms)
                ms = _time_ms(lambda: fn(*planes, **kw), reps=20,
                              queued=True)
                lib_ms = _time_ms(lambda: torch.sparse.mm(a, x64), reps=20,
                                  queued=True)
            entries.append(_entry(
                fn.kernel, config, "df64",
                launches=launches[(fn.kernel, config, "df64")],
                err=errs[fn.kernel], ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                nbytes=op.traffic_bytes(), flops=per_slot * op.plan.nnz * n,
                bw=bw, iters=n, peak=F64_PEAK_FLOPS,
                lo_plane=op.vals_lo is not None, **extra))
        del a
    return entries


@contextlib.contextmanager
def _env(**kv):
    """Set the given SMVP_* switches for the block, then unset them."""
    os.environ.update(kv)
    try:
        yield
    finally:
        for k in kv:
            del os.environ[k]


def _start_cocluster(triplets):
    """Co-cluster the smoke matrix in a background thread (the refinement
    is host C++ called through ctypes, which lets the GIL go): minutes of
    host work that overlap the device phases. ``cocluster`` keeps the
    result in the process, so the co-clustered operators, the CLI run and
    the headline module that follow reuse it. Returns a function that
    waits for it and returns the result."""
    import threading

    from smvp_toolkit_tpu_torch.ops.cocluster import cocluster

    r, c, _, shape = triplets
    out = {}

    def work():
        t0 = time.perf_counter()
        try:
            out["res"] = cocluster(r, c, shape)
        except BaseException as e:  # re-raised by the waiter
            out["err"] = e
        out["s"] = time.perf_counter() - t0

    th = threading.Thread(target=work, name="cocluster-smoke", daemon=True)
    th.start()

    def wait():
        t0 = time.perf_counter()
        th.join()
        if "err" in out:
            raise out["err"]
        res = out["res"]
        print(f"[plan] smoke co-clustered in {out['s']:.1f} s of host time "
              f"(waited {time.perf_counter() - t0:.1f} s here): s_true "
              f"{res.s_true} sublanes against {res.s_true_natural} for the "
              f"natural order, {res.moves} moves, init {res.init}, padded "
              f"shape {res.shape_padded}", flush=True)
        return res

    return wait


def _subwin_planes(S, op):
    """K2-subwin's windows for ``op`` under the switch (raises if the plan
    is not eligible)."""
    with _env(SMVP_SELL_SUBWIN="1"):
        win = op.subwin_windows()
    _check(win is not None, f"{op.plan.chunk}-chunk plan: no sub-windows")
    return win


def _check_onehot(np, torch, S, label, op, errs=None):
    """K6 on ``op``'s dense operands against its plain version and against
    the route's K1 (K4) kernel, <= 1e-6 of max |y|."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        op.plan.shape[1]).astype(np.float32)).to(DEVICE)
    xt = op._x_tiles(x)
    vals, lidx, oht, seg = op.onehot_planes()
    xw = S.onehot_xw(xt, op.tile_base, op.plan.window_tiles)
    y = S.sell_onehot(xw, vals, lidx, oht, seg)
    yp = S.sell_onehot_plain(xw, vals, lidx, oht, seg)
    y1 = op.kernel(*op._planes(), xt, **op._kw())
    torch.cuda.synchronize()
    e, e1 = _rel_err(y, yp), _rel_err(y, y1)
    dname = str(op.value_dtype).replace("torch.", "")
    what = f"sell_onehot_kernel on {label} {dname}"
    _check(bool(torch.isfinite(y).all()), f"{what}: not finite")
    _check(e <= TOL_KERNEL, f"{what} vs plain: {e}")
    _check(e1 <= TOL_KERNEL, f"{what} vs {op.base_route}: {e1}")
    if errs is not None:
        errs[("sell_onehot_kernel", label, dname)] = (y - yp).abs().max(
            ).item()
    print(f"[check] {label:28s} {dname:9s} sell_onehot_kernel vs plain "
          f"{e:.3e}, vs {op.base_route} {e1:.3e} (oht {tuple(oht.shape)}, seg "
          f"{tuple(seg.shape)}, {(oht.numel() + seg.numel()) * 4} bytes)",
          flush=True)


def _check_subwin(np, torch, S, label, op, errs=None):
    """K2-subwin (N = 3) against its plain version and against K2 relsl on
    the same plan (<= 1e-6 of max |y|), and the control: stb shifted by 16
    tiles must miss that tolerance."""
    stb, ssb, split, sub_wt, sub_nsw = _subwin_planes(S, op)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        op.plan.shape[1]).astype(np.float32)).to(DEVICE)
    xt = op._x_tiles(x)
    planes = (op.vals, op.lidx, op.relsl, op.tile_base)
    kw = dict(split=split, sub_wt=sub_wt, sub_nsw=sub_nsw, iterations=3,
              **op._kw())
    y = S.sell_bench_subwin(*planes, stb, ssb, xt, **kw)
    yp = S.sell_bench_subwin_plain(*planes, stb, ssb, xt, **kw)
    y2 = S.sell_bench_loop(*planes, xt, iterations=3, **op._kw())
    bad = S.sell_bench_subwin(*planes, stb + 16, ssb, xt, **kw)
    torch.cuda.synchronize()
    e, e2, eb = _rel_err(y, yp), _rel_err(y, y2), _rel_err(bad, y2)
    dname = str(op.value_dtype).replace("torch.", "")
    what = f"sell_bench_subwin_kernel on {label} {dname}"
    _check(bool(torch.isfinite(y).all()), f"{what}: not finite")
    _check(e <= TOL_KERNEL, f"{what} vs plain: {e}")
    _check(e2 <= TOL_KERNEL, f"{what} vs sell_bench_kernel: {e2}")
    _check(eb > TOL_KERNEL, f"{what}: stb + 16 still within {TOL_KERNEL}")
    if errs is not None:
        errs[("sell_bench_subwin_kernel", label, dname)] = (
            y - yp).abs().max().item()
    print(f"[check] {label:28s} {dname:9s} sell_bench_subwin_kernel (N=3, "
          f"split {split}, sub_wt {sub_wt}/{op.plan.window_tiles}, sub_nsw "
          f"{sub_nsw}) vs plain {e:.3e}, vs sell_bench_kernel {e2:.3e}; "
          f"control stb + 16: {eb:.3e} (must exceed {TOL_KERNEL})",
          flush=True)


def phase_switch_kernels(np, torch, plans, ops, errs):
    """Phase 2 for K6 and K2-subwin: K6 on every small resident plan and
    on smoke (float32 and bfloat16), K2-subwin on the eligible small plan
    and on smoke, each with its control."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    for name, plan in plans:
        if name in ROUTE or plan.y_block_slices:
            continue
        for dname in DTYPE_NAMES:
            op = S.SellSpMV(plan, value_dtype=getattr(torch, dname),
                            device=DEVICE)
            _check_onehot(np, torch, S, name, op)
            if name == "random-rect-empty-rows":
                _check_subwin(np, torch, S, name, op)
    for dname in DTYPE_NAMES:
        op, _ = ops[("smoke", dname)]
        _check_onehot(np, torch, S, "smoke", op, errs)
        op._onehot = None  # 6 GB of dense operands; phase 4 rebuilds them
        _check_subwin(np, torch, S, "smoke", op, errs)


def _cc_operators(np, torch, triplets, result):
    """smoke-cc: the co-clustered f32 and bf16 operators, both from the
    process's one co-clustering of the matrix (``result``)."""
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    r, c, v, shape = triplets
    coo = COOMatrix.from_numpy(r, c, v, shape=shape, device="cpu")
    out = {}
    for dname in DTYPE_NAMES:
        t0 = time.perf_counter()
        op = S.CoClusteredSellSpMV(coo, value_dtype=getattr(torch, dname),
                                   device=DEVICE)
        _check(op.result is result, "smoke-cc co-clustered the matrix again")
        p = op.inner.plan
        print(f"[plan] smoke-cc {dname}: S {p.n_sublanes} in {p.n_chunks} "
              f"chunks of {p.chunk}, WT {p.window_tiles}, NS {p.n_slices}, "
              f"CT {p.n_coltiles}, occupancy {op.occupancy:.4f}; built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[dname] = op
    return out


def phase_cocluster(np, torch, configs, wait_cc, launches, errs):
    """Phase 3, smoke-cc: K1 and K2 on the co-clustered plan against their
    plain versions, then ``__call__`` and ``bench_loop(200)`` in both
    dtypes (natural y against the float64 oracle), and one CLI run
    ``-c --cocluster --fused`` in bf16 (K2 on the permuted planes only).
    Returns the operators and x for phase 4."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    triplets = configs["smoke"][1]
    result = wait_cc()
    _check(result.s_true < result.s_true_natural,
           f"co-clustering did not cut the sublanes: {result.s_true} >= "
           f"{result.s_true_natural}")
    nat = configs["smoke"][0]
    ccs = _cc_operators(np, torch, triplets, result)
    print(f"[main] smoke-cc occupancy {ccs['float32'].occupancy:.4f} "
          f"(co-clustered plan) against {nat.nnz / nat.slots():.4f} "
          f"(natural plan), {result.occupancy(nat.nnz):.4f} and "
          f"{nat.nnz / (result.s_true_natural * 128):.4f} unpadded",
          flush=True)
    out = {}
    n_iter = ITERATIONS["smoke"]
    for dname in DTYPE_NAMES:
        op = ccs[dname]
        inner = op.inner
        ref, x = _oracle(np, torch, triplets, dname)
        xd = torch.from_numpy(x).to(DEVICE)
        # K1 and K2 on the permuted planes against their plain versions
        xp = op.to_permuted(xd.to(inner.value_dtype))
        xt = inner._x_tiles(xp)
        y1 = S.sell_spmv(*inner._planes(), xt, **inner._kw())
        y2 = S.sell_bench_loop(*inner._planes(), xt, iterations=3,
                               **inner._kw())
        yp = S.sell_spmv_plain(*inner._planes(), xt, **inner._kw())
        torch.cuda.synchronize()
        e1, e2 = _rel_err(y1, yp), _rel_err(y2, yp)
        _check(e1 <= TOL_KERNEL and e2 <= TOL_KERNEL,
               f"K1/K2 on smoke-cc {dname} vs plain: {e1}, {e2}")
        errs[("sell_bench_kernel", "smoke-cc", dname)] = (
            y2 - yp).abs().max().item()
        print(f"[check] smoke-cc {dname:9s} sell_spmv_kernel vs plain "
              f"{e1:.3e}, sell_bench_kernel(N=3) vs plain {e2:.3e}",
              flush=True)
        scale = float(np.abs(ref).max())
        for bench in (False, True):
            _zero_counts(S)
            y = (op.from_permuted(op.bench_loop(xp, n_iter)) if bench
                 else op(xd))
            torch.cuda.synchronize()
            what = f"smoke-cc operator {dname} bench={bench}"
            kname = S.KERNEL_NAMES[("relsl", bench)]
            k = _check_only(_counts(S), [kname], what)[kname]
            launches[(kname, "smoke-cc", dname)] = k
            y = y.double().cpu().numpy()
            _check(y.shape == ref.shape and bool(np.isfinite(y).all()),
                   f"{what}: y shape {y.shape} or not finite")
            err = float(np.abs(y - ref).max()) / scale
            _check(err <= TOL_ORACLE, f"{what} oracle error {err}")
            print(f"[main] smoke-cc CoClusteredSellSpMV "
                  f"{'bench_loop(' + str(n_iter) + ')' if bench else '__call__'}"
                  f" {dname}: launches {k} ({kname}), vs float64 oracle "
                  f"{err:.3e}", flush=True)
        out[dname] = (op, xp)
    # the same bench_loop under SMVP_SELL_SUBWIN=1
    op, xp = out["float32"]
    with _env(SMVP_SELL_SUBWIN="1"):
        _check(op.inner.bench_route == "subwin", "smoke-cc under the "
               f"switch runs {op.inner.bench_route}")
        _zero_counts(S)
        y = op.from_permuted(op.bench_loop(xp, n_iter))
        torch.cuda.synchronize()
    k = _check_only(_counts(S), ["sell_bench_subwin_kernel"],
                    "smoke-cc bench_loop SMVP_SELL_SUBWIN=1")
    ref, _ = _oracle(np, torch, triplets, "float32")
    err = float(np.abs(y.double().cpu().numpy() - ref).max()
                / np.abs(ref).max())
    _check(err <= TOL_ORACLE, f"smoke-cc subwin oracle error {err}")
    print(f"[main] smoke-cc bench_loop({n_iter}) float32 "
          f"SMVP_SELL_SUBWIN=1: launches {k}, vs float64 oracle {err:.3e}",
          flush=True)
    # the CLI: co-clustered through the process's cocluster result
    _cli_runs(np, torch, "smoke-cc-cli", SMOKE_SPEC, ["-c", "--cocluster"],
              triplets, launches, config="smoke", dtypes=("bfloat16",),
              fused_modes=(True,), want=lambda fused: ["sell_bench_kernel"])
    return out


def phase_switches(np, torch, configs, launches):
    """Phase 3 under the JAX operator's switches, the smoke CLI each time:
    smoke-compat (``-c -n 10``, COMPAT=1: K6 only), smoke-subwin (``-c
    --fused -n 200``, SUBWIN=1: K2-subwin only), then ``-c -n 10`` under
    RELSL=0 (K4 only), SPLIT=4 (four K1 launches per call), SPMM=0 with
    ``--spmm 8`` (eight K1 launches per SpMM call) and LIDX32=1 (int32
    lane planes; the bytes printed)."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    plan, trip = configs["smoke"]
    calls = SWITCH_N + 3  # timed, two warm-up and the result call
    nch = plan.n_chunks
    ranges = -(-nch // -(-nch // min(SPLIT_N, nch)))  # 4 at smoke's 92
    with _env(SMVP_SELL_COMPAT="1"):
        _cli_runs(np, torch, "smoke-compat", SMOKE_SPEC, ["-c"], trip,
                  launches, config="smoke", n=SWITCH_N, fused_modes=(False,),
                  want=lambda fused: ["sell_onehot_kernel"],
                  count=lambda fused: {"sell_onehot_kernel": calls})
    with _env(SMVP_SELL_SUBWIN="1"):
        _cli_runs(np, torch, "smoke-subwin", SMOKE_SPEC, ["-c"], trip,
                  launches, config="smoke", fused_modes=(True,),
                  want=lambda fused: ["sell_bench_subwin_kernel"])
    with _env(SMVP_SELL_RELSL="0"):
        _cli_runs(np, torch, "smoke-relsl0", SMOKE_SPEC, ["-c"], trip,
                  launches, config="smoke", n=SWITCH_N, fused_modes=(False,),
                  dtypes=("float32",),
                  want=lambda fused: ["sell_split_kernel"])
    with _env(SMVP_SELL_SPLIT=str(SPLIT_N)):
        _cli_runs(np, torch, "smoke-split4", SMOKE_SPEC, ["-c"], trip,
                  launches, config="smoke", n=SWITCH_N, fused_modes=(False,),
                  dtypes=("float32",),
                  want=lambda fused: ["sell_spmv_kernel"],
                  count=lambda fused: {"sell_spmv_kernel": ranges * calls})
    with _env(SMVP_SELL_SPMM="0"):
        _cli_runs(np, torch, "smoke-spmm0", SMOKE_SPEC, ["-c"], trip,
                  launches, spmm=True, config="smoke", n=SWITCH_N,
                  fused_modes=(False,), dtypes=("float32",),
                  want=lambda fused: ["sell_spmv_kernel"],
                  count=lambda fused: {
                      "sell_spmv_kernel": calls + SPMM_K * calls})
    before = plan.traffic_bytes()
    with _env(SMVP_SELL_LIDX32="1"):
        after = plan.traffic_bytes()
        op = S.SellSpMV(plan, device=DEVICE)
        _check(op.lidx.dtype == torch.int32, f"LIDX32: {op.lidx.dtype}")
        _cli_runs(np, torch, "smoke-lidx32", SMOKE_SPEC, ["-c"], trip,
                  launches, config="smoke", n=SWITCH_N, fused_modes=(False,),
                  dtypes=("float32",),
                  want=lambda fused: ["sell_spmv_kernel"])
    del op
    _check(after - before == plan.n_sublanes * 128 * 3,
           f"LIDX32 bytes {before} -> {after}")
    print(f"[main] smoke SMVP_SELL_LIDX32=1: int32 lane planes; traffic_bytes "
          f"{before} -> {after} (+{after - before}, 3 bytes per slot)",
          flush=True)


def phase_headline():
    """Phase 3: the headline module in this process (its co-clustering
    comes from the process's cocluster result); prints its JSON line."""
    from smvp_toolkit_tpu_torch.bench import headline

    rec = headline.run()
    print(json.dumps(rec), flush=True)
    modes = [r["mode"] for r in rec["rungs"]]
    _check(modes == ["sell-cuda-gridfused-cc-bf16", "sell-cuda-gridfused-bf16",
                     "sell-cuda-gridfused"], f"headline rungs {modes}")
    for r in rec["rungs"]:
        _check(r["validation_err"] < headline.LIMIT, f"headline {r['mode']}: "
               f"{r['validation_err']}")
    print("[main] headline: " + "; ".join(
        f"{r['mode']} {r['value']:.1f} Mnnz/s ({r['avg_ms']:.6f} ms, "
        f"occupancy {r['occupancy']:.4f}, err {r['validation_err']:.3e})"
        for r in rec["rungs"]), flush=True)
    return rec


def _k2_ms(S, op, xt, n_iter):
    """K2's time per launch at ``n_iter`` on ``op``'s planes."""
    return _time_ms(lambda: S.sell_bench_loop(*op._planes(), xt,
                                              iterations=n_iter, **op._kw()),
                    reps=3, warmup=1)


def phase_switch_timings(np, torch, ops, ccs, errs, launches, configs, bw):
    """Phase 4 for K6 (smoke, both dtypes, one SpMV), K2-subwin (smoke,
    N = 200) and K2-cocluster (smoke-cc, N = 200). Library: the natural
    float32 CSR ``torch.sparse.mm``, N calls for N iterations. K6's bound
    is its bytes (the dense operands read once); its dense products'
    time at the float32 rate is printed beside it, but the kernel skips
    the one-hot zeros, so only the 2 flops per non-zero bound it."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    plan, triplets = configs["smoke"]
    a = _library_csr(np, torch, triplets)
    n_iter = ITERATIONS["smoke"]
    entries = []
    for dname in DTYPE_NAMES:
        op, x = ops[("smoke", dname)]
        x2 = x.float()[:, None]
        xt = op._x_tiles(x)
        vb = op.vals.element_size()
        vals, lidx, oht, seg = op.onehot_planes()
        xw = S.onehot_xw(xt, op.tile_base, plan.window_tiles)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (xw, vals, lidx, oht, seg)) + (
            plan.n_slices * 128 * 4)
        dense = 2.0 * plan.n_sublanes * 128 * (plan.window_tiles
                                               + plan.n_slices)
        ms = _time_ms(lambda: S.sell_onehot(xw, vals, lidx, oht, seg), reps=5)
        plain_ms = _time_ms(lambda: S.sell_onehot_plain(
            xw, vals, lidx, oht, seg), reps=2, warmup=1)
        lib_ms = _time_ms(lambda: torch.sparse.mm(a, x2), reps=20)
        entries.append(_entry(
            "sell_onehot_kernel", "smoke-compat", dname,
            launches=launches[("sell_onehot_kernel", "smoke-compat", dname)],
            err=errs[("sell_onehot_kernel", "smoke", dname)], ms=ms,
            plain_ms=plain_ms, lib_ms=lib_ms, nbytes=nbytes,
            flops=2.0 * plan.nnz, bw=bw,
            dense_flops_ms=dense / F32_PEAK_FLOPS * 1e3))
        op._onehot = None  # the dense operands: 6 GB at smoke
        del vals, lidx, oht, seg, xw
        stb, ssb, split, sub_wt, sub_nsw = _subwin_planes(S, op)
        planes = (op.vals, op.lidx, op.relsl, op.tile_base)
        kw = dict(split=split, sub_wt=sub_wt, sub_nsw=sub_nsw,
                  iterations=n_iter, **op._kw())
        ms = _time_ms(lambda: S.sell_bench_subwin(*planes, stb, ssb, xt,
                                                  **kw), reps=3, warmup=1)
        plain_ms = _time_ms(lambda: S.sell_bench_subwin_plain(
            *planes, stb, ssb, xt, **kw), reps=1, warmup=0)
        lib_ms = _time_ms(lambda: [torch.sparse.mm(a, x2)
                                   for _ in range(n_iter)], reps=1, warmup=1)
        entries.append(_entry(
            "sell_bench_subwin_kernel", "smoke-subwin", dname,
            launches=launches[("sell_bench_subwin_kernel", "smoke-subwin",
                               dname)],
            err=errs[("sell_bench_subwin_kernel", "smoke", dname)], ms=ms,
            plain_ms=plain_ms, lib_ms=lib_ms,
            nbytes=plan.traffic_bytes(vb, x_bytes=vb),
            flops=2.0 * plan.nnz * n_iter, bw=bw, iters=n_iter,
            split=split, sub_wt=sub_wt, sub_nsw=sub_nsw,
            body="warp-per-sublane"))
        print(f"[time] smoke-subwin {dname}: sell_bench_subwin_kernel "
              f"{ms / n_iter:.6f} ms per iteration = "
              f"{ms / _k2_ms(S, op, xt, n_iter):.3f} x sell_bench_kernel on "
              f"the same plan and N", flush=True)
        cc, xp = ccs[dname]
        inner = cc.inner
        xpt = inner._x_tiles(xp)
        e = _rel_err(S.sell_bench_loop(*inner._planes(), xpt,
                                       iterations=n_iter, **inner._kw()),
                     S.sell_spmv_plain(*inner._planes(), xpt, **inner._kw()))
        _check(e <= TOL_KERNEL, f"K2-cocluster {dname} at N = {n_iter} vs "
               f"one plain SpMV: {e}")
        ms = _time_ms(lambda: S.sell_bench_loop(
            *inner._planes(), xpt, iterations=n_iter, **inner._kw()),
            reps=3, warmup=1)
        k1_ms = _time_ms(lambda: S.sell_spmv(*inner._planes(), xpt,
                                             **inner._kw()),
                         reps=20, queued=True)
        print(f"[time] smoke-cc {dname}: sell_bench_kernel "
              f"{ms / n_iter:.6f} ms per iteration = "
              f"{ms / n_iter / k1_ms:.3f} x one sell_spmv_kernel launch "
              f"({k1_ms:.6f} ms, queued); N = {n_iter} vs plain {e:.3e}",
              flush=True)
        plain_ms = _time_ms(lambda: S.sell_bench_loop_plain(
            *inner._planes(), xpt, iterations=n_iter, **inner._kw()),
            reps=1, warmup=0)
        entries.append(_entry(
            "sell_bench_kernel", "smoke-cc", dname,
            launches=launches[("sell_bench_kernel", "smoke-cc", dname)],
            err=errs[("sell_bench_kernel", "smoke-cc", dname)], ms=ms,
            plain_ms=plain_ms, lib_ms=lib_ms,
            nbytes=inner.plan.traffic_bytes(vb, x_bytes=vb),
            flops=2.0 * inner.plan.nnz * n_iter, bw=bw, iters=n_iter,
            replaces=COCLUSTER_REPLACES, occupancy=cc.occupancy))
    del a
    return entries


# ---------------------------------------------------------------------------
# Distribution: smoke as row-block shards (smoke-dp4 on emulated ranks,
# smoke-dp1 on a real one-rank NCCL group), the torchrun entry points, and
# L2's load balance
# ---------------------------------------------------------------------------


def _dist_inputs(np, torch, triplets, dname):
    """The oracle's x (default_rng(1), bf16-rounded in bf16) on the card,
    the float64 oracle y, and the --spmm X (default_rng(0), likewise)."""
    ref, x = _oracle(np, torch, triplets, dname)
    X = np.random.default_rng(0).standard_normal(
        (triplets[3][1], SPMM_K)).astype(np.float32)
    if dname == "bfloat16":
        X = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
    dev = torch.device(DEVICE)
    return ref, torch.from_numpy(x).to(dev), torch.from_numpy(X).to(dev)


def _host_coo(torch, triplets, device="cpu"):
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    r, c, v, shape = triplets
    return COOMatrix.from_numpy(r, c, v, shape=shape, device=device)


def _dist_shards(torch, sh, dname):
    """Every rank's view of the sharding ``sh`` on the card in ``dname``
    (the host stacks do not depend on the value dtype)."""
    import dataclasses

    sh = dataclasses.replace(sh, value_dtype=getattr(torch, dname))
    return [sh.for_rank(k, torch.device(DEVICE)) for k in range(sh.n_shards)]


def _cat_rows(torch, sh, blocks, nrows):
    """The ranks' first rows_per_shard rows in the given order, trimmed."""
    return torch.cat([b[: sh.rows_per_shard] for b in blocks])[:nrows]


def _plain_grad(torch, csr, X, W):
    """X̄ of sum(W ∘ A·X) by autograd through the plain CSR SpMM."""
    from smvp_toolkit_tpu_torch.ops.spmv_torch import spmm_csr

    Xr = X.clone().requires_grad_(True)
    (spmm_csr(csr, Xr) * W).sum().backward()
    return Xr.grad


def phase_dist_kernels(np, torch, configs, ops):
    """smoke-dp4: smoke's matrix as 4 row-block shards at chunk 1024,
    launched rank by rank on the card. Per shard, K2-sharded (N = 3), K1,
    K4 on the shard's split planes (``SMVP_SELL_RELSL=0``) and K1 with k =
    8 against their plain versions; the shards' rows in
    rank order against the unsharded K2 (N = 3) and K1 (<= 1e-6) and the
    float64 oracle (<= 1e-5); in reverse order they must miss. The
    gradient of sum(W ∘ A·X) at k = 8 from the transpose shards (the sum
    of the ranks' A_kᵀ·W_k) against the plain autograd gradient. Returns
    the ranks per dtype and the transpose shards."""
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.parallel import sell_dist as SD
    from smvp_toolkit_tpu_torch.parallel.mesh import Mesh

    plan, trip = configs["smoke"]
    nrows, ncols = trip[3]
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    coo = _host_coo(torch, trip)
    emulated = Mesh(DIST_SHARDS, 0, dev)
    sh = SD.shard_sell(coo, emulated, chunk=DIST_CHUNK)
    t1 = time.perf_counter()
    sh_t = SD.shard_sell_transpose(coo, emulated, chunk=DIST_CHUNK)
    t2 = time.perf_counter()
    _check(sh.relsl is not None and sh.lidx.dtype == np.int8,
           "smoke-dp4: merged word and int8 lanes")
    print(f"[plan] smoke-dp4: {DIST_SHARDS} shards of {sh.rows_per_shard} "
          f"rows, chunk {sh.chunk}, S {sh.S}, WT {sh.WT}, NSl {sh.NSl}, CT "
          f"{sh.CT}, nnz per shard {list(sh.plan_nnz)}, planned in "
          f"{t1 - t0:.1f} s; transpose shards S {sh_t.S}, WT {sh_t.WT}, in "
          f"{t2 - t1:.1f} s", flush=True)
    out = {"sh": sh}
    for dname in DTYPE_NAMES:
        ref, x, X = _dist_inputs(np, torch, trip, dname)
        scale = float(np.abs(ref).max())
        ranks = _dist_shards(torch, sh, dname)
        op = ops[("smoke", dname)][0]
        y_k2, y_k1 = op.bench_loop(x, DIST_CHECK_N), op(x)
        ys, y1s, Ys, e_k2, e_k1, e_k4, e_mm = [], [], [], 0.0, 0.0, 0.0, 0.0
        for s in ranks:
            o = s.op
            kw = dict(n_slices=s.NSl, chunk=s.chunk)
            xt = o._x_tiles(x)
            planes = (o.vals, o.lidx, o.relsl, o.tile_base)
            y = SD._local_bench(s, x, DIST_CHECK_N)
            yp = S.sell_bench_loop_plain(*planes, xt,
                                         iterations=DIST_CHECK_N, **kw)
            y1, y1p = SD._local_spmv(s, x), S.sell_spmv_plain(*planes, xt,
                                                               **kw)
            with _env(SMVP_SELL_RELSL="0"):  # K4 on the shard's split planes
                y4 = SD._local_spmv(s, x)
            y4p = S.sell_split_plain(o.vals, o.lidx, *o.split_planes(),
                                     o.tile_base, xt, **kw)
            Y = SD._local_mat(s, X)
            Yp = S.sell_spmm_plain(*planes, o._block(X, s.CT * 128, o.vals
                                                     .dtype, "X"),
                                   **o._mat_kw())
            torch.cuda.synchronize()
            tol_mm, _ = _spmm_tolerance(torch, S, o)
            e_k2 = max(e_k2, _rel_err(y, yp))
            e_k1 = max(e_k1, _rel_err(y1, y1p))
            e_k4 = max(e_k4, _rel_err(y4, y4p))
            e = _rel_err(Y, Yp)
            e_mm = max(e_mm, e)
            _check(e <= tol_mm, f"smoke-dp4 {dname} shard {s.rank}: K1 "
                   f"k={SPMM_K} vs plain {e} (tolerance {tol_mm})")
            ys.append(y)
            y1s.append(y1)
            Ys.append(Y)
        yc = _cat_rows(torch, sh, ys, nrows)
        wrong = _cat_rows(torch, sh, ys[::-1], nrows)
        e_cat, e_wrong = _rel_err(yc, y_k2), _rel_err(wrong, y_k2)
        e_cat1 = _rel_err(_cat_rows(torch, sh, y1s, nrows), y_k1)
        e_or = float(np.abs(yc.double().cpu().numpy() - ref).max()) / scale
        ref_mat = _spmm_oracle(np, torch, trip, dname)
        Yc = _cat_rows(torch, sh, Ys, nrows).double().cpu().numpy()
        e_or_mm = float(np.abs(Yc - ref_mat).max() / np.abs(ref_mat).max())
        print(f"[check] smoke-dp4 {dname}: per shard vs plain K2-sharded "
              f"(N={DIST_CHECK_N}) {e_k2:.3e}, K1 {e_k1:.3e}, K4 (split "
              f"planes) {e_k4:.3e}, K1 k={SPMM_K} "
              f"{e_mm:.3e}; rank-order y vs "
              f"unsharded K2 {e_cat:.3e}, vs K1 {e_cat1:.3e}, vs float64 "
              f"oracle {e_or:.3e}, Y vs oracle {e_or_mm:.3e}; control "
              f"(reverse order) vs K2 {e_wrong:.3e}", flush=True)
        for what, e, tol in (("K2-sharded vs plain", e_k2, TOL_KERNEL),
                             ("K1 vs plain", e_k1, TOL_KERNEL),
                             ("K4 vs plain", e_k4, TOL_KERNEL),
                             ("y vs unsharded K2", e_cat, TOL_KERNEL),
                             ("y vs unsharded K1", e_cat1, TOL_KERNEL),
                             ("y vs oracle", e_or, TOL_ORACLE),
                             ("Y vs oracle", e_or_mm, TOL_ORACLE)):
            _check(e <= tol, f"smoke-dp4 {dname} {what}: {e}")
        _check(e_wrong > TOL_KERNEL, f"smoke-dp4 {dname}: the reversed "
               f"control did not miss ({e_wrong})")
        out[dname] = (ranks, x, ref)
        del ys, y1s, Ys
    # The gradient: X̄ = Aᵀ·W = Σ_k A_kᵀ·W_k on the transpose shards.
    t_ranks = _dist_shards(torch, sh_t, "float32")
    _, _, X = _dist_inputs(np, torch, trip, "float32")
    W = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (nrows, SPMM_K)).astype(np.float32)).to(dev)
    Wp = torch.nn.functional.pad(
        W, (0, 0, 0, sh_t.n_shards * sh_t.rows_per_shard - nrows))
    g = sum(SD._local_mat_t(s, Wp) for s in t_ranks)[:ncols]
    want = _plain_grad(torch, csr_encode(_host_coo(torch, trip, dev)), X, W)
    torch.cuda.synchronize()
    tol = max(_spmm_tolerance(torch, S, s.op)[0] for s in t_ranks)
    e = _rel_err(g, want)
    print(f"[check] smoke-dp4 gradient of sum(W*A.X), k={SPMM_K}, from "
          f"{len(t_ranks)} transpose shards vs plain autograd: {e:.3e} "
          f"(tolerance {tol:.3e})", flush=True)
    _check(e <= tol, f"smoke-dp4 gradient vs plain autograd: {e}")
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist_main(np, torch, configs, dist_shards, launches):
    """The distribution main path, counts zeroed before and read after
    each run: smoke-dp4's ranks' K2-sharded launches at N = 200, one
    after another on the card (4 per dtype, K2 only); then smoke-dp1, a
    real one-rank NCCL group in this process: the sharded SpMV (K1, NCCL
    all-gather), K2-sharded at N = 200, the SpMM and its gradient through
    ``differentiable_spmm_sharded`` (K1 with k = 8, NCCL all-reduce), the
    row-block CSR, the striped TJDS (NCCL all-reduce) and the 1 × 1 grid,
    each against the float64 oracle. Returns smoke-dp1's shards and the
    all-gather time of smoke's y."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.parallel import sell_dist as SD

    plan, trip = configs["smoke"]
    nrows = trip[3][0]
    sh = dist_shards["sh"]
    n_iter = ITERATIONS["smoke"]
    _zero_counts(S)
    SD.bench_loop_sharded.launches = 0
    for dname in DTYPE_NAMES:
        ranks, x, ref = dist_shards[dname]
        y = _cat_rows(torch, sh, [SD._local_bench(s, x, n_iter)
                                  for s in ranks], nrows)
        torch.cuda.synchronize()
        e = float(np.abs(y.double().cpu().numpy() - ref).max()) / float(
            np.abs(ref).max())
        print(f"[main] smoke-dp4 {dname}: {len(ranks)} ranks' K2-sharded "
              f"(N={n_iter}) in turn, y vs float64 oracle {e:.3e}",
              flush=True)
        _check(e <= TOL_ORACLE, f"smoke-dp4 {dname} N={n_iter}: {e}")
    counts = _counts(S)
    got = _check_only(counts, ["sell_bench_kernel"], "smoke-dp4 main path")
    _check(got["sell_bench_kernel"] == SD.bench_loop_sharded.launches
           == DIST_SHARDS * len(DTYPE_NAMES),
           f"smoke-dp4 launches {got}, bench_loop_sharded "
           f"{SD.bench_loop_sharded.launches}")
    for dname in DTYPE_NAMES:
        launches[("sell_bench_kernel", "smoke-dp4", dname)] = DIST_SHARDS
    return _dist_nccl(np, torch, trip, launches)


def _dist_nccl(np, torch, trip, launches):
    import torch.distributed as dist

    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.parallel import (
        differentiable_spmm_sharded,
        distributed_init,
        make_mesh,
        make_mesh_2d,
        shard_csr,
        shard_csr_2d,
        shard_sell,
        shard_sell_transpose,
        shard_tjds,
        spmm_sell_sharded,
        spmv_csr_2d,
        spmv_csr_sharded,
        spmv_sell_sharded,
        spmv_tjds_sharded,
    )
    from smvp_toolkit_tpu_torch.parallel import sell_dist as SD
    from smvp_toolkit_tpu_torch.parallel.mesh import gather_rows

    nrows, ncols = trip[3]
    n_iter = ITERATIONS["smoke"]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1")
    with _env(**env):
        t0 = time.perf_counter()
        _check(distributed_init(device=DEVICE),
               "distributed_init() with WORLD_SIZE=1")
        t1 = time.perf_counter()
    try:
        backend = "nccl" if torch.device(DEVICE).type == "cuda" else "gloo"
        _check(dist.get_backend() == backend and distributed_init(),
               f"one-rank group: backend {dist.get_backend()}, a second "
               "init must keep it")
        mesh = make_mesh(device=DEVICE)
        coo = _host_coo(torch, trip)
        t2 = time.perf_counter()
        sh1 = shard_sell(coo, mesh, chunk=DIST_CHUNK)
        sh1_t = shard_sell_transpose(coo, mesh, chunk=DIST_CHUNK)
        t3 = time.perf_counter()
        print(f"[plan] smoke-dp1: NCCL group of 1 rank on {mesh.device} "
              f"(init {t1 - t0:.1f} s), one shard, chunk {sh1.chunk}, S "
              f"{sh1.S}, WT {sh1.WT}; with its transpose planned in "
              f"{t3 - t2:.1f} s", flush=True)
        coo_card = _host_coo(torch, trip, mesh.device)
        csr = csr_encode(coo_card)
        tj = tjds_encode(coo_card)
        ranks = {"float32": [sh1]}
        ranks["bfloat16"] = _dist_shards(torch, sh1, "bfloat16")
        results = {}
        _zero_counts(S)
        SD.bench_loop_sharded.launches = 0
        for dname in DTYPE_NAMES:
            ref, x, X = _dist_inputs(np, torch, trip, dname)
            s = ranks[dname][0]
            results[(dname, "spmv_sell_sharded")] = (
                spmv_sell_sharded(s, x, mesh), ref)
            results[(dname, "bench_loop_sharded")] = (
                SD.bench_loop_sharded(s, x, mesh, n_iter), ref)
        ref, x, X = _dist_inputs(np, torch, trip, "float32")
        results[("float32", "spmm_sell_sharded")] = (
            spmm_sell_sharded(sh1, X, mesh),
            _spmm_oracle(np, torch, trip, "float32"))
        W = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (nrows, SPMM_K)).astype(np.float32)).to(mesh.device)
        f = differentiable_spmm_sharded(sh1, sh1_t, mesh)
        Xr = X.clone().requires_grad_(True)
        (f(Xr) * W).sum().backward()
        want = _plain_grad(torch, csr, X, W)
        results[("float32", "spmv_csr_sharded")] = (
            spmv_csr_sharded(shard_csr(csr, mesh), x, mesh), ref)
        results[("float32", "spmv_tjds_sharded")] = (
            spmv_tjds_sharded(shard_tjds(tj, mesh), x, mesh), ref)
        grid = make_mesh_2d(1, 1, device=DEVICE)
        results[("float32", "spmv_csr_2d")] = (
            spmv_csr_2d(shard_csr_2d(csr, grid), x, grid), ref)
        torch.cuda.synchronize()
        counts = _counts(S)
        got = _check_only(counts, ["sell_spmv_kernel", "sell_bench_kernel",
                                   "sell_spmm_kernel"], "smoke-dp1 main path")
        _check(SD.bench_loop_sharded.launches == len(DTYPE_NAMES),
               f"smoke-dp1 bench_loop_sharded launches "
               f"{SD.bench_loop_sharded.launches}")
        for dname in DTYPE_NAMES:
            launches[("sell_bench_kernel", "smoke-dp1", dname)] = 1
        tol, _ = _spmm_tolerance(torch, S, sh1_t.op)
        e_grad = _rel_err(Xr.grad, want)
        line = []
        for (dname, fn), (y, ref) in results.items():
            y = y.double().cpu().numpy()
            _check(y.shape == ref.shape and bool(np.isfinite(y).all()),
                   f"smoke-dp1 {fn} {dname}: shape {y.shape}")
            e = float(np.abs(y - ref).max() / np.abs(ref).max())
            line.append(f"{fn} {dname} {e:.3e}")
            _check(e <= TOL_ORACLE, f"smoke-dp1 {fn} {dname}: {e}")
        print(f"[main] smoke-dp1 (NCCL, 1 rank): launches {got}; vs float64 "
              f"oracle: {', '.join(line)}; differentiable_spmm_sharded "
              f"gradient vs plain autograd {e_grad:.3e} (tolerance "
              f"{tol:.3e})", flush=True)
        _check(e_grad <= tol, f"smoke-dp1 gradient: {e_grad}")
        y = results[("float32", "spmv_sell_sharded")][0]
        ag_ms = _time_ms(lambda: gather_rows(y, 1, mesh.group), reps=20)
        ar_ms = _time_ms(lambda: dist.all_reduce(y, group=mesh.group),
                         reps=20)
        print(f"[dist] NCCL one-rank all_gather of smoke's y ({y.numel()} "
              f"float32): {ag_ms:.6f} ms, all_reduce {ar_ms:.6f} ms (one "
              "card: no link crossed)", flush=True)
    finally:
        dist.destroy_process_group()
    return {"ranks": ranks, "allgather_ms": ag_ms, "allreduce_ms": ar_ms}


def phase_dist_entry_points(np, torch, configs):
    """``torchrun --standalone --nproc_per_node 1`` on the runner
    (``parallel.launch``, --alg csr and tjds, -n 100: its checksum against
    the float64 sum of the matrix, x = ones) and on the CLI (``-c -t
    --shards 1 -n 10``), each in a subprocess."""
    r, c, v, shape = configs["smoke"][1]
    want = float(np.asarray(v, np.float64).sum())
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m"]
    dev = ["--device", torch.device(DEVICE).type]
    for argv in (["smvp_toolkit_tpu_torch.parallel.launch", SMOKE_SPEC,
                  "--alg", "csr", "-n", str(LAUNCH_N), *dev],
                 ["smvp_toolkit_tpu_torch.parallel.launch", SMOKE_SPEC,
                  "--alg", "tjds", "-n", str(LAUNCH_N), *dev],
                 ["smvp_toolkit_tpu_torch.cli", "-c", "-t", "--shards", "1",
                  "-n", "10", "--no-report", *dev, SMOKE_SPEC]):
        t0 = time.perf_counter()
        proc = subprocess.run(run + argv, cwd=root, env=env,
                              capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        what = "torchrun " + " ".join(argv)
        _check(proc.returncode == 0, f"{what}: rc {proc.returncode}\n"
               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        data = [ln for ln in proc.stdout.splitlines() if "[DATA]" in ln]
        m = re.search(r"y checksum \[process 0\]: (\S+)", proc.stdout)
        if "launch" in argv[0]:
            _check(m is not None, f"{what}: no checksum line")
            got = float(m.group(1))
            e = abs(got - want) / abs(want)
            _check(e <= TOL_ORACLE, f"{what}: checksum {got} vs {want}")
            data.append(f"checksum {got} vs float64 sum {want:.9g} "
                        f"({e:.3e})")
        else:
            _check(len(data) >= 3, f"{what}: {data}")
        print(f"[main] {what}: rc 0 in {wall:.1f} s; " + " | ".join(
            ln.split("\t", 1)[-1] for ln in data), flush=True)


def phase_dist_balance(np, torch, configs):
    """L2's power-law matrix as 4 row-block CSR shards (emulated ranks)
    with equal rows and with equal non-zeros: each shard's non-zeros and
    the time of its local SpMV, and the rank-order y against the float64
    oracle."""
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.parallel.mesh import Mesh
    from smvp_toolkit_tpu_torch.parallel.spmv_dist import (
        _local_csr,
        shard_csr,
    )

    trip = configs["L2"][1]
    dev = torch.device(DEVICE)
    csr = csr_encode(_host_coo(torch, trip, dev))
    ref, x = _oracle(np, torch, trip, "float32")
    x = torch.from_numpy(x).to(dev)
    for balance in ("rows", "nnz"):
        sh = shard_csr(csr, Mesh(DIST_SHARDS, 0, dev), balance=balance)
        ends = sh.nnz_starts[1:] + (sh.nnz,)
        nnz = [e - s for s, e in zip(sh.nnz_starts, ends)]
        blocks, ms = [], []
        for k in range(DIST_SHARDS):
            s = sh.for_rank(k, dev)
            ms.append(_time_ms(lambda: _local_csr(s, x), reps=20))
            blocks.append(_local_csr(s, x)[: sh.block_rows()[k]])
        y = torch.cat(blocks).double().cpu().numpy()
        e = float(np.abs(y - ref).max() / np.abs(ref).max())
        print(f"[main] L2 shard_csr balance={balance}: rows per shard "
              f"{list(sh.block_rows())}, nnz per shard {nnz} (max/mean "
              f"{max(nnz) / (sum(nnz) / len(nnz)):.3f}), local ms "
              f"{[round(t, 6) for t in ms]} (max/mean "
              f"{max(ms) / (sum(ms) / len(ms)):.3f}), y vs float64 oracle "
              f"{e:.3e}", flush=True)
        _check(e <= TOL_ORACLE, f"L2 balance={balance}: {e}")


def phase_dist_timings(np, torch, configs, dist_shards, dp1, launches, bw):
    """Phase 4 for K2-sharded (``bench_loop_sharded`` → ``sell_bench_kernel``)
    at N = 200: each smoke-dp4 shard's launch and smoke-dp1's, f32 / bf16.
    Bound: the shard plan's bytes over the memory rate, or 2·nnz·N flops
    over the float32 rate; library: ``torch.sparse.mm`` on the shard's
    row-block float32 CSR, N calls."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    r, c, v, shape = configs["smoke"][1]
    n_iter = ITERATIONS["smoke"]
    entries = []
    for config, ranks_of in (("smoke-dp4", lambda d: dist_shards[d][0]),
                             ("smoke-dp1", lambda d: dp1["ranks"][d])):
        libs = {}
        for dname in DTYPE_NAMES:
            x = dist_shards[dname][1]
            for s in ranks_of(dname):
                o = s.op
                blk = s.rows_per_shard
                if s.rank not in libs:
                    sel = (r >= s.rank * blk) & (r < (s.rank + 1) * blk)
                    a = _library_csr(np, torch, (r[sel] - s.rank * blk,
                                                 c[sel], v[sel],
                                                 (blk, shape[1])))
                    x2 = dist_shards["float32"][1][:, None]
                    libs[s.rank] = _time_ms(lambda: [
                        torch.sparse.mm(a, x2) for _ in range(n_iter)],
                        reps=1, warmup=1)
                    del a
                xt = o._x_tiles(x)
                planes = (o.vals, o.lidx, o.relsl, o.tile_base)
                kw = dict(n_slices=s.NSl, chunk=s.chunk, iterations=n_iter)
                ms = _time_ms(lambda: S.sell_bench_loop(*planes, xt, **kw),
                              reps=3, warmup=1)
                if config == "smoke-dp4":
                    k1_ms = _time_ms(lambda: S.sell_spmv(
                        *planes, xt, n_slices=s.NSl, chunk=s.chunk), reps=20,
                        queued=True)
                    print(f"[time] smoke-dp4 shard {s.rank} {dname}: "
                          f"sell_spmv_kernel (warp per sublane, "
                          f"{_sublane_blocks(o.plan)} blocks) {k1_ms:.6f} ms "
                          f"per launch; sell_bench_kernel (warp per sublane) "
                          f"{ms / n_iter:.6f} ms per iteration = "
                          f"{ms / n_iter / k1_ms:.3f} x one sell_spmv_kernel "
                          f"launch; {n_iter} x K1 {n_iter * k1_ms:.6f} ms "
                          f"against {ms:.6f} ms", flush=True)
                plain_ms = _time_ms(lambda: S.sell_bench_loop_plain(
                    *planes, xt, **kw), reps=1, warmup=0)
                yk = S.sell_bench_loop(*planes, xt, **kw)
                yp = S.sell_bench_loop_plain(*planes, xt, **kw)
                err = (yk - yp).abs().max().item()
                _check(_rel_err(yk, yp) <= TOL_KERNEL,
                       f"{config} shard {s.rank} {dname} N={n_iter}: "
                       f"K2-sharded vs plain {_rel_err(yk, yp)}")
                nnz = s.plan_nnz[s.rank]
                vb = o.vals.element_size()
                entries.append(_entry(
                    "sell_bench_kernel", f"{config}/shard{s.rank}", dname,
                    launches=launches[("sell_bench_kernel", config, dname)]
                    // len(ranks_of(dname)),
                    err=err, ms=ms, plain_ms=plain_ms, lib_ms=libs[s.rank],
                    nbytes=o.plan.traffic_bytes(vb, x_bytes=vb),
                    flops=2.0 * nnz * n_iter, bw=bw, iters=n_iter,
                    replaces=DIST_REPLACES, wrapper="bench_loop_sharded",
                    shard_nnz=nnz, shards=s.n_shards,
                    allgather_ms=dp1["allgather_ms"]))
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
        regs, spills, spilled = _ptxas_summary(logs)
        print(f"[build] {len(logs)} source(s) built: {sorted(logs)}; "
              f"registers per thread: {regs}; spill stores {spills} bytes "
              f"(most in one type instance: {spilled})", flush=True)
        print("[regs] warp-per-sublane kernels, forward and N-iteration "
              "(K9's on both routes, K10's and K11's SpMV phases among "
              "them), the k-column ones (K5 and K2 with k columns among "
              "them), K7 by slice and K8 on staged slices (most over their "
              "value and index types, lo plane and column shapes): "
              + "; ".join(
                  f"{k} {regs.get(k)} registers, spill stores "
                  f"{spilled.get(k, 0)} bytes"
                  for k in WARP_PER_SUBLANE + KCOL_PER_SUBLANE + BY_SLICE
                  + STAGED_SLICES),
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
        from smvp_toolkit_tpu_torch.ops.spmv_df64 import bench_df64_blocks

        grid["sell_bench_packed_kernel"] = S.bench_packed_blocks()
        grid["sell_bench_df64_kernel"] = bench_df64_blocks(torch.int8)
        print(f"[grid] bench kernels' cooperative grid (blocks of 256 "
              f"threads, sell_bench_df64_kernel's of 128; int8 lane "
              f"indices): {grid}", flush=True)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for r in S.ROUTES:
            rgrid = {(d, str(lt)[6:]): S.bench_blocks(getattr(torch, d), lt,
                                                      route=r)
                     for d in DTYPE_NAMES for lt in (torch.int8, torch.int32)}
            _check(all(b == SUBLANE_BLOCKS_PER_SM * sms
                       for b in rgrid.values()),
                   f"{S.KERNEL_NAMES[(r, True)]} grid {rgrid}, not "
                   f"{SUBLANE_BLOCKS_PER_SM} blocks on each of {sms} SMs")
            print(f"[grid] {S.KERNEL_NAMES[(r, True)]} (warp per sublane): "
                  f"{rgrid} blocks of 256 threads, "
                  f"{SUBLANE_BLOCKS_PER_SM} per SM", flush=True)
        _check(grid["sell_bench_packed_kernel"] == SUBLANE_BLOCKS_PER_SM * sms,
               f"sell_bench_packed_kernel grid "
               f"{grid['sell_bench_packed_kernel']}, not "
               f"{SUBLANE_BLOCKS_PER_SM} blocks on each of {sms} SMs")

    with _Phase("plans"):
        configs = _configs(np)
        wait_cc = _start_cocluster(configs["smoke"][1])
        plans = _small_plans(np) + [(n, p) for n, (p, _) in configs.items()]
        gcn = _gcn_graph(np, torch)
    with _Phase("kernels vs plain"):
        ops, errs = phase_kernels(np, torch, plans, gcn)
    with _Phase("warp-per-sublane kernels: contract plans, Inf, switches"):
        phase_streamy(np, torch, plans, ops)
    with _Phase("df64 and packed kernels vs plain"):
        phase_new_kernels(np, torch, plans, ops, errs)
    with _Phase("one-hot and sub-window kernels vs plain"):
        phase_switch_kernels(np, torch, plans, ops, errs)
    del plans
    with _Phase("solver kernels vs plain"):
        phase_solver_kernels(np, torch)
    launches = phase_main_path(np, torch, configs)
    with _Phase("main path: smoke-cisr"):
        phase_cisr(np, torch, configs, launches)
    with _Phase("main path: smoke-df64, smoke-df64-f64"):
        df64 = phase_df64(np, torch, configs, ops, launches)
    with _Phase("main path: smoke-packed, L1-packed, L2 gate"):
        phase_packed(np, torch, configs, ops, launches)
    with _Phase("main path: gcn_arxiv"):
        phase_gcn(np, torch, gcn, launches)
    with _Phase("main path: hpcg104"):
        hpcg = phase_hpcg(np, torch, launches)
    with _Phase("main path: hpcg104-refine"):
        phase_refine(np, torch, hpcg)
    with _Phase("main path: smoke-cc"):
        ccs = phase_cocluster(np, torch, configs, wait_cc, launches, errs)
    with _Phase("main path: switches"):
        phase_switches(np, torch, configs, launches)
    with _Phase("main path: headline"):
        phase_headline()
    with _Phase("distribution: smoke-dp4 kernels vs plain"):
        dist_shards = phase_dist_kernels(np, torch, configs, ops)
    with _Phase("main path: smoke-dp4, smoke-dp1 (NCCL)"):
        dp1 = phase_dist_main(np, torch, configs, dist_shards, launches)
    with _Phase("main path: torchrun entry points"):
        phase_dist_entry_points(np, torch, configs)
    with _Phase("main path: L2 load balance"):
        phase_dist_balance(np, torch, configs)
    with _Phase("timings"):
        from smvp_toolkit_tpu_torch.bench.roofline import hbm_bandwidth_gbs

        bw = hbm_bandwidth_gbs(torch.device(DEVICE)) * 1e9
        entries = phase_timings(np, torch, ops, errs, launches, configs, bw)
        entries += phase_mat_timings(np, torch, ops, errs, launches, configs,
                                     gcn, bw)
        entries += phase_solver_timings(np, torch, hpcg, launches, bw)
        entries += phase_df64_timings(np, torch, configs, df64, launches, bw)
        entries += phase_switch_timings(np, torch, ops, ccs, errs, launches,
                                        configs, bw)
        entries += phase_dist_timings(np, torch, configs, dist_shards, dp1,
                                      launches, bw)

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
