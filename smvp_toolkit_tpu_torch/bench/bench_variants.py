"""Times the N-iteration body's variants against the kept kernels on a card.

Run from the root of a checkout on a machine with one CUDA card:

    python -m smvp_toolkit_tpu_torch.bench.bench_variants [--out FILE]

It builds ``csrc/variants/sell_bench_variants.cu`` (the package's nvcc
flags, into ``build/kernels``) beside the package's own kernels. The
variants are the warp-per-sublane N-iteration body of ``csrc/sell_bench.cu``
with one thing changed each (that file's header lists them): one barrier
an iteration over two y buffers or two barriers around one y, cached or
L1-bypassing plane loads instead of streaming ones, a dynamic walk of the
work items, and, on the merged-word routes, the one-thread-per-slot body
those kernels ran before.

With ``--vgrad`` it times the values-gradient kernel K7 against its
variants (``csrc/variants/sell_vals_grad_variants.cu``: the
one-thread-per-slot walk K7 ran before, a per-run form on the k-column
body's staging, the by-slice body without the shared-memory copy of G,
with its gathers per column block as first written, with eight column
blocks a load round, and walking the lanes with G held in registers)
and the kept kernel and the by-slice variants on schedules of other unit
caps (64, 32 and 16 sublanes),
against ``torch.sparse.sampled_addmm`` on A's pattern (beta 0), on
gcn_arxiv's A at k = 256 and 40 (float32), all queued behind a spin
kernel; each first held to the plain version within 1e-6 of max |plane|.
With ``--subwin`` it times K2-subwin's forms on smoke's plan under its
sub-chain windows (split 4) at N = 200, float32 and bfloat16: the kept
kernel (two y buffers, one barrier an iteration), the same body with one
buffer and two barriers, and the one-thread-per-slot walk it ran before,
against K2 (``sell_bench_loop``) on the same plan and N calls of
``torch.sparse.mm``; each form first held at N = 3 to the plain version
(<= 1e-6 of max |y|).

With ``--kcol`` it times the k-column body's variants instead
(``csrc/variants/sell_spmm_variants.cu``: another column shape, no
run-summing, eight blocks an SM, and the one-thread-per-slot warp walk K1
and K4 with k columns ran before) against the kept K1 / K4 with k columns
and ``torch.sparse.mm`` on a float32 CSR tensor, all queued behind a spin
kernel: smoke and L2 at k = 8 (float32 and bfloat16) and gcn_arxiv's A
(K4) and Aᵀ (K1) at k = 256 and 40 (float32; ``chip_smoke.py``'s graph:
``gcn_norm(synth_powerlaw(169_343, 2_315_598, seed=0))``). Every variant
is first held to the plain version within the SpMM tolerance of the plan
(max(1e-6, 2·2^-24·√n), n the most products a row sums).

With ``--packed`` it times K5 (``csrc/variants/sell_packed_variants.cu``:
the one-thread-per-slot walk K5 ran before, the kept body built beside it,
the warp-per-sublane body with rel decoded per slot instead of staged
from lane 0, and rel taken from lane 0's loaded word by a warp shuffle
instead of a staging load) against the kept kernel and
``torch.sparse.mm`` on a float32 CSR tensor on smoke-packed (resident y)
and L1-packed (streamed y), bf16, all queued behind a spin kernel; each
first held to the plain version within 1e-6 of max |y|. On smoke-packed
it then times K2-packed's forms at N = 200 (the same file: the
one-thread-per-slot walk it ran before, K2's body under K5's staging of
lane 0's word, ``PackedStage``, and the kept body built beside them, rel
from lane 0's loaded word by a warp shuffle, ``PackedShuffle``) against
the kept kernel and N calls of
``torch.sparse.mm``, each form first held at N = 1, 2 and 3 to the plain
version, on the operator's plane and on one whose lanes 1..127 carry
another rel than lane 0's (``disagreeing_lanes``; there the old walk must
miss by more than 1e-3). Then K5 with k columns' forms at k = 8 (the same
file: the one-thread-per-slot warp walk it ran before, ``mat_sweep``
under ``PackedLaneZero``, the k-column body under K5's staging of lane 0's
word, ``PackedStage``, and the kept body built beside them, rel taken in
step 1 from the loaded lane-0 word by a warp shuffle, ``PackedShuffle``)
against the kept kernel and ``torch.sparse.mm`` on a float32 CSR
tensor with k columns, all queued behind a spin kernel, each first held to
the plain version within the plan's SpMM tolerance, on the operator's
plane and on ``disagreeing_lanes``'. With ``--solver`` it times K9
(``csrc/variants/sell_solver_variants.cu``: the one-thread-per-slot SpMV
phase it ran before, the kept warp-per-sublane phase built beside it, and
that phase gathering through L2 only) at hpcg104 (HPCG's 27-point stencil
on 104³, ``chip_smoke.py``'s matrix), 300 steps, float32, against the
kept kernel, its plain version and the scan loop over ``torch.sparse.mm``
(``models.solvers.conjugate_gradient``), and on the split planes of
Poisson 256² widened to a window of 512 tiles (``chip_smoke.py`` phase
2's plan), 300 steps, against the kept kernel and its plain version; then
K10 (the same file and forms) at hpcg104, 600 steps, against the kept
kernel, its plain version and the scan loop (``models.solvers.
chebyshev``); each first held at 30 steps to the plain version (<= 1e-4
of max |x|); then K11 (the same file: its three SpMV
phases on the old thread-per-slot walk, the kept warp-per-sublane item
ranges, and those gathering through L2 only) at hpcg104, 100 steps,
sweeps 4, against the kept kernel, its plain version and the scan loop
over ``torch.sparse.mm`` (``models.solvers.pcg_precond`` with
``ic0_preconditioner``), each first held at 30 steps to the plain version
(<= 1e-4). With ``--kbench`` it times K2 with k columns
(``csrc/variants/sell_spmm_variants.cu``: the one-thread-per-slot warp
walk it ran before, the k-column body with one Y buffer and two barriers
an iteration, and with two buffers and one barrier) at smoke, k = 8, N =
200, float32 and bfloat16, against the kept kernel and N calls of
``torch.sparse.mm`` on a float32 CSR tensor, each form first held at N =
1, 2 and 3 to the plain version (the SpMM tolerance of the plan). With
``--df64`` it times K8
(``csrc/variants/sell_df64_variants.cu``: the row walk K8 ran before and
the staged body with U = 1, 2, 4, 8 steps in flight and one or two slices
a block) against the kept kernel and ``torch.sparse.mm`` on a float64 CSR
tensor on smoke-df64 (float32 values, no lo plane) and smoke-df64-f64
(float64 values, a lo plane), queued behind a spin kernel; each first
held to the plain version bit for bit. With ``--onehot`` it times K6
(``csrc/variants/sell_onehot_variants.cu``: the dense-operand kernel K6
ran before, on the JAX launch's one-hot operands built once on the card,
the walk K6 was first written with, K8's staged body, with U = 1, 2, 4, 8
steps in flight and one or two slices a block, and the kept body, one warp
per slice with four rows a thread, at U = 1, 2, 4, 8)
against the kept kernel and ``torch.sparse.mm`` on a float32 CSR tensor
on smoke (merged word) and L2 (split planes, a window of 2,000 tiles),
float32 and bfloat16, all queued behind a spin kernel; the kept kernel
and the dense one are first held to the plain version within 1e-6 of max
|y|, and the kept kernel to the dense one and every form to the kept
kernel bit for bit.

Configurations (``chip_smoke.py``'s full-size ones, chunk 2048): smoke
(``synth:1000000:10000000``, resident y, merged word), L1
(``synth:4194304:41943040``, streamed y, merged word), L2
(``synth_powerlaw(1_000_000, 10_000_000, seed=0)``, resident y, split
planes), L3 (``synth_powerlaw(4_000_000, 40_000_000, seed=0)``, streamed
y, split planes), and smoke as 4 row-block shards at chunk 1024
(smoke-dp4, ``shard_sell``), float32 and bfloat16. For each: the kept
kernel at N = 1, 2, 3 and every variant at N = 3 against the plain
version (<= 1e-6 of max |y|; it exits non-zero otherwise), then, in turns
(forward order, then reversed), the route's forward kernel (queued behind
a spin kernel, as ``chip_smoke.py`` times K1), the kept N-iteration
kernel through its wrapper (``wrapper``) and every variant, at N = 200
(smoke, shards) or 100 (L1-L3). Each case prints one ``[variant]`` line
per kernel: ms per
launch in each turn, ms per iteration, and that over one forward launch.
With ``--out``, one JSON object of every time goes there.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["VARIANTS", "ONE_BUFFER", "KCOL_VARIANTS", "KCOL_SHAPES",
           "VGRAD_VARIANTS", "VGRAD_CAPS", "VGRAD_SCHEDULED", "VGRAD_K",
           "SUBWIN_FORMS", "PACKED_VARIANTS", "PACKED_BENCH_FORMS",
           "DF64_VARIANTS", "DF64_FORMS", "SOLVER_VARIANTS",
           "SOLVER_LAUNCHERS", "PACKED_SPMM_FORMS", "KBENCH_FORMS",
           "plane_pointers", "vgrad_pointers", "packed_pointers",
           "df64_pointers", "kcol_cases", "spmm_tolerance",
           "disagreeing_lanes", "ONEHOT_VARIANTS", "ONEHOT_FORMS",
           "ONEHOT_CONFIGS", "build_onehot_variants", "onehot_dense_launcher",
           "onehot_variant_launcher", "main"]

# Variant ids of sell_bench_variants.cu.
VARIANTS = {"barrier1": 0, "barrier2": 1, "cached": 2, "nol1": 3,
            "dynamic": 4, "slot": 5}
# Variants that leave the result in y[0] (the others in y[(N - 1) % 2]).
ONE_BUFFER = ("barrier2", "slot")
SMOKE_SPEC = "synth:1000000:10000000"
L1_SPEC = "synth:4194304:41943040"
ITERATIONS = {"smoke": 200, "L1": 100, "L2": 100, "L3": 100, "shard": 200}
SHARDS, SHARD_CHUNK = 4, 1024
TOL = 1e-6
REPS, FORWARD_REPS = 3, 20
SPIN_CYCLES = 50_000_000  # about 25 ms: longer than the host takes to queue
_VARIANTS_DIR = Path(__file__).resolve().parent.parent / "csrc" / "variants"
_SRC = _VARIANTS_DIR / "sell_bench_variants.cu"
_KCOL_SRC = _VARIANTS_DIR / "sell_spmm_variants.cu"
_VGRAD_SRC = _VARIANTS_DIR / "sell_vals_grad_variants.cu"
_PACKED_SRC = _VARIANTS_DIR / "sell_packed_variants.cu"
_DF64_SRC = _VARIANTS_DIR / "sell_df64_variants.cu"
_SOLVER_SRC = _VARIANTS_DIR / "sell_solver_variants.cu"
_ONEHOT_SRC = _VARIANTS_DIR / "sell_onehot_variants.cu"
# Variant ids of sell_solver_variants.cu (K9, K10 and K11) and each
# solver's launcher there, hpcg104's grid and steps (K10; K9 at CG_STEPS,
# K11 at IC0_STEPS, IC0_SWEEPS sweeps), and K9's split-plane check: Poisson
# POISSON_N² widened to a window of POISSON_WINDOW tiles.
SOLVER_VARIANTS = {"walk": 0, "body": 1, "ldcg": 2}
SOLVER_LAUNCHERS = {"K9": "sell_cg_variant_launch",
                    "K10": "sell_chebyshev_variant_launch",
                    "K11": "sell_pcg_ic0_variant_launch"}
HPCG_N, SOLVER_STEPS, SOLVER_CHECK_STEPS = 104, 600, 30
CG_STEPS = 300
POISSON_N, POISSON_WINDOW = 256, 512
IC0_STEPS, IC0_SWEEPS = 100, 4
SOLVER_TOL = 1e-4
# K2 with k columns' forms of sell_spmm_variants.cu
# (sell_bench_spmm_variant_launch) and the Y buffer each leaves its result
# in (None: buffer 0); smoke's k and N.
KBENCH_FORMS = {"walk": 0, "buffers1": 1, "buffers2": 2}
KBENCH_K, KBENCH_N = 8, 200
# Variant ids of sell_packed_variants.cu (K5) and its configurations: the
# full-size plan each reuses; K2-packed's forms there and the y buffer
# each leaves its result in (None: buffer 0).
PACKED_VARIANTS = {"walk": 0, "body": 1, "perslot": 2, "shfl": 3}
PACKED_BENCH_FORMS = {"walk": 0, "staged": 1, "shfl": 2}
PACKED_BENCH_N = 200
# K5 with k columns' forms there (sell_packed_spmm_variant_launch) and k.
PACKED_SPMM_FORMS = {"walk": 0, "staged": 1, "shfl": 2}
PACKED_SPMM_K = 8
PACKED_CONFIGS = {"smoke-packed": "smoke", "L1-packed": "L1"}
# Variant ids of sell_df64_variants.cu (K8) and the staged forms timed:
# (U steps in flight, S slices a block).
DF64_VARIANTS = {"walk": 0, "staged": 1}
DF64_FORMS = tuple((u, sl) for sl in (1, 2) for u in (1, 2, 4, 8))
DF64_CONFIGS = ("smoke-df64", "smoke-df64-f64")
# Variant ids of sell_onehot_variants.cu's sell_onehot_variant_launch (K6)
# and the forms timed: (variant, U steps in flight, S slices a block; the
# warp form takes no S); its configurations.
ONEHOT_VARIANTS = {"staged": 0, "warp": 1}
ONEHOT_FORMS = (tuple(("staged", u, sl) for sl in (1, 2) for u in (1, 2, 4, 8))
                + tuple(("warp", u, 0) for u in (1, 2, 4, 8)))
ONEHOT_CONFIGS = ("smoke", "L2")
# Variant ids of sell_vals_grad_variants.cu; the schedule caps timed on
# the kept kernel beside its own (spmv_sell.VG_CAP); the k values timed.
VGRAD_VARIANTS = {"walk": 0, "run": 1, "nostage": 2, "block": 3, "rows8": 4,
                  "lanes": 5}
VGRAD_CAPS = (64, 32, 16)
# The variants on the by-slice schedule, timed on every cap beside the
# kept one too.
VGRAD_SCHEDULED = ("nostage", "block", "rows8", "lanes")
VGRAD_K = (256, 40)
# K2-subwin's forms of sell_bench_variants.cu (sell_bench_subwin_variant_
# launch) and the y buffer each leaves its result in (None: buffer 0).
SUBWIN_FORMS = {"walk": 0, "buffers1": 1, "buffers2": 2}
SUBWIN_N = 200
# Variant ids of sell_spmm_variants.cu; per k the column shapes (T, P)
# timed beside the kept one (``spmv_sell.spmm_shape``) at the kept run cap,
# and the run caps timed beside it at the kept shape; with ``--sweep``,
# every shape of KCOL_SWEEP at every cap.
KCOL_VARIANTS = {"shape": 0, "nosum": 1, "slots": 2, "blocks8": 3}
KCOL_CAP = 16  # sell_common.cuh, kMatRunCap
KCOL_CAPS = (4, 8, 16, 64)
KCOL_SHAPES = {8: ((2, 1), (1, 4)), 40: ((2, 5), (8, 2)),
               256: ((16, 4), (32, 2))}
KCOL_SWEEP = {8: ((1, 2), (2, 1), (1, 1), (1, 4)),
              40: ((4, 4), (2, 5), (4, 3), (8, 2), (16, 1), (2, 4)),
              256: ((8, 4), (16, 4), (32, 2), (4, 4), (2, 4))}
KCOL_K = {"smoke": (8,), "L2": (8,), "gcn_arxiv:A": (256, 40),
          "gcn_arxiv:At": (256, 40)}
GCN_NODES, GCN_EDGES = 169_343, 2_315_598
_SIGNATURES = {
    "sell_bench_variant_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "sell_bench_variant_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_VGRAD_SIGNATURES = {
    "sell_vals_grad_variant_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_SIGNATURES["sell_bench_subwin_variant_launch"] = (ctypes.c_int, [
    ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p])
_PACKED_SIGNATURES = {
    "sell_packed_variant_launch": (ctypes.c_int, [ctypes.c_int] + [
        ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]),
    "sell_bench_packed_variant_launch": (ctypes.c_int, [ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "sell_packed_spmm_variant_launch": (ctypes.c_int, [ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_DF64_SIGNATURES = {
    "sell_df64_variant_launch": (ctypes.c_int, [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_ONEHOT_SIGNATURES = {
    "sell_onehot_dense_launch": (ctypes.c_int, [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "sell_onehot_variant_launch": (ctypes.c_int, [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_KCOL_SIGNATURES = {
    "sell_spmm_variant_launch": (ctypes.c_int, [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]),
    "sell_bench_spmm_variant_launch": (ctypes.c_int, [ctypes.c_int] + [
        ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _build_variants(src: Path = _SRC, signatures: dict = _SIGNATURES):
    """A variants library and ptxas's report of its kernels."""
    from smvp_toolkit_tpu_torch.ops import _build

    out = _build.build_dir() / f"lib{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise _build.KernelBuildError(f"{' '.join(cmd)}\n{proc.stdout}"
                                      f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib, proc.stdout + proc.stderr


def _registers(log: str) -> Dict[str, int]:
    """Most registers per kernel family in ptxas's report."""
    import re

    regs, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            entry = ("slot_kernel" if "slot_kernel" in name else
                     "slots_kernel" if "slots_kernel" in name else
                     f"variant {m2.group(1)}" if (m2 := re.search(
                         r"variant_kernelILi(\d)", name)) else name)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            regs[entry] = max(regs.get(entry, 0), int(m.group(1)))
    return regs


def _time_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean ms per call from CUDA events; with ``queued`` the calls are
    queued behind a spin kernel, so the host's work per call does not pace
    the card (chip_smoke.py's ``_time_ms``)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel(a, b) -> float:
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale else diff


def plane_pointers(op, route: str) -> list:
    """The six plane pointers of ``sell_bench_variant_launch`` (the order
    of ``sell_bench_launch``: vals, lidx, the merged word or rel_tile,
    slice_of, tile_base, y_block_id), None where ``route`` has no such
    plane."""
    names = (("vals", "lidx", "meta", "tile_base", "ybid")
             if route in ("relsl", "streamy_relsl") else
             ("vals", "lidx", "meta", "slice", "tile_base", "ybid"))
    planes = dict(zip(names, op._planes(route)))
    return [planes[k].data_ptr() if k in planes else None
            for k in ("vals", "lidx", "meta", "slice", "tile_base", "ybid")]


def _launcher(torch, lib, S, op, route, xt):
    """fn(variant, iterations) -> y for one operator's planes."""
    kw = op._kw()
    n_out = kw["n_slices"] * S.LANES
    counters = torch.zeros(2, dtype=torch.int32, device=op.device)
    ptr = plane_pointers(op, route)
    vk = int(op.vals.dtype == torch.bfloat16)

    def run(variant: str, iterations: int):
        ys = torch.empty(2, n_out, dtype=torch.float32, device=op.device)
        rc = lib.sell_bench_variant_launch(
            VARIANTS[variant], S._ROUTE_IDS[route], *ptr, xt.data_ptr(),
            ys.data_ptr(), counters.data_ptr(), op.vals.numel(), n_out,
            kw["chunk"], kw.get("nsb", 0), iterations, vk,
            op.device.index or 0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant {variant} on {route}: CUDA error "
                               f"{rc} ({lib.sell_error_string(rc).decode()})")
        return ys[0 if variant in ONE_BUFFER else (iterations - 1) % 2]

    return run


def _cases(torch, names):
    """(name, operator per dtype, N) of the configurations."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.parallel import sell_dist as SD
    from smvp_toolkit_tpu_torch.parallel.mesh import Mesh
    from smvp_toolkit_tpu_torch.utils.synth import (
        parse_synth_spec,
        synth_powerlaw,
    )

    dev = torch.device("cuda", 0)
    makers = {
        "smoke": lambda: parse_synth_spec(SMOKE_SPEC, device="cpu"),
        "L1": lambda: parse_synth_spec(L1_SPEC, device="cpu"),
        "L2": lambda: synth_powerlaw(1_000_000, 10_000_000, seed=0,
                                     device="cpu"),
        "L3": lambda: synth_powerlaw(4_000_000, 40_000_000, seed=0,
                                     device="cpu"),
    }
    for name in names:
        t0 = time.perf_counter()
        coo = makers["smoke" if name == "smoke-dp4" else name]()
        if name == "smoke-dp4":
            sh = SD.shard_sell(coo, Mesh(SHARDS, 0, dev), chunk=SHARD_CHUNK)
            print(f"[plan] smoke-dp4: {SHARDS} shards, chunk {sh.chunk}, in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for k in range(SHARDS):
                ops = {d: dataclasses.replace(
                    sh, value_dtype=getattr(torch, d)).for_rank(k, dev).op
                    for d in ("float32", "bfloat16")}
                yield f"smoke-dp4/shard{k}", ops, ITERATIONS["shard"]
            continue
        rr, cc, vv = coo.to_numpy()
        plan = S._auto_plan(rr, cc, vv, coo.shape)
        print(f"[plan] {name}: S {plan.n_sublanes} in {plan.n_chunks} chunks "
              f"of {plan.chunk}, WT {plan.window_tiles}, NS {plan.n_slices}, "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        ops = {d: S.SellSpMV(plan, value_dtype=getattr(torch, d), device=dev)
               for d in ("float32", "bfloat16")}
        yield name, ops, ITERATIONS[name]
        del ops


def run(names: List[str]) -> dict:
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    _build.build(["sell_spmv", "sell_bench"])
    lib, log = _build_variants()
    print(f"[regs] variants: {_registers(log)}", flush=True)
    print("[grid] " + ", ".join(
        f"{v} {r} {d}: {_blocks(lib, VARIANTS[v], S._ROUTE_IDS[r], i)}"
        for v in ("barrier1", "slot") for r in S.ROUTES[:2]
        for i, d in enumerate(("f32", "bf16"))), flush=True)
    out = {}
    for name, ops, n_iter in _cases(torch, names):
        for dname, op in ops.items():
            route = op.base_route
            fwd, bench = S._ROUTE_FNS[route]
            plain = getattr(S, fwd.__name__ + "_plain")
            planes, kw = op._planes(route), op._kw()
            x = torch.from_numpy(np.random.default_rng(1).standard_normal(
                op.plan.shape[1]).astype(np.float32)).to(op.device)
            xt = op._x_tiles(x)
            launch = _launcher(torch, lib, S, op, route, xt)
            variants = [v for v in VARIANTS if v != "slot"
                        or route in ("relsl", "streamy_relsl")]
            yp = plain(*planes, xt, **kw)
            errs = {f"kept N={n}": _rel(bench(*planes, xt, iterations=n,
                                              **kw), yp) for n in (1, 2, 3)}
            errs.update({v: _rel(launch(v, 3), yp) for v in variants})
            torch.cuda.synchronize()
            bad = {k: e for k, e in errs.items() if not e <= TOL}
            if bad:
                raise SystemExit(f"bench_variants: {name} {dname}: {bad}")
            fns = {"forward": (lambda: fwd(*planes, xt, **kw)),
                   "wrapper": (lambda: bench(*planes, xt, iterations=n_iter,
                                             **kw))}
            fns.update({v: (lambda v=v: launch(v, n_iter)) for v in variants})
            times = {k: [] for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for k in order:
                    times[k].append(_time_ms(
                        torch, fns[k], FORWARD_REPS if k == "forward" else
                        REPS, queued=k == "forward"))
            f_ms = min(times["forward"])
            print(f"[variant] {name} {dname} ({route}, N = {n_iter}, "
                  f"{S.KERNEL_NAMES[(route, False)]} {f_ms:.6f} ms; errors "
                  f"{max(errs.values()):.3e})", flush=True)
            for k, t in times.items():
                per = min(t) / (1 if k == "forward" else n_iter)
                print(f"[variant]   {k:9s} "
                      f"{' / '.join(f'{v:.6f}' for v in t)} ms per launch; "
                      f"{per:.6f} ms per iteration = {per / f_ms:.3f} x one "
                      f"forward launch", flush=True)
            out[f"{name}/{dname}"] = dict(route=route, iterations=n_iter,
                                          ms=times, errors=errs)
        del ops
        torch.cuda.empty_cache()
    return out


def spmm_tolerance(plan) -> tuple:
    """max(1e-6, 2·2^-24·√n), n the most products one row of Y sums
    (chip_smoke.py's ``_spmm_tolerance``), and n."""
    live = (plan.rel_tile.reshape(-1) >= 0) & (plan.slice_of.reshape(-1) >= 0)
    nz = (plan.vals.reshape(-1, 128) != 0) & live[:, None]
    rows = (plan.slice_of.reshape(-1)[:, None].astype(np.int64) * 128
            + np.arange(128))
    n = int(np.bincount(rows[nz]).max()) if nz.any() else 0
    return max(TOL, 2 * 2.0 ** -24 * n ** 0.5), n


def _library_csr(torch, triplets, dev, dtype=None):
    """``torch.sparse.mm``'s CSR operand of the triplets (float32, or
    ``dtype``), duplicates summed."""
    import scipy.sparse as sp

    r, c, v, shape = triplets
    npt = np.float64 if dtype == torch.float64 else np.float32
    a = sp.csr_matrix((np.asarray(v, npt), (r, c)), shape=shape)
    a.sum_duplicates()
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(a.indices.astype(np.int64)).to(dev),
        torch.from_numpy(a.data).to(dev), size=shape)


def kcol_cases(torch, names):
    """(name, operator per dtype, host triplets, k values) of the k-column
    configurations."""
    from smvp_toolkit_tpu_torch.models import gcn_norm
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.utils.synth import (
        parse_synth_spec,
        synth_powerlaw,
    )

    dev = torch.device("cuda", 0)
    gcn = [n for n in names if n.startswith("gcn_arxiv")]
    for name in names:
        if name in gcn:
            continue
        coo = (parse_synth_spec(SMOKE_SPEC, device="cpu") if name == "smoke"
               else synth_powerlaw(1_000_000, 10_000_000, seed=0,
                                   device="cpu"))
        rr, cc, vv = coo.to_numpy()
        plan = S._auto_plan(rr, cc, vv, coo.shape)
        ops = {d: S.SellSpMV(plan, value_dtype=getattr(torch, d), device=dev)
               for d in ("float32", "bfloat16")}
        yield name, ops, (rr, cc, vv, coo.shape), KCOL_K[name]
        del ops
    if gcn:
        s = gcn_norm(synth_powerlaw(GCN_NODES, GCN_EDGES, seed=0,
                                    device=dev))
        op = S.sell_op_csr(s)
        for name in gcn:
            o = op if name == "gcn_arxiv:A" else op.transpose()
            r, c, v = o._triplets
            yield name, {"float32": o}, (r, c, v, o.shape), KCOL_K[name]


def run_kcol(names: List[str], sweep: bool = False) -> dict:
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    _build.build(["sell_spmm"])
    lib, log = _build_variants(_KCOL_SRC, _KCOL_SIGNATURES)
    print(f"[regs] k-column variants: {_registers(log)}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, ops, triplets, ks in kcol_cases(torch, names):
        a = _library_csr(torch, triplets, torch.device("cuda", 0))
        for dname, op in ops.items():
            route = op.base_route
            fn = S._SPMM_FNS[route]
            plain = getattr(S, fn.__name__ + "_plain")
            planes, kw = op._planes(route), op._mat_kw()
            ptr = plane_pointers(op, route)[:5]
            tol, n_max = spmm_tolerance(op.plan)
            for k in ks:
                X = torch.from_numpy(np.random.default_rng(k).standard_normal(
                    (op.shape[1], k)).astype(np.float32)).to(op.device)
                Xt = op._block(X, op.plan.n_coltiles * S.LANES,
                               op.value_dtype, "X")

                def launch(variant, t=0, p=0, cap=KCOL_CAP):
                    Y = torch.zeros(kw["n_slices"] * S.LANES, k,
                                    dtype=torch.float32, device=op.device)
                    rc = lib.sell_spmm_variant_launch(
                        KCOL_VARIANTS[variant], S._ROUTE_IDS[route], t, p,
                        cap, *ptr, Xt.data_ptr(), Y.data_ptr(), op.vals.numel(),
                        kw["chunk"], k, int(op.vals.dtype == torch.bfloat16),
                        op.device.index or 0, stream)
                    if rc:
                        raise RuntimeError(
                            f"k-column variant {variant} ({t}, {p}) on "
                            f"{route}: CUDA error {rc} "
                            f"({lib.sell_error_string(rc).decode()})")
                    return Y

                t, _, p = S.spmm_shape(k)
                fns = {"kept": lambda: fn(*planes, Xt, **kw),
                       "library": lambda: torch.sparse.mm(a, X),
                       "slots": lambda: launch("slots"),
                       "nosum": lambda: launch("nosum", t, p),
                       "blocks8": lambda: launch("blocks8", t, p)}
                for cap in KCOL_CAPS:
                    if cap != KCOL_CAP:
                        fns[f"cap{cap}"] = (lambda cap=cap:
                                            launch("shape", t, p, cap))
                for tt, pp in KCOL_SHAPES.get(k, ()):
                    fns[f"T{tt}P{pp}"] = (lambda tt=tt, pp=pp:
                                          launch("shape", tt, pp))
                if sweep:
                    for (tt, pp), cap in itertools.product(KCOL_SWEEP[k],
                                                           KCOL_CAPS):
                        fns[f"T{tt}P{pp}c{cap}"] = (
                            lambda tt=tt, pp=pp, cap=cap:
                            launch("shape", tt, pp, cap))
                    for tt, pp in KCOL_SWEEP[k]:
                        fns[f"T{tt}P{pp}b8"] = (lambda tt=tt, pp=pp:
                                                launch("blocks8", tt, pp))
                yp = plain(*planes, Xt, **kw)
                errs = {v: _rel(f(), yp) for v, f in fns.items()
                        if v != "library"}
                torch.cuda.synchronize()
                bad = {v: e for v, e in errs.items() if not e <= tol}
                if bad:
                    raise SystemExit(f"bench_variants: {name} {dname} k={k}: "
                                     f"{bad} > {tol}")
                times = {v: [] for v in fns}
                for order in (list(fns), list(fns)[::-1]):
                    for v in order:
                        times[v].append(_time_ms(torch, fns[v], FORWARD_REPS,
                                                 queued=True))
                kept = min(times["kept"])
                print(f"[kcol] {name} {dname} k={k} ({route}, shape T{t} "
                      f"P{p}; errors {max(errs.values()):.3e} <= {tol:.2e}, "
                      f"rows of up to {n_max} products)", flush=True)
                for v, tv in times.items():
                    print(f"[kcol]   {v:9s} {' / '.join(f'{x:.6f}' for x in tv)}"
                          f" ms; {min(tv) / kept:.3f} x kept", flush=True)
                out[f"{name}/{dname}/k{k}"] = dict(route=route, shape=[t, p],
                                                   ms=times, errors=errs)
                del X, Xt, yp
        del a, ops
        torch.cuda.empty_cache()
    return out


def vgrad_pointers(op, X, G, out, schedule) -> list:
    """The ten pointers of ``sell_vals_grad_variant_launch`` (the order of
    ``sell_vals_grad_launch``): lidx, the merged word or rel_tile,
    slice_of (None on the merged word), tile_base, X, G, the output plane
    and the schedule's order, unit_start and unit_slice."""
    meta = (op.relsl,) if op.relsl is not None else op.split_planes()
    planes = [op.lidx, meta[0], meta[1] if len(meta) > 1 else None,
              op.tile_base, X, G, out, schedule.order, schedule.unit_start,
              schedule.unit_slice]
    return [None if t is None else t.data_ptr() for t in planes]


def _gcn_a(torch):
    """gcn_arxiv's A (``chip_smoke.py``'s graph) on the card."""
    from smvp_toolkit_tpu_torch.models import gcn_norm
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

    t0 = time.perf_counter()
    op = S.sell_op_csr(gcn_norm(synth_powerlaw(
        GCN_NODES, GCN_EDGES, seed=0, device=torch.device("cuda", 0))))
    print(f"[plan] gcn_arxiv:A: S {op.plan.n_sublanes}, route {op.route}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return op


def run_vgrad(ks=VGRAD_K) -> dict:
    """K7's variants on gcn_arxiv's A (float32) at each k of ``ks``."""
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    _build.build(["sell_vals_grad"])
    lib, log = _build_variants(_VGRAD_SRC, _VGRAD_SIGNATURES)
    print(f"[regs] vgrad variants: {_registers(log)}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    op = _gcn_a(torch)
    plan, kw = op.plan, op._mat_kw()
    meta = dict(relsl=op.relsl, rel=op.rel, slice_of=op.slice_of)
    route = "relsl" if op.relsl is not None else "split"
    kept = op.vals_grad_schedule()
    rel, sl = (S._decode_word(op.relsl) if op.relsl is not None
               else op.split_planes())
    scheds = {cap: S.vals_grad_schedule(rel, sl, cap=cap)
              for cap in VGRAD_CAPS}
    print(f"[plan] gcn_arxiv:A K7 schedule: {kept.n_units} units of at most "
          f"{kept.cap} sublanes, built in {kept.seconds:.4f} s; " + ", ".join(
              f"cap {c}: {v.n_units} units" for c, v in scheds.items()),
          flush=True)
    r, c, v = op._triplets
    a = _library_csr(torch, (r, c, v, op.shape), op.device)
    out = {}
    for k in ks:
        rng = np.random.default_rng(k)
        X = torch.from_numpy(rng.standard_normal(
            (plan.n_coltiles * S.LANES, k)).astype(np.float32)).to(op.device)
        G = torch.from_numpy(rng.standard_normal(
            (plan.n_slices * S.LANES, k)).astype(np.float32)).to(op.device)
        Xtr = X[: op.shape[1]].t().contiguous()
        Gr = G[: op.shape[0]].contiguous()

        def launch(variant, sched=kept):
            o = torch.empty(op.lidx.shape, dtype=torch.float32,
                            device=op.device)
            rc = lib.sell_vals_grad_variant_launch(
                VGRAD_VARIANTS[variant], S._ROUTE_IDS[route],
                *vgrad_pointers(op, X, G, o, sched), sched.n_units,
                op.lidx.numel(), kw["chunk"], k, 0,
                int(op.lidx.dtype == torch.int32), op.device.index or 0,
                stream)
            if rc:
                raise RuntimeError(f"vgrad variant {variant}: CUDA error {rc} "
                                   f"({lib.sell_error_string(rc).decode()})")
            return o

        fns = {"kept": lambda: S.sell_vals_grad(
            op.lidx, op.tile_base, X, G, schedule=kept, **meta, **kw)}
        fns.update({f"cap{cap}": (lambda sc=sc: S.sell_vals_grad(
            op.lidx, op.tile_base, X, G, schedule=sc, **meta, **kw))
            for cap, sc in scheds.items() if cap != kept.cap})
        fns.update({name: (lambda name=name: launch(name))
                    for name in VGRAD_VARIANTS})
        fns.update({f"{name}@{cap}": (lambda name=name, sc=sc:
                                      launch(name, sc))
                    for name in VGRAD_SCHEDULED
                    for cap, sc in scheds.items() if cap != kept.cap})
        fns["library"] = lambda: torch.sparse.sampled_addmm(a, Gr, Xtr,
                                                            beta=0.0)
        ref = S.sell_vals_grad_plain(op.lidx, op.tile_base, X, G, **meta,
                                     **kw)
        errs = {name: _rel(f(), ref) for name, f in fns.items()
                if name != "library"}
        torch.cuda.synchronize()
        bad = {name: e for name, e in errs.items() if not e <= TOL}
        if bad:
            raise SystemExit(f"bench_variants: vgrad k={k}: {bad} > {TOL}")
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(_time_ms(torch, fns[name], FORWARD_REPS,
                                            queued=True))
        best = min(times["kept"])
        print(f"[vgrad] gcn_arxiv:A float32 k={k} ({route}; errors "
              f"{max(errs.values()):.3e} <= {TOL})", flush=True)
        for name, t in times.items():
            print(f"[vgrad]   {name:10s} {' / '.join(f'{x:.6f}' for x in t)}"
                  f" ms; {min(t) / best:.3f} x kept", flush=True)
        out[f"gcn_arxiv:A/float32/k{k}"] = dict(route=route, ms=times,
                                                errors=errs)
        del X, G, Xtr, Gr, ref
    return out


def run_subwin() -> dict:
    """K2-subwin's forms on smoke's plan under its windows, against K2."""
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    _build.build(["sell_bench"])
    lib, _ = _build_variants()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    coo = parse_synth_spec(SMOKE_SPEC, device="cpu")
    rr, cc, vv = coo.to_numpy()
    plan = S._auto_plan(rr, cc, vv, coo.shape)
    split = S.subwin_split(plan.chunk)
    stb, ssb, sub_wt, sub_nsw = S._sub_windows(plan, split)
    stb = torch.from_numpy(stb).to(dev)
    ssb = torch.from_numpy(ssb).to(dev)
    print(f"[plan] smoke-subwin: split {split}, sub_wt {sub_wt}, sub_nsw "
          f"{sub_nsw}", flush=True)
    a = _library_csr(torch, (rr, cc, vv, coo.shape), dev)
    wkw = dict(split=split, sub_wt=sub_wt, sub_nsw=sub_nsw)
    out = {}
    for dname in ("float32", "bfloat16"):
        op = S.SellSpMV(plan, value_dtype=getattr(torch, dname), device=dev)
        planes, kw = (op.vals, op.lidx, op.relsl, op.tile_base), op._kw()
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            plan.shape[1]).astype(np.float32)).to(dev)
        xt, x2 = op._x_tiles(x), x[:, None]
        n_out = kw["n_slices"] * S.LANES

        def form(name, n):
            ys = torch.empty(2, n_out, dtype=torch.float32, device=dev)
            rc = lib.sell_bench_subwin_variant_launch(
                SUBWIN_FORMS[name], *(t.data_ptr() for t in planes),
                stb.data_ptr(), ssb.data_ptr(), xt.data_ptr(), ys.data_ptr(),
                op.vals.numel(), n_out, kw["chunk"], split, sub_wt, sub_nsw,
                n, int(dname == "bfloat16"), 0, stream)
            if rc:
                raise RuntimeError(f"subwin form {name}: CUDA error {rc} "
                                   f"({lib.sell_error_string(rc).decode()})")
            return ys[(n - 1) % 2 if name == "buffers2" else 0]

        fns = {"kept": lambda n: S.sell_bench_subwin(
            *planes, stb, ssb, xt, iterations=n, **wkw, **kw)}
        fns.update({name: (lambda n, name=name: form(name, n))
                    for name in SUBWIN_FORMS})
        fns["K2"] = lambda n: S.sell_bench_loop(*planes, xt, iterations=n,
                                                **kw)
        ref = S.sell_bench_subwin_plain(*planes, stb, ssb, xt, iterations=1,
                                        **wkw, **kw)
        errs = {name: _rel(f(3), ref) for name, f in fns.items()}
        torch.cuda.synchronize()
        bad = {name: e for name, e in errs.items() if not e <= TOL}
        if bad:
            raise SystemExit(f"bench_variants: subwin {dname}: {bad}")
        fns["library"] = lambda n: [torch.sparse.mm(a, x2) for _ in range(n)]
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(_time_ms(
                    torch, lambda: fns[name](SUBWIN_N), REPS))
        best = min(times["kept"])
        print(f"[subwin] smoke {dname} (N = {SUBWIN_N}; errors "
              f"{max(errs.values()):.3e} <= {TOL})", flush=True)
        for name, t in times.items():
            print(f"[subwin]   {name:9s} {' / '.join(f'{v:.6f}' for v in t)}"
                  f" ms; {min(t) / best:.3f} x kept", flush=True)
        out[f"smoke-subwin/{dname}"] = dict(ms=times, errors=errs)
        del op
    return out


def packed_pointers(op, y) -> list:
    """The pointers of ``sell_packed_variant_launch`` (the order of
    ``sell_packed_launch``): the packed plane, slice_of, tile_base,
    y_block_id (None on a resident plan), then x is passed apart, and
    ``y``."""
    pk, sl = op.packed_planes()
    yb = op.y_block_id if op.plan.y_block_slices else None
    return [t.data_ptr() if t is not None else None
            for t in (pk, sl, op.tile_base, yb)] + [y.data_ptr()]


def disagreeing_lanes(packed, slice_of, tile_base, *, chunk: int,
                      n_coltiles: int):
    """A copy of the (S, 128) int32 packed word plane whose live sublanes'
    lanes 1..127 carry a rel other than lane 0's: odd lanes 511 (dead),
    even lanes tile 0 of the chunk's window (1 where lane 0's rel is 0 and
    the column tiles reach that far; else 511). Values and lane indices
    stay as they were, so a kernel that reads rel from lane 0, as the JAX
    ``_unpack_plane`` and the plain versions do, gives the plane's own y,
    and one that decodes rel per slot does not. numpy arrays in and out."""
    w = packed.reshape(-1, 128).astype(np.int64) & 0xFFFFFFFF
    rel_all = w >> 7 & 511
    rel0 = rel_all[:, 0]
    live = (rel0 != 511) & (slice_of.reshape(-1) >= 0)
    s = np.arange(w.shape[0])
    room = tile_base.astype(np.int64)[s // chunk] + 1 < n_coltiles
    other = np.where(rel0 != 0, 0, np.where(room, 1, 511))
    rel = np.where(np.arange(128) % 2 == 1, 511, other[:, None])
    rel[:, 0] = rel0
    rel = np.where(live[:, None], rel, rel_all)
    out = (w & ~(511 << 7)) | (rel << 7)
    return out.astype(np.uint32).view(np.int32).reshape(packed.shape)


def df64_pointers(planes, y_hi, y_lo) -> list:
    """The eleven pointers of ``sell_df64_variant_launch`` (the order of
    ``sell_df64_launch``): ``SellDf64SpMV._planes``'s nine (vals_lo None
    without a lo plane) and the y pair."""
    return [None if t is None else t.data_ptr()
            for t in (*planes, y_hi, y_lo)]


def _turns(torch, fns, reps=FORWARD_REPS):
    """Every function timed queued behind the spin kernel, in turns
    (forward order, then reversed)."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(_time_ms(torch, fns[k], reps, queued=True))
    return times


def _print_times(tag, times, kept="kept"):
    best = min(times[kept])
    for k, t in times.items():
        print(f"[{tag}]   {k:9s} {' / '.join(f'{v:.6f}' for v in t)} ms; "
              f"{min(t) / best:.3f} x kept", flush=True)


def _smoke_and_l1(names):
    """(name, triplets, plan) of smoke and L1 (chip_smoke.py's plans)."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    for name in names:
        t0 = time.perf_counter()
        coo = parse_synth_spec(SMOKE_SPEC if name == "smoke" else L1_SPEC,
                               device="cpu")
        rr, cc, vv = coo.to_numpy()
        plan = S._auto_plan(rr, cc, vv, coo.shape)
        print(f"[plan] {name}: S {plan.n_sublanes} in {plan.n_chunks} chunks "
              f"of {plan.chunk}, streamed {bool(plan.y_block_slices)}, in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        yield name, (rr, cc, vv, coo.shape), plan


def run_packed(names=tuple(PACKED_CONFIGS)) -> dict:
    """K5's variants against the kept kernel and the float32 CSR call."""
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    _build.build(["sell_packed"])
    lib, log = _build_variants(_PACKED_SRC, _PACKED_SIGNATURES)
    print(f"[regs] packed variants: {_registers(log)}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    wanted = {PACKED_CONFIGS[n]: n for n in names}
    out = {}
    for base, triplets, plan in _smoke_and_l1(list(wanted)):
        name = wanted[base]
        op = S.SellSpMV(plan, value_dtype=torch.bfloat16, device=dev)
        pk, sl = op.packed_planes()
        kw = op._kw()
        if plan.y_block_slices:
            kw["y_block_id"] = op.y_block_id
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            plan.shape[1]).astype(np.float32)).to(dev)
        xt, x2 = op._x_tiles(x), x[:, None]
        a = _library_csr(torch, triplets, dev)

        def launch(variant):
            y = torch.zeros(kw["n_slices"] * S.LANES, dtype=torch.float32,
                            device=dev)
            ptr = packed_pointers(op, y)
            rc = lib.sell_packed_variant_launch(
                PACKED_VARIANTS[variant], *ptr[:4], xt.data_ptr(), ptr[4],
                pk.numel(), kw["chunk"], kw.get("nsb", 0), 0, stream)
            if rc:
                msg = lib.sell_error_string(rc).decode()
                raise RuntimeError(f"packed variant {variant}: CUDA error "
                                   f"{rc} ({msg})")
            return y

        fns = {"kept": lambda: S.sell_packed(pk, sl, op.tile_base, xt, **kw)}
        fns.update({v: (lambda v=v: launch(v)) for v in PACKED_VARIANTS})
        yp = S.sell_packed_plain(pk, sl, op.tile_base, xt, **kw)
        errs = {v: _rel(f(), yp) for v, f in fns.items()}
        torch.cuda.synchronize()
        bad = {v: e for v, e in errs.items() if not e <= TOL}
        if bad:
            raise SystemExit(f"bench_variants: {name}: {bad}")
        fns["library"] = lambda: torch.sparse.mm(a, x2)
        times = _turns(torch, fns)
        print(f"[packed] {name} bfloat16 ({op.route}; errors "
              f"{max(errs.values()):.3e} <= {TOL})", flush=True)
        _print_times("packed", times)
        out[f"{name}/bfloat16"] = dict(route=op.route, ms=times, errors=errs)
        if not plan.y_block_slices:
            out[f"{name}/bfloat16/K2-packed"] = _packed_bench_forms(
                torch, lib, S, op, xt, a, x2, stream)
            out[f"{name}/bfloat16/K5-k{PACKED_SPMM_K}"] = _packed_spmm_forms(
                torch, lib, S, op, a, stream)
        del op, a, pk, sl
        torch.cuda.empty_cache()
    return out


def _packed_bench_forms(torch, lib, S, op, xt, a, x2, stream) -> dict:
    """K2-packed's forms on ``op``'s resident packed planes: each held at
    N = 1, 2, 3 to the plain version on the operator's plane and on
    ``disagreeing_lanes``' (the old walk must miss there), then timed at
    PACKED_BENCH_N in turns against the kept kernel and N library calls."""
    pk, sl = op.packed_planes()
    kw = op._kw()
    bad = torch.from_numpy(disagreeing_lanes(
        pk.cpu().numpy(), sl.cpu().numpy(), op.tile_base.cpu().numpy(),
        chunk=op.plan.chunk, n_coltiles=op.plan.n_coltiles)).to(op.device)
    n_out = kw["n_slices"] * S.LANES

    def form(name, n, plane=pk):
        ys = torch.empty(2, n_out, dtype=torch.float32, device=op.device)
        rc = lib.sell_bench_packed_variant_launch(
            PACKED_BENCH_FORMS[name], plane.data_ptr(), sl.data_ptr(),
            op.tile_base.data_ptr(), xt.data_ptr(), ys.data_ptr(),
            plane.numel(), n_out, kw["chunk"], n, 0, stream)
        if rc:
            raise RuntimeError(f"K2-packed form {name}: CUDA error {rc} "
                               f"({lib.sell_error_string(rc).decode()})")
        return ys[0 if name == "walk" else (n - 1) % 2]

    def kept(n, plane=pk):
        return S.sell_bench_packed(plane, sl, op.tile_base, xt,
                                   iterations=n, **kw)

    runs = {"kept": kept}
    runs.update({f: (lambda n, plane=pk, f=f: form(f, n, plane))
                 for f in PACKED_BENCH_FORMS})
    errs, lanes = {}, {}
    for k, fn in runs.items():
        errs[k] = max(_rel(fn(n), S.sell_bench_packed_plain(
            pk, sl, op.tile_base, xt, iterations=n, **kw)) for n in (1, 2, 3))
        lanes[k] = max(_rel(fn(n, bad), S.sell_bench_packed_plain(
            bad, sl, op.tile_base, xt, iterations=n, **kw)) for n in (2, 3))
    torch.cuda.synchronize()
    bad_errs = {k: e for k, e in errs.items() if not e <= TOL}
    bad_lanes = {k: e for k, e in lanes.items()
                 if not (e > 1e-3 if k == "walk" else e <= TOL)}
    if bad_errs or bad_lanes:
        raise SystemExit(f"bench_variants: K2-packed: {bad_errs}, on "
                         f"disagreeing lanes {bad_lanes}")
    n = PACKED_BENCH_N
    fns = {k: (lambda fn=fn: fn(n)) for k, fn in runs.items()}
    fns["library"] = lambda: [torch.sparse.mm(a, x2) for _ in range(n)]
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(_time_ms(torch, fns[k], 2))
    print(f"[packed] K2-packed, N = {n} (errors {max(errs.values()):.3e} "
          f"<= {TOL}; on disagreeing lanes {lanes})", flush=True)
    _print_times("packed", times)
    return dict(iterations=n, ms=times, errors=errs, disagreeing_lanes=lanes)


def _packed_spmm_forms(torch, lib, S, op, a, stream) -> dict:
    """K5 with k columns' forms on ``op``'s resident packed planes at k =
    PACKED_SPMM_K: each held to the plain version within the plan's SpMM
    tolerance on the operator's plane and on ``disagreeing_lanes``', then
    timed queued in turns against the kept kernel and the float32 CSR
    call with k columns."""
    pk, sl = op.packed_planes()
    kw = op._mat_kw()
    k = PACKED_SPMM_K
    bad = torch.from_numpy(disagreeing_lanes(
        pk.cpu().numpy(), sl.cpu().numpy(), op.tile_base.cpu().numpy(),
        chunk=op.plan.chunk, n_coltiles=op.plan.n_coltiles)).to(op.device)
    X = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (op.plan.n_coltiles * S.LANES, k)).astype(np.float32)).to(op.device)
    Xt = X.to(torch.bfloat16)
    Xl = X[: op.plan.shape[1]]
    n_out = kw["n_slices"] * S.LANES

    def form(name, plane=pk):
        Y = torch.zeros(n_out, k, dtype=torch.float32, device=op.device)
        rc = lib.sell_packed_spmm_variant_launch(
            PACKED_SPMM_FORMS[name], plane.data_ptr(), sl.data_ptr(),
            op.tile_base.data_ptr(), Xt.data_ptr(), Y.data_ptr(),
            plane.numel(), kw["chunk"], k, 0, stream)
        if rc:
            raise RuntimeError(f"K5 with k columns form {name}: CUDA error "
                               f"{rc} ({lib.sell_error_string(rc).decode()})")
        return Y

    runs = {"kept": lambda plane=pk: S.sell_packed_spmm(
        plane, sl, op.tile_base, Xt, **kw)}
    runs.update({f: (lambda plane=pk, f=f: form(f, plane))
                 for f in PACKED_SPMM_FORMS})
    tol, _ = spmm_tolerance(op.plan)
    errs = {}
    for name, fn in runs.items():
        errs[name] = max(_rel(fn(plane), S.sell_packed_spmm_plain(
            plane, sl, op.tile_base, Xt, **kw)) for plane in (pk, bad))
    torch.cuda.synchronize()
    bad_errs = {name: e for name, e in errs.items() if not e <= tol}
    if bad_errs:
        raise SystemExit(f"bench_variants: K5 with k columns: {bad_errs} > "
                         f"{tol}")
    fns = {name: fn for name, fn in runs.items()}
    fns["library"] = lambda: torch.sparse.mm(a, Xl)
    times = _turns(torch, fns)
    print(f"[packed] K5 with k columns, k = {k} (errors on the plane and "
          f"on disagreeing lanes {max(errs.values()):.3e} <= {tol:.3e})",
          flush=True)
    _print_times("packed", times)
    return dict(k=k, ms=times, errors=errs)


def _solver_lib(C):
    """The solver variants' library, its launchers typed as the kept one."""
    signatures = {fn: C._SIGNATURES["sell_solver_launch"]
                  for fn in SOLVER_LAUNCHERS.values()}
    signatures["sell_error_string"] = (ctypes.c_char_p, [ctypes.c_int])
    lib, log = _build_variants(_SOLVER_SRC, signatures)
    print(f"[regs] solver variants: {_registers(log)}", flush=True)
    return lib


def _cg_variants(torch, lib, M, C, op, b, steps, mv=None, a=None) -> dict:
    """K9's variants on ``op`` (its route: merged word or split planes)
    against the kept kernel and its plain version, and, given the float32
    CSR operand ``a``, the scan loop over it; each first held at
    SOLVER_CHECK_STEPS steps to the plain version."""
    n = op.shape[0]
    launcher = getattr(lib, SOLVER_LAUNCHERS["K9"])

    def variant(name, s):
        return C.cg_launch(op, b, s, variant=(
            launcher, SOLVER_VARIANTS[name]))[:n]

    runs = {"kept": lambda s: C.fused_cg(op, b, s)}
    runs.update({v: (lambda s, v=v: variant(v, s)) for v in SOLVER_VARIANTS})
    xp = C.fused_cg_plain(op, b, SOLVER_CHECK_STEPS)
    errs = {k: _rel(fn(SOLVER_CHECK_STEPS), xp) for k, fn in runs.items()}
    torch.cuda.synchronize()
    bad = {k: e for k, e in errs.items() if not e <= SOLVER_TOL}
    if bad:
        raise SystemExit(f"bench_variants: K9 on {op._route()}: {bad}")
    fns = {k: (lambda fn=fn: fn(steps)) for k, fn in runs.items()}
    if a is not None:
        fns["library"] = lambda: M.conjugate_gradient(a, b, num_iters=steps,
                                                      spmv=mv)
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(_time_ms(torch, fns[k], 1))
    t0 = time.perf_counter()
    C.fused_cg_plain(op, b, steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"[solver] K9 {op._route()} float32, {steps} steps (errors at "
          f"{SOLVER_CHECK_STEPS} steps {max(errs.values()):.3e} <= "
          f"{SOLVER_TOL}); plain {plain_ms:.3f} ms", flush=True)
    _print_times("solver", times)
    return dict(route=op._route(), steps=steps, ms=times, errors=errs,
                plain_ms=plain_ms)


def _poisson_split(torch, S, dev):
    """K9's split-plane operator: Poisson POISSON_N² (float32) rewindowed to
    POISSON_WINDOW tiles, past the merged word's 511, and b = 1."""
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.ops.sell_plan import rewindow_plan
    from smvp_toolkit_tpu_torch.utils.synth import poisson2d

    m = poisson2d(POISSON_N).tocoo()
    csr = csr_encode(COOMatrix.from_numpy(
        m.row, m.col, m.data.astype(np.float32), shape=m.shape, pad_to=128,
        device=dev))
    op = S.SellSpMV(rewindow_plan(S.sell_op_csr(csr).plan, POISSON_WINDOW),
                    device=dev)
    if op.route != "split":
        raise SystemExit(f"bench_variants: Poisson {POISSON_N}² widened "
                         f"runs on {op.route}")
    return op, torch.ones(m.shape[0], device=dev)


def run_solver() -> dict:
    """K9's, K10's and K11's variants at hpcg104 against the kept kernels,
    their plain versions and the scan loops over the float32 CSR call,
    and K9's on split planes."""
    import torch

    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.models import solvers as M
    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import cg_fused as C
    from smvp_toolkit_tpu_torch.ops import pcg_fused as P
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil

    _build.build(["sell_solvers"])
    lib = _solver_lib(C)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    m = hpcg_stencil(HPCG_N).tocoo()
    csr = csr_encode(COOMatrix.from_numpy(m.row, m.col, m.data,
                                          shape=m.shape, pad_to=128,
                                          device=dev))
    op = S.sell_op_csr(csr)
    print(f"[plan] hpcg104: {m.shape[0]} rows, {m.nnz} nnz; S "
          f"{op.plan.n_sublanes} in {op.plan.n_chunks} chunks of "
          f"{op.plan.chunk}, in {time.perf_counter() - t0:.1f} s",
          flush=True)
    n = m.shape[0]
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n).astype(
        np.float32)).to(dev)
    v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(
        np.float32)).to(dev)
    lows, highs = M.lanczos_eigsh(csr, v0, num_iters=30, k=1)
    lo, hi = float(lows[0]) * 0.3, float(highs[0]) * 1.1
    a = _library_csr(torch, (m.row, m.col, m.data, m.shape), dev)

    def mv(mat, v):
        return torch.sparse.mm(mat, v[:, None])[:, 0]

    out = {"hpcg104/float32/K9": _cg_variants(torch, lib, M, C, op, b,
                                              CG_STEPS, mv, a)}
    sop, sb = _poisson_split(torch, S, dev)
    out[f"poisson{POISSON_N}-widened/float32/K9"] = _cg_variants(
        torch, lib, M, C, sop, sb, CG_STEPS)
    del sop, sb

    def variant(name, steps):
        return P.chebyshev_launch(
            op, b, lo, hi, steps,
            variant=(lib.sell_chebyshev_variant_launch,
                     SOLVER_VARIANTS[name]))[:n]

    runs = {"kept": lambda s: P.fused_chebyshev(op, b, lo, hi, s)}
    runs.update({v: (lambda s, v=v: variant(v, s)) for v in SOLVER_VARIANTS})
    xp = P.fused_chebyshev_plain(op, b, lo, hi, SOLVER_CHECK_STEPS)
    errs = {k: _rel(fn(SOLVER_CHECK_STEPS), xp) for k, fn in runs.items()}
    torch.cuda.synchronize()
    bad = {k: e for k, e in errs.items() if not e <= SOLVER_TOL}
    if bad:
        raise SystemExit(f"bench_variants: K10 at hpcg104: {bad}")
    s = SOLVER_STEPS
    fns = {k: (lambda fn=fn: fn(s)) for k, fn in runs.items()}
    fns["library"] = lambda: M.chebyshev(a, b, lo, hi, num_iters=s, spmv=mv)
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(_time_ms(torch, fns[k], 1))
    t0 = time.perf_counter()
    P.fused_chebyshev_plain(op, b, lo, hi, s)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"[solver] K10 hpcg104 float32, {s} steps, interval [{lo:.6g}, "
          f"{hi:.6g}] (errors at {SOLVER_CHECK_STEPS} steps "
          f"{max(errs.values()):.3e} <= {SOLVER_TOL}); plain "
          f"{plain_ms:.3f} ms", flush=True)
    _print_times("solver", times)
    out["hpcg104/float32"] = dict(steps=s, ms=times, errors=errs,
                                  plain_ms=plain_ms)
    out["hpcg104/float32/K11"] = _ic0_variants(torch, lib, M, P, csr, op, b,
                                               (m.row, m.col, m.data,
                                                m.shape), mv)
    return out


def _ic0_variants(torch, lib, M, P, csr, op, b, triplets, mv) -> dict:
    """K11's variants at hpcg104 (IC0_STEPS steps, IC0_SWEEPS sweeps)
    against the kept kernel, its plain version and the scan loop over the
    float32 CSR call, each first held at SOLVER_CHECK_STEPS steps."""
    from smvp_toolkit_tpu_torch.ops.ilu import ic0
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _triplets_from_csr_host

    dev, n = op.device, csr.shape[0]
    t0 = time.perf_counter()
    factors = ic0(csr)
    P._ic0_planes(op, factors)
    print(f"[plan] hpcg104 IC(0) factors and their plans in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    a = _library_csr(torch, triplets, dev)

    def library_op(c):
        m = _library_csr(torch, _triplets_from_csr_host(c), dev)
        return lambda v: mv(m, v)

    pre = M.ic0_preconditioner(factors, sweeps=IC0_SWEEPS,
                               op_builder=library_op)

    def variant(name, steps):
        return P.pcg_ic0_launch(
            op, factors, b, steps, IC0_SWEEPS,
            variant=(lib.sell_pcg_ic0_variant_launch,
                     SOLVER_VARIANTS[name]))[:n]

    runs = {"kept": lambda s: P.fused_pcg_ic0(op, factors, b, s,
                                              IC0_SWEEPS)}
    runs.update({v: (lambda s, v=v: variant(v, s)) for v in SOLVER_VARIANTS})
    xp = P.fused_pcg_ic0_plain(op, factors, b, SOLVER_CHECK_STEPS,
                               IC0_SWEEPS)
    errs = {k: _rel(fn(SOLVER_CHECK_STEPS), xp) for k, fn in runs.items()}
    torch.cuda.synchronize()
    bad = {k: e for k, e in errs.items() if not e <= SOLVER_TOL}
    if bad:
        raise SystemExit(f"bench_variants: K11 at hpcg104: {bad}")
    s = IC0_STEPS
    fns = {k: (lambda fn=fn: fn(s)) for k, fn in runs.items()}
    fns["library"] = lambda: M.pcg_precond(a, b, pre, num_iters=s, spmv=mv)
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(_time_ms(torch, fns[k], 1))
    t0 = time.perf_counter()
    P.fused_pcg_ic0_plain(op, factors, b, s, IC0_SWEEPS)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"[solver] K11 hpcg104 float32, {s} steps, sweeps {IC0_SWEEPS} "
          f"(errors at {SOLVER_CHECK_STEPS} steps {max(errs.values()):.3e} "
          f"<= {SOLVER_TOL}); plain {plain_ms:.3f} ms", flush=True)
    _print_times("solver", times)
    return dict(steps=s, sweeps=IC0_SWEEPS, ms=times, errors=errs,
                plain_ms=plain_ms)


def run_kbench() -> dict:
    """K2 with k columns' forms at smoke (k = KBENCH_K, N = KBENCH_N)
    against the kept kernel and N calls of the float32 CSR call."""
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    _build.build(["sell_spmm"])
    lib, log = _build_variants(_KCOL_SRC, _KCOL_SIGNATURES)
    print(f"[regs] k-column variants: {_registers(log)}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    (_, triplets, plan), = _smoke_and_l1(["smoke"])
    a = _library_csr(torch, triplets, dev)
    tol, n_max = spmm_tolerance(plan)
    k, n = KBENCH_K, KBENCH_N
    X = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (plan.shape[1], k)).astype(np.float32)).to(dev)
    out = {}
    for dname in ("float32", "bfloat16"):
        op = S.SellSpMV(plan, value_dtype=getattr(torch, dname), device=dev)
        planes, kw = op._planes(), op._mat_kw()
        Xt = op._block(X, plan.n_coltiles * S.LANES, op.value_dtype, "X")
        n_out = kw["n_slices"] * S.LANES * k

        def form(name, iters):
            ys = torch.empty(2, n_out, dtype=torch.float32, device=dev)
            rc = lib.sell_bench_spmm_variant_launch(
                KBENCH_FORMS[name], op.vals.data_ptr(), op.lidx.data_ptr(),
                op.relsl.data_ptr(), op.tile_base.data_ptr(), Xt.data_ptr(),
                ys.data_ptr(), op.vals.numel(), n_out, kw["chunk"], k, iters,
                int(op.vals.dtype == torch.bfloat16), 0, stream)
            if rc:
                raise RuntimeError(f"K2 with k columns form {name}: CUDA "
                                   f"error {rc} "
                                   f"({lib.sell_error_string(rc).decode()})")
            b = (iters - 1) % 2 if name == "buffers2" else 0
            return ys[b].view(-1, k)

        runs = {"kept": lambda iters: S.sell_bench_spmm(
            *planes, Xt, iterations=iters, **kw)}
        runs.update({f: (lambda iters, f=f: form(f, iters))
                     for f in KBENCH_FORMS})
        errs = {}
        for name, fn in runs.items():
            errs[name] = max(_rel(fn(i), S.sell_bench_spmm_plain(
                *planes, Xt, iterations=i, **kw)) for i in (1, 2, 3))
        torch.cuda.synchronize()
        bad = {f: e for f, e in errs.items() if not e <= tol}
        if bad:
            raise SystemExit(f"bench_variants: K2 with k columns {dname}: "
                             f"{bad} > {tol}")
        fns = {f: (lambda fn=fn: fn(n)) for f, fn in runs.items()}
        fns["library"] = lambda: [torch.sparse.mm(a, X) for _ in range(n)]
        times = {f: [] for f in fns}
        for order in (list(fns), list(fns)[::-1]):
            for f in order:
                times[f].append(_time_ms(torch, fns[f], 2))
        print(f"[kbench] smoke {dname} k={k}, N = {n} (shape "
              f"{S.spmm_shape(k)}, {S.MAT_BENCH_Y_BUFFERS} Y buffers kept; "
              f"errors at N = 1-3 {max(errs.values()):.3e} <= {tol:.2e}, "
              f"rows of up to {n_max} products)", flush=True)
        _print_times("kbench", times)
        out[f"smoke/{dname}/k{k}"] = dict(iterations=n, ms=times,
                                          errors=errs)
        del op, planes, Xt
        torch.cuda.empty_cache()
    return out


def run_df64(names=DF64_CONFIGS) -> dict:
    """K8's variants against the kept kernel and the float64 CSR call."""
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D
    from smvp_toolkit_tpu_torch.ops.precision import df_split

    _build.build(["sell_df64"])
    lib, log = _build_variants(_DF64_SRC, _DF64_SIGNATURES)
    print(f"[regs] df64 variants: {_registers(log)}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    (_, (r, c, v, shape), plan), = _smoke_and_l1(["smoke"])
    out = {}
    for name in names:
        if name == "smoke-df64":
            op, v64 = D.SellDf64SpMV(plan, device=dev), np.asarray(
                v, np.float64)
        else:
            v64 = np.random.default_rng(0).standard_normal(len(r))
            op = D.SellDf64SpMV.from_coo_f64(r, c, v64, shape, device=dev)
        x64 = np.random.default_rng(1).standard_normal(shape[1])
        xh, xl = df_split(x64, device=dev)
        planes = op._planes(xh, xl)
        kw = dict(n_slices=op.plan.n_slices, chunk=op.plan.chunk)
        lk = int(op.lidx.dtype == torch.int32)
        a = _library_csr(torch, (r, c, v64, shape), dev, torch.float64)
        x2 = (xh.double() + xl.double())[: shape[1], None]

        def launch(variant, u=0, slices=0):
            n_rows = kw["n_slices"] * 128
            yh = torch.empty(n_rows, dtype=torch.float32, device=dev)
            yl = torch.empty(n_rows, dtype=torch.float32, device=dev)
            rc = lib.sell_df64_variant_launch(
                DF64_VARIANTS[variant], u, slices,
                *df64_pointers(planes, yh, yl), n_rows, kw["chunk"], lk, 0,
                stream)
            if rc:
                raise RuntimeError(f"df64 variant {variant} U{u} S{slices}: "
                                   f"CUDA error {rc} "
                                   f"({lib.sell_error_string(rc).decode()})")
            return yh, yl

        fns = {"kept": lambda: D.sell_df64(*planes, **kw),
               "walk": lambda: launch("walk")}
        fns.update({f"U{u}S{sl}": (lambda u=u, sl=sl: launch("staged", u, sl))
                    for u, sl in DF64_FORMS})
        ph, pl = D.sell_df64_plain(*planes, **kw)
        got = {k: f() for k, f in fns.items()}
        same = {k: bool(torch.equal(yh, ph) and torch.equal(yl, pl))
                for k, (yh, yl) in got.items()}
        del got
        if not all(same.values()):
            raise SystemExit(f"bench_variants: {name}: not bit for bit the "
                             f"plain version: {same}")
        fns["library"] = lambda: torch.sparse.mm(a, x2)
        times = _turns(torch, fns)
        print(f"[df64] {name} (lo plane {op.vals_lo is not None}; every form "
              f"bit-equal to the plain version)", flush=True)
        _print_times("df64", times)
        out[name] = dict(lo_plane=op.vals_lo is not None, ms=times)
        del op, a, planes
        torch.cuda.empty_cache()
    return out


def build_onehot_variants():
    """The library of ``csrc/variants/sell_onehot_variants.cu`` (built
    with the package's nvcc flags into ``build/kernels``) and ptxas's
    report of its kernels."""
    return _build_variants(_ONEHOT_SRC, _ONEHOT_SIGNATURES)


def _onehot_rc(lib, rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.sell_error_string(rc).decode()})")


def onehot_dense_launcher(lib, vals, lidx, rel, slice_of, tile_base, x, *,
                          n_slices: int, chunk: int, window_tiles: int,
                          index=None):
    """fn() -> y of the dense-operand kernel K6 ran before, on ``sell_
    onehot``'s operands: the JAX launch's operands (``onehot_dense``,
    ``onehot_xw``, vals as float32, lidx as int32) built once on the card,
    then one launch a call. ``index`` is not read."""
    import torch

    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    oht, seg = S.onehot_dense(rel, slice_of, n_slices=n_slices, chunk=chunk,
                              window_tiles=window_tiles)
    xw = S.onehot_xw(x, tile_base, window_tiles)
    v32, l32 = vals.float().contiguous(), lidx.int().contiguous()
    dev = vals.device

    def run():
        y = torch.empty(n_slices * S.LANES, dtype=torch.float32, device=dev)
        _onehot_rc(lib, lib.sell_onehot_dense_launch(
            xw.data_ptr(), v32.data_ptr(), l32.data_ptr(), oht.data_ptr(),
            seg.data_ptr(), y.data_ptr(), tile_base.numel(), chunk,
            window_tiles, n_slices, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream),
            "sell_onehot_dense_kernel")
        return y

    return run


def onehot_variant_launcher(lib, vals, lidx, rel, slice_of, tile_base, x, *,
                            n_slices: int, chunk: int, window_tiles: int,
                            index):
    """fn(variant, u, slices) -> y of one of ``ONEHOT_FORMS`` on ``sell_
    onehot``'s operands and slice index (``slice_of`` and ``window_tiles``
    are not read)."""
    import torch

    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    slice_ptr, sublanes = index
    vk, lk = S._kinds(vals, lidx)
    dev = vals.device

    def run(variant: str, u: int, slices: int):
        y = torch.empty(n_slices * S.LANES, dtype=torch.float32, device=dev)
        _onehot_rc(lib, lib.sell_onehot_variant_launch(
            ONEHOT_VARIANTS[variant], u, slices, vals.data_ptr(),
            lidx.data_ptr(), rel.data_ptr(), tile_base.data_ptr(),
            slice_ptr.data_ptr(), sublanes.data_ptr(), x.data_ptr(),
            y.data_ptr(), n_slices * S.LANES, chunk, vk, lk, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream),
            f"onehot variant {variant} U{u} S{slices}")
        return y

    return run


def run_onehot(names=ONEHOT_CONFIGS) -> dict:
    """K6's variants against the kept kernel and the float32 CSR call."""
    import torch

    from smvp_toolkit_tpu_torch.ops import _build
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S

    _build.build(["sell_onehot"])
    lib, log = build_onehot_variants()
    print(f"[regs] onehot variants: {_registers(log)}", flush=True)
    dev = torch.device("cuda", 0)
    out = {}
    for name, ops, triplets, _ in kcol_cases(torch, list(names)):
        a = _library_csr(torch, triplets, dev)
        for dname, op in ops.items():
            x = torch.from_numpy(np.random.default_rng(1).standard_normal(
                op.plan.shape[1]).astype(np.float32)).to(dev)
            xt = op._x_tiles(x)
            x2 = xt.float()[: op.plan.shape[1], None]
            args = (op.vals, op.lidx, *op.split_planes(), op.tile_base, xt)
            kw = op._onehot_kw()
            dense = onehot_dense_launcher(lib, *args, **kw)
            form = onehot_variant_launcher(lib, *args, **kw)
            y = S.sell_onehot(*args, **kw)
            yp = S.sell_onehot_plain(*args, **kw)
            errs = {"kept": _rel(y, yp), "dense": _rel(dense(), yp)}
            same = {"dense": bool(torch.equal(dense(), y))}
            same.update({f"{v}U{u}S{sl}": bool(torch.equal(form(v, u, sl), y))
                         for v, u, sl in ONEHOT_FORMS})
            del yp
            if not all(e <= TOL for e in errs.values()) or not all(
                    same.values()):
                raise SystemExit(f"bench_variants: {name} {dname}: errors "
                                 f"{errs}, bit for bit the kept kernel "
                                 f"{same}")
            fns = {"kept": lambda: S.sell_onehot(*args, **kw),
                   "dense": dense}
            fns.update({f"{v}U{u}S{sl}": (lambda v=v, u=u, sl=sl:
                                          form(v, u, sl))
                        for v, u, sl in ONEHOT_FORMS})
            fns["library"] = lambda: torch.sparse.mm(a, x2)
            times = _turns(torch, fns)
            longest = int(torch.diff(kw["index"][0]).max())
            print(f"[onehot] {name} {dname} (errors {errs}; the dense kernel "
                  f"and every form bit-equal to the kept one; {longest} "
                  f"live sublanes in the longest slice)", flush=True)
            _print_times("onehot", times)
            out[f"{name}/{dname}"] = dict(ms=times, errors=errs,
                                          longest_slice=longest)
            del dense, fns
            torch.cuda.empty_cache()
        del a
    return out


def _blocks(lib, variant: int, route: int, vk: int) -> int:
    n = ctypes.c_int(0)
    rc = lib.sell_bench_variant_blocks(variant, route, vk, 0,
                                       ctypes.byref(n))
    if rc:
        raise RuntimeError(f"occupancy query: CUDA error {rc}")
    return n.value


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", default=None,
                   help="comma-separated: smoke, L1, L2, L3, smoke-dp4 "
                   "(default all); with --kcol: smoke, L2, gcn_arxiv:A, "
                   "gcn_arxiv:At (default all); with --packed: "
                   "smoke-packed, L1-packed; with --df64: smoke-df64, "
                   "smoke-df64-f64; with --onehot: smoke, L2")
    p.add_argument("--kcol", action="store_true",
                   help="time the k-column body's variants instead")
    p.add_argument("--sweep", action="store_true",
                   help="with --kcol: every shape at every run cap")
    p.add_argument("--vgrad", action="store_true",
                   help="time K7's variants on gcn_arxiv's A instead")
    p.add_argument("--subwin", action="store_true",
                   help="time K2-subwin's forms on smoke instead")
    p.add_argument("--packed", action="store_true",
                   help="time K5's variants on smoke-packed and L1-packed, "
                   "K2-packed's and K5 with k columns' on smoke-packed, "
                   "instead")
    p.add_argument("--df64", action="store_true",
                   help="time K8's variants on smoke-df64 and "
                   "smoke-df64-f64 instead")
    p.add_argument("--solver", action="store_true",
                   help="time K9's, K10's and K11's variants at hpcg104 "
                   "(K9 also on split planes) instead")
    p.add_argument("--kbench", action="store_true",
                   help="time K2 with k columns' forms on smoke instead")
    p.add_argument("--onehot", action="store_true",
                   help="time K6's variants on smoke and L2 instead")
    p.add_argument("--out", help="write every time to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    default = ",".join(KCOL_K) if args.kcol else "smoke,L1,L2,L3,smoke-dp4"
    names = (args.configs or default).split(",")
    if args.vgrad:
        out = run_vgrad()
    elif args.subwin:
        out = run_subwin()
    elif args.packed:
        out = run_packed(tuple((args.configs or ",".join(PACKED_CONFIGS))
                               .split(",")))
    elif args.df64:
        out = run_df64(tuple((args.configs or ",".join(DF64_CONFIGS))
                             .split(",")))
    elif args.solver:
        out = run_solver()
    elif args.kbench:
        out = run_kbench()
    elif args.onehot:
        out = run_onehot(tuple((args.configs or ",".join(ONEHOT_CONFIGS))
                               .split(",")))
    else:
        out = run_kcol(names, args.sweep) if args.kcol else run(names)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, cases=out)))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
