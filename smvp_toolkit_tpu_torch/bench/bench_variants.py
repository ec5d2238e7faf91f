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
           "plane_pointers", "kcol_cases", "spmm_tolerance", "main"]

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
_KCOL_SIGNATURES = {
    "sell_spmm_variant_launch": (ctypes.c_int, [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]),
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


def _library_csr(torch, triplets, dev):
    """``torch.sparse.mm``'s float32 CSR operand of the triplets,
    duplicates summed."""
    import scipy.sparse as sp

    r, c, v, shape = triplets
    a = sp.csr_matrix((np.asarray(v, np.float32), (r, c)), shape=shape)
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
                   "gcn_arxiv:At (default all)")
    p.add_argument("--kcol", action="store_true",
                   help="time the k-column body's variants instead")
    p.add_argument("--sweep", action="store_true",
                   help="with --kcol: every shape at every run cap")
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
    out = run_kcol(names, args.sweep) if args.kcol else run(names)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, cases=out)))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
