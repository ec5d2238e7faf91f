"""Rank programs of the port's gloo worlds, and the runner that spawns them.

Not a test module: ``tests/test_torch_dist.py`` and
``tests/test_torch_sell_dist.py`` write their inputs to ``input.npz`` in a
work directory, ``run_world`` starts one process per rank (torch and the
port only, no JAX), each joins a gloo group through a ``file://``
rendezvous in that directory (no TCP port, so parallel test workers
cannot collide), runs one of ``PROGRAMS`` and saves what it computed as
``rank<r>.npz``. A world that has not finished after ``timeout`` seconds
is killed and fails its test.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def run_world(program: str, world: int, workdir, timeout: float = 120.0):
    """Run ``program`` on ``world`` gloo ranks; returns each rank's
    results (a list of dicts of arrays), or raises with the ranks'
    output."""
    workdir = Path(workdir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "SMVP_SELL_COMPAT", "SMVP_SELL_RELSL",
              "SMVP_SELL_SPMM"):
        env.pop(k, None)
    procs = []
    for rank in range(world):
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c",
             "import sys, torch_dist_ranks as t; "
             "t.rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), "
             "sys.argv[4])", program, str(rank), str(world), str(workdir)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    failed = []
    for rank, (p, log) in enumerate(procs):
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            failed.append(f"rank {rank} hung")
        log.close()
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    failed += [f"rank {r} exited {p.returncode}"
               for r, (p, _) in enumerate(procs) if p.returncode]
    if failed:
        logs = "\n".join((workdir / f"rank{r}.log").read_text()[-3000:]
                         for r in range(world))
        raise RuntimeError(f"{program} on {world} ranks: {failed}\n{logs}")
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


def rank_main(program: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from smvp_toolkit_tpu_torch.parallel.mesh import distributed_init

    path = Path(workdir)
    assert distributed_init(f"file://{path / 'rendezvous'}", world, rank,
                            device="cpu")
    inputs = dict(np.load(path / "input.npz"))
    out = PROGRAMS[program](rank, world, inputs)
    np.savez(path / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def _coo(inputs, prefix=""):
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    shape = tuple(int(s) for s in inputs[prefix + "shape"])
    return COOMatrix.from_numpy(inputs[prefix + "r"], inputs[prefix + "c"],
                                inputs[prefix + "v"], shape=shape,
                                device="cpu")


def _np(t):
    return t.detach().float().cpu().numpy()


def dist_program(rank: int, world: int, inputs) -> dict:
    """The CSR, TJDS and 2-D sharded functions, a sub-mesh and the
    benchmark helper on one rank."""
    import torch

    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
    from smvp_toolkit_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        shard_and_bench,
        shard_csr,
        shard_csr_2d,
        shard_tjds,
        spmm_csr_2d,
        spmm_csr_sharded,
        spmv_csr_2d,
        spmv_csr_sharded,
        spmv_tjds_sharded,
    )

    mesh = make_mesh()
    assert (mesh.size, mesh.rank) == (world, rank)
    x = torch.from_numpy(inputs["x"])
    X = torch.from_numpy(inputs["X"])
    out = {}
    for name in ("", "skew_"):
        coo = _coo(inputs, name)
        csr = csr_encode(coo)
        for balance in ("rows", "nnz"):
            sh = shard_csr(csr, mesh, balance=balance)
            out[f"{name}csr_{balance}"] = _np(spmv_csr_sharded(sh, x, mesh))
            out[f"{name}csr_{balance}_block"] = _np(
                spmv_csr_sharded(sh, x, mesh, gather=False))
            out[f"{name}spmm_{balance}"] = _np(spmm_csr_sharded(sh, X, mesh))
            out[f"{name}csr_{balance}_vals2"] = _np(spmv_csr_sharded(
                sh.with_vals(2 * csr.vals), x, mesh))
        out[f"{name}tjds"] = _np(spmv_tjds_sharded(
            shard_tjds(tjds_encode(coo), mesh), x, mesh))
    coo = _coo(inputs)
    csr = csr_encode(coo)
    for rows in (1, 2) if world == 2 else (2,):
        grid = make_mesh_2d(rows, world // rows)
        sh2 = shard_csr_2d(csr, grid)
        key = f"2d_{rows}x{world // rows}"
        out[key] = _np(spmv_csr_2d(sh2, x, grid))
        out[key + "_spmm"] = _np(spmm_csr_2d(sh2, X, grid))
    sub = make_mesh(world // 2)
    if sub.rank >= 0:
        out["sub"] = _np(spmv_csr_sharded(shard_csr(csr, sub), x, sub))
    for alg, enc in (("CSR", csr), ("TJDS", tjds_encode(coo))):
        for kernel in ("auto", "torch"):
            _, y = shard_and_bench(alg, enc, x, world, iterations=2,
                                   kernel=kernel, mesh=mesh)
            out[f"bench_{alg}_{kernel}"] = _np(y)
    return out


def sell_program(rank: int, world: int, inputs) -> dict:
    """The sharded SELL functions on one rank: SpMV in float32 and
    bfloat16 and under the switches, K2-sharded, SpMM, its transpose and
    gradient, and a plan without the merged word."""
    import torch

    from smvp_toolkit_tpu_torch.parallel import (
        differentiable_spmm_sharded,
        make_mesh,
        shard_sell,
        shard_sell_transpose,
        spmm_sell_sharded,
        spmm_sell_sharded_t,
        spmv_sell_sharded,
    )
    from smvp_toolkit_tpu_torch.parallel.sell_dist import bench_loop_sharded

    mesh = make_mesh()
    coo = _coo(inputs)
    x = torch.from_numpy(inputs["x"])
    X = torch.from_numpy(inputs["X"])
    G = torch.from_numpy(inputs["G"])
    sh = shard_sell(coo, mesh)
    sh16 = shard_sell(coo, mesh, value_dtype=torch.bfloat16)
    assert sh.rank == rank and sh.op.vals.shape == (sh.S, 128)
    out = {"f32": _np(spmv_sell_sharded(sh, x, mesh)),
           "bf16": _np(spmv_sell_sharded(sh16, x, mesh)),
           "bench": _np(bench_loop_sharded(sh, x, mesh, 3)),
           "bench_bf16": _np(bench_loop_sharded(sh16, x, mesh, 3)),
           "spmm": _np(spmm_sell_sharded(sh, X, mesh))}
    for var, val in (("SMVP_SELL_RELSL", "0"), ("SMVP_SELL_COMPAT", "1"),
                     ("SMVP_SELL_SPMM", "0")):
        os.environ[var] = val
        key = f"{var}={val}"
        out[key] = _np(spmv_sell_sharded(sh, x, mesh))
        out[key + " spmm"] = _np(spmm_sell_sharded(sh, X, mesh))
        del os.environ[var]
    sh_t = shard_sell_transpose(coo, mesh)
    out["spmm_t"] = _np(spmm_sell_sharded_t(sh_t, G, mesh))
    f = differentiable_spmm_sharded(sh, sh_t, mesh)
    Xr = X.clone().requires_grad_(True)
    loss = (f(Xr) * G).sum()
    loss.backward()
    out["loss"] = np.float64(loss.item())
    out["grad"] = _np(Xr.grad)
    wide = shard_sell(_coo(inputs, "wide_"), mesh)
    xw = torch.from_numpy(inputs["wide_x"])
    out["wide"] = _np(spmv_sell_sharded(wide, xw, mesh))
    try:
        bench_loop_sharded(wide, xw, mesh, 3)
        out["wide_bench_raised"] = np.array(False)
    except ValueError as e:
        out["wide_bench_raised"] = np.array("relsl plane" in str(e))
    return out


PROGRAMS = {"dist": dist_program, "sell": sell_program}
