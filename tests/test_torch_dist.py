"""The port's row-block CSR, TJDS stripes and 2-D grid against the JAX
package's ``parallel`` on its 8-device virtual CPU mesh.

The host stacks (``shard_csr``, ``shard_tjds``, ``shard_csr_2d``) must
equal the JAX arrays element for element. The sharded SpMVs run in real
gloo worlds of 2 and 4 ranks (``torch_dist_ranks``, one world per size,
spawned once for the module) and must agree with the JAX functions on a
mesh of as many devices within 1e-6 of max |y| (the sums are float32 in
another order). Then the process group's rules (``make_mesh``,
``distributed_init``), the ``torchrun`` runner and the CLI's ``--shards``
against the JAX CLI's.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode as jtjds_encode
from smvp_toolkit_tpu import parallel as J
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
from smvp_toolkit_tpu_torch import parallel as P
from smvp_toolkit_tpu_torch.parallel.mesh import Mesh
from smvp_toolkit_tpu_torch.parallel.spmv_2d import Mesh2D

from conftest import random_coo
from torch_dist_ranks import ROOT, run_world

TOL = 1e-6
CPU = torch.device("cpu")
SPEC = "synth:3000:20000"


def _matrices():
    """(name, r, c, v, shape): a random matrix with empty rows, 700 × 600,
    and a skewed one whose non-zeros all sit in its first rows (later
    nnz-balanced blocks are empty)."""
    rng = np.random.RandomState(0)
    r, c, v = random_coo(rng, 700, 600, 5000)
    rs = rng.randint(0, 6, 900)
    cs = rng.randint(0, 600, 900)
    keep = np.unique(rs * 600 + cs, return_index=True)[1]
    return [("", r, c, v.astype(np.float32), (700, 600)),
            ("skew_", rs[keep], cs[keep],
             rng.randn(len(keep)).astype(np.float32), (700, 600))]


def _inputs():
    rng = np.random.RandomState(1)
    out = {"x": rng.randn(600).astype(np.float32),
           "X": rng.randn(600, 5).astype(np.float32)}
    for name, r, c, v, shape in _matrices():
        out.update({name + "r": r, name + "c": c, name + "v": v,
                    name + "shape": np.array(shape)})
    return out


def _jcoo(inputs, name=""):
    return JCOO.from_numpy(
        inputs[name + "r"].astype(np.int32), inputs[name + "c"].astype(
            np.int32), inputs[name + "v"],
        shape=tuple(int(s) for s in inputs[name + "shape"]), pad_to=64)


def _pcoo(inputs, name=""):
    return COOMatrix.from_numpy(
        inputs[name + "r"], inputs[name + "c"], inputs[name + "v"],
        shape=tuple(int(s) for s in inputs[name + "shape"]), pad_to=64,
        device="cpu")


def _close(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return (np.shape(got) == want.shape
            and np.abs(np.asarray(got, np.float64) - want).max()
            <= TOL * scale)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results and the inputs they were made from."""
    inputs = _inputs()
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"dist{world}")
        np.savez(d / "input.npz", **inputs)
        out[world] = run_world("dist", world, d)
    return inputs, out


# -- host stacks --------------------------------------------------------------


@pytest.mark.parametrize("balance", ["rows", "nnz"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["", "skew_"])
def test_shard_csr_stacks_equal_jax(name, n, balance):
    inputs = _inputs()
    j = J.shard_csr(jcsr_encode(_jcoo(inputs, name)), J.make_mesh(n),
                    balance=balance)
    p = P.shard_csr(csr_encode(_pcoo(inputs, name)), Mesh(n, 0, CPU),
                    balance=balance)
    for f in ("vals", "col_ind", "local_rows"):
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)))
    for f in ("shape", "nnz", "rows_per_shard", "n_shards", "row_starts",
              "nnz_starts"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.block_rows() == j.block_rows()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_tjds_stacks_equal_jax(n):
    inputs = _inputs()
    j = J.shard_tjds(jtjds_encode(_jcoo(inputs)), J.make_mesh(n))
    p = P.shard_tjds(tjds_encode(_pcoo(inputs)), Mesh(n, 0, CPU))
    for f in ("vals", "row_ind", "offsets", "perm"):
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)))
    assert (p.shape, p.nnz, p.n_shards) == (j.shape, j.nnz, j.n_shards)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 4), (4, 2), (3, 1)])
def test_shard_csr_2d_stacks_equal_jax(grid):
    inputs = _inputs()
    j = J.shard_csr_2d(jcsr_encode(_jcoo(inputs)), J.make_mesh_2d(*grid))
    p = P.shard_csr_2d(csr_encode(_pcoo(inputs)), Mesh2D(*grid, 0, 0, CPU))
    for f in ("vals", "local_cols", "local_rows"):
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)))
    for f in ("shape", "nnz", "rows_blk", "cols_blk", "grid"):
        assert getattr(p, f) == getattr(j, f), f


def test_emulated_ranks_concatenate_to_y():
    """Each rank's local block, computed without a group (the test seam),
    concatenates to the JAX sharded y; the public function refuses a
    mesh of several ranks without its group."""
    from smvp_toolkit_tpu_torch.parallel.spmv_dist import _local_csr

    inputs = _inputs()
    x = inputs["x"]
    sh = P.shard_csr(csr_encode(_pcoo(inputs)), Mesh(8, 0, CPU),
                     balance="nnz")
    blocks = [_local_csr(sh.for_rank(k, CPU), torch.from_numpy(x))[:r]
              for k, r in enumerate(sh.block_rows())]
    mesh = J.make_mesh(8)
    want = J.spmv_csr_sharded(J.shard_csr(jcsr_encode(_jcoo(inputs)), mesh,
                                          balance="nnz"), x, mesh)
    assert _close(torch.cat(blocks).numpy(), want)
    with pytest.raises(ValueError, match="process group"):
        P.spmv_csr_sharded(sh, torch.from_numpy(x), Mesh(8, 0, CPU))


# -- gloo worlds against the JAX mesh -----------------------------------------


def _jax_results(inputs, world):
    """The JAX functions on a mesh of ``world`` devices, same keys as the
    rank programs."""
    mesh = J.make_mesh(world)
    x, X = inputs["x"], inputs["X"]
    out = {}
    for name in ("", "skew_"):
        jc = _jcoo(inputs, name)
        jcsr = jcsr_encode(jc)
        for balance in ("rows", "nnz"):
            sh = J.shard_csr(jcsr, mesh, balance=balance)
            out[f"{name}csr_{balance}"] = J.spmv_csr_sharded(sh, x, mesh)
            out[f"{name}csr_{balance}_blocks"] = J.spmv_csr_sharded(
                sh, x, mesh, gather=False)
            out[f"{name}spmm_{balance}"] = J.spmm_csr_sharded(sh, X, mesh)
            out[f"{name}csr_{balance}_vals2"] = J.spmv_csr_sharded(
                sh.with_vals(2 * jcsr.vals), x, mesh)
        out[f"{name}tjds"] = J.spmv_tjds_sharded(
            J.shard_tjds(jtjds_encode(jc), mesh), x, mesh)
    jcsr = jcsr_encode(_jcoo(inputs))
    for rows in (1, 2) if world == 2 else (2,):
        grid = J.make_mesh_2d(rows, world // rows)
        sh2 = J.shard_csr_2d(jcsr, grid)
        key = f"2d_{rows}x{world // rows}"
        out[key] = J.spmv_csr_2d(sh2, x, grid)
        out[key + "_spmm"] = J.spmm_csr_2d(sh2, X, grid)
    sub = J.make_mesh(world // 2)
    out["sub"] = J.spmv_csr_sharded(J.shard_csr(jcsr, sub), x, sub)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_csr_tjds_2d_match_jax(worlds, world):
    inputs, results = worlds
    want = _jax_results(inputs, world)
    ranks = results[world]
    for key, ref in want.items():
        for r, res in enumerate(ranks):
            if key.endswith("_blocks"):  # gather=False: the rank's block
                assert _close(res[key[:-1]], ref[r:r + 1]), (key, r)
            elif key == "sub" and r >= world // 2:  # outside the sub-mesh
                assert key not in res
            else:
                assert _close(res[key], ref), (key, r)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_and_bench_every_rank_holds_y(worlds, world):
    inputs, results = worlds
    import scipy.sparse as sp

    a = sp.csr_matrix((inputs["v"].astype(np.float64),
                       (inputs["r"], inputs["c"])), shape=(700, 600))
    ref = a @ inputs["x"].astype(np.float64)
    for res in results[world]:
        for key in ("bench_CSR_auto", "bench_CSR_torch", "bench_TJDS_auto",
                    "bench_TJDS_torch"):
            assert _close(res[key], ref), key


# -- the process group's rules ------------------------------------------------


def test_make_mesh_without_a_group(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert P.distributed_init(device="cpu") is False
    assert P.device_count() == 1
    mesh = P.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    with pytest.raises(ValueError) as e:
        P.make_mesh(2, device="cpu")
    with pytest.raises(ValueError) as j:
        J.make_mesh(16)
    pattern = r"requested \d+ devices, only \d+ present"
    assert re.fullmatch(pattern, str(e.value))
    assert re.fullmatch(pattern, str(j.value))
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, only 1"):
        P.make_mesh_2d(2, 2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        P.distributed_init(device="cpu")


def _torchrun(args, cwd, nproc=2, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout)


def _checksums(text):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"y checksum \[process (\d+)\]: (\S+)", text)}


def test_launch_checksums_agree_with_jax(tmp_path, capsys):
    """``parallel.launch`` under torchrun (2 gloo ranks) and as one rank:
    every rank prints the checksum the JAX runner prints on 8 devices."""
    from smvp_toolkit_tpu.parallel import launch as jlaunch
    from smvp_toolkit_tpu_torch.parallel import launch

    for alg in ("csr", "tjds"):
        assert jlaunch.main([SPEC, "--alg", alg, "-n", "2"]) == 0
        want = _checksums(capsys.readouterr().out)[0]
        assert launch.main([SPEC, "--alg", alg, "-n", "2", "--device",
                            "cpu"]) == 0
        got = _checksums(capsys.readouterr().out)
        assert list(got) == [0] and abs(got[0] - want) <= 1e-5 * abs(want)
        proc = _torchrun(["-m", "smvp_toolkit_tpu_torch.parallel.launch",
                          SPEC, "--alg", alg, "-n", "2", "--device", "cpu"],
                         tmp_path)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        got = _checksums(proc.stdout)
        assert sorted(got) == [0, 1]
        assert all(abs(v - want) <= 1e-5 * abs(want) for v in got.values())


def _report_vector(path):
    lines = Path(path).read_text().splitlines()
    start = lines.index("[")
    return np.array([float(t) for t in lines[start + 1:lines.index("]")]])


def _report(d, alg):
    (path,) = Path(d).glob(f"smvp-toolbox_report_{alg}_*")
    return _report_vector(path)


@pytest.mark.parametrize("kernel", [("auto", "pallas"), ("torch", "xla")])
def test_cli_shards_2_matches_jax(tmp_path, kernel):
    """``--shards 2`` under torchrun (2 gloo ranks, rank 0 alone writes the
    reports) against the JAX CLI's ``--shards 2`` on its virtual mesh."""
    from smvp_toolkit_tpu import cli as jcli

    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    ref.mkdir()
    args = ["-c", "-t", "-n", "2", "--x", "random:1", "--shards", "2"]
    proc = _torchrun(["-m", "smvp_toolkit_tpu_torch.cli", *args, "--kernel",
                      kernel[0], "--device", "cpu", "-d", str(port), SPEC],
                     tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.count("2 shards") == 4  # two formats, two ranks
    assert jcli.main([*args, "--kernel", kernel[1], "-d", str(ref),
                      SPEC]) == 0
    for alg in ("CSR", "TJDS"):
        assert len(list(port.glob(f"smvp-toolbox_report_{alg}_*"))) == 1
        got, want = _report(port, alg), _report(ref, alg)
        assert got.shape == want.shape == (3000,)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_cli_shards_refusals(tmp_path, capsys):
    """The JAX CLI's rc-2 cases, and a group smaller than the shards:
    exit 1 in the JAX function's words, as the JAX CLI fails with fewer
    devices than shards."""
    from smvp_toolkit_tpu import cli as jcli
    from smvp_toolkit_tpu_torch import cli as tcli

    base = ["-c", "-n", "1", "--no-report"]
    for extra in (["--shards", "0"], ["--fused", "--shards", "2"]):
        assert tcli.main([*base, *extra, "--device", "cpu", SPEC]) == 2
        assert jcli.main([*base, *extra, SPEC]) == 2
    err = capsys.readouterr().err
    assert err.count("shard count must be >= 1") == 2
    assert err.count("--fused is not supported together with --shards") == 2
    assert tcli.main([*base, "--shards", "3", "--device", "cpu", SPEC]) == 1
    assert "requested 3 devices, only 1 present" in capsys.readouterr().err
    with pytest.raises(ValueError, match="requested 9 devices, only 8"):
        jcli.main([*base, "--shards", "9", SPEC])
    assert len(jax.devices()) == 8
