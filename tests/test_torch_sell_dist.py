"""The port's sharded SELL path (``parallel/sell_dist.py``) against the JAX
package's on its 8-device virtual CPU mesh, Pallas in interpret mode.

Host stacks: ``shard_sell`` and ``shard_sell_transpose`` equal the JAX
``ShardedSell`` arrays element for element (merged word included), for
1, 2, 4 and 8 shards at chunk 1024 and 2048. Results: in gloo worlds of 2
and 4 ranks (spawned once per size for the module) the sharded SpMV in
float32, bfloat16, under ``SMVP_SELL_RELSL=0`` and ``SMVP_SELL_COMPAT=1``,
K2-sharded with N = 3, the SpMM, its transpose and the gradient of
``differentiable_spmm_sharded`` agree with the JAX functions within 1e-6
of max |y| (float32 sums in another order; the bf16 products are exact in
float32 on both sides). On the CPU each rank runs the kernels' plain
versions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.parallel import make_mesh as jmesh
from smvp_toolkit_tpu.parallel import sell_dist as JS
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.parallel import sell_dist as PS
from smvp_toolkit_tpu_torch.parallel.mesh import Mesh

from conftest import random_coo
from torch_dist_ranks import run_world

TOL = 1e-6
CPU = torch.device("cpu")
STACKS = ("vals", "lidx", "rel_tile", "slice_of", "tile_base", "relsl")
META = ("shape", "nnz", "chunk", "n_shards", "rows_per_shard",
        "n_coltiles", "window_tiles", "n_slices_local", "slice_window")


def _inputs():
    """A 700 × 600 random matrix with empty rows (the 4-shard split leaves
    the last shard no rows), its x, X and cotangent G, and a 200 × 70,000
    matrix whose one chunk spans more than 511 tiles (no merged word)."""
    rng = np.random.RandomState(3)
    r, c, v = random_coo(rng, 700, 600, 5000)
    wr, wc, wv = random_coo(rng, 200, 70_000, 600)
    return {"r": r, "c": c, "v": v.astype(np.float32),
            "shape": np.array((700, 600)),
            "x": rng.randn(600).astype(np.float32),
            "X": rng.randn(600, 5).astype(np.float32),
            "G": rng.randn(700, 5).astype(np.float32),
            "wide_r": wr, "wide_c": wc, "wide_v": wv.astype(np.float32),
            "wide_shape": np.array((200, 70_000)),
            "wide_x": rng.randn(70_000).astype(np.float32)}


def _jcoo(inputs, name=""):
    return JCOO.from_numpy(
        inputs[name + "r"].astype(np.int32),
        inputs[name + "c"].astype(np.int32), inputs[name + "v"],
        shape=tuple(int(s) for s in inputs[name + "shape"]))


def _pcoo(inputs, name=""):
    return COOMatrix.from_numpy(
        inputs[name + "r"], inputs[name + "c"], inputs[name + "v"],
        shape=tuple(int(s) for s in inputs[name + "shape"]), device="cpu")


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    return (np.shape(got) == want.shape
            and np.abs(np.asarray(got, np.float64) - want).max()
            <= tol * np.abs(want).max())


def _assert_stacks_equal(p, j, value_dtype=None):
    for f in STACKS:
        a, b = getattr(p, f), getattr(j, f)
        if b is None:
            assert a is None, f
            continue
        b = np.asarray(b)
        if f == "vals" and value_dtype is not None:
            a = torch.from_numpy(a).to(value_dtype).float().numpy()
            b = b.astype(np.float32)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in META:
        assert getattr(p, f) == getattr(j, f), f


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("chunk", [1024, 2048])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_stacks_equal_jax(n, chunk, transpose):
    inputs = _inputs()
    jf = JS.shard_sell_transpose if transpose else JS.shard_sell
    pf = PS.shard_sell_transpose if transpose else PS.shard_sell
    j = jf(_jcoo(inputs), jmesh(n), chunk=chunk)
    p = pf(_pcoo(inputs), Mesh(n, 0, CPU), chunk=chunk)
    assert p.relsl is not None
    _assert_stacks_equal(p, j)


def test_shard_stacks_bf16_int32_lanes_and_wide(monkeypatch):
    """bf16 values (rounded to nearest even on both sides), int32 lanes
    under ``SMVP_SELL_LIDX32=1``, and a window past 511 tiles (no merged
    word) also stack as the JAX package stacks them."""
    inputs = _inputs()
    j = JS.shard_sell(_jcoo(inputs), jmesh(4), value_dtype=jnp.bfloat16)
    p = PS.shard_sell(_pcoo(inputs), Mesh(4, 2, CPU),
                      value_dtype=torch.bfloat16)
    _assert_stacks_equal(p, j, torch.bfloat16)
    assert p.op.vals.dtype == torch.bfloat16 and p.op.lidx.dtype == torch.int8
    assert torch.equal(p.op.vals.float(), torch.from_numpy(
        np.asarray(j.vals[2]).astype(np.float32)))
    monkeypatch.setenv("SMVP_SELL_LIDX32", "1")
    j = JS.shard_sell(_jcoo(inputs), jmesh(2))
    p = PS.shard_sell(_pcoo(inputs), Mesh(2, 0, CPU))
    assert p.lidx.dtype == np.int32 and p.op.lidx.dtype == torch.int32
    _assert_stacks_equal(p, j)
    monkeypatch.delenv("SMVP_SELL_LIDX32")
    j = JS.shard_sell(_jcoo(inputs, "wide_"), jmesh(2))
    p = PS.shard_sell(_pcoo(inputs, "wide_"), Mesh(2, 0, CPU))
    assert p.WT > 511 and p.relsl is None and p.op.relsl is None
    _assert_stacks_equal(p, j)


def test_eight_ragged_shards_locally_match_jax():
    """8 shards of a 700-row matrix (two shards with no rows, all with
    dead padding sublanes), each launched on its own as its rank would:
    K1 and K2-sharded (N = 3) concatenate to the JAX y on 8 devices, and
    in the wrong order they do not."""
    inputs = _inputs()
    x = inputs["x"]
    mesh = jmesh(8)
    jsh = JS.shard_sell(_jcoo(inputs), mesh)
    want = np.asarray(JS.spmv_sell_sharded(jsh, x, mesh))
    want_bench = np.asarray(JS.bench_loop_sharded(jsh, x, mesh, 3))
    sh = PS.shard_sell(_pcoo(inputs), Mesh(8, 0, CPU))
    blk = sh.rows_per_shard
    xt = torch.from_numpy(x)
    ranks = [sh.for_rank(k, CPU) for k in range(8)]
    y = [PS._local_spmv(s, xt)[:blk] for s in ranks]
    yb = [PS._local_bench(s, xt, 3)[:blk] for s in ranks]
    assert sum(p > 0 for p in sh.plan_nnz) == 6
    assert _close(torch.cat(y)[:700].numpy(), want)
    assert _close(torch.cat(yb)[:700].numpy(), want_bench)
    assert not _close(torch.cat(y[::-1])[:700].numpy(), want)
    with pytest.raises(ValueError, match="process group"):
        PS.spmv_sell_sharded(sh, xt, Mesh(8, 0, CPU))


def test_bench_loop_sharded_needs_the_merged_word():
    inputs = _inputs()
    xw = inputs["wide_x"]
    with pytest.raises(ValueError, match="needs the relsl plane"):
        JS.bench_loop_sharded(JS.shard_sell(_jcoo(inputs, "wide_"),
                                            jmesh(1)), xw, jmesh(1), 3)
    mesh = Mesh(1, 0, CPU)
    sh = PS.shard_sell(_pcoo(inputs, "wide_"), mesh)
    with pytest.raises(ValueError, match="needs the relsl plane"):
        PS.bench_loop_sharded(sh, torch.from_numpy(xw), mesh, 3)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    inputs = _inputs()
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"sell{world}")
        np.savez(d / "input.npz", **inputs)
        out[world] = run_world("sell", world, d)
    return inputs, out


def _jax_results(inputs, world, monkeypatch):
    mesh = jmesh(world)
    jc = _jcoo(inputs)
    x, X, G = (jnp.asarray(inputs[k]) for k in ("x", "X", "G"))
    sh = JS.shard_sell(jc, mesh)
    sh16 = JS.shard_sell(jc, mesh, value_dtype=jnp.bfloat16)
    out = {"f32": JS.spmv_sell_sharded(sh, x, mesh),
           "bf16": JS.spmv_sell_sharded(sh16, x, mesh),
           "bench": JS.bench_loop_sharded(sh, x, mesh, 3),
           "bench_bf16": JS.bench_loop_sharded(sh16, x, mesh, 3),
           "spmm": JS.spmm_sell_sharded(sh, X, mesh)}
    for var, val in (("SMVP_SELL_RELSL", "0"), ("SMVP_SELL_COMPAT", "1"),
                     ("SMVP_SELL_SPMM", "0")):
        monkeypatch.setenv(var, val)
        key = f"{var}={val}"
        out[key] = JS.spmv_sell_sharded(sh, x, mesh)
        out[key + " spmm"] = JS.spmm_sell_sharded(sh, X, mesh)
        monkeypatch.delenv(var)
    sh_t = JS.shard_sell_transpose(jc, mesh)
    out["spmm_t"] = JS.spmm_sell_sharded_t(sh_t, G, mesh)
    f = JS.differentiable_spmm_sharded(sh, sh_t, mesh)
    loss, grad = jax.value_and_grad(lambda X: jnp.sum(f(X) * G))(X)
    out["loss"], out["grad"] = loss, grad
    wide = JS.shard_sell(_jcoo(inputs, "wide_"), mesh)
    out["wide"] = JS.spmv_sell_sharded(wide, jnp.asarray(inputs["wide_x"]),
                                       mesh)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sell_matches_jax(worlds, world, monkeypatch):
    inputs, results = worlds
    want = _jax_results(inputs, world, monkeypatch)
    for r, res in enumerate(results[world]):
        assert set(want) <= set(res)
        for key, ref in want.items():
            if key == "loss":
                assert abs(res[key] - ref) <= 1e-5 * abs(ref), (key, r)
            else:
                assert _close(res[key], ref), (key, r)
        assert bool(res["wide_bench_raised"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sell_matches_float64(worlds, world):
    """Every rank's y, Y, Aᵀ·G and gradient against float64 scipy (bf16:
    values and x rounded to bf16 first)."""
    import scipy.sparse as sp

    inputs, results = worlds
    a = sp.csr_matrix((inputs["v"].astype(np.float64),
                       (inputs["r"], inputs["c"])), shape=(700, 600))
    x, X, G = (inputs[k].astype(np.float64) for k in ("x", "X", "G"))

    def bf(t):
        return torch.from_numpy(np.asarray(t, np.float32)).to(
            torch.bfloat16).double().numpy()

    a16 = sp.csr_matrix((bf(inputs["v"]), (inputs["r"], inputs["c"])),
                        shape=(700, 600))
    for res in results[world]:
        assert _close(res["f32"], a @ x, 1e-5)
        assert _close(res["bench"], a @ x, 1e-5)
        assert _close(res["bf16"], a16 @ bf(x), 1e-5)
        assert _close(res["spmm"], a @ X, 1e-5)
        assert _close(res["spmm_t"], a.T @ G, 1e-5)
        assert _close(res["grad"], a.T @ G, 1e-5)
