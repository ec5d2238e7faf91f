"""SpMM: the port's ``matmat`` and ``bench_loop_mat`` against the JAX
operator's, plan by plan, and the CLI's ``--spmm``.

Both packages run the same plan (``interop.plan_from_arrays``); the JAX
operator runs its Pallas kernels in interpret mode, the port its kernels'
plain versions (CPU tensors). Tolerance: max |Δ| / max |Y| <= 1e-5 (the
JAX operator splits k into launch groups of 8 and sums in another order;
its SpMM is held to 1e-5 against a dense oracle by its own tests).
"""

from __future__ import annotations

import functools
import json
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu import cli as jcli
from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as j_csr_encode
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.ops import spmv_xla
from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import (
    coo_from_triplets,
    plan_fields,
    plan_from_arrays,
)
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops import spmv_torch

import torch_kcol_plans as kcol

TOL = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _triplets(route):
    """Small matrices on each route; every third row is empty."""
    rng = np.random.RandomState(len(route))
    if route == "split":  # 547 column tiles in one chunk: WT > 511
        n, m, nnz = 300, 70000, 500
    else:
        n, m, nnz = 400, 330, 2400
    r, c = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    r = np.where(r % 3 == 0, (r + 1) % n, r)
    return r, c, rng.randn(nnz), (n, m)


@functools.lru_cache(maxsize=None)
def _plans(route):
    r, c, v, shape = _triplets(route)
    if route == "streamy":
        jp = jplan.build_streamed_sell_plan(r, c, v, shape, chunk=64,
                                            y_block_rows=2048)
    else:
        jp = jplan.build_sell_plan(r, c, v, shape, chunk=1024)
    return jp, plan_from_arrays(plan_fields(jp))


ROUTES = ["relsl", "split", "streamy"]
# The streamed plan runs column by column, so one k covers it.
MATMAT_CASES = [(r, k) for r in ("relsl", "split") for k in (2, 8, 17)] + [
    ("streamy", 8)]


def _x(m, k, seed=7):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32)


@pytest.mark.parametrize("route,k", MATMAT_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmat_matches_jax(route, k, dtype):
    jp, tp = _plans(route)
    tdt, jdt = DTYPES[dtype]
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    assert op.route == ("streamy_relsl" if route == "streamy" else route)
    X = _x(tp.shape[1], k)
    before = {n: f.launches for n, f in tsp.MAT_KERNELS.items()}
    Y = op.matmat(torch.from_numpy(X))
    Yj = jsp.SellSpMV(jp, value_dtype=jdt).matmat(jnp.asarray(X))
    assert Y.dtype == torch.float32 and Y.shape == (tp.shape[0], k)
    assert _rel(Y.numpy(), Yj) <= TOL
    assert {n: f.launches for n, f in tsp.MAT_KERNELS.items()} == before


@pytest.mark.parametrize("k", [6, 8])
@pytest.mark.parametrize("route", ["relsl", "split"])
def test_hub_row_plan_matches_jax_and_oracle(route, k):
    """A row of 200 entries in one column tile (200 duplicate sublanes, past
    several 64-sublane work items of the k-column kernels): the plain
    version against the JAX operator on the same plan and against a
    float64 dense oracle (duplicates summed)."""
    r, c, v, shape, chunk = kcol.hub_row_triplets(route)
    tp = kcol.hub_row_plan(route)
    jp = jplan.build_sell_plan(r, c, v, shape, chunk=chunk)
    op = tsp.SellSpMV(tp, device="cpu")
    assert op.route == route
    X = _x(shape[1], k)
    Y = op.matmat(torch.from_numpy(X)).numpy()
    assert _rel(Y, jsp.SellSpMV(jp).matmat(jnp.asarray(X))) <= TOL
    dense = np.zeros(shape)
    np.add.at(dense, (r, c), np.asarray(v, np.float32))
    assert _rel(Y, dense @ X.astype(np.float64)) <= TOL


_SPMM_SRC = (Path(tsp.__file__).resolve().parent.parent / "csrc"
             / "sell_common.cuh").read_text()


def _kernel_shape(k):
    """The column shape csrc/sell_common.cuh's with_mat_shape (the table
    every k-column kernel launches with) returns for k, read from its
    table."""
    body = _SPMM_SRC[_SPMM_SRC.index("cudaError_t with_mat_shape"):]
    body = body[:body.index("\n}\n")]
    vector, scalar = body.split("if (k <= 4)", 1)
    scalar = "if (k <= 4)" + scalar
    part, var = (vector, k // 4) if k % 4 == 0 else (scalar, k)
    for bound, t, w, p in re.findall(
            r"if \(\w+ <= (\d+)\) return fn\(MatShape<(\d+), (\d+), "
            r"(\d+)>", part):
        if var <= int(bound):
            return int(t), int(w), int(p)
    t, w, p = re.findall(r"return fn\(MatShape<(\d+), (\d+), (\d+)>",
                         part)[-1]
    return int(t), int(w), int(p)


def test_spmm_shape_matches_the_kernel_table():
    """``spmm_shape`` (the column shape K1, K4 and K5 with k columns launch)
    equals the kernel's own table for every k up to 700; the vector form
    is taken exactly where k % 4 == 0; T is a power of two up to a warp, P
    at most 4; one column block covers k up to 128 in either form."""
    for k in range(1, 701):
        t, w, p = tsp.spmm_shape(k)
        assert (t, w, p) == _kernel_shape(k), k
        assert (w == 4) == (k % 4 == 0) and t in (1, 2, 4, 8, 16, 32), k
        assert 1 <= p <= 4, k
        if k <= 128:
            assert t * w * p >= k, k
    assert tsp.spmm_shape(8) == (1, 4, 2)      # 32 rows a warp step
    assert tsp.spmm_shape(40) == (4, 4, 4)
    assert tsp.spmm_shape(256) == (8, 4, 4)    # two column blocks
    assert tsp.spmm_shape(300) == (8, 4, 4)    # three column blocks
    assert tsp.spmm_shape(6) == (2, 1, 4)
    with pytest.raises(ValueError):
        tsp.spmm_shape(0)


@pytest.mark.parametrize("route", ROUTES)
def test_matmat_k1_and_float64_oracle(route):
    _, tp = _plans(route)
    r, c, v, shape = _triplets(route)
    dense = np.zeros(shape)
    np.add.at(dense, (r, c), np.asarray(v, np.float32))
    op = tsp.SellSpMV(tp, device="cpu")
    for k in (1, 5):
        X = _x(shape[1], k, seed=k)
        Y = op.matmat(torch.from_numpy(X)).numpy()
        assert _rel(Y, dense @ X.astype(np.float64)) <= TOL
    x = _x(shape[1], 1)
    assert torch.equal(op.matmat(torch.from_numpy(x))[:, 0],
                       op(torch.from_numpy(x[:, 0])))


def test_matmat_values_override():
    _, tp = _plans("relsl")
    op = tsp.SellSpMV(tp, device="cpu")
    X = torch.from_numpy(_x(tp.shape[1], 4))
    assert torch.equal(op.matmat(X, vals=2 * op.vals), 2 * op.matmat(X))
    with pytest.raises(ValueError, match="slots"):
        op.matmat(X, vals=op.vals[:-1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bench_loop_mat_matches_jax(dtype):
    jp, tp = _plans("relsl")
    tdt, jdt = DTYPES[dtype]
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    X = _x(tp.shape[1], 8)
    Y = op.bench_loop_mat(torch.from_numpy(X), 3)
    assert torch.equal(Y, op.matmat(torch.from_numpy(X)))
    Yj = jsp.SellSpMV(jp, value_dtype=jdt).bench_loop_mat(jnp.asarray(X), 3)
    assert _rel(Y.numpy(), Yj) <= TOL
    y1 = op.bench_loop_mat(torch.from_numpy(X[:, :1]), 2)
    assert torch.equal(y1[:, 0], op.bench_loop(torch.from_numpy(X[:, 0]), 2))


@pytest.mark.parametrize("route,match", [
    ("split", "relsl layout only"), ("streamy", "resident-y plan")])
def test_bench_loop_mat_refusals_match_jax(route, match):
    jp, tp = _plans(route)
    X = _x(tp.shape[1], 4)
    with pytest.raises(ValueError, match=match):
        tsp.SellSpMV(tp, device="cpu").bench_loop_mat(torch.from_numpy(X), 2)
    with pytest.raises(ValueError, match=match):
        jsp.SellSpMV(jp).bench_loop_mat(jnp.asarray(X), 2)


def test_spmm_csr_matches_spmv_xla():
    r, c, v, shape = _triplets("relsl")
    j = j_csr_encode(JCOO.from_numpy(r, c, v, shape=shape).pad(128))
    t = csr_encode(coo_from_triplets(r, c, v, shape, device="cpu").pad(128))
    X = _x(shape[1], 6)
    Y = spmv_torch.spmm_csr(t, torch.from_numpy(X))
    assert Y.dtype == torch.float32 and Y.shape == (shape[0], 6)
    assert _rel(Y.numpy(), spmv_xla.spmm_csr(j, jnp.asarray(X))) <= 1e-6


@pytest.mark.parametrize("route", ROUTES)
def test_traffic_bytes_k(route):
    """The planes once per launch, x and y once per column; for k up to
    the JAX launch group (8) the k-dependence equals the JAX figure's."""
    jp, tp = _plans(route)
    xy = tp.traffic_bytes(k=2) - tp.traffic_bytes(k=1)
    assert xy == tp.n_coltiles * 128 * 4 + tp.n_slices * 128 * 4
    assert tp.traffic_bytes(k=17) == tp.traffic_bytes() + 16 * xy
    assert tp.traffic_bytes(2, x_bytes=2, k=3) - tp.traffic_bytes(
        2, x_bytes=2) == 2 * (tp.n_coltiles * 128 * 2 + tp.n_slices * 512)
    if route != "streamy":
        assert jp.traffic_bytes(x_resident=True, k=5) - jp.traffic_bytes(
            x_resident=True) == 4 * xy


def test_mat_wrapper_checks():
    _, tp = _plans("relsl")
    op = tsp.SellSpMV(tp, device="cpu")
    kw = op._mat_kw()
    rows = tp.n_coltiles * 128
    good = torch.zeros(rows, 3)
    bad = [
        (torch.zeros(rows - 1, 3), ValueError, "rows"),
        (torch.zeros(rows, 0), ValueError, "k >= 1"),
        (torch.zeros(rows), ValueError, "block"),
        (torch.zeros(rows, 3, dtype=torch.float64), TypeError, "float"),
        (torch.zeros(3, rows).t(), ValueError, "contiguous"),
        (torch.zeros(rows, 1).expand(rows, 3), ValueError, "contiguous"),
    ]
    for X, err, match in bad:
        with pytest.raises(err, match=match):
            tsp.sell_spmm(*op._planes(), X, **kw)
    with pytest.raises(ValueError, match="iterations"):
        tsp.sell_bench_spmm(*op._planes(), good, iterations=0, **kw)
    assert tsp.sell_spmm(*op._planes(), good, **kw).shape == (
        tp.n_slices * 128, 3)


SPEC = "synth:4096:40960"


def test_cli_spmm_record_and_result(tmp_path, monkeypatch):
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")
    jout, tout = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    assert jcli.main(["-c", "-n", "1", "--no-report", "--kernel", "xla",
                      "--spmm", "4", "--json-out", jout, SPEC]) == 0
    assert tcli.main(["-c", "-n", "2", "--no-report", "--device", "cpu",
                      "--spmm", "4", "--out-dir", str(tmp_path),
                      "--json-out", tout, SPEC]) == 0
    with open(jout) as f:
        jrec = [json.loads(ln) for ln in f][-1]
    with open(tout) as f:
        trec = [json.loads(ln) for ln in f][-1]
    assert set(jrec) <= set(trec)
    assert trec["alg"] == jrec["alg"] == "SPMM-CSR"
    assert trec["k"] == 4 and trec["nnz"] == jrec["nnz"]
    assert trec["kernel"] == "sell-plain-fused"
    assert trec["timing"] == "per call" and trec["avg_ms"] > 0
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    r, c, v = parse_synth_spec(SPEC, device="cpu").to_numpy()
    dense = np.zeros((4096, 4096))
    np.add.at(dense, (r, c), v)
    X = np.random.default_rng(0).standard_normal((4096, 4)).astype(
        np.float32)
    assert _rel(np.load(tmp_path / "spmm.npy"),
                dense @ X.astype(np.float64)) <= TOL


@pytest.mark.parametrize("extra,timing", [
    (["--fused"], "N-iteration kernel"), (["--kernel", "torch"], "per call")])
def test_cli_spmm_modes(tmp_path, extra, timing):
    out = str(tmp_path / "t.jsonl")
    assert tcli.main(["-c", "-n", "2", "--no-report", "--device", "cpu",
                      "--spmm", "3", "--json-out", out, *extra, SPEC]) == 0
    with open(out) as f:
        rec = [json.loads(ln) for ln in f][-1]
    assert rec["timing"] == timing
    assert rec["kernel"] == ("torch" if "torch" in extra
                             else "sell-plain-fused")


@pytest.mark.parametrize("argv", [
    ["-c", "--spmm", "0"], ["-c", "--spmm", "-3"], ["-t", "--spmm", "4"],
    ["-c", "--spmm", "4", "--out-dir", "/nonexistent"]])
def test_cli_spmm_probes_rc2(argv, tmp_path):
    assert tcli.main(["-d", str(tmp_path)] + argv + ["--device", "cpu",
                                                    SPEC]) == 2
    assert not os.listdir(tmp_path)
