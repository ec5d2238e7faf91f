"""The JAX operator's switches, honoured by the port's SellSpMV.

Each switch the port follows, against the JAX operator under the same
environment (its Pallas kernels in interpret mode; the port's plain
versions on the CPU): the route the call takes and the plain version
that ran, the plane dtypes, the ``traffic_bytes`` delta, and y within
1e-6 of max |y|.

* ``SMVP_SELL_RELSL=0``: merged-word plans take the split planes (K4
  resident, K3-split streamed), in ``__call__``, ``matmat`` and
  ``bench_loop``;
* ``SMVP_SELL_LIDX32=1``: int32 lane planes in ``SellSpMV``,
  ``SellDf64SpMV`` and the K11 planes; 4 bytes per lane;
* ``SMVP_SELL_SPMM=0`` and ``SMVP_SELL_COMPAT=1``: ``matmat`` runs one
  k = 1 call per column; under COMPAT each is K6, and ``bench_loop``
  keeps K2 (the JAX bench kernel has no one-hot branch);
* ``SMVP_SELL_SPLIT=N``: N launches over chunk ranges, then a sum, under
  the JAX gates.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_df64 as jdf
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import pcg_fused as P
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops.ilu import ic0
from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV
from smvp_toolkit_tpu_torch.utils.synth import poisson2d

TOL = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _plan(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "resident":  # ROADMAP's plan: 4,096 rows, 40,960 nnz
        r, c = rng.randint(0, 4096, 40960), rng.randint(0, 4096, 40960)
        return jplan.build_sell_plan(r, c, rng.randn(40960), (4096, 4096),
                                     chunk=2048)
    if name == "resident-chunks":  # five chunks of 256
        r, c = rng.randint(0, 3000, 9000), rng.randint(0, 3000, 9000)
        return jplan.build_sell_plan(r, c, rng.randn(9000), (3000, 3000),
                                     chunk=256)
    if name == "streamed":
        r = rng.randint(0, 5000, 9000)
        c = np.clip(r + rng.randint(-64, 65, 9000), 0, 699)
        return jplan.build_streamed_sell_plan(r, c, rng.randn(9000),
                                              (5000, 700), chunk=256,
                                              y_block_rows=2048)
    raise AssertionError(name)


@pytest.fixture(scope="module", params=["resident", "resident-chunks",
                                        "streamed"])
def case(request):
    jp = _plan(request.param)
    x = np.random.default_rng(5).standard_normal(jp.shape[1]).astype(
        np.float32)
    return request.param, jp, plan_from_arrays(plan_fields(jp)), x


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _spy(monkeypatch, *names):
    calls = []
    for name in names:
        fn = getattr(tsp, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(tsp, name, spy)
    return calls


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_relsl_off_takes_the_split_planes(case, dtype, monkeypatch):
    name, jp, tp, x = case
    tdt, jdt = DTYPES[dtype]
    monkeypatch.setenv("SMVP_SELL_RELSL", "0")
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    streamed = name == "streamed"
    want = "streamy" if streamed else "split"
    assert op.base_route == ("streamy_relsl" if streamed else "relsl")
    assert op.route == op.bench_route == want
    rel, sl = op.split_planes()
    assert rel.dtype == sl.dtype == torch.int32
    assert np.array_equal(rel.numpy(), tp.rel_tile.reshape(-1))
    assert np.array_equal(sl.numpy(), tp.slice_of.reshape(-1))
    calls = _spy(monkeypatch, f"sell_{want}_plain", f"sell_bench_{want}_plain")
    jop = jsp.SellSpMV(jp, value_dtype=jdt)
    xt = torch.from_numpy(x)
    assert _rel(op(xt).numpy(), jop(jnp.asarray(x))) <= TOL
    assert _rel(op.bench_loop(xt, 2).numpy(),
                jop.bench_loop(jnp.asarray(x), 2)) <= TOL
    # the bench plain version repeats the forward one
    assert calls[:2] == [f"sell_{want}_plain", f"sell_bench_{want}_plain"]
    assert set(calls) == {f"sell_{want}_plain", f"sell_bench_{want}_plain"}
    if not streamed:
        X = np.random.default_rng(2).standard_normal(
            (tp.shape[1], 3)).astype(np.float32)
        mcalls = _spy(monkeypatch, "sell_split_spmm_plain")
        Y = op.matmat(torch.from_numpy(X))
        assert mcalls == ["sell_split_spmm_plain"]
        assert _rel(Y.numpy(), jop.matmat(jnp.asarray(X))) <= TOL
        # K2 with k columns runs the merged word only: both refuse
        for o, XX in ((op, torch.from_numpy(X)), (jop, jnp.asarray(X))):
            with pytest.raises(ValueError, match="relsl layout only"):
                o.bench_loop_mat(XX, 2)


def test_lidx32_widens_the_lane_planes(monkeypatch):
    jp = _plan("resident")
    tp = plan_from_arrays(plan_fields(jp))
    t0, j0 = tp.traffic_bytes(), jp.traffic_bytes()
    assert tsp.SellSpMV(tp, device="cpu").lidx.dtype == torch.int8
    monkeypatch.setenv("SMVP_SELL_LIDX32", "1")
    t1, j1 = tp.traffic_bytes(), jp.traffic_bytes()
    assert (j0, j1) == (2736136, 4309000)  # ROADMAP's figures
    assert t1 - t0 == j1 - j0 == tp.n_sublanes * 128 * 3
    op = tsp.SellSpMV(tp, device="cpu")
    jop = jsp.SellSpMV(jp)
    assert op.lidx.dtype == torch.int32 and jop.lidx.dtype == jnp.int32
    assert tsp.lidx_dtype(2048) == torch.int32
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    assert _rel(op(torch.from_numpy(x)).numpy(), jop(jnp.asarray(x))) <= TOL
    assert _rel(op.bench_loop(torch.from_numpy(x), 2).numpy(),
                jop.bench_loop(jnp.asarray(x), 2)) <= TOL


def test_lidx32_in_df64_and_k11_planes(monkeypatch):
    rng = np.random.default_rng(3)
    n = 20000
    r, c = rng.integers(0, n, 60000), rng.integers(0, n, 60000)
    v = rng.standard_normal(60000)
    before = SellDf64SpMV.from_coo_f64(r, c, v, (n, n), device="cpu")
    assert before.plan.chunk == 2048 and before.lidx.dtype == torch.int8
    monkeypatch.setenv("SMVP_SELL_LIDX32", "1")
    op = SellDf64SpMV.from_coo_f64(r, c, v, (n, n), device="cpu")
    jop = jdf.SellDf64SpMV.from_coo_f64(r, c, v, (n, n))
    assert op.lidx.dtype == torch.int32 and jop.lidx.dtype == jnp.int32
    # each operator counts the lane width it holds
    assert op.traffic_bytes() - before.traffic_bytes() == \
        op.plan.n_sublanes * 128 * 3
    a = poisson2d(24).tocoo()
    coo = COOMatrix.from_numpy(a.row, a.col, a.data, shape=a.shape,
                               device="cpu")
    csr = csr_encode(coo)
    sop = tsp.SellSpMV.from_coo(coo)
    planes = P._ic0_planes(sop, ic0(csr))
    assert sop.lidx.dtype == planes.lidx.dtype == torch.int32


@pytest.mark.parametrize("switch", ["SMVP_SELL_SPMM=0", "SMVP_SELL_COMPAT=1"])
def test_matmat_per_column_fallbacks(switch, monkeypatch):
    jp = _plan("resident-chunks")
    tp = plan_from_arrays(plan_fields(jp))
    key, val = switch.split("=")
    monkeypatch.setenv(key, val)
    op = tsp.SellSpMV(tp, device="cpu")
    one = "sell_onehot_plain" if key == "SMVP_SELL_COMPAT" else \
        "sell_spmv_plain"
    calls = _spy(monkeypatch, one, "sell_spmm_plain")
    X = np.random.default_rng(2).standard_normal((3000, 4)).astype(np.float32)
    Y = op.matmat(torch.from_numpy(X))
    assert calls == [one] * 4
    assert _rel(Y.numpy(), jsp.SellSpMV(jp).matmat(jnp.asarray(X))) <= TOL


def test_compat_bench_loop_keeps_k2(monkeypatch):
    jp = _plan("resident-chunks")
    tp = plan_from_arrays(plan_fields(jp))
    monkeypatch.setenv("SMVP_SELL_COMPAT", "1")
    op = tsp.SellSpMV(tp, device="cpu")
    assert op.route == "onehot" and op.bench_route == "relsl"
    calls = _spy(monkeypatch, "sell_bench_loop_plain")
    x = np.random.default_rng(4).standard_normal(3000).astype(np.float32)
    y = op.bench_loop(torch.from_numpy(x), 2)
    assert calls == ["sell_bench_loop_plain"]
    assert _rel(y.numpy(), jsp.SellSpMV(jp).bench_loop(jnp.asarray(x), 2)) \
        <= TOL


@pytest.mark.parametrize("n_split", [1, 2, 4, 9])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_launch_sums_chunk_ranges(n_split, dtype, monkeypatch):
    jp = _plan("resident-chunks")  # 5 chunks: 4 -> ranges 2,2,1; 9 -> 5
    tp = plan_from_arrays(plan_fields(jp))
    tdt, jdt = DTYPES[dtype]
    monkeypatch.setenv("SMVP_SELL_SPLIT", str(n_split))
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    calls = _spy(monkeypatch, "sell_spmv_plain")
    x = np.random.default_rng(7).standard_normal(3000).astype(np.float32)
    y = op(torch.from_numpy(x))
    per = -(-tp.n_chunks // min(n_split, tp.n_chunks))
    assert len(calls) == -(-tp.n_chunks // per)
    assert _rel(y.numpy(), jsp.SellSpMV(jp, value_dtype=jdt)(
        jnp.asarray(x))) <= TOL
    # the JAX gates: a values plane passed in, a streamed plan and COMPAT
    # take one launch
    calls.clear()
    op._apply(torch.from_numpy(x), op.vals.reshape(-1))
    assert len(calls) == 1


def test_split_launch_gates(monkeypatch):
    monkeypatch.setenv("SMVP_SELL_SPLIT", "3")
    st = plan_from_arrays(plan_fields(_plan("streamed")))
    calls = _spy(monkeypatch, "sell_streamy_relsl_plain",
                 "sell_onehot_plain")
    tsp.SellSpMV(st, device="cpu")(torch.zeros(700))
    assert calls == ["sell_streamy_relsl_plain"]
    monkeypatch.setenv("SMVP_SELL_COMPAT", "1")
    tp = plan_from_arrays(plan_fields(_plan("resident-chunks")))
    tsp.SellSpMV(tp, device="cpu")(torch.zeros(3000))
    assert calls[1:] == ["sell_onehot_plain"]


def test_packed_split_launch(monkeypatch):
    jp = _plan("resident-chunks")
    tp = plan_from_arrays(plan_fields(jp))
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    monkeypatch.setenv("SMVP_SELL_SPLIT", "2")
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    assert op.route == "packed"
    calls = _spy(monkeypatch, "sell_packed_plain")
    x = np.random.default_rng(8).standard_normal(3000).astype(np.float32)
    y = op(torch.from_numpy(x))
    assert len(calls) == 2
    assert _rel(y.numpy(), jsp.SellSpMV(jp, value_dtype=jnp.bfloat16)(
        jnp.asarray(x))) <= TOL


def test_docstring_names_the_switches_not_followed():
    doc = tsp.SellSpMV.__doc__
    for name in ("REDUCE1", "REDUCE2", "BF16_TAA", "NOWINDOW", "PREFETCH",
                 "VMEM_MB", "SPMM_GROUP", "RELSL", "LIDX32", "SPMM=0",
                 "SPLIT=N", "COMPAT", "SUBWIN", "SPLIT_CHAIN", "PACK"):
        assert f"SMVP_SELL_{name}" in doc, name
