"""The packed bf16 plane (``SMVP_SELL_PACK=1``): the port's K5 and K2-packed
(plain versions on the CPU) against the JAX operator's packed kernels in
interpret mode.

Both packages run the same plan (``interop.plan_from_arrays``). The
packed word (bf16 value bits 16..31, rel 7..15 with 511 dead, lane 0..6)
equals the JAX ``SellSpMV._packed()`` bit for bit. ``__call__`` (K5,
resident and streamed y), ``matmat`` with k > 1 (K5 with k columns) and
``bench_loop`` (K2-packed) in bf16 agree with the JAX operator under the
switch within 1e-6 of max |y| (the gathers are exact, only the summation
order differs). The gates: float32 values, windows over 511 tiles and a
``vals=`` plane never take the packed route, and a streamed plan's
``bench_loop`` raises under the switch in both packages.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import plan_checks
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

TOL = 1e-6
BLOCK_ROWS = 2048


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _plan(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "resident":
        r, c = rng.randint(0, 6000, 40000), rng.randint(0, 9000, 40000)
        r = np.where(r % 3 == 0, r + 1, r).clip(0, 5999)  # empty rows
        return jplan.build_sell_plan(r, c, rng.randn(40000), (6000, 9000),
                                     chunk=1024)
    if name == "resident-int32-lidx":  # chunk 208: int32 lane indices
        r, c = rng.randint(0, 3000, 20000), rng.randint(0, 2500, 20000)
        return jplan.build_sell_plan(r, c, rng.randn(20000), (3000, 2500),
                                     chunk=208, allow_small_chunk=False)
    if name == "streamed":
        n, nnz = 5000, 9000
        r = rng.randint(0, n, nnz)
        c = np.clip(r + rng.randint(-64, 65, nnz), 0, 699)
        return jplan.build_streamed_sell_plan(r, c, rng.randn(nnz), (n, 700),
                                              chunk=256,
                                              y_block_rows=BLOCK_ROWS)
    assert name == "wide"  # one chunk over 547 column tiles: WT > 511
    r, c = rng.randint(0, 3000, 800), rng.randint(0, 70000, 800)
    return jplan.build_sell_plan(r, c, rng.randn(800), (3000, 70000),
                                 chunk=1024)


@pytest.fixture(scope="module", params=["resident", "resident-int32-lidx",
                                        "streamed"])
def case(request):
    jp = _plan(request.param)
    x = np.random.default_rng(5).standard_normal(jp.shape[1]).astype(
        np.float32)
    return request.param, jp, plan_from_arrays(plan_fields(jp)), x


@pytest.fixture
def packed(monkeypatch):
    monkeypatch.setenv("SMVP_SELL_PACK", "1")


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tsp, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(tsp, name, spy)
    return calls


def test_packed_plane_bit_equal_to_jax(case):
    _, jp, tp, _ = case
    want = np.asarray(jsp.SellSpMV(jp, value_dtype=jnp.bfloat16)._packed())
    got = tsp.packed_plane_host(tp)
    assert got.dtype == np.int32 and got.shape == tp.vals.shape
    assert np.array_equal(got, want)
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    pk, sl = op.packed_planes()
    assert np.array_equal(pk.numpy(), want)
    assert np.array_equal(sl.numpy(), tp.slice_of.reshape(-1))
    # the word's value field is the operator's own bf16 plane
    vals = (pk & -65536).view(torch.float32)
    assert torch.equal(vals, op.vals.float())


def test_call_matches_jax_packed(case, packed, monkeypatch):
    name, jp, tp, x = case
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    assert op.route == ("streamy_packed" if name == "streamed" else "packed")
    assert op.base_route == tsp.plan_route(tp)
    calls = _spy(monkeypatch, "sell_packed_plain")
    before = {n: f.launches for n, f in tsp.PACKED_KERNELS.items()}
    y_t = op(torch.from_numpy(x))
    assert calls == ["sell_packed_plain"]
    assert {n: f.launches for n, f in tsp.PACKED_KERNELS.items()} == before
    y_j = jsp.SellSpMV(jp, value_dtype=jnp.bfloat16)(jnp.asarray(x))
    assert _rel(y_t.numpy(), y_j) <= TOL
    monkeypatch.delenv("SMVP_SELL_PACK")
    assert op.route == op.base_route
    assert _rel(op(torch.from_numpy(x)).numpy(), y_t.numpy()) <= TOL


@pytest.mark.parametrize("k", [2, 8, 17])
def test_matmat_matches_jax_packed(case, packed, monkeypatch, k):
    name, jp, tp, x = case
    X = np.random.default_rng(k).standard_normal((tp.shape[1], k)).astype(
        np.float32)
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    plain = ("sell_packed_plain" if name == "streamed"
             else "sell_packed_spmm_plain")
    calls = _spy(monkeypatch, plain)
    Y_t = op.matmat(torch.from_numpy(X))
    # resident: one k-wide K5 launch; streamed: K5 per column
    assert calls == [plain] * (k if name == "streamed" else 1)
    Y_j = jsp.SellSpMV(jp, value_dtype=jnp.bfloat16).matmat(jnp.asarray(X))
    assert Y_t.shape == (tp.shape[0], k)
    assert _rel(Y_t.numpy(), Y_j) <= TOL


def test_bench_loop_matches_jax_packed(case, packed, monkeypatch):
    name, jp, tp, x = case
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    jop = jsp.SellSpMV(jp, value_dtype=jnp.bfloat16)
    if name == "streamed":  # no streamed packed N-iteration kernel
        with pytest.raises(ValueError, match="streamed-y bench_loop"):
            op.bench_loop(torch.from_numpy(x), 3)
        with pytest.raises(ValueError, match="streamed-y bench_loop"):
            jop.bench_loop(jnp.asarray(x), 3)
        return
    calls = _spy(monkeypatch, "sell_bench_packed_plain")
    y = op.bench_loop(torch.from_numpy(x), 3)
    assert calls == ["sell_bench_packed_plain"]
    assert torch.equal(y, op(torch.from_numpy(x)))  # bit for bit on the CPU
    assert _rel(y.numpy(), jop.bench_loop(jnp.asarray(x), 3)) <= TOL


def test_bench_loop_mat_ignores_the_switch(packed, monkeypatch):
    tp = plan_from_arrays(plan_fields(_plan("resident")))
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (tp.shape[1], 4)).astype(np.float32))
    calls = _spy(monkeypatch, "sell_bench_spmm_plain")
    Y = op.bench_loop_mat(X, 2)
    assert calls == ["sell_bench_spmm_plain"]
    assert _rel(Y.numpy(), op.matmat(X).numpy()) <= TOL


def test_gates_keep_the_unpacked_routes(packed, monkeypatch):
    rng = np.random.default_rng(2)
    calls = _spy(monkeypatch, "sell_packed_plain")
    mcalls = _spy(monkeypatch, "sell_packed_spmm_plain")
    # float32 values
    tp = plan_from_arrays(plan_fields(_plan("resident")))
    f32 = tsp.SellSpMV(tp, device="cpu")
    assert f32.route == "relsl"
    x = torch.from_numpy(rng.standard_normal(tp.shape[1]).astype(np.float32))
    f32(x)
    # WT > 511: the split planes (K4) stay, in both packages
    jw = _plan("wide")
    wide = tsp.SellSpMV(plan_from_arrays(plan_fields(jw)),
                        value_dtype=torch.bfloat16, device="cpu")
    assert wide.route == "split" and wide.plan.window_tiles > 511
    xw = rng.standard_normal(jw.shape[1]).astype(np.float32)
    y_w = wide(torch.from_numpy(xw))
    jop = jsp.SellSpMV(jw, value_dtype=jnp.bfloat16)
    assert _rel(y_w.numpy(), jop(jnp.asarray(xw))) <= TOL
    assert jop._packed_cache is None and wide._packed is None
    with pytest.raises(ValueError, match="9-bit rel"):
        tsp.packed_plane_host(wide.plan)
    # a vals= plane (the training hooks) never takes the packed route
    bf = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    y_v = bf._apply(x, vals=bf.vals.clone())
    Y_v = bf.matmat(torch.stack([x, 2 * x], 1), vals=bf.vals.clone())
    assert calls == [] and mcalls == []
    assert _rel(y_v.numpy(), bf(x).numpy()) <= TOL
    assert calls == ["sell_packed_plain"]
    assert _rel(Y_v[:, 1].numpy(), 2 * y_v.numpy()) <= TOL


def test_traffic_bytes_of_the_packed_route(case):
    _, _, tp, _ = case
    per_chunk = 2 if tp.y_block_slices else 1
    want = (tp.n_sublanes * 128 * 4 + tp.n_sublanes * 4
            + tp.n_chunks * 4 * per_chunk + tp.n_coltiles * 128 * 2
            + tp.n_slices * 128 * 4)
    assert tp.traffic_bytes(2, x_bytes=2, packed=True) == want
    # a third more than the merged word's planes (bf16 + int8 + one word)
    if tp.merged_word and tp.chunk % 32 == 0:
        assert tp.traffic_bytes(2, x_bytes=2) < want


def test_packed_plane_checks():
    tp = plan_from_arrays(plan_fields(_plan("resident")))
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    pk, sl = op.packed_planes()
    xt = op._x_tiles(torch.ones(tp.shape[1]))
    kw = op._kw()
    with pytest.raises(TypeError, match="bfloat16"):
        tsp.sell_packed(pk, sl, op.tile_base, xt.float(), **kw)
    with pytest.raises(ValueError, match="one row per slice id"):
        tsp.sell_packed(pk[:-1], sl, op.tile_base, xt, **kw)
    with pytest.raises(TypeError, match="int32"):
        tsp.sell_packed(pk, sl.long(), op.tile_base, xt, **kw)
    with pytest.raises(ValueError, match="iterations"):
        tsp.sell_bench_packed(pk, sl, op.tile_base, xt, iterations=0, **kw)
    with pytest.raises(TypeError):
        tsp.sell_packed_spmm(pk, sl, op.tile_base,
                             torch.ones(tp.n_coltiles * 128, 3),
                             **op._mat_kw())
    with pytest.raises(ValueError, match="9-bit rel"):
        plan_checks.check_packed_plan(
            plan_from_arrays(plan_fields(_plan("wide"))))
