"""The port's chunk autotuner (``ops/autotune.py``) on the CPU.

The card's cost model picks the chunk; the plan at that chunk is the JAX
planner's field for field (``_auto_plan`` of the JAX package at the
picked chunk, and of the whole sweep: the pick is the cheapest of the
JAX-built candidates where it beats chunk 2048's by the margin, else
chunk 2048's), and the operator on it gives the JAX operator's y
at that chunk (Pallas interpret mode) within 1e-6 of max |y| in both value
dtypes (the suite's bound: the gathers are exact, the summation order
differs). Under ``SMVP_SELL_AUTOTUNE=0`` the plan is the JAX
``_tuned_plan``'s, chunk 2048. ``rechunk_plan`` (the sweep's cut of one
sort at every chunk) equals the JAX planner at every chunk; the fit
recovers planted rates and refits the shipped records to the shipped
rates; the entry points plan through ``_tuned_plan``.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import (
    coo_from_triplets,
    plan_fields,
    plan_from_arrays,
)
from smvp_toolkit_tpu_torch.ops import autotune as ta
from smvp_toolkit_tpu_torch.ops import sell_plan as tplan
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

TOL = 1e-6
DTYPES = {False: (torch.float32, jnp.float32),
          True: (torch.bfloat16, jnp.bfloat16)}


def _matrix(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "banded":  # chunks up to 2048 stay below the sublane count
        n, nnz = 40000, 400000
        r = rng.integers(0, n, nnz)
        c = np.clip(r + rng.integers(-64, 65, nnz), 0, n - 1)
        return r, c, rng.standard_normal(nnz), (n, n)
    if kind == "powerlaw":  # hub columns, wide windows
        n, nnz = 30000, 200000
        r = rng.integers(0, n, nnz)
        c = (n * rng.power(0.3, nnz)).astype(np.int64) % n
        return r, c, rng.standard_normal(nnz), (n, n)
    if kind == "small":  # the planner shrinks the chunk
        n, nnz = 900, 5000
        r, c = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
        return r, c, rng.standard_normal(nnz), (n, n)
    if kind == "wide-x":  # 1.7M columns: a wide x
        n, m, nnz = 3000, 1_700_000, 30000
        r = rng.integers(0, n, nnz)
        c = rng.integers(0, m, nnz)
        return r, c, rng.standard_normal(nnz), (n, m)
    if kind == "split":  # few entries over many tiles: WT 560 at 2048
        n, m, nnz = 3000, 70000, 1800
        r = rng.integers(0, n, nnz)
        c = rng.integers(0, m, nnz)
        return r, c, rng.standard_normal(nnz), (n, m)
    raise AssertionError(kind)


KINDS = ("banded", "powerlaw", "small", "wide-x")


def _fields_equal(a, b):
    for (name, x), y in zip(plan_fields(a).items(), plan_fields(b).values()):
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), name
        else:
            assert x == y, name


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_tuned_plan_is_the_jax_plan_at_the_pick(kind, bf16, monkeypatch):
    """The pick is the cheapest of the JAX-built sweep on the card's model
    where it is ``MARGIN`` cheaper than the JAX ``_auto_plan`` at chunk
    2048, else that plan; the tuned plan is the JAX ``_auto_plan`` at its
    chunk."""
    monkeypatch.delenv("SMVP_SELL_AUTOTUNE", raising=False)
    r, c, v, shape = _matrix(kind)
    tp, none = ta._tuned_plan(r, c, v, shape, bf16=bf16)
    assert none is None
    rates = ta.production_rates()
    costs = {}
    for chunk in ta.CHUNKS:
        jp = jsp._auto_plan(r, c, v, shape, chunk=chunk)
        costs[jp.chunk] = ta.plan_cost_us(
            plan_from_arrays(plan_fields(jp)), 2 if bf16 else 4, rates)
        if jp.chunk < chunk:
            break
    default = jsp._auto_plan(r, c, v, shape, chunk=2048).chunk
    cheapest = min(costs, key=lambda ch: (costs[ch], ch))
    want = (cheapest if costs[cheapest] < (1 - ta.MARGIN) * costs[default]
            else default)
    assert tp.chunk == want
    _fields_equal(tp, jsp._auto_plan(r, c, v, shape, chunk=tp.chunk))
    assert ta.pick_plan(r, c, v, shape, bf16=bf16, rates=rates)[1] == \
        pytest.approx(costs[tp.chunk], rel=1e-12)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_tuned_operator_y_equals_jax_at_the_pick(kind, bf16, monkeypatch):
    monkeypatch.delenv("SMVP_SELL_AUTOTUNE", raising=False)
    r, c, v, shape = _matrix(kind)
    tdt, jdt = DTYPES[bf16]
    op = tsp.SellSpMV.from_coo(coo_from_triplets(r, c, v, shape,
                                                 device="cpu"),
                               value_dtype=tdt, device="cpu")
    jp = jsp._auto_plan(r, c, v, shape, chunk=op.plan.chunk)
    x = np.random.default_rng(5).standard_normal(shape[1]).astype(np.float32)
    y_t = op(torch.from_numpy(x))
    y_j = jsp.SellSpMV(jp, value_dtype=jdt)(jnp.asarray(x))
    assert y_t.shape == (shape[0],)
    assert _rel(y_t.numpy(), np.asarray(y_j)[: shape[0]]) <= TOL


@pytest.mark.parametrize("autotune", ["0"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["banded", "small"])
def test_tuned_plan_equals_jax(kind, bf16, autotune, monkeypatch):
    """``SMVP_SELL_AUTOTUNE=0``: chunk 2048 and the JAX plan."""
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", autotune)
    r, c, v, shape = _matrix(kind)
    jp, jv = jsp._tuned_plan(r, c, v, shape, bf16=bf16)
    tp, tv = ta._tuned_plan(r, c, v, shape, bf16=bf16)
    assert tv == jv
    _fields_equal(tp, jp)
    if autotune == "0":
        assert tv is None and tp.chunk <= 2048


def test_small_matrix_shrinks_the_chunk():
    r, c, v, shape = _matrix("small")
    plan, _ = ta.pick_plan(r, c, v, shape)
    assert plan.chunk < 512 and plan.n_chunks == 1


def test_sweep_stops_where_the_planner_shrinks():
    """A matrix of 1,256 sublanes: 512 and 1024, then 2048 shrinks to the
    sublane count and ends the sweep (the JAX sweep's rule)."""
    rng = np.random.default_rng(3)
    n, nnz = 2000, 40000
    r, c = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    chunks = [p.chunk for p in ta.sweep_plans(r, c, v, (n, n))]
    s_true = jplan.build_sell_plan(r, c, v, (n, n), chunk=8192).chunk
    assert 1024 < s_true < 2048
    assert chunks == [512, 1024, s_true]


@pytest.mark.parametrize("costs,want", [
    ({512: 98.5, 1024: 99.0, 2048: 100.0}, 2048),  # 1.5%: inside
    ({512: 97.9, 1024: 99.0, 2048: 100.0}, 512),   # 2.1%: beyond
    ({4096: 90.0, 2048: 100.0, 8192: 95.0}, 4096),
    ({512: 100.0, 2048: 100.0}, 2048),             # a tie keeps 2048
])
def test_pick_keeps_chunk_2048_within_the_margin(costs, want, monkeypatch):
    """The sweep leaves chunk 2048 only for a candidate modelled
    ``MARGIN`` (2%) cheaper; a chunk the table leaves out is dearest."""
    assert ta.MARGIN == 0.02 and ta.DEFAULT_CHUNK == 2048
    monkeypatch.setattr(ta, "plan_cost_us",
                        lambda plan, *a: costs.get(plan.chunk, 1e9))
    r, c, v, shape = _matrix("banded")
    plan, cost = ta.pick_plan(r, c, v, shape)
    assert (plan.chunk, cost) == (want, costs[want])
    _fields_equal(plan, jsp._auto_plan(r, c, v, shape, chunk=want))


def _streamed(rng):
    """A streamed plan's triplets: four y blocks of 2048 rows, the second
    empty, hub columns."""
    n = 4 * 2048
    r = rng.integers(0, n, 50000)
    r = r[(r < 2048) | (r >= 2 * 2048)]
    c = (n * rng.power(0.3, len(r))).astype(np.int64) % n
    return r, c, rng.standard_normal(len(r)), (n, n)


@pytest.mark.parametrize("kind", KINDS + ("split", "empty", "streamed"))
def test_rechunk_equals_the_jax_planner(kind):
    """One sort cut at every chunk: each candidate equals the JAX planner's
    plan at its chunk, from a base of any chunk."""
    if kind == "streamed":
        r, c, v, shape = _streamed(np.random.default_rng(1))

        def build(mod, chunk):
            return mod.build_streamed_sell_plan(r, c, v, shape, chunk=chunk,
                                                y_block_rows=2048)
    else:
        if kind == "empty":
            e = np.zeros(0, np.int64)
            r, c, v, shape = e, e, np.zeros(0), (300, 500)
        else:
            r, c, v, shape = _matrix(kind)

        def build(mod, chunk):
            return mod.build_sell_plan(r, c, v, shape, chunk=chunk)
    for base_chunk in (512, 2048):
        base = build(tplan, base_chunk)
        for chunk in ta.CHUNKS + (200,):
            want = build(jplan, chunk)
            _fields_equal(tplan.rechunk_plan(base, chunk), want)
            # the sweep's candidates: the geometry without the planes
            bare = tplan.rechunk_plan(base, chunk, planes=False)
            assert bare.vals.shape == want.vals.shape
            assert not bare.vals.any() and not bare.lane_idx.any()
            _fields_equal(dataclasses.replace(
                bare, vals=np.asarray(want.vals),
                lane_idx=np.asarray(want.lane_idx)), want)


def _synthetic_records(rates, rng, n=60):
    recs = []
    for i in range(n):
        bf16 = bool(i % 2)
        route = ("relsl", "split", "streamy_relsl", "streamy")[i % 4]
        s = int(rng.integers(1000, 2_000_000))
        rec = dict(name=f"m{i // 10}", chunk=int(512 * 2 ** (i % 5)),
                   dtype="bfloat16" if bf16 else "float32", route=route,
                   S=s, live=int(s * rng.uniform(0.8, 1.0)),
                   hub=int(rng.integers(1, 200_000)), lidx_bytes=1,
                   n_chunks=max(1, s // int(rng.integers(512, 8192))),
                   traffic_bytes=int(s * rng.uniform(700, 900)
                                     + rng.integers(0, 10 ** 8)),
                   err=0.0, spread=0.01)
        rec["us"] = float(ta._record_terms(rec) @ ta._coefs(rates))
        recs.append(rec)
    return recs


def test_calibrate_recovers_planted_rates():
    planted = {"gb_s_f32": 2700.0, "gb_s_bf16": 2100.0,
               "hub_sublane_ns": 1.5, "launch_us": 4.0}
    recs = _synthetic_records(planted, np.random.default_rng(0))
    # records the fit must drop: a kernel off its plain version, repeats
    # that disagree, no time
    bad = [dict(recs[0], err=1e-3, us=1e6), dict(recs[1], spread=0.5,
                                                  us=1e6),
           dict(recs[2], us=None)]
    fit = ta.calibrate_rates(recs + bad)
    assert fit["calibrated_on"] == len(recs)
    for k, want in planted.items():
        assert fit[k] == pytest.approx(want, rel=1e-6), k
    with pytest.raises(ValueError):
        ta.calibrate_rates(recs[:3])


def test_check_pick_plan_verdicts():
    rates = {"gb_s_f32": 1000.0, "gb_s_bf16": 1000.0, "launch_us": 1.0}
    base = dict(name="a", dtype="float32", route="relsl", n_chunks=4,
                err=0.0, spread=0.0, live=5000, hub=10, lidx_bytes=1)
    recs = [dict(base, chunk=512, S=5000, traffic_bytes=10 ** 6, us=5.0),
            dict(base, chunk=2048, S=6000, traffic_bytes=2 * 10 ** 6,
                 us=4.0),
            dict(base, chunk=512, name="b", S=5000, traffic_bytes=10 ** 6,
                 us=2.0),
            # modelled 1% cheaper than chunk 2048: inside the margin
            dict(base, chunk=512, name="c", S=5000,
                 traffic_bytes=1_970_000, us=3.0),
            dict(base, chunk=2048, name="c", S=6000,
                 traffic_bytes=2 * 10 ** 6, us=4.0)]
    a, c = ta.check_pick_plan(recs, rates)
    assert a == ("a float32: measured best chunk=2048 (4.00 us), model "
                 "picks 512 (5.00 us, 1.250x the best, 1.250x chunk "
                 "2048) -> MISMATCH")
    assert c == ("c float32: measured best chunk=512 (3.00 us), model "
                 "picks 2048 (4.00 us, 1.333x the best, 1.000x chunk "
                 "2048) -> MISMATCH")


def test_shipped_records_refit_to_the_shipped_rates():
    recs = [json.loads(ln) for ln in
            ta.RECORDS_FILE.read_text().splitlines() if ln.strip()]
    shipped = json.loads((ta.RECORDS_FILE.parent
                          / "autotune_rates.json").read_text())
    fit = ta.calibrate_rates(recs)
    assert fit["calibrated_on"] == shipped["calibrated_on"]
    for k in ta.RATES:
        assert fit[k] == pytest.approx(shipped[k], rel=1e-9, abs=1e-12), k
    assert ta.production_rates() == {k: shipped[k] for k in ta.RATES}
    # every record is one candidate of a sweep, with the geometry the
    # model reads and its median card time
    for rec in recs:
        assert {"name", "chunk", "dtype", "route", "S", "n_chunks",
                "traffic_bytes", "us", "us_repeats"} <= set(rec)


def test_rates_file_names_the_card():
    data = json.loads((ta.RECORDS_FILE.parent
                       / "autotune_rates.json").read_text())
    assert "H100" in data["device"]["name"]
    assert data["device"]["power_limit"].endswith(" W")
    assert set(ta.RATES) <= set(data)
    for tpu_key in ("hbm_gb_s", "mxu_mac_us", "shuffle_gel_s",
                    "grid_step_us"):
        assert tpu_key not in data
    assert 819.0 not in data.values()


@pytest.mark.parametrize("relsl", ["1", "0"])
@pytest.mark.parametrize("kind", ["banded", "split", "streamed"])
def test_plan_cost_prices_the_operator_route(kind, relsl, monkeypatch):
    monkeypatch.setenv("SMVP_SELL_RELSL", relsl)
    if kind == "streamed":
        r, c, v, shape = _streamed(np.random.default_rng(2))
        plan = tplan.build_streamed_sell_plan(r, c, v, shape, chunk=512,
                                              y_block_rows=2048)
    else:
        plan = tsp._auto_plan(*_matrix(kind))
    op = tsp.SellSpMV(plan, device="cpu")
    assert ta.plan_route(plan) == op.route
    split = op.route in ("split", "streamy")
    rates = {"gb_s_f32": 2000.0, "gb_s_bf16": 1500.0,
             "hub_sublane_ns": 2.0, "launch_us": 3.0}
    live = ((plan.rel_tile.reshape(-1) >= 0)
            & (plan.slice_of.reshape(-1) >= 0))
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    if plan.y_block_slices:
        sl += np.repeat(plan.y_block_id, plan.chunk) * plan.y_block_slices
    hub = int(np.bincount(sl[live]).max())
    assert ta.hub_sublanes(plan) == hub
    for vb, rate in ((4, 2000.0), (2, 1500.0)):
        nbytes = plan.traffic_bytes(vb, x_bytes=vb)
        if split and plan.merged_word:  # the split planes read two words
            nbytes += 4 * plan.n_sublanes
        assert ta.plan_bytes(plan, vb) == nbytes
        # the dead sublanes' values and lanes are never read
        moved = nbytes - (plan.n_sublanes - int(live.sum())) * 128 * (
            vb + (1 if plan.chunk % 32 == 0 else 4))
        want = moved / (rate * 1e3) + hub * 2.0 * 1e-3 + 3.0
        assert ta.plan_cost_us(plan, vb, rates) == pytest.approx(want,
                                                                 rel=1e-12)




@pytest.mark.parametrize("entry", ["from_coo", "csr", "tjds", "coo",
                                   "cocluster"])
def test_entry_points_plan_through_the_tuner(entry, monkeypatch):
    monkeypatch.delenv("SMVP_SELL_AUTOTUNE", raising=False)
    # a model that wants the smallest chunk: 512, not the 2048 of
    # SMVP_SELL_AUTOTUNE=0
    monkeypatch.setattr(ta, "plan_cost_us", lambda plan, *a: plan.chunk)
    r, c, v, shape = _matrix("banded")
    coo = coo_from_triplets(r, c, v, shape, device="cpu")
    if entry == "from_coo":
        op = tsp.SellSpMV.from_coo(coo, device="cpu")
    elif entry == "csr":
        op = tsp.sell_op_csr(csr_encode(coo))
    elif entry == "tjds":
        from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode

        op = tsp.sell_op_tjds(tjds_encode(coo))
    elif entry == "coo":
        op = tsp.sell_op_coo(coo)
    else:
        from smvp_toolkit_tpu_torch.ops.cocluster import cocluster_plan

        cc = tsp.CoClusteredSellSpMV(coo, device="cpu", passes=1)
        _res, plan, none = cocluster_plan(r, c, v, shape, passes=1)
        assert none is None
        _fields_equal(cc.inner.plan, plan)
        op = cc.inner
    assert op.plan.chunk == 512
    if entry != "cocluster":
        rr, cc_, vv = op._triplets
        _fields_equal(op.plan, ta._tuned_plan(rr, cc_, vv, shape,
                                              bf16=False)[0])
        # Aᵀ keeps the JAX operator's chunk 2048
        assert op.transpose().plan.chunk == 2048
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")
    if entry == "from_coo":
        assert tsp.SellSpMV.from_coo(coo, device="cpu").plan.chunk == 2048
