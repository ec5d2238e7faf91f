"""The port's autotuner logic against the JAX package's.

``ops/autotune.py`` of both packages at the shipped rates on the same
matrices (numpy seeds): ``pick_plan``'s chunk and every plan field equal,
its cost within rtol 1e-12; the JAX byte count the model charges
(``jax_traffic_bytes`` against the JAX ``SellPlan.traffic_bytes``),
``plan_cost_us``, ``_tuned_plan``, the split policy, the VMEM pick and
the calibration helpers equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from smvp_toolkit_tpu.ops import autotune as ja
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import autotune as ta


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
    if kind == "wide-x":  # x beyond the resident limit: windows charged
        n, m, nnz = 3000, 1_700_000, 30000
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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_pick_plan_equals_jax(kind, bf16):
    r, c, v, shape = _matrix(kind)
    jp, jcost = ja.pick_plan(r, c, v, shape, bf16=bf16,
                             rates=ja.production_rates())
    tp, tcost = ta.pick_plan(r, c, v, shape, bf16=bf16,
                             rates=ta.production_rates())
    assert tp.chunk == jp.chunk
    assert tcost == pytest.approx(jcost, rel=1e-12, abs=0)
    _fields_equal(tp, jp)
    # the default rates too
    assert ta.pick_plan(r, c, v, shape, bf16=bf16)[0].chunk == \
        ja.pick_plan(r, c, v, shape, bf16=bf16)[0].chunk


def test_small_matrix_shrinks_the_chunk():
    r, c, v, shape = _matrix("small")
    plan, _ = ta.pick_plan(r, c, v, shape)
    assert plan.chunk < 512 and plan.n_chunks == 1


@pytest.mark.parametrize("lidx32", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_traffic_bytes_and_cost_equal_jax(kind, lidx32, monkeypatch):
    if lidx32:
        monkeypatch.setenv("SMVP_SELL_LIDX32", "1")
    r, c, v, shape = _matrix(kind)
    for chunk in (200, 1024, 2048):
        jp = jplan.build_sell_plan(r, c, v, shape, chunk=chunk)
        tp = plan_from_arrays(plan_fields(jp))
        for vb in (4, 2):
            assert ta.jax_traffic_bytes(tp, vb, None, vb) == \
                jp.traffic_bytes(vb, None, vb)
            assert ta.jax_traffic_bytes(tp, vb, 4, vb) == \
                jp.traffic_bytes(vb, 4, vb)
        for kw in ({}, dict(table_passes=1, reduce_passes=3),
                   dict(rates=ja.production_rates())):
            assert ta.plan_cost_us(tp, 2, **kw) == pytest.approx(
                ja.plan_cost_us(jp, 2, **kw), rel=1e-12, abs=0)


def test_wide_x_charges_windows():
    r, c, v, shape = _matrix("wide-x")
    tp = plan_from_arrays(plan_fields(jplan.build_sell_plan(
        r, c, v, shape, chunk=2048)))
    assert tp.n_coltiles * 128 * 4 > ta._RESIDENT_X_LIMIT
    s = tp.n_sublanes
    want = (s * 128 * 5 + s * 8 + tp.n_chunks * 4
            + tp.n_chunks * tp.window_tiles * 128 * 4
            + tp.n_slices * 128 * 4)
    assert ta.jax_traffic_bytes(tp) == want


@pytest.mark.parametrize("autotune", ["1", "0"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["banded", "small"])
def test_tuned_plan_equals_jax(kind, bf16, autotune, monkeypatch):
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", autotune)
    r, c, v, shape = _matrix(kind)
    jp, jv = jsp._tuned_plan(r, c, v, shape, bf16=bf16)
    tp, tv = ta._tuned_plan(r, c, v, shape, bf16=bf16)
    assert tv == jv
    _fields_equal(tp, jp)
    if autotune == "0":
        assert tv is None and tp.chunk <= 2048


def test_rates_split_and_vmem_equal_jax(monkeypatch):
    assert ta.RATES == ja.RATES
    assert ta.production_rates() == ja.production_rates()
    for chunk in (8, 200, 512, 1024, 1536, 2048, 2560, 4096, 8192, 16384):
        assert ta.pick_vmem_mb(chunk) == ja.pick_vmem_mb(chunk)
        for k in (1, 8):
            assert ta._split_policy(chunk, k) == jsp._split_policy(chunk, k)
        monkeypatch.delenv("SMVP_SELL_SPLIT_CHAIN", raising=False)
        assert ta.chain_split(chunk) == jsp._chain_setting(chunk, 1)[0]
        monkeypatch.setenv("SMVP_SELL_SPLIT_CHAIN", "2")
        assert ta.chain_split(chunk) == jsp._chain_setting(chunk, 1)[0] == 2


def _records():
    """Session records in the JAX calibration's schema (numpy seed)."""
    rng = np.random.default_rng(0)
    recs = []
    for name in ("a", "b", "c"):
        for chunk in (512, 1024, 2048):
            for bf16 in (False, True):
                s = int(rng.integers(1000, 50000))
                recs.append(dict(
                    name=name, chunk=chunk, bf16=bf16, S=s,
                    WT=int(rng.integers(16, 200)),
                    NSW=int(rng.integers(16, 400)),
                    n_chunks=max(1, s // chunk),
                    traffic_bytes=int(rng.integers(10**6, 10**8)),
                    avg_us=float(rng.uniform(5, 500)), err=1e-5))
    recs.append(dict(recs[0], precision="HIGH", name="p"))
    recs.append(dict(recs[1], reduce2=True, name="q"))
    recs.append(dict(recs[2], env_compat=True))
    recs.append(dict(recs[3], err=0.5))
    recs.append({"avg_us": 3.0, "kind": "grad"})
    return recs


def test_calibration_helpers_equal_jax():
    recs = _records()
    for rec in recs:
        if "S" in rec:
            assert ta._passes(rec) == ja._passes(rec)
            assert ta._cost_terms(rec) == ja._cost_terms(rec)
    for rec in ({"precision": "HIGHEST"}, {"precision": "HIGH"},
                {"bf16": True, "reduce2": True}, {"reduce2": True}):
        assert ta._passes(rec) == ja._passes(rec)
    assert ta._usable(recs) == ja._usable(recs)
    assert ta.calibrate_rates(recs) == ja.calibrate_rates(recs)
    assert ta.calibrate_rates(recs[:2]) == ja.calibrate_rates(recs[:2])
    rates = ta.calibrate_rates(recs)
    assert ta.check_pick_plan(recs, rates) == ja.check_pick_plan(recs, rates)
    assert ta.check_pick_plan(recs, ta.production_rates()) == \
        ja.check_pick_plan(recs, ja.production_rates())
