"""Streamed-y planner: every plan field equal to the JAX planner's.

``build_streamed_sell_plan``, ``common_window`` and ``rewindow_plan`` of
the port against the JAX package's, field for field (including
``y_block_id``, ``y_block_slices``, ``slice_base``, ``slice_window``,
``window_tiles`` and ``n_slices``), small y blocks (2048 rows) so that
several blocks occur at small sizes. Also the ``_auto_plan`` switch to a
streamed plan above ``_RESIDENT_Y_LIMIT``, the route each plan runs on and
the route-aware ``traffic_bytes``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.ops import sell_plan as tplan
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

BLOCK_ROWS = 2048


def _assert_plans_equal(t, j):
    for f in dataclasses.fields(jplan.SellPlan):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


def _triplets(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "banded":
        n, nnz = 5000, 9000
        r = rng.randint(0, n, size=nnz)
        c = np.clip(r + rng.randint(-64, 65, size=nnz), 0, 699)
        return r, c, rng.randn(nnz), (n, 700)
    if name == "uniform":
        r, c = rng.randint(0, 4500, 6000), rng.randint(0, 3000, 6000)
        return r, c, rng.randn(6000), (4500, 3000)
    if name == "empty-middle":
        r = np.array([5, 17, 2 * BLOCK_ROWS + 9])
        return r, np.array([3, 499, 123]), np.array([1.5, -2.0, 4.25]), (
            3 * BLOCK_ROWS, 500)
    if name == "wide":  # few entries over 547 column tiles: WT > 511
        r, c = rng.randint(0, 4200, 1500), rng.randint(0, 70000, 1500)
        return r, c, rng.randn(1500), (4200, 70000)
    if name == "wide-few":  # one chunk over 547 column tiles: WT > 511
        r, c = rng.randint(0, 3000, 800), rng.randint(0, 70000, 800)
        return r, c, rng.randn(800), (3000, 70000)
    if name == "nnz0":
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0), (5000, 300)
    raise AssertionError(name)


CASES = [("banded", 256), ("banded", 208), ("uniform", 512),
         ("empty-middle", 256), ("wide", 1024), ("nnz0", 256)]
IDS = [f"{n}-c{c}" for n, c in CASES]


def _streamed(name, chunk):
    r, c, v, shape = _triplets(name)
    kw = dict(chunk=chunk, y_block_rows=BLOCK_ROWS)
    return (tplan.build_streamed_sell_plan(r, c, v, shape, **kw),
            jplan.build_streamed_sell_plan(r, c, v, shape, **kw))


@pytest.mark.parametrize("name,chunk", CASES, ids=IDS)
def test_streamed_plan_every_field_equal(name, chunk):
    t, j = _streamed(name, chunk)
    _assert_plans_equal(t, j)
    assert t.y_block_slices == BLOCK_ROWS // 128
    assert t.n_slices == t.y_block_slices * (int(t.y_block_id.max()) + 1)
    assert (np.diff(t.y_block_id) >= 0).all()
    assert (t.slice_of < t.y_block_slices).all()  # block-local slice ids


def test_streamed_plan_block_layout():
    t, _ = _streamed("empty-middle", 256)
    # every block has at least one chunk; the middle one is all dead
    assert set(t.y_block_id.tolist()) == {0, 1, 2}
    mid = t.y_block_id == 1
    assert (t.slice_of[mid] == -1).all()
    with pytest.raises(ValueError, match="2048"):
        tplan.build_streamed_sell_plan(*_triplets("banded")[:3], (5000, 700),
                                       y_block_rows=1000)


@pytest.mark.parametrize("min_wt", [16, 64, 600])
def test_rewindow_plan_equal(min_wt):
    r, c, v, shape = _triplets("uniform")
    t = tplan.build_sell_plan(r, c, v, shape, chunk=256)
    j = jplan.build_sell_plan(r, c, v, shape, chunk=256)
    _assert_plans_equal(tplan.rewindow_plan(t, min_wt),
                        jplan.rewindow_plan(j, min_wt))
    # equal to planning with the wider window in the first place
    _assert_plans_equal(tplan.rewindow_plan(t, min_wt),
                        tplan.build_sell_plan(r, c, v, shape, chunk=256,
                                              min_window_tiles=min_wt))


def test_common_window_equal():
    subs_t, subs_j = [], []
    for seed, ncols in ((1, 3000), (2, 9000), (3, 1200)):
        rng = np.random.RandomState(seed)
        r, c = rng.randint(0, 2048, 3000), rng.randint(0, ncols, 3000)
        v = rng.randn(3000)
        kw = dict(chunk=256, allow_small_chunk=False)
        subs_t.append(tplan.build_sell_plan(r, c, v, (2048, 9000), **kw))
        subs_j.append(jplan.build_sell_plan(r, c, v, (2048, 9000), **kw))
    pt, wt_t, nsw_t, bt = tplan.common_window(subs_t, 16)
    pj, wt_j, nsw_j, bj = jplan.common_window(subs_j, 16)
    assert (wt_t, nsw_t) == (wt_j, nsw_j)
    for a, b in zip(pt, pj):
        _assert_plans_equal(a, b)
    for a, b in zip(bt, bj):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("nrows,streamed", [(1000, False), (3000, True)])
def test_auto_plan_threshold_matches_jax(monkeypatch, nrows, streamed):
    # 1024 bytes of y: 256 rows resident; the JAX test's cut
    monkeypatch.setattr(tsp, "_RESIDENT_Y_LIMIT", 1024 if streamed else
                        tsp._RESIDENT_Y_LIMIT)
    monkeypatch.setattr(jsp, "_RESIDENT_Y_LIMIT", 1024 if streamed else
                        jsp._RESIDENT_Y_LIMIT)
    r, c, v = np.array([0, 10, 2999 % nrows]), np.array([1, 2, 3]), np.array(
        [1.0, 2.0, -1.0])
    t = tsp._auto_plan(r, c, v, (nrows, 128))
    j = jsp._auto_plan(r, c, v, (nrows, 128))
    _assert_plans_equal(t, j)
    assert bool(t.y_block_slices) == streamed
    assert t.y_block_slices in (0, tsp._STREAM_Y_BLOCK_ROWS // 128)


def test_auto_plan_cut_is_the_jax_cut():
    assert tsp._RESIDENT_Y_LIMIT == jsp._RESIDENT_Y_LIMIT
    assert tsp._STREAM_Y_BLOCK_ROWS == jsp._STREAM_Y_BLOCK_ROWS


ROUTE_CASES = [("banded", 256, False, "relsl"),
               ("banded", 256, True, "streamy_relsl"),
               ("wide", 1024, True, "streamy"),
               ("wide-few", 1024, False, "split")]


@pytest.mark.parametrize("name,chunk,streamed,route", ROUTE_CASES,
                         ids=[c[3] for c in ROUTE_CASES])
def test_route_and_traffic_bytes(name, chunk, streamed, route):
    r, c, v, shape = _triplets(name)
    if streamed:
        t, j = _streamed(name, chunk)
    else:
        t = tplan.build_sell_plan(r, c, v, shape, chunk=chunk)
        j = jplan.build_sell_plan(r, c, v, shape, chunk=chunk)
    assert tsp.plan_route(t) == route
    # the JAX operator's merged-word gate (spmv_pallas.py relsl route)
    assert t.merged_word == (j.window_tiles <= jsp._PACK_WT_MAX
                             and j.n_slices < jsp._RELSL_SL_DEAD)
    s, nch = t.n_sublanes, t.n_chunks
    for vb in (4, 2):
        # JAX charges both split words and no y_block_id
        jax_bytes = j.traffic_bytes(vb, x_bytes=vb, x_resident=True)
        want = (jax_bytes - (4 * s if t.merged_word else 0)
                + (4 * nch if streamed else 0))
        assert t.traffic_bytes(vb, x_bytes=vb) == want
