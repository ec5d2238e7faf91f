"""K5 with k columns on the k-column body, emulated in numpy, against the
port's plain version and the JAX package's packed SpMM.

``sell_packed_spmm_kernel`` (``csrc/sell_packed.cu``) runs
``sell_common.cuh::sublane_mat_sweep`` under ``PackedShuffle``: a block
per work item (up to 64 sublanes of one chunk) and column block of
``spmm_shape(k)``. It stages each sublane's slice from ``slice_of`` (dead
where it is -1); step 1 takes rel from the lane-0 word it loads (a dead
rel clears the sublane's mask) and ballots the nonzero value bits (``w &
0xFFFF0000``) of each live sublane's words; step 2 cuts runs of sublanes of one slice (a new run where the slice
changes or the sublane's index in the item is a multiple of 16); step 3
takes each unit (a run and one lane it touches), sums v·X[col, block's
columns] over the run's sublanes whose mask holds the lane, the value and
lane index (``w & 127``) from the slot's own word, rel from the staging,
and adds the sums into that row of Y once. A zero value is never
multiplied, so an Inf in X at a padding lane's column never reaches Y.
``PackedStage`` (rel staged from the lane-0 word, a dead one ending the
run; ``stage_rel=True``) is the form timed against it.

``_packed_sweep`` is that walk. On the packed test plans of
``test_torch_packed`` (resident, and resident with int32 lane indices at
chunk 208, whose items end in a run of 16 sublanes) and on the hub-row
plan of ``tests/torch_kcol_plans.py`` (200 duplicate sublanes of one row
past several items and units), each also rewritten by
``bench_variants.disagreeing_lanes`` (lanes 1..127 carrying another rel
than lane 0's), and with the lane-0 rel of every third live sublane set
dead (the reference drops those sublanes), at k = 2, 8 and 17 (scalar and vector column shapes), it
equals ``sell_packed_spmm_plain`` within the plan's SpMM tolerance
(``bench_variants.spmm_tolerance``), in both forms, and the JAX
operator's packed
``matmat`` (``SMVP_SELL_PACK=1``, its Pallas kernel in interpret mode, rel
from lane 0 too) within 1e-5 of max |Y|, ``test_torch_spmm``'s tolerance
against the JAX operator. At k = 300 (three column blocks of 128) it
equals the plain version, and with Inf in X at a padding lane's column,
every real entry of that column zeroed in its word, Y stays finite.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.bench.bench_variants import spmm_tolerance
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

import test_torch_packed as packed_cases
import torch_kcol_plans as kcol
import torch_packed_plans as pp

LANES = pp.LANES
RUN = 64   # sublanes of a work item (sell_common.cuh, kRun)
CAP = 16   # sublanes a unit sums at most (kMatRunCap)
TOL_JAX = 1e-5
PLANS = ["resident", "resident-int32-lidx", "hub-row"]
PLANES = ["own", "disagreeing-lanes", "dead-lane-zero"]


@functools.lru_cache(maxsize=None)
def _plans(name):
    """(JAX plan, the port's bf16 operator) of ``name``, the same arrays."""
    if name == "hub-row":
        r, c, v, shape, chunk = kcol.hub_row_triplets("relsl")
        jp = jplan.build_sell_plan(r, c, v, shape, chunk=chunk,
                                   allow_small_chunk=False)
    else:
        jp = packed_cases._plan(name)
    tp = plan_from_arrays(plan_fields(jp))
    return jp, tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")


def _plane(op, which):
    """The operator's packed plane; its copy with disagreeing lanes; or its
    copy with the lane-0 rel of every third live sublane set dead (511),
    which the reference reads as a dead sublane whatever its slice."""
    pk, sl = op.packed_planes()
    if which == "own":
        return pk
    if which == "disagreeing-lanes":
        return torch.from_numpy(pp.disagreeing_lanes(
            pk.numpy(), sl.numpy(), op.tile_base.numpy(),
            chunk=op.plan.chunk, n_coltiles=op.plan.n_coltiles))
    words = pk.numpy().reshape(-1, LANES).copy()
    live = np.flatnonzero((pp.word_rel(words)[:, 0] != pp.REL_DEAD)
                          & (sl.numpy() >= 0))[::3]
    words[live, 0] |= pp.REL_DEAD << pp.REL_SHIFT
    return torch.from_numpy(words.reshape(pk.shape))


def _packed_sweep(packed, slice_of, tile_base, X, *, n_slices, chunk,
                  stage_rel=False):
    """Y as the kernel's units make it: per column block of
    ``spmm_shape(k)`` and work item, the staged slice and the lane-0 rel
    (a dead rel empties the sublane's mask; ``stage_rel``: marks the
    sublane dead, as a staged rel does), the nonzero value bits' masks,
    the runs cut at a new slice or a multiple of CAP, and per unit the sum
    over its run's masked sublanes of v·X[col] (float32 products, float64
    sums) added into Y as float32. Numpy arrays in, float64 Y
    (n_slices·128, k) out."""
    k = X.shape[1]
    t, w, p = tsp.spmm_shape(k)
    per_block = t * w * p
    words = packed.reshape(-1, LANES).astype(np.int64) & 0xFFFFFFFF
    vals = (words & 0xFFFF0000).astype(np.uint32).view(np.float32)
    lane_idx = words & 127
    rel0 = pp.word_rel(packed.reshape(-1, LANES))[:, 0]
    sl = slice_of.reshape(-1).astype(np.int64)
    dead_rel = rel0 == pp.REL_DEAD
    key = np.where((dead_rel & stage_rel) | (sl < 0), -1, sl)
    tb = tile_base.astype(np.int64)
    X = np.asarray(X, np.float32)
    runs = -(-chunk // RUN)
    items = words.shape[0] // chunk * runs
    Y = np.zeros((n_slices * LANES, k))
    for cb in range(-(-k // per_block)):
        cols = slice(cb * per_block, min(k, (cb + 1) * per_block))
        for item in range(items):
            c, r = divmod(item, runs)
            s0 = c * chunk + r * RUN
            n = min(RUN, chunk - r * RUN)
            kk = key[s0:s0 + n]
            for j in range(n):
                if kk[j] < 0 or not (j % CAP == 0 or kk[j - 1] != kk[j]):
                    continue
                end = j + 1
                while end < n and end % CAP and kk[end] == kk[j]:
                    end += 1
                s = np.arange(s0 + j, s0 + end)
                mask = (vals[s] != 0) & ~dead_rel[s][:, None]
                rel = np.where(dead_rel[s], 0, rel0[s])  # masked anyway
                col = (tb[c] + rel)[:, None] * LANES + lane_idx[s]
                with np.errstate(invalid="ignore"):  # 0·Inf, masked out
                    prod = vals[s][:, :, None] * X[col, cols]
                acc = np.where(mask[:, :, None], prod, 0.0).astype(
                    np.float64).sum(axis=0)
                touched = mask.any(axis=0)
                rows = kk[j] * LANES + np.flatnonzero(touched)
                Y[rows, cols] += acc[touched].astype(np.float32)
    return Y


def _x(rows, k, seed):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(
        np.float32)


def _block(op, X):
    """X as the operator hands it to the kernel: bf16, CT·128 rows."""
    return op._block(torch.from_numpy(X), op.plan.n_coltiles * LANES,
                     torch.bfloat16, "X")


def _walk(op, plane, Xt, stage_rel=False):
    _, sl = op.packed_planes()
    kw = op._mat_kw()
    return _packed_sweep(plane.numpy(), sl.numpy(), op.tile_base.numpy(),
                         Xt.float().numpy(), n_slices=kw["n_slices"],
                         chunk=kw["chunk"], stage_rel=stage_rel)


@functools.lru_cache(maxsize=None)
def _jax(plan, k):
    jp, op = _plans(plan)
    X = _x(op.plan.shape[1], k, k)
    return np.asarray(jsp.SellSpMV(jp, value_dtype=jnp.bfloat16).matmat(
        jnp.asarray(X)))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("which", PLANES)
@pytest.mark.parametrize("k", [2, 8, 17])
@pytest.mark.parametrize("plan", PLANS)
def test_packed_sweep_matches_plain_and_jax(plan, k, which, monkeypatch):
    _, op = _plans(plan)
    assert op.plan.window_tiles <= 511 and not op.plan.y_block_slices
    plane = _plane(op, which)
    X = _x(op.plan.shape[1], k, k)
    Xt = _block(op, X)
    y = _walk(op, plane, Xt)
    _, sl = op.packed_planes()
    yp = tsp.sell_packed_spmm_plain(plane, sl, op.tile_base, Xt,
                                    **op._mat_kw()).numpy()
    tol, _ = spmm_tolerance(op.plan)
    assert y.shape == yp.shape and np.isfinite(y).all()
    assert np.abs(yp).max() > 0 and _rel(y, yp) <= tol
    assert _rel(_walk(op, plane, Xt, stage_rel=True), yp) <= tol
    if which == "dead-lane-zero":  # the JAX operator packs its own plane
        own = tsp.sell_packed_spmm_plain(_plane(op, "own"), sl,
                                         op.tile_base, Xt, **op._mat_kw())
        assert _rel(y, own.numpy()) > 1e-3
        return
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    assert op.route == "packed"
    yj = _jax(plan, k)
    assert yj.shape == (op.plan.shape[0], k)
    assert _rel(y[: op.plan.shape[0]], yj) <= TOL_JAX


def test_disagreeing_lanes_change_the_words():
    """The rewritten planes differ from the operator's in the rel field of
    live sublanes' lanes 1..127 only, so the tests above see a plane that
    a per-slot decode would read otherwise."""
    for plan in PLANS:
        _, op = _plans(plan)
        own, bad = _plane(op, "own").numpy(), _plane(op, "disagreeing-lanes")
        bad = bad.numpy()
        diff = own != bad
        assert diff.any(), plan
        assert not diff.reshape(-1, LANES)[:, 0].any(), plan
        assert np.array_equal(own & ~(511 << 7), bad & ~(511 << 7)), plan


@pytest.mark.parametrize("plan", PLANS)
def test_packed_sweep_column_blocks(plan):
    """k = 300 runs three column blocks of 128; the walk equals the plain
    version."""
    _, op = _plans(plan)
    t, w, p = tsp.spmm_shape(300)
    assert -(-300 // (t * w * p)) == 3
    Xt = _block(op, _x(op.plan.shape[1], 300, 7))
    pk, sl = op.packed_planes()
    y = _walk(op, pk, Xt)
    yp = tsp.sell_packed_spmm_plain(pk, sl, op.tile_base, Xt,
                                    **op._mat_kw()).numpy()
    tol, _ = spmm_tolerance(op.plan)
    assert _rel(y, yp) <= tol


@pytest.mark.parametrize("plan", PLANS)
def test_packed_sweep_skips_zero_values(plan):
    """Inf in X at the column of a padding lane (value bits 0 in a live
    sublane) whose real entries get value bits 0 in their words (rel and
    lane kept): only zero values read it, and Y stays finite, equal to the
    plain version."""
    _, op = _plans(plan)
    tp = op.plan
    pk, sl = op.packed_planes()
    words = pk.numpy().reshape(-1, LANES)
    vals = (words.astype(np.int64) & 0xFFFF0000) != 0
    live = (tp.rel_tile.reshape(-1) >= 0) & (tp.slice_of.reshape(-1) >= 0)
    s = np.arange(words.shape[0])
    cols = ((tp.tile_base.astype(np.int64)[s // tp.chunk]
             + tp.rel_tile.reshape(-1))[:, None] * LANES
            + tp.lane_idx.reshape(words.shape))
    col = int(cols[live[:, None] & ~vals][0])
    zeroed = words.copy()
    real = live[:, None] & vals & (cols == col)
    zeroed[real] &= 0xFFFF
    zeroed = torch.from_numpy(zeroed.reshape(pk.shape))
    X = _x(tp.shape[1], 8, 9)
    X[col] = np.inf
    Xt = _block(op, X)
    y = _walk(op, zeroed, Xt)
    yp = tsp.sell_packed_spmm_plain(zeroed, sl, op.tile_base, Xt,
                                    **op._mat_kw()).numpy()
    assert np.isfinite(y).all() and np.isfinite(yp).all()
    tol, _ = spmm_tolerance(tp)
    assert _rel(y, yp) <= tol
