"""K2 with k columns' N-iteration walk on the k-column body, emulated in
numpy, against the port's plain version and the JAX package's
``SellSpMV.bench_loop_mat``.

``sell_bench_spmm_kernel`` (``csrc/sell_spmm.cu``, over
``sell_common.cuh::sublane_mat_bench_sweeps``) runs N sweeps in one
cooperative launch. Each sweep walks items × column blocks pieces of work,
piece w being column block w / items and item w % items; each piece is
``sublane_mat_run``: stage up to 64 sublanes of one chunk from the merged
word (rel, slice; dead where either is), find each live sublane's nonzero
lanes, cut runs of sublanes of one slice (a new run where the slice
changes or the sublane's index in the item is a multiple of 16), and for
each unit (a run and one lane it touches) sum v·X[col, block's columns]
over the run's sublanes whose mask holds the lane, then add the sums into
that row of Y once. A zero value is never multiplied, so an Inf in X at a
padding lane's column never reaches Y. Y takes one buffer (zeroed, then
swept, each iteration) or two (the next zeroed while this one is swept,
the result in buffer (N − 1) % 2); the buffers start full of NaN here, as
fresh device memory may, so a buffer swept before it is zeroed shows.

``_bench_walk`` is that walk. On the hub-row plan (``tests/
torch_kcol_plans.py``: 200 duplicate sublanes of one row past several
items and units) and on a random merged-word plan at chunk 208 (each
chunk three runs of 64 sublanes and one of 16), float32 and bfloat16, k =
2, 8 and 17 (scalar and vector column shapes), N = 1, 2 and 3 in both
buffer forms, it equals the port's ``sell_bench_spmm_plain`` within the
plan's SpMM tolerance (``bench_variants.spmm_tolerance``: max(1e-6,
2·2^-24·√n), n the most products a row sums) and the JAX
``bench_loop_mat`` (its Pallas kernel in interpret mode) within 1e-5 of
max |Y|, ``test_torch_spmm``'s tolerance against the JAX operator. At k =
300 (three column blocks of 128) it equals the plain version, and with
Inf in X at a padding lane's column Y stays finite.
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

import torch_kcol_plans as kcol

LANES = 128
RUN = 64   # sublanes of a work item (sell_common.cuh, kRun)
CAP = 16   # sublanes a unit sums at most (kMatRunCap)
REL_DEAD, SLICE_SHIFT, SLICE_DEAD = 511, 9, (1 << 23) - 1
TOL_JAX = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
PLANS = ["hub-row", "random-chunk208"]


@functools.lru_cache(maxsize=None)
def _plans(name):
    """(JAX plan, the port's plan) of ``name``, the same arrays."""
    if name == "hub-row":
        r, c, v, shape, chunk = kcol.hub_row_triplets("relsl")
    else:
        rng = np.random.RandomState(5)
        shape, chunk = (700, 900), 208
        r, c = rng.randint(0, 700, 6000), rng.randint(0, 900, 6000)
        v = rng.randn(6000)
    jp = jplan.build_sell_plan(r, c, v, shape, chunk=chunk,
                               allow_small_chunk=False)
    return jp, plan_from_arrays(plan_fields(jp))


def _sweep(op, X, vals=None):
    """One sweep of the walk on the operator's merged-word planes (or
    ``vals`` in place of its values plane): the rows' sums of every unit
    of every piece of work, in walk order, as (row, columns, sums)."""
    k = X.shape[1]
    t, w, p = tsp.spmm_shape(k)
    per_block = t * w * p
    X = torch.from_numpy(X).to(op.value_dtype).float().numpy()
    word = op.relsl.numpy().astype(np.int64) & 0xFFFFFFFF
    vals = (op.vals if vals is None else vals).float().numpy().reshape(
        -1, LANES)
    lidx = op.lidx.numpy().astype(np.int64).reshape(-1, LANES)
    tb = op.tile_base.numpy().astype(np.int64)
    chunk = op.plan.chunk
    runs = -(-chunk // RUN)
    items = vals.shape[0] // chunk * runs
    out = []
    for w_ in range(items * -(-k // per_block)):
        cb, item = divmod(w_, items)
        cols = slice(cb * per_block, min(k, (cb + 1) * per_block))
        c, r = divmod(item, runs)
        s0 = c * chunk + r * RUN
        n = min(RUN, chunk - r * RUN)
        rel = word[s0:s0 + n] & REL_DEAD
        sl = word[s0:s0 + n] >> SLICE_SHIFT
        key = np.where((rel == REL_DEAD) | (sl == SLICE_DEAD), -1, sl)
        mask = (vals[s0:s0 + n] != 0) & (key >= 0)[:, None]
        for j in range(n):
            if key[j] < 0 or not (j % CAP == 0 or key[j - 1] != key[j]):
                continue
            run = [j]
            while (run[-1] + 1 < n and (run[-1] + 1) % CAP
                   and key[run[-1] + 1] == key[j]):
                run.append(run[-1] + 1)
            for lane in np.flatnonzero(mask[run].any(axis=0)):
                acc = np.zeros(cols.stop - cols.start)
                for jj in run:
                    if mask[jj, lane]:
                        s = s0 + jj
                        col = (tb[c] + rel[jj]) * LANES + lidx[s, lane]
                        acc += (vals[s, lane] * X[col, cols]).astype(
                            np.float64)
                out.append((key[j] * LANES + lane, cols, acc))
    return out


def _bench_walk(units, shape, iterations, buffers):
    """K2 with k columns' result after ``iterations`` sweeps of ``units``
    into ``buffers`` Y buffers of ``shape`` (1: zero, sweep; 2: the next
    zeroed while this one is swept), the buffers full of NaN before the
    launch."""
    ys = np.full((buffers, *shape), np.nan)
    if buffers == 2:
        ys[0] = 0.0
    for it in range(iterations):
        if buffers == 2:
            if it + 1 < iterations:
                ys[(it + 1) % 2] = 0.0
            y = ys[it % 2]
        else:
            y = ys[0]
            y[:] = 0.0
        for row, cols, acc in units:
            y[row, cols] += acc.astype(np.float32)
    return ys[(iterations - 1) % buffers]


def _x(rows, k, seed):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _case(plan, dtype, k):
    """The port's operator, X and one sweep's units of (plan, dtype, k)."""
    _, tp = _plans(plan)
    op = tsp.SellSpMV(tp, value_dtype=DTYPES[dtype][0], device="cpu")
    X = _x(tp.n_coltiles * LANES, k, k)
    return op, X, _sweep(op, X)


@functools.lru_cache(maxsize=None)
def _jax(plan, dtype, k, iterations):
    jp, tp = _plans(plan)
    X = _case(plan, dtype, k)[1][: tp.shape[1]]
    return np.asarray(jsp.SellSpMV(jp, value_dtype=DTYPES[dtype][1])
                      .bench_loop_mat(jnp.asarray(X), iterations))


@pytest.mark.parametrize("buffers", [1, 2])
@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("k", [2, 8, 17])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("plan", PLANS)
def test_bench_walk_matches_plain_and_jax(plan, dtype, k, iterations,
                                          buffers):
    _, tp = _plans(plan)
    op, X, units = _case(plan, dtype, k)
    assert op.route == "relsl"
    y = _bench_walk(units, (tp.n_slices * LANES, k), iterations, buffers)
    yp = tsp.sell_bench_spmm_plain(
        *op._planes(), torch.from_numpy(X).to(op.value_dtype),
        iterations=iterations, **op._mat_kw()).numpy()
    tol, _ = spmm_tolerance(tp)
    assert y.shape == yp.shape and np.isfinite(y).all()
    scale = np.abs(yp).max()
    assert scale > 0 and np.abs(y - yp).max() <= tol * scale
    yj = _jax(plan, dtype, k, iterations)
    assert yj.shape == (tp.shape[0], k)
    assert np.abs(y[: tp.shape[0]] - yj).max() <= TOL_JAX * np.abs(yj).max()


@pytest.mark.parametrize("plan", PLANS)
def test_bench_walk_column_blocks(plan):
    """k = 300 runs three column blocks of 128 (the grid walks them column
    block by column block); the result equals the plain version."""
    _, tp = _plans(plan)
    op = tsp.SellSpMV(tp, device="cpu")
    t, w, p = tsp.spmm_shape(300)
    assert -(-300 // (t * w * p)) == 3
    X = _x(tp.n_coltiles * LANES, 300, 7)
    y = _bench_walk(_sweep(op, X), (tp.n_slices * LANES, 300), 2,
                    tsp.MAT_BENCH_Y_BUFFERS)
    yp = tsp.sell_bench_spmm_plain(*op._planes(), torch.from_numpy(X),
                                   iterations=2, **op._mat_kw()).numpy()
    tol, _ = spmm_tolerance(tp)
    assert np.abs(y - yp).max() <= tol * np.abs(yp).max()


@pytest.mark.parametrize("plan", PLANS)
def test_bench_walk_skips_zero_values(plan):
    """Inf in X at the column of a padding lane (v = 0 in a live sublane)
    whose real entries are zeroed through the values plane: only zero
    values read it, and Y stays finite, equal to the plain version."""
    _, tp = _plans(plan)
    op = tsp.SellSpMV(tp, device="cpu")
    vals = tp.vals.reshape(-1, LANES)
    live = (tp.rel_tile.reshape(-1) >= 0) & (tp.slice_of.reshape(-1) >= 0)
    s = np.arange(vals.shape[0])
    cols = ((tp.tile_base.astype(np.int64)[s // tp.chunk]
             + tp.rel_tile.reshape(-1))[:, None] * LANES
            + tp.lane_idx.reshape(vals.shape))
    col = int(cols[live[:, None] & (vals == 0)][0])
    v = op.vals.clone().reshape(vals.shape)
    v[torch.from_numpy(live[:, None] & (cols == col))] = 0
    v = v.reshape(op.vals.shape)
    X = _x(tp.n_coltiles * LANES, 8, 9)
    X[col] = np.inf
    y = _bench_walk(_sweep(op, X, vals=v), (tp.n_slices * LANES, 8), 3,
                    tsp.MAT_BENCH_Y_BUFFERS)
    planes = (v,) + tuple(op._planes()[1:])
    yp = tsp.sell_bench_spmm_plain(*planes, torch.from_numpy(X),
                                   iterations=3, **op._mat_kw()).numpy()
    assert np.isfinite(y).all() and np.isfinite(yp).all()
    tol, _ = spmm_tolerance(tp)
    assert np.abs(y - yp).max() <= tol * np.abs(yp).max()
