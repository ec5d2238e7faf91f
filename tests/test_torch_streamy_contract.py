"""The non-finite contract of the split-plane routes' plain versions.

The two routes that run the warp-per-sublane body (``sell_common.cuh``,
``sublane_run``), the streamed split route (K3-split and K2 streamed split:
``sell_streamy``, ``sell_bench_streamy``) and the resident split route (K4
and K2 split: ``sell_split``, ``sell_bench_split``), are held on the card
to their plain versions (tests/test_torch_cuda.py), so these pin what the
kernels must do: every slot of a live sublane contributes v · x[col],
padding (v = 0) included, so Inf in x at a column that only padding lanes
read lands NaN (0 · Inf) in exactly the rows of the live sublanes whose
padding lanes read it; a dead sublane adds nothing, and every other row
stays finite. The plans (``contract_plan``, numpy only; the card tests in
tests/test_torch_cuda.py take them too) put the edges of the kernels' walk
(a block per run of sublanes inside one chunk, a warp per sublane) where
a kernel can get them wrong: a run of dead sublanes ending a chunk, an
empty middle y block (an all-dead chunk between live ones), int32 lane
indices (a chunk that is not a multiple of 32), a chunk of one sublane,
and a chunk whose only live sublane is its first. Each is a streamed plan
with one chunk per y block over 547 column tiles (windows over 511 tiles,
but the one-sublane chunks' single tile); its resident-y variant (``resident``) keeps every chunk and
writes each chunk's slices into one y, so each edge stays where it was.
Every column is odd, so no nonzero sits at lane 0 of a tile and x there is
read by padding lanes alone (``padding_column``). A plan with no live
sublane (the split planes of an empty matrix, and an empty streamed plan)
gives y = 0. On the CPU the wrappers take these plain versions and count
no launch. With finite x both plain versions agree with a float64 numpy
oracle of the plan within 1e-6 of max |y| (float32 sums of a few
products; bfloat16: the oracle takes the bf16-rounded values and x).
Parity with the JAX operator on finite inputs is
tests/test_torch_routes.py's ``streamed-split`` and ``resident-split`` cases.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    build_sell_plan,
    build_streamed_sell_plan,
)

TOL = 1e-6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Per route: the forward and N-iteration wrappers, their plain versions.
ROUTES = ("streamy", "split")
WRAPPERS = {route: {"forward": (fwd, {}), "bench": (bench, {"iterations": 2})}
            for route, (fwd, bench) in
            (("streamy", (S.sell_streamy, S.sell_bench_streamy)),
             ("split", (S.sell_split, S.sell_bench_split)))}
PLAINS = {"streamy": (S.sell_streamy_plain, S.sell_bench_streamy_plain),
          "split": (S.sell_split_plain, S.sell_bench_split_plain)}
BLOCK_ROWS = 2048
NCOLS = 70000  # 547 column tiles: windows over 511 tiles, split planes

NAMES = ("dead-run-ends-chunk", "empty-middle-block", "int32-lidx",
         "single-sublane-chunk", "single-live-sublane")


def _coords(rng, blocks, per_block):
    rows = np.concatenate([rng.randint(b * BLOCK_ROWS, (b + 1) * BLOCK_ROWS,
                                       per_block) for b in blocks])
    cols = rng.randint(0, NCOLS, rows.size) | 1
    return rows, cols, rng.randn(rows.size)


def resident(plan):
    """The resident-y variant of a streamed plan: the same chunks, planes
    and windows, each chunk's live slices moved to their place in one y
    (block id · NSB + local slice)."""
    sl = plan.slice_of.astype(np.int64)
    glob = plan.y_block_id.astype(np.int64)[:, None] * plan.y_block_slices
    return dataclasses.replace(
        plan, slice_of=np.where(sl >= 0, glob + sl, -1).astype(np.int32),
        slice_base=None, slice_window=0, y_block_id=None, y_block_slices=0)


def contract_plan(name, route="streamy"):
    """The named plan on ``route`` (``streamy`` or ``split``), checked to
    have the edge it is named for."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "single-live-sublane":
        # block 1 holds one entry: its chunk's first sublane is live, the
        # rest padding
        r, c, v = _coords(rng, (0, 2), 200)
        r = np.append(r, BLOCK_ROWS + 77)
        c, v = np.append(c, 4097), np.append(v, 2.5)
    else:
        # fewer entries per block than a chunk has sublanes: one chunk per
        # block, over every column tile
        r, c, v = _coords(rng, (0, 2) if name == "empty-middle-block"
                          else (0, 1, 2), 150 if name == "int32-lidx" else 200)
    chunk = {"int32-lidx": 200, "single-sublane-chunk": 1}.get(name, 256)
    plan = build_streamed_sell_plan(r, c, v, (3 * BLOCK_ROWS, NCOLS),
                                    chunk=chunk, y_block_rows=BLOCK_ROWS)
    if route == "split":
        plan = resident(plan)
    dead = ((plan.rel_tile.reshape(-1) < 0)
            | (plan.slice_of.reshape(-1) < 0)).reshape(plan.n_chunks, chunk)
    assert bool(plan.y_block_slices) == (route == "streamy")
    if name == "single-sublane-chunk":
        assert chunk == 1 and not dead.all()
    elif name == "single-live-sublane":
        assert (dead.sum(1) == chunk - 1).any() and not dead[:, 0].all()
    elif name == "empty-middle-block":
        assert dead.all(1)[1:-1].any() and not dead.all(1)[[0, -1]].any()
    else:
        assert (dead[:, -1] & ~dead[:, 0]).any()
    return plan


def no_live_planes(route):
    """(operator, planes, kw) of a plan with no live sublane on ``route``
    (CPU): the split planes of an empty matrix (a merged-word plan, its
    split planes all -1), or an empty streamed plan (one all-dead chunk
    per y block)."""
    empty = np.zeros(0, np.int64)
    if route == "split":
        plan = build_sell_plan(empty, empty, np.zeros(0), (300, 200))
    else:
        plan = build_streamed_sell_plan(empty, empty, np.zeros(0),
                                        (3 * BLOCK_ROWS, NCOLS), chunk=256,
                                        y_block_rows=BLOCK_ROWS)
    op = S.SellSpMV(plan, device="cpu")
    return op, op._planes(route), op._kw()


def _ybase(plan):
    """The first y slice of each chunk's y block (0 on a resident plan)."""
    if not plan.y_block_slices:
        return np.zeros(plan.n_chunks, np.int64)
    return plan.y_block_id.astype(np.int64) * plan.y_block_slices


def padding_column(plan):
    """(column, rows) for Inf in x: lane 0 of a tile that live sublanes
    read, a column that only padding lanes read (every nonzero column is
    odd), and the y rows of the live sublanes' padding lanes that read it,
    in which the k = 1 contract lands NaN (0 · Inf). Where the planner
    gave dead padding sublanes a live rel (the chunk's last real tile),
    the tile is theirs, so the column is read by dead sublanes too."""
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    live = (rel >= 0) & (sl >= 0)
    chunk_of = np.arange(rel.size) // plan.chunk
    tile = plan.tile_base.astype(np.int64)[chunk_of] + rel
    shared = np.intersect1d(tile[~live & (rel >= 0)], tile[live])
    col = int(shared[0] if shared.size else tile[np.argmax(live)]) * 128
    cols = tile[:, None] * 128 + plan.lane_idx.astype(np.int64)
    assert not ((cols == col) & (plan.vals != 0))[live].any()
    hit = live[:, None] & (cols == col) & (plan.vals == 0)
    ybase = _ybase(plan)[chunk_of]
    s, lane = np.nonzero(hit)
    return col, np.unique((ybase[s] + sl[s]) * 128 + lane)


def oracle(plan, x, vals=None):
    """y = A·x in float64 from the plan's numpy arrays (live sublanes
    only), with ``vals`` in place of the plan's values plane if given."""
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    s = np.nonzero((rel >= 0) & (sl >= 0))[0]
    c = s // plan.chunk
    cols = ((plan.tile_base.astype(np.int64)[c] + rel[s])[:, None] * 128
            + plan.lane_idx[s].astype(np.int64))
    rows = (_ybase(plan)[c] + sl[s])[:, None] * 128 + np.arange(128)
    vals = plan.vals if vals is None else np.asarray(vals)
    y = np.zeros(plan.n_slices * 128)
    np.add.at(y, rows.reshape(-1), (vals[s].astype(np.float64)
                                    * np.asarray(x, np.float64)[cols]
                                    ).reshape(-1))
    return y


# The streamed plans keep the ids they had before the resident variants.
CASES = [("streamy", n) for n in NAMES] + [("split", n) for n in NAMES]


@pytest.fixture(scope="module", params=CASES,
                ids=[n if r == "streamy" else f"split-{n}" for r, n in CASES])
def plan(request):
    """(route, plan) of one contract case."""
    route, name = request.param
    return route, contract_plan(name, route)


def _operands(plan, route, dtype):
    op = S.SellSpMV(plan, value_dtype=DTYPES[dtype], device="cpu")
    x = np.random.default_rng(11).standard_normal(plan.shape[1]).astype(
        np.float32)
    return op, op._planes(route), op._kw(), op._x_tiles(
        torch.from_numpy(x))


def _launches(route):
    return tuple(fn.launches for fn, _ in WRAPPERS[route].values())


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS["streamy"]))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_inf_at_padding_column_lands_nan_in_its_rows(plan, dtype, wrapper):
    route, plan = plan
    _, planes, kw, xt = _operands(plan, route, dtype)
    col, rows = padding_column(plan)
    assert rows.size
    xt[col] = float("inf")
    fn, extra = WRAPPERS[route][wrapper]
    before = _launches(route)
    y = fn(*planes, xt, **kw, **extra)
    assert _launches(route) == before
    nan = torch.isnan(y).nonzero().squeeze(1).numpy()
    np.testing.assert_array_equal(nan, rows)
    keep = torch.ones_like(y, dtype=torch.bool)
    keep[torch.from_numpy(rows)] = False
    assert torch.isfinite(y[keep]).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_versions_match_float64_oracle(plan, dtype):
    route, plan = plan
    op, planes, kw, xt = _operands(plan, route, dtype)
    ref = oracle(plan, xt.float().numpy(), vals=op.vals.float().numpy())
    scale = np.abs(ref).max()
    assert scale > 0
    fwd, bench = PLAINS[route]
    for y in (fwd(*planes, xt, **kw), bench(*planes, xt, iterations=2, **kw)):
        assert y.shape == ref.shape
        assert np.abs(y.double().numpy() - ref).max() / scale <= TOL


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS["streamy"]))
@pytest.mark.parametrize("route", ROUTES)
def test_no_live_sublane_gives_zero(route, wrapper):
    op, planes, kw = no_live_planes(route)
    assert not ((op.plan.rel_tile.reshape(-1) >= 0)
                & (op.plan.slice_of.reshape(-1) >= 0)).any()
    xt = op._x_tiles(torch.ones(op.shape[1]))
    fn, extra = WRAPPERS[route][wrapper]
    before = _launches(route)
    y = fn(*planes, xt, **kw, **extra)
    assert _launches(route) == before
    assert y.shape == (op.plan.n_slices * 128,) and not y.any()
