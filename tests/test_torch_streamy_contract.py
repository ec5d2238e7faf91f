"""The non-finite contract of the warp-per-sublane routes' plain versions.

All four routes run the warp-per-sublane body (``sell_common.cuh``,
``sublane_run``) in their forward and N-iteration kernels: the streamed
split route (K3-split and K2 streamed split: ``sell_streamy``,
``sell_bench_streamy``), the resident split route (K4 and K2 split:
``sell_split``, ``sell_bench_split``), and the two merged-word routes,
which stage the merged rel‖slice word (K3-relsl and K2 streamed:
``sell_streamy_relsl``, ``sell_bench_streamy_relsl``; K1 and K2:
``sell_spmv``, ``sell_bench_loop``). K2 takes two y buffers in turn
(``bench_buffer`` says which one holds the result). Each kernel is held
on the card to its plain version (tests/test_torch_cuda.py), so these pin
what the kernels must do: every slot of a live sublane contributes v · x[col],
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
with one chunk per y block: on the split routes over 547 column tiles
(windows over 511 tiles, but the one-sublane chunks' single tile), on the
merged routes over 469 (windows of at most 480 tiles, which the merged
word's 9-bit rel holds). Its resident-y variant (``resident``) keeps every
chunk and writes each chunk's slices into one y, so each edge stays where
it was. On the merged routes a chunk's dead padding sublanes carry the
chunk's last real tile, so their rel is live and only the slice field
marks them dead (the plans are checked to hold one). Every column is odd,
so no nonzero sits at lane 0 of a tile and x there is read by padding
lanes alone (``padding_column``). A plan with no live sublane (the split
planes or merged word of an empty matrix, and an empty streamed plan)
gives y = 0. On the CPU the wrappers take these plain versions and count
no launch. With finite x the plain versions agree with a float64 numpy
oracle of the plan within 1e-6 of max |y| (float32 sums of a few
products; bfloat16: the oracle takes the bf16-rounded values and x).
Parity with the JAX operator on finite inputs is tests/test_torch_routes.py's
``streamed-split`` and ``resident-split`` cases and its merged contract
plans (``test_merged_contract_plans_match_jax_operator``).
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
# The split routes come first: their cases keep the ids they had before the
# merged routes joined.
ROUTES = ("streamy", "split", "streamy_relsl", "relsl")
MERGED = ("streamy_relsl", "relsl")
RESIDENT = ("split", "relsl")
WRAPPERS = {route: {"forward": (fwd, {}), "bench": (bench, {"iterations": 2})}
            for route, (fwd, bench) in S._ROUTE_FNS.items()}
PLAINS = {route: (getattr(S, fwd.__name__ + "_plain"),
                  getattr(S, bench.__name__ + "_plain"))
          for route, (fwd, bench) in S._ROUTE_FNS.items()}
BLOCK_ROWS = 2048
NCOLS = 70000  # 547 column tiles: windows over 511 tiles, split planes
NCOLS_MERGED = 60000  # 469 column tiles: windows fit the merged word

NAMES = ("dead-run-ends-chunk", "empty-middle-block", "int32-lidx",
         "single-sublane-chunk", "single-live-sublane")


def _coords(rng, blocks, per_block, ncols):
    rows = np.concatenate([rng.randint(b * BLOCK_ROWS, (b + 1) * BLOCK_ROWS,
                                       per_block) for b in blocks])
    cols = rng.randint(0, ncols, rows.size) | 1
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
    """The named plan on ``route`` (one of ``ROUTES``), checked to have
    the edge it is named for and to run on ``route``."""
    rng = np.random.RandomState(sum(map(ord, name)))
    ncols = NCOLS_MERGED if route in MERGED else NCOLS
    if name == "single-live-sublane":
        # block 1 holds one entry: its chunk's first sublane is live, the
        # rest padding
        r, c, v = _coords(rng, (0, 2), 200, ncols)
        r = np.append(r, BLOCK_ROWS + 77)
        c, v = np.append(c, 4097), np.append(v, 2.5)
    else:
        # fewer entries per block than a chunk has sublanes: one chunk per
        # block, over every column tile
        r, c, v = _coords(rng, (0, 2) if name == "empty-middle-block"
                          else (0, 1, 2), 150 if name == "int32-lidx" else 200,
                          ncols)
    chunk = {"int32-lidx": 200, "single-sublane-chunk": 1}.get(name, 256)
    plan = build_streamed_sell_plan(r, c, v, (3 * BLOCK_ROWS, ncols),
                                    chunk=chunk, y_block_rows=BLOCK_ROWS)
    if route in RESIDENT:
        plan = resident(plan)
    assert bool(plan.y_block_slices) == (route not in RESIDENT)
    if route in MERGED:
        assert S.plan_route(plan) == route
    rel = plan.rel_tile.reshape(-1)
    dead = ((rel < 0) | (plan.slice_of.reshape(-1) < 0)).reshape(
        plan.n_chunks, chunk)
    if route in MERGED and chunk > 1:
        # a dead padding sublane that only its slice field marks
        assert (dead.reshape(-1) & (rel >= 0)).any()
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
    (CPU): the merged word or the split planes of an empty matrix (a
    merged-word plan, its split planes all -1), or of an empty streamed
    plan (one all-dead chunk per y block)."""
    empty = np.zeros(0, np.int64)
    if route in RESIDENT:
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


# The streamed split plans keep the ids they had before the other routes.
CASES = [(r, n) for r in ROUTES for n in NAMES]


@pytest.fixture(scope="module", params=CASES,
                ids=[n if r == "streamy" else f"{r}-{n}" for r, n in CASES])
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", RESIDENT)
def test_caller_vals_get_aligned_storage(route, dtype):
    """A ``vals`` plane passed in by a caller (``matmat(X, vals=...)``)
    reaches the forward wrapper contiguous and aligned to 16 bytes, as the
    warp-per-sublane kernels' vector loads need: a view at an odd offset
    is copied into new storage, an aligned plane is passed on as it is;
    y is the same either way."""
    plan = contract_plan("dead-run-ends-chunk", route)
    op = S.SellSpMV(plan, value_dtype=DTYPES[dtype], device="cpu")
    v = op.vals.reshape(-1).clone()
    flat = torch.empty(v.numel() + 1, dtype=v.dtype)
    odd = flat[1:]
    odd.copy_(v)
    assert odd.data_ptr() % S._VEC_ALIGN
    got = op._vals_plane(odd)
    assert got.data_ptr() % S._VEC_ALIGN == 0 and got.is_contiguous()
    assert torch.equal(got, op.vals)
    assert op._vals_plane(v).data_ptr() == v.data_ptr()
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (plan.shape[1], 1)).astype(np.float32))
    assert torch.equal(op.matmat(x, vals=odd), op.matmat(x, vals=v))


@pytest.mark.parametrize("iterations, buffer",
                         [(1, 0), (2, 1), (3, 0), (4, 1), (100, 1), (201, 0)])
def test_bench_buffer_of_the_last_iteration(iterations, buffer):
    """K2's iteration ``it`` sweeps into y buffer ``it % 2``, so the wrapper
    returns buffer ``(N - 1) % 2``; the other routes' N-iteration kernels
    have one y."""
    assert S.BENCH_Y_BUFFERS == {"relsl": 2, "streamy_relsl": 1,
                                 "streamy": 1, "split": 1}
    assert S.bench_buffer("relsl", iterations) == buffer
    for route in ("streamy_relsl", "streamy", "split"):
        assert S.bench_buffer(route, iterations) == 0


def test_bench_buffer_needs_an_iteration():
    with pytest.raises(ValueError, match="iterations"):
        S.bench_buffer("relsl", 0)
