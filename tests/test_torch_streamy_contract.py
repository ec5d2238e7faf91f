"""The non-finite contract of the streamed split route's plain versions.

K3-split and K2 streamed split (``sell_streamy``, ``sell_bench_streamy``)
are held on the card to ``sell_streamy_plain`` and
``sell_bench_streamy_plain`` (tests/test_torch_cuda.py), so these pin what
the kernels must do: every slot of a live sublane contributes v · x[col],
padding (v = 0) included, so Inf in x at a column that only padding lanes
read lands NaN (0 · Inf) in exactly the rows of the live sublanes whose
padding lanes read it; a dead sublane adds nothing, and every other row
stays finite. The plans (``contract_plan``, numpy only; the card tests in
tests/test_torch_cuda.py take them too) put the edges of the kernels' walk
(a block per run of sublanes inside one chunk, a warp per sublane) where
a kernel can get them wrong: a run of dead sublanes ending a chunk, an
empty middle y block (an all-dead chunk), int32 lane indices (a chunk that
is not a multiple of 32), a chunk of one sublane, and a chunk whose only
live sublane is its first. Every column is odd, so no nonzero sits at lane
0 of a tile and x there is read by padding lanes alone
(``padding_column``). On the CPU the wrappers take these plain versions
and count no launch. With finite x both plain versions agree with a
float64 numpy oracle of the plan within 1e-6 of max |y| (float32 sums of
a few products; bfloat16: the oracle takes the bf16-rounded values and
x). Parity with the JAX operator on finite inputs is
tests/test_torch_routes.py's ``streamed-split`` case.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.ops.sell_plan import build_streamed_sell_plan

TOL = 1e-6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WRAPPERS = {"forward": (S.sell_streamy, {}),
            "bench": (S.sell_bench_streamy, {"iterations": 2})}
BLOCK_ROWS = 2048
NCOLS = 70000  # 547 column tiles: windows over 511 tiles, split planes

NAMES = ("dead-run-ends-chunk", "empty-middle-block", "int32-lidx",
         "single-sublane-chunk", "single-live-sublane")


def _coords(rng, blocks, per_block):
    rows = np.concatenate([rng.randint(b * BLOCK_ROWS, (b + 1) * BLOCK_ROWS,
                                       per_block) for b in blocks])
    cols = rng.randint(0, NCOLS, rows.size) | 1
    return rows, cols, rng.randn(rows.size)


def contract_plan(name):
    """The named plan, checked to have the edge it is named for."""
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
    dead = ((plan.rel_tile.reshape(-1) < 0)
            | (plan.slice_of.reshape(-1) < 0)).reshape(plan.n_chunks, chunk)
    if name == "single-sublane-chunk":
        assert chunk == 1 and not dead.all()
    elif name == "single-live-sublane":
        assert (dead.sum(1) == chunk - 1).any() and not dead[:, 0].all()
    elif name == "empty-middle-block":
        assert dead.all(1).any() and 1 in plan.y_block_id
    else:
        assert (dead[:, -1] & ~dead[:, 0]).any()
    return plan


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
    ybase = plan.y_block_id.astype(np.int64)[chunk_of] * plan.y_block_slices
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
    rows = ((plan.y_block_id.astype(np.int64)[c] * plan.y_block_slices
             + sl[s])[:, None] * 128 + np.arange(128))
    vals = plan.vals if vals is None else np.asarray(vals)
    y = np.zeros(plan.n_slices * 128)
    np.add.at(y, rows.reshape(-1), (vals[s].astype(np.float64)
                                    * np.asarray(x, np.float64)[cols]
                                    ).reshape(-1))
    return y


@pytest.fixture(scope="module", params=NAMES)
def plan(request):
    return contract_plan(request.param)


def _operands(plan, dtype):
    op = S.SellSpMV(plan, value_dtype=DTYPES[dtype], device="cpu")
    x = np.random.default_rng(11).standard_normal(plan.shape[1]).astype(
        np.float32)
    return op, op._planes("streamy"), op._kw(), op._x_tiles(
        torch.from_numpy(x))


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_inf_at_padding_column_lands_nan_in_its_rows(plan, dtype, wrapper):
    _, planes, kw, xt = _operands(plan, dtype)
    col, rows = padding_column(plan)
    assert rows.size
    xt[col] = float("inf")
    fn, extra = WRAPPERS[wrapper]
    before = (S.sell_streamy.launches, S.sell_bench_streamy.launches)
    y = fn(*planes, xt, **kw, **extra)
    assert (S.sell_streamy.launches, S.sell_bench_streamy.launches) == before
    nan = torch.isnan(y).nonzero().squeeze(1).numpy()
    np.testing.assert_array_equal(nan, rows)
    keep = torch.ones_like(y, dtype=torch.bool)
    keep[torch.from_numpy(rows)] = False
    assert torch.isfinite(y[keep]).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_versions_match_float64_oracle(plan, dtype):
    op, planes, kw, xt = _operands(plan, dtype)
    ref = oracle(plan, xt.float().numpy(), vals=op.vals.float().numpy())
    scale = np.abs(ref).max()
    assert scale > 0
    for y in (S.sell_streamy_plain(*planes, xt, **kw),
              S.sell_bench_streamy_plain(*planes, xt, iterations=2, **kw)):
        assert y.shape == ref.shape
        assert np.abs(y.double().numpy() - ref).max() / scale <= TOL
