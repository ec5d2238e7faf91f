"""K2-packed's two-buffer walk and K5-with-k-columns' lane-0 decode,
emulated in numpy, against the plain versions and the JAX package.

K2-packed (``sell_bench_packed_kernel``, ``csrc/sell_packed.cu``) runs K2's
N-iteration body under ``PackedShuffle``, K5's function (rel from each
sublane's lane-0 word) with rel taken from the loaded lane-0 word by a
warp shuffle instead of K5's staging load: two y buffers in turn (buffer 0 zeroed before the first iteration; iteration
``it`` zeroes buffer ``(it + 1) % 2`` unless it is the last, and sweeps
into buffer ``it % 2``), each sweep K5's walk
(``test_torch_packed_staging._body``: rel from each sublane's lane-0 word).
Its y is buffer ``(N - 1) % 2`` (``spmv_sell.PACKED_BENCH_Y_BUFFERS``);
on the resident plans it equals ``sell_bench_packed_plain`` and the JAX
operator's ``bench_loop`` under ``SMVP_SELL_PACK=1`` (interpret mode)
within 1e-6 of max |y|.

K5 with k columns (``sell_packed_spmm_kernel``) keeps its one-thread-per-
slot warp walk (``warp_slots``) under ``PackedLaneZero``: rel from the
sublane's lane-0 word, value and lane from the slot's own word, only
nonzero values multiplied. ``_mat_walk`` emulates it.

On a plane whose lanes 1..127 carry another rel than lane 0's
(``torch_packed_plans.disagreeing_lanes``) both emulations equal the plain
versions, which read lane 0 as the JAX ``_unpack_plane`` does; the per-slot
decode both kernels ran before misses them by more than 1e-3.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

import test_torch_packed as packed_cases
import test_torch_packed_staging as k5
import torch_packed_plans as pp

TOL = 1e-6
RESIDENT = ["resident", "resident-int32-lidx"]
CSRC = Path(tsp.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(scope="module", params=RESIDENT)
def case(request):
    jp = packed_cases._plan(request.param)
    tp = plan_from_arrays(plan_fields(jp))
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    x = np.random.default_rng(11).standard_normal(tp.shape[1]).astype(
        np.float32)
    return jp, tp, op, x


def _bad_plane(op):
    pk, sl = op.packed_planes()
    return torch.from_numpy(pp.disagreeing_lanes(
        pk.numpy(), sl.numpy(), op.tile_base.numpy(), chunk=op.plan.chunk,
        n_coltiles=op.plan.n_coltiles))


def _two_buffer_walk(op, xt, iterations, packed=None, per_slot=False):
    """K2-packed's buffers after ``iterations`` iterations: buffer 0 zeroed
    before the first, buffer 1 as ``torch.empty`` left it (NaN here) until
    an iteration zeroes it; each sweep is K5's staged walk."""
    n_out = op._kw()["n_slices"] * pp.LANES
    ys = np.full((tsp.PACKED_BENCH_Y_BUFFERS, n_out), np.nan)
    ys[0] = 0.0
    for it in range(iterations):
        if it + 1 < iterations:
            ys[(it + 1) % 2] = 0.0
        ys[it % 2] += k5._emulate(op, xt, packed, per_slot)
    return ys


def _mat_walk(packed, slice_of, tile_base, X, *, n_slices, chunk,
              per_slot=False):
    """K5 with k columns as ``warp_slots`` walks it: each live slot of a
    nonzero value adds v·X[col] to Y[row]; rel from the sublane's lane-0
    word (``PackedLaneZero``), or, ``per_slot``, from the slot's own word
    (``PackedWord``, the decode the kernel ran before). Products in
    float32, sums in float64."""
    words = packed.reshape(-1, pp.LANES).astype(np.int64) & 0xFFFFFFFF
    rel = pp.word_rel(packed.reshape(-1, pp.LANES))
    if not per_slot:
        rel = np.repeat(rel[:, :1], pp.LANES, axis=1)
    vals = (words & 0xFFFF0000).astype(np.uint32).view(np.float32)
    lane = words & 127
    sl = slice_of.reshape(-1).astype(np.int64)[:, None]
    s = np.arange(words.shape[0])[:, None]
    live = (rel != pp.REL_DEAD) & (sl >= 0) & (vals != 0)
    col = (tile_base.astype(np.int64)[s // chunk] + rel) * pp.LANES + lane
    row = sl * pp.LANES + np.arange(pp.LANES)
    Xf = np.asarray(X, np.float32)
    Y = np.zeros((n_slices * pp.LANES, Xf.shape[1]))
    prod = vals[live][:, None] * Xf[col[live]]
    np.add.at(Y, row[live], prod.astype(np.float64))
    return Y


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_two_buffer_walk_matches_plain_and_jax(case, iterations,
                                               monkeypatch):
    jp, tp, op, x = case
    xt = op._x_tiles(torch.from_numpy(x))
    ys = _two_buffer_walk(op, xt, iterations)
    y = ys[(iterations - 1) % 2]
    pk, sl = op.packed_planes()
    yp = tsp.sell_bench_packed_plain(pk, sl, op.tile_base, xt,
                                     iterations=iterations, **op._kw())
    assert np.isfinite(y).all()
    assert k5._rel(y, yp.numpy()) <= TOL
    if iterations == 1:  # buffer 1 is never written: read buffer 0
        assert np.isnan(ys[1]).all()
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    assert op.bench_route == "packed"
    y_j = jsp.SellSpMV(jp, value_dtype=jnp.bfloat16).bench_loop(
        jnp.asarray(x), iterations)
    assert k5._rel(y[: tp.shape[0]], np.asarray(y_j)) <= TOL


def test_two_buffer_walk_follows_lane_zero(case):
    _, tp, op, x = case
    bad = _bad_plane(op)
    xt = op._x_tiles(torch.from_numpy(x))
    pk, sl = op.packed_planes()
    yp = tsp.sell_bench_packed_plain(bad, sl, op.tile_base, xt,
                                     iterations=3, **op._kw()).numpy()
    y_own = tsp.sell_bench_packed_plain(pk, sl, op.tile_base, xt,
                                        iterations=3, **op._kw()).numpy()
    assert np.array_equal(yp, y_own)
    for n in (2, 3):
        y = _two_buffer_walk(op, xt, n, bad)[(n - 1) % 2]
        assert k5._rel(y, yp) <= TOL
    y_old = _two_buffer_walk(op, xt, 3, bad, per_slot=True)[0]
    assert k5._rel(y_old, yp) > 1e-3


@pytest.mark.parametrize("k", [1, 3, 8])
def test_k_columns_follow_lane_zero(case, k):
    _, tp, op, _ = case
    X = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (tp.n_coltiles * pp.LANES, k)).astype(np.float32)).to(torch.bfloat16)
    pk, sl = op.packed_planes()
    bad = _bad_plane(op)
    kw = op._mat_kw()
    walk_kw = dict(n_slices=kw["n_slices"], chunk=kw["chunk"])
    args = (sl.numpy(), op.tile_base.numpy(), X.float().numpy())
    want = tsp.sell_packed_spmm_plain(bad, sl, op.tile_base, X, **kw)
    own = tsp.sell_packed_spmm_plain(pk, sl, op.tile_base, X, **kw)
    assert torch.equal(want, own)
    assert k5._rel(_mat_walk(pk.numpy(), *args, **walk_kw),
                   own.numpy()) <= TOL
    assert k5._rel(_mat_walk(bad.numpy(), *args, **walk_kw),
                   want.numpy()) <= TOL
    old = _mat_walk(bad.numpy(), *args, per_slot=True, **walk_kw)
    assert k5._rel(old, want.numpy()) > 1e-3


def test_k2_packed_instantiates_k2s_body():
    text = (CSRC / "sell_packed.cu").read_text()
    m = re.search(r"__launch_bounds__\(kThreads, kSublaneMinBlocks\)\n"
                  r"    sell_bench_packed_kernel\(const Args<X, L> a\) \{\n"
                  r"  sublane_bench_sweeps<(Packed\w+), ResidentY, "
                  r"kPackedBenchYBuffers>\(a\);", text)
    assert m and m.group(1) in ("PackedStage", "PackedShuffle")
    common = (CSRC / "sell_common.cuh").read_text()
    assert f"struct {m.group(1)} " in common


def test_packed_bench_buffers_match_the_source():
    """The wrapper's y buffers are the kernel's (``kPackedBenchYBuffers``)."""
    text = (CSRC / "sell_packed.cu").read_text()
    assert (f"constexpr int kPackedBenchYBuffers = "
            f"{tsp.PACKED_BENCH_Y_BUFFERS};" in text)


def test_k_column_decode_reads_lane_zero():
    """``sell_packed_spmm_kernel`` decodes under ``PackedLaneZero``, whose
    rel comes from the sublane's lane-0 word; no kernel outside
    ``csrc/variants/`` instantiates the per-slot ``PackedWord`` decode."""
    text = (CSRC / "sell_packed.cu").read_text()
    assert ("sell_packed_spmm_kernel(const MatArgs<X, L> a) {\n"
            "  mat_sweep<PackedLaneZero>(a);" in text)
    common = (CSRC / "sell_common.cuh").read_text()
    body = common[common.index("struct PackedLaneZero : PackedWord {"):]
    body = body[: body.index("};")]
    assert "a.meta[i & ~127LL]" in body
    for src in [*CSRC.glob("*.cu"), CSRC / "sell_common.cuh"]:
        assert not re.search(r"<\s*PackedWord\s*[,>]", src.read_text()), src
