"""K2-subwin's per-sublane staging against the JAX package.

The kernel (``csrc/sell_bench.cu``) runs K2's warp-per-sublane body under
a staging policy, ``SubwinWord``, that applies the sub-chain window rule
once per sublane: it stages K2's rel and slice where the rule keeps the
sublane and -1 in both where it does not, and the body then skips the
sublane as dead. ``_stage`` below is that policy in numpy, operation for
operation. On every plan and chain split where ``_sub_windows`` returns
windows it must mark dead exactly the sublanes whose slots the plain
version (``_subwin_sweep_plain``, through ``_subwin_windowed``) drops, and
K2's plain sweep over the staged sublanes must equal the JAX ``bench_loop``
under ``SMVP_SELL_SUBWIN=1`` (its subwin branch in Pallas interpret mode)
within 1e-6 of max |y|.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

import test_torch_subwin as subwin

TOL = 1e-6
REL_DEAD, SLICE_SHIFT = 511, 9


def _stage(relsl, tile_base, stb, ssb, *, chunk, split, sub_wt, sub_nsw):
    """``SubwinWord::stage`` for every sublane: (rel, slice), int64, -1 in
    both where the window rule drops the sublane."""
    word = relsl.reshape(-1).astype(np.int64) & 0xFFFFFFFF
    s = np.arange(word.size, dtype=np.int64)
    c = s // chunk
    h = (s - c * chunk) // (chunk // split)
    stb_s = stb.astype(np.int64)[c, h]
    ssb_s = ssb.astype(np.int64)[c, h]
    r = word & REL_DEAD
    sl = word >> SLICE_SHIFT
    rel_adj = r - (stb_s - tile_base.astype(np.int64)[c])
    live = ((rel_adj >= 0) & (rel_adj < sub_wt) & (sl >= ssb_s)
            & (sl < ssb_s + sub_nsw))
    return np.where(live, r, -1), np.where(live, sl, -1)


def _windows(tp, split):
    sub = tsp._sub_windows(tp, split)
    if sub is None:
        return None
    stb, ssb, sub_wt, sub_nsw = sub
    return dict(stb=stb, ssb=ssb, split=split, sub_wt=sub_wt,
                sub_nsw=sub_nsw)


@pytest.mark.parametrize("name", subwin.NAMES)
def test_staging_marks_dead_what_the_plain_version_drops(name):
    tp = plan_from_arrays(plan_fields(subwin._plan(name)))
    splits = [s for s in (2, 4, 8) if _windows(tp, s) is not None]
    assert splits
    for split in splits:
        _check_staging(tp, split)


def _check_staging(tp, split):
    win = _windows(tp, split)
    relsl = tsp.relsl_plane_host(tp)
    rel, sl = _stage(relsl, tp.tile_base, win["stb"], win["ssb"],
                     chunk=tp.chunk, split=split, sub_wt=win["sub_wt"],
                     sub_nsw=win["sub_nsw"])
    _, ok, tile = tsp._subwin_windowed(
        torch.from_numpy(relsl), torch.from_numpy(tp.tile_base),
        torch.from_numpy(win["stb"]), torch.from_numpy(win["ssb"]),
        chunk=tp.chunk, split=split, sub_wt=win["sub_wt"],
        sub_nsw=win["sub_nsw"])
    ok = ok.numpy()
    assert np.array_equal(rel < 0, ~ok) and np.array_equal(sl < 0, ~ok)
    # a staged sublane reads K2's column: tile_base + rel == stb + rel_adj
    s = np.flatnonzero(ok)
    assert np.array_equal(tp.tile_base.astype(np.int64)[s // tp.chunk]
                          + rel[s], tile.numpy()[s])
    # the rule drops every dead sublane and keeps the others' fields
    dead = (tp.rel_tile.reshape(-1) < 0) | (tp.slice_of.reshape(-1) < 0)
    assert not ok[dead].any()
    assert np.array_equal(sl[ok], tp.slice_of.reshape(-1)[ok])


@pytest.mark.parametrize("dtype", sorted(subwin.DTYPES))
@pytest.mark.parametrize("name", subwin.NAMES)
def test_staged_k2_sweep_matches_jax_subwin(name, dtype, monkeypatch):
    jp = subwin._plan(name)
    tp = plan_from_arrays(plan_fields(jp))
    tdt, jdt = subwin.DTYPES[dtype]
    subwin._split_env(monkeypatch, tp)
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    stb, ssb, split, sub_wt, sub_nsw = op.subwin_windows()
    rel, sl = _stage(op.relsl.numpy(), tp.tile_base, stb.numpy(),
                     ssb.numpy(), chunk=tp.chunk, split=split, sub_wt=sub_wt,
                     sub_nsw=sub_nsw)
    x = np.random.default_rng(6).standard_normal(tp.shape[1]).astype(
        np.float32)
    xt = op._x_tiles(torch.from_numpy(x))
    y = tsp._sweep_plain(op.vals, op.lidx, torch.from_numpy(rel),
                         torch.from_numpy(sl), op.tile_base, None, xt,
                         n_slices=tp.n_slices, chunk=tp.chunk)
    y_j = np.asarray(jsp.SellSpMV(jp, value_dtype=jdt).bench_loop(
        jnp.asarray(x), 2))
    assert subwin._rel(y[: tp.shape[0]].numpy(), y_j) <= TOL
    y_plain = tsp.sell_bench_subwin_plain(
        op.vals, op.lidx, op.relsl, op.tile_base, stb, ssb, xt, split=split,
        sub_wt=sub_wt, sub_nsw=sub_nsw, iterations=1, **op._kw())
    assert subwin._rel(y.numpy(), y_plain.numpy()) <= TOL


def test_subwin_buffers_match_the_source():
    """The wrapper's y buffers are the kernel's (``kSubwinYBuffers``)."""
    src = (tsp.__file__.rsplit("/", 2)[0] + "/csrc/sell_bench.cu")
    text = open(src).read()
    assert (f"constexpr int kSubwinYBuffers = {tsp.SUBWIN_Y_BUFFERS};"
            in text)
    assert "sublane_bench_sweeps<SubwinWord, ResidentY, kSubwinYBuffers>" in (
        text)
