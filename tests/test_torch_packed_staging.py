"""K5's per-sublane staging on the packed word against the JAX package.

K5 (``csrc/sell_packed.cu``) runs K1's warp-per-sublane body under the
``PackedStage`` policy: a block per work item of up to 64 sublanes of one
chunk stages each sublane's rel from its lane-0 word and its slice from
``slice_of`` (-1 in both where either is dead), and a warp per live
sublane decodes four words a thread (value bits 16..31, lane bits 0..6),
gathers x and adds four rows. ``_body`` below is that walk in numpy,
work item by work item. On the small resident and streamed plans its y
equals the plain version (``sell_packed_plain``) and the JAX operator
under ``SMVP_SELL_PACK=1`` (its packed kernel in interpret mode) within
1e-6 of max |y|; on a plane whose lanes 1..127 carry another rel than
lane 0 it equals the plain version, which reads lane 0 as the JAX
``_unpack_plane`` does, and not the per-slot decode K5 ran before.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

import test_torch_packed as packed_cases
import torch_packed_plans as pp

TOL = 1e-6
RUN = 64  # sublanes of a work item (sell_common.cuh, kRun)
NAMES = ["resident", "resident-int32-lidx", "streamed"]


def _stage(packed, slice_of, s):
    """``PackedStage::stage`` of sublanes ``s``: (rel, slice), -1 in both
    where either is dead."""
    r = pp.word_rel(packed.reshape(-1, pp.LANES)[s, 0])
    sl = slice_of.reshape(-1)[s].astype(np.int64)
    dead = (r == pp.REL_DEAD) | (sl < 0)
    return np.where(dead, -1, r), np.where(dead, -1, sl)


def _per_slot(packed, slice_of, s):
    """The walk K5 ran before: rel from each slot's own word, (S, 128)."""
    r = pp.word_rel(packed.reshape(-1, pp.LANES)[s])
    sl = slice_of.reshape(-1)[s].astype(np.int64)[:, None]
    return np.where((r == pp.REL_DEAD) | (sl < 0), -1, r)


def _body(packed, slice_of, tile_base, x, *, n_slices, chunk,
          y_block_id=None, nsb=0, per_slot=False):
    """K5's function, walked as the kernel walks it: work item (chunk c,
    run r) stages up to 64 sublanes, then each live one's four-word groups
    are decoded and their products added to four rows. Products in
    float32, sums in float64 (the kernel's atomics sum in float32, in no
    fixed order)."""
    words = packed.reshape(-1, pp.LANES).astype(np.int64) & 0xFFFFFFFF
    vals = (words & 0xFFFF0000).astype(np.uint32).view(np.float32)
    lane = (words & 127).astype(np.int64)
    xf = np.asarray(x, np.float32)
    y = np.zeros(n_slices * pp.LANES)
    n_sub = words.shape[0]
    for c in range(n_sub // chunk):
        base = 0 if y_block_id is None else int(y_block_id[c]) * nsb
        for first in range(0, chunk, RUN):
            s = c * chunk + first + np.arange(min(RUN, chunk - first))
            rel, sl = _stage(packed, slice_of, s)
            for j in np.flatnonzero(sl >= 0):
                r = (_per_slot(packed, slice_of, s[j:j + 1])[0]
                     if per_slot else np.full(pp.LANES, rel[j]))
                ok = r >= 0
                col = (int(tile_base[c]) + r) * pp.LANES + lane[s[j]]
                p = np.where(ok, vals[s[j]] * xf[np.where(ok, col, 0)],
                             np.float32(0))
                rows = (base + sl[j]) * pp.LANES + np.arange(pp.LANES)
                y[rows] += p.astype(np.float64)
    return y


def _rel(a, b) -> float:
    return packed_cases._rel(a, b)


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    jp = packed_cases._plan(request.param)
    tp = plan_from_arrays(plan_fields(jp))
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    x = np.random.default_rng(9).standard_normal(tp.shape[1]).astype(
        np.float32)
    return request.param, jp, tp, op, x


def _kw(op):
    kw = op._kw()
    if op.plan.y_block_slices:
        kw["y_block_id"] = op.y_block_id
    return kw


def _emulate(op, xt, packed=None, per_slot=False):
    pk, sl = op.packed_planes()
    kw = _kw(op)
    yb = kw.get("y_block_id")
    return _body((pk if packed is None else packed).numpy(), sl.numpy(),
                 op.tile_base.numpy(), xt.float().numpy(),
                 n_slices=kw["n_slices"], chunk=kw["chunk"],
                 y_block_id=None if yb is None else yb.numpy(),
                 nsb=kw.get("nsb", 0), per_slot=per_slot)


def test_staging_reads_the_planes_rel_and_slice(case):
    """On the operator's own plane every word of a sublane carries one rel,
    so lane 0's is every slot's, and the staging marks dead exactly the
    plan's dead sublanes."""
    _, _, tp, op, _ = case
    pk, sl = (t.numpy() for t in op.packed_planes())
    s = np.arange(tp.n_sublanes)
    rel, slc = _stage(pk, sl, s)
    dead = (tp.rel_tile.reshape(-1) < 0) | (tp.slice_of.reshape(-1) < 0)
    assert np.array_equal(rel < 0, dead) and np.array_equal(slc < 0, dead)
    assert np.array_equal(rel[~dead], tp.rel_tile.reshape(-1)[~dead])
    assert np.array_equal(slc[~dead], tp.slice_of.reshape(-1)[~dead])
    per = _per_slot(pk, sl, s)
    assert np.array_equal(per[~dead], np.repeat(rel[~dead, None], 128, 1))


def test_staged_body_matches_plain_and_jax(case, monkeypatch):
    name, jp, tp, op, x = case
    xt = op._x_tiles(torch.from_numpy(x))
    y = _emulate(op, xt)[: tp.shape[0]]
    pk, sl = op.packed_planes()
    yp = tsp.sell_packed_plain(pk, sl, op.tile_base, xt, **_kw(op))
    assert _rel(y, yp[: tp.shape[0]].numpy()) <= TOL
    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    assert op.route == ("streamy_packed" if name == "streamed"
                        else "packed")
    y_j = jsp.SellSpMV(jp, value_dtype=jnp.bfloat16)(jnp.asarray(x))
    assert _rel(y, np.asarray(y_j)) <= TOL


def test_disagreeing_lanes_follow_lane_zero(case):
    """On a plane whose lanes 1..127 carry another rel, the staged body
    (rel from lane 0) equals the plain version on that plane and the
    plane's own y; the per-slot decode K5 ran before does not."""
    _, _, tp, op, x = case
    pk, sl = op.packed_planes()
    bad = pp.disagreeing_lanes(pk.numpy(), sl.numpy(), op.tile_base.numpy(),
                               chunk=tp.chunk, n_coltiles=tp.n_coltiles)
    assert np.array_equal(bad.reshape(-1, 128)[:, 0],
                          pk.numpy().reshape(-1, 128)[:, 0])
    assert np.array_equal(bad & ~(511 << 7), pk.numpy() & ~(511 << 7))
    xt = op._x_tiles(torch.from_numpy(x))
    kw = _kw(op)
    yp = tsp.sell_packed_plain(torch.from_numpy(bad), sl, op.tile_base, xt,
                               **kw).numpy()
    y_own = tsp.sell_packed_plain(pk, sl, op.tile_base, xt, **kw).numpy()
    assert np.array_equal(yp, y_own)
    y = _emulate(op, xt, torch.from_numpy(bad))
    assert _rel(y, yp) <= TOL
    y_old = _emulate(op, xt, torch.from_numpy(bad), per_slot=True)
    assert _rel(y_old, yp) > 1e-3


def test_k5_instantiates_the_staged_body():
    src = (tsp.__file__.rsplit("/", 2)[0] + "/csrc/sell_packed.cu")
    text = open(src).read()
    assert "sublane_sweep<PackedStage, YAddr>(a);" in text
    assert ("__launch_bounds__(kThreads, kSublaneMinBlocks)\n"
            "    sell_packed_kernel" in text)
    common = open(tsp.__file__.rsplit("/", 2)[0]
                  + "/csrc/sell_common.cuh").read()
    assert "a.meta[s * kLanes]" in common  # lane 0's word
