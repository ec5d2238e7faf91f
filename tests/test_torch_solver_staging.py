"""K9's, K10's and K11's SpMV phases on the warp-per-sublane body,
emulated in numpy, against the port's plain sweeps and the JAX package's
fused CG, Chebyshev and IC(0)-PCG.

``sell_cg_kernel`` (``csrc/sell_solvers.cu``) runs ``cg_solve`` with the
same walk as K10 over all work items (``SublanePhase<MergedWord>``), and
``sell_cg_split_kernel`` the walk under the split planes' staging
(``SublanePhase<SplitPlanes>``: rel and slice from ``rel_tile`` and
``slice_of`` per sublane, -1 = dead). Thirty emulated float32 CG steps in
K9's order (r = p = b; per step q = A·xin(p), α = r·r / max(p·q, 1e-30),
x += α·p, r −= α·q, β = r'·r' / max(r·r, 1e-30), p = r + β·p; the dot
products in float64 over float32 products) on that walk equal the JAX
``fused_cg`` (interpret mode) and the port's CPU path within 1e-4 of max
|x|, the tolerance of ``test_torch_fused_solvers``, on the systems below;
in bfloat16 the emulated walk equals the plain sweep in the same
recurrence within 1e-4 after 3 steps and 2^-7 after 30. Under the split
staging the walk equals the plain split sweep within 1e-6 of max |q| on
``tests/torch_kcol_plans.py``'s split plan (3000 x 70000, chunk 1024, a
window of 547 tiles), and thirty CG steps on it equal the JAX ``fused_cg``
on the split planes of a tridiagonal system widened past 511 tiles
(``test_torch_fused_solvers``'s).

``sell_chebyshev_kernel`` (``csrc/sell_solvers.cu``) runs its SpMV phase,
q += A·xin on the padded state vectors of T·128 entries, over the plan's
work items: up to 64 sublanes of one chunk each (the last run of a chunk
partial where the chunk is not a multiple of 64), each staged from the
merged word (rel, slice; -1 in both where either is dead), each live
sublane's 128 lanes multiplied against the gathered xin and added to q's
rows of its slice. ``_spmv_items`` is that walk, item by item. It equals
``cg_fused.plain_spmv(op)`` on Poisson 64² and HPCG 16³ (the JAX
operator's plans, chunks 192 and 1104: the latter's last run partial) and
on Poisson 64² at chunk 200 (each chunk three runs of 64 and one of 8),
float32 and bfloat16 (xin rounded to bf16), within 1e-6 of max |q|.
Thirty emulated float32 Chebyshev steps on it equal the JAX
``fused_chebyshev`` (its Pallas kernel in interpret mode on the CPU) and
the port's CPU path within 1e-4 of max |x|, the tolerance of
``test_torch_fused_solvers.test_fused_chebyshev_matches_jax``; in bfloat16
the emulated walk equals the plain sweep in the same recurrence within
1e-4 after 3 steps and 2^-7 after 30, the card checks' limits, and the
port's CPU path within 2^-7 after 30.

``sell_pcg_ic0_kernel`` runs the same walk three times a step, once over
each plan's range of work items in the concatenated planes of
``pcg_fused._IC0Planes`` (A, strict(L), strict(L)ᵀ: whole chunks at one
chunk size, so item (c, r) reads ``tile_base[c]`` at the global chunk
index c). ``_range_walk`` is that walk over a slot range; on Poisson 64²
and HPCG 16³ each of the three ranges equals the port's plain sweep of
that plan (``_IC0Planes.sub_planes``) within 1e-6 of max |q|, and on
Poisson 128² at chunk 64, where the factor plans' tile bases differ from
A's at the same chunk offset. Thirty
emulated float32 K11 steps on it (the kernel's phase order: A, _a_end,
sweeps−1 sweeps of L, sweeps−1 of Lᵀ; sweeps 2 and 4) equal the JAX
``fused_pcg_ic0`` (interpret mode) within 1e-4 of max |x|, the tolerance
of ``test_torch_fused_solvers.test_fused_pcg_ic0_matches_jax``; in
bfloat16 the emulated walk equals the plain sweeps in the same recurrence
within 1e-4 after 3 steps and 2^-7 after 30.

The kernels' gathers of xin are plain loads (``Coherent``), never
``__ldg``: the vector phases rewrite xin between SpMV phases of one
launch, and the read-only path may return the last step's values, which a
few steps at a small size need not show. A source test pins that for K9
(both routes), K10 and K11's three phases, that K2 with k columns runs the
k-column body's N-iteration walk, and that the one-thread-per-slot walks
(``spmv_range``, ``slot``, ``warp_slots``, ``mat_sweep``, the old
``mat_bench_sweeps``) live only in ``csrc/variants/``.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr_encode
from smvp_toolkit_tpu.ops import ilu as jilu
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.ops.cg_fused import fused_cg as jfused_cg
from smvp_toolkit_tpu.ops.pcg_fused import (
    fused_chebyshev as jfused_chebyshev,
    fused_pcg_ic0 as jfused_pcg_ic0,
)
from smvp_toolkit_tpu_torch.interop import (
    ic0_factors_from_arrays,
    plan_fields,
    plan_from_arrays,
)
from smvp_toolkit_tpu_torch.ops import pcg_fused as P
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops.cg_fused import (
    fused_cg,
    pad_state,
    plain_spmv,
    state_tiles,
)
from smvp_toolkit_tpu_torch.ops.sell_plan import rewindow_plan
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

import torch_kcol_plans as kcol

LANES = 128
RUN = 64  # sublanes of a work item (sell_common.cuh, kRun)
REL_DEAD, SLICE_SHIFT, SLICE_DEAD = 511, 9, (1 << 23) - 1
TOL_SPMV = 1e-6
TOL_SOLVER = 1e-4
# bfloat16 after 30 steps: a one-ulp float32 difference between summation
# orders now and then flips the bf16 rounding of an SpMV input entry, and
# the recurrence carries the jump on (tests/test_torch_cuda.py,
# SOLVER_TOL_BF16); after 3 steps bf16 is held to TOL_SOLVER.
TOL_SOLVER_BF16 = 2.0 ** -7
STEPS = 30
CASES = ["poisson64", "hpcg16", "poisson64-chunk200"]
CSRC = Path(tsp.__file__).resolve().parent.parent / "csrc"


def _matrix(name):
    """(scipy matrix, spectrum bounds lo, hi) with lo below the smallest
    and hi above the largest eigenvalue (the analytic spectra: Poisson
    4 − 2cos(πi/(n+1)) − 2cos(πj/(n+1)); HPCG's 27-point stencil
    27 − Π_d (1 + 2cos(πk_d/(n+1))))."""
    if name.startswith("poisson"):
        n = 64
        c = np.cos(np.pi / (n + 1))
        return poisson2d(n), 0.9 * (4 - 4 * c), 8.0
    n = 16
    c = np.cos(np.pi / (n + 1))
    return hpcg_stencil(n), 0.9 * (27 - (1 + 2 * c) ** 3), 36.5


@pytest.fixture(scope="module", params=CASES)
def system(request):
    """(name, JAX plan, the port's plan, b, lo, hi): the JAX operator's own
    plan (``from_coo``), or Poisson 64² at chunk 200."""
    a, lo, hi = _matrix(request.param)
    a = a.tocoo()
    r, c, v = a.row, a.col, a.data.astype(np.float32)
    if request.param.endswith("chunk200"):
        jp = jplan.build_sell_plan(r, c, v, a.shape, chunk=200,
                                   allow_small_chunk=False)
    else:
        jp = jsp.SellSpMV.from_coo(JCOO.from_numpy(
            r.astype(np.int32), c.astype(np.int32), v, shape=a.shape,
            pad_to=128)).plan
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32)
    return request.param, jp, plan_from_arrays(plan_fields(jp)), b, lo, hi


def _staging(planes):
    """Per sublane (rel, slice, live) as the staging policy gives them:
    ``MergedWord`` from the merged word of (vals, lidx, relsl, tile_base),
    ``SplitPlanes`` from rel_tile and slice_of of (vals, lidx, rel_tile,
    slice_of, tile_base)."""
    if len(planes) == 4:
        word = planes[2].numpy().astype(np.int64) & 0xFFFFFFFF
        rel, sl = word & REL_DEAD, word >> SLICE_SHIFT
        return rel, sl, (rel != REL_DEAD) & (sl != SLICE_DEAD)
    rel = planes[2].numpy().astype(np.int64)
    sl = planes[3].numpy().astype(np.int64)
    return rel, sl, (rel >= 0) & (sl >= 0)


def _range_walk(planes, chunk, lo, hi):
    """The slots [lo, hi) (chunk boundaries) of merged-word or split
    planes, walked as the kernels' SpMV phases walk them: the work items
    from lo's to hi's, item = c·runs + r staging up to 64 sublanes (chunk
    c, run r) under the planes' policy (``_staging``), the live ones' 128
    lanes each taken with the chunk's ``tile_base[c]``. Returns the rows,
    columns and values of every slot multiplied, item by item."""
    vals_p, lidx_p, tile_base = planes[0], planes[1], planes[-1]
    rel_all, sl_all, live_all = _staging(planes)
    vals = vals_p.float().numpy().reshape(-1, LANES)
    lidx = lidx_p.numpy().astype(np.int64).reshape(-1, LANES)
    tb = tile_base.numpy().astype(np.int64)
    runs, per_chunk = -(-chunk // RUN), LANES * chunk
    assert lo % per_chunk == 0 and hi % per_chunk == 0
    rows, cols, vs = [], [], []
    for item in range(lo // per_chunk * runs, hi // per_chunk * runs):
        c, r = divmod(item, runs)
        first = r * RUN
        s = c * chunk + first + np.arange(min(RUN, chunk - first))
        live = live_all[s]
        s, rel, sl = s[live], rel_all[s][live], sl_all[s][live]
        cols.append(((tb[c] + rel)[:, None] * LANES + lidx[s]).ravel())
        rows.append((sl[:, None] * LANES + np.arange(LANES)).ravel())
        vs.append(vals[s].ravel())
    return tuple(np.concatenate(a) if a else np.zeros(0, t)
                 for a, t in ((rows, np.int64), (cols, np.int64),
                              (vs, np.float32)))


def _apply(walk, xin):
    """q = the walk's slots times xin on the state vector: products in
    float32, sums in float64."""
    rows, cols, v = walk
    x = np.asarray(xin, np.float32)
    return np.bincount(rows, weights=(v * x[cols]).astype(np.float64),
                       minlength=len(x))


def _spmv_items(op, xin):
    """q = A·xin on the state vectors (``len(xin)`` = T·128), walked as
    K9's and K10's SpMV phases walk it: every work item of the plan, under
    the route's staging."""
    return _apply(_range_walk(op._planes(), op.plan.chunk, 0,
                              op.vals.numel()), xin)


def _operator(tp, dtype):
    return tsp.SellSpMV(tp, value_dtype=dtype, device="cpu")


def _xin(op, v):
    """The SpMV input the kernel gathers: the state vector itself in
    float32, its bf16 copy in bfloat16."""
    return torch.from_numpy(v).to(op.value_dtype).float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_items_match_the_plain_sweep(system, dtype):
    name, _, tp, b, _, _ = system
    op = _operator(tp, dtype)
    if name != "poisson64":
        assert tp.chunk % RUN, "the last run of a chunk must be partial"
    n_state = state_tiles(tp) * LANES
    v = pad_state(torch.from_numpy(b), state_tiles(tp)).numpy()
    q = _spmv_items(op, _xin(op, v))
    want = plain_spmv(op)(op._planes(), torch.from_numpy(v)).numpy()
    assert q.shape == want.shape == (n_state,)
    scale = np.abs(want).max()
    assert np.abs(q - want).max() <= TOL_SPMV * scale


def _plain_sweep(op, xin):
    """q = A·xin by the route's plain sweep on the state vectors."""
    return plain_spmv(op)(op._planes(), torch.from_numpy(xin)).numpy()


def _chebyshev(op, b, lo, hi, steps, spmv=_spmv_items):
    """K10's solve in float32 with the emulated SpMV phase (or ``spmv``):
    r = b, d = b·float32(1/θ); per step q = A·xin(d); x += d; r −= q;
    d = a_k·d + c_k·r."""
    coeffs, inv_theta = P.chebyshev_coefficients(lo, hi, steps)
    n_state = state_tiles(op.plan) * LANES
    bt = np.zeros(n_state, np.float32)
    bt[: len(b)] = b
    x = np.zeros(n_state, np.float32)
    r = bt.copy()
    d = bt * inv_theta
    for k in range(steps):
        q = spmv(op, _xin(op, d)).astype(np.float32)
        x = x + d
        r = r - q
        d = coeffs[0, k] * d + coeffs[1, k] * r
    return x[: len(b)]


def test_emulated_chebyshev_matches_jax(system):
    """Float32: 30 emulated steps against the JAX kernel (interpret mode)
    and the port's CPU path."""
    _, jp, tp, b, lo, hi = system
    op = _operator(tp, torch.float32)
    x = _chebyshev(op, b, lo, hi, STEPS)
    xj = np.asarray(jfused_chebyshev(jsp.SellSpMV(jp), jnp.asarray(b), lo,
                                     hi, STEPS))
    assert np.isfinite(x).all()
    assert np.abs(x - xj).max() <= TOL_SOLVER * np.abs(xj).max()
    xp = P.fused_chebyshev(op, torch.from_numpy(b), lo, hi, STEPS).numpy()
    assert np.abs(x - xp).max() <= TOL_SOLVER * np.abs(xp).max()


@pytest.mark.parametrize("steps, tol", [(3, TOL_SOLVER),
                                        (STEPS, TOL_SOLVER_BF16)])
def test_emulated_bf16_chebyshev_matches_the_plain_sweep(system, steps,
                                                        tol):
    """bfloat16: the emulated walk against the plain sweep in the same
    recurrence (the kernel's first direction b·float32(1/θ)), at the card
    checks' limits; after 30 steps also against the port's CPU path, whose
    first direction b/θ differs in the last bit, enough to flip the bf16
    rounding of an SpMV input entry within 3 steps."""
    _, _, tp, b, lo, hi = system
    op = _operator(tp, torch.bfloat16)
    x = _chebyshev(op, b, lo, hi, steps)
    xs = _chebyshev(op, b, lo, hi, steps, spmv=_plain_sweep)
    assert np.isfinite(x).all()
    assert np.abs(x - xs).max() <= tol * np.abs(xs).max()
    if steps == STEPS:
        xp = P.fused_chebyshev(op, torch.from_numpy(b), lo, hi, steps)
        xp = xp.numpy()
        assert np.abs(x - xp).max() <= tol * np.abs(xp).max()


# -- K9: the CG recurrence over the same walk, merged word and split planes


def _cg(op, b, steps, spmv=_spmv_items):
    """K9's solve in float32 with the emulated SpMV phase (or ``spmv``),
    in the kernel's order: x = 0, r = p = b, r·r; per step q = A·xin(p),
    α = r·r / max(p·q, 1e-30), x += α·p, r −= α·q, β = r'·r' / max(r·r,
    1e-30), p = r + β·p (dot products: float64 sums of float32
    products)."""
    f32 = np.float32
    bt = np.zeros(state_tiles(op.plan) * LANES, f32)
    bt[: len(b)] = b
    x, r, p = np.zeros_like(bt), bt.copy(), bt.copy()
    rs = f32(np.sum((bt * bt).astype(np.float64)))
    for _ in range(steps):
        q = spmv(op, _xin(op, p)).astype(f32)
        pq = f32(np.sum((p * q).astype(np.float64)))
        alpha = f32(rs / np.maximum(pq, f32(1e-30)))
        x = x + alpha * p
        r = r - alpha * q
        rs2 = f32(np.sum((r * r).astype(np.float64)))
        beta = f32(rs2 / np.maximum(rs, f32(1e-30)))
        p = r + beta * p
        rs = rs2
    return x[: len(b)]


def test_emulated_cg_matches_jax(system):
    """Float32: 30 emulated K9 steps against the JAX kernel (interpret
    mode) and the port's CPU path."""
    _, jp, tp, b, _, _ = system
    op = _operator(tp, torch.float32)
    x = _cg(op, b, STEPS)
    xj = np.asarray(jfused_cg(jsp.SellSpMV(jp), jnp.asarray(b), STEPS))
    assert np.isfinite(x).all() and x.shape == xj.shape
    assert np.abs(x - xj).max() <= TOL_SOLVER * np.abs(xj).max()
    xp = fused_cg(op, torch.from_numpy(b), STEPS).numpy()
    assert np.abs(x - xp).max() <= TOL_SOLVER * np.abs(xp).max()


@pytest.mark.parametrize("steps, tol", [(3, TOL_SOLVER),
                                        (STEPS, TOL_SOLVER_BF16)])
def test_emulated_bf16_cg_matches_the_plain_sweep(system, steps, tol):
    """bfloat16: the emulated walk against the plain sweep in the same
    recurrence, at the card checks' limits; after 30 steps also against
    the port's CPU path."""
    _, _, tp, b, _, _ = system
    op = _operator(tp, torch.bfloat16)
    x = _cg(op, b, steps)
    xs = _cg(op, b, steps, spmv=_plain_sweep)
    assert np.isfinite(x).all()
    assert np.abs(x - xs).max() <= tol * np.abs(xs).max()
    if steps == STEPS:
        xp = fused_cg(op, torch.from_numpy(b), steps).numpy()
        assert np.abs(x - xp).max() <= tol * np.abs(xp).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_items_match_the_plain_split_sweep(dtype):
    """The walk under the split planes' staging equals the plain split
    sweep on the split plan of ``torch_kcol_plans`` (a window of 547 tiles,
    rel past the merged word's 511, 200 duplicate sublanes of one row)."""
    tp = kcol.hub_row_plan("split")
    op = _operator(tp, dtype)
    assert op.route == "split" and tp.window_tiles > 511
    assert len(op._planes()) == 5
    v = np.random.default_rng(2).standard_normal(
        state_tiles(tp) * LANES).astype(np.float32)
    q = _spmv_items(op, _xin(op, v))
    want = _plain_sweep(op, v)
    assert q.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(q - want).max() <= TOL_SPMV * scale


def test_emulated_split_cg_matches_jax(monkeypatch):
    """Float32: 30 emulated K9 steps under the split staging, on a
    tridiagonal system of 513·128 rows whose plan is widened to a window
    of 512 tiles, against the JAX kernel on its split planes (interpret
    mode) and the port's CPU path."""
    n = 513 * LANES
    a = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n, n)).tocoo()
    r, c, v = a.row.astype(np.int32), a.col.astype(np.int32), a.data
    jop = jsp.SellSpMV.from_coo(JCOO.from_numpy(
        r, c, v.astype(np.float32), shape=a.shape, pad_to=128))
    tp = rewindow_plan(plan_from_arrays(plan_fields(jop.plan)), 512)
    op = _operator(tp, torch.float32)
    assert op.route == "split"
    b = np.random.RandomState(1).rand(n).astype(np.float32)
    x = _cg(op, b, STEPS)
    monkeypatch.setenv("SMVP_SELL_RELSL", "0")
    xj = np.asarray(jfused_cg(jop, jnp.asarray(b), STEPS))
    assert np.isfinite(x).all()
    assert np.abs(x - xj).max() <= TOL_SOLVER * np.abs(xj).max()
    xp = fused_cg(op, torch.from_numpy(b), STEPS).numpy()
    assert np.abs(x - xp).max() <= TOL_SOLVER * np.abs(xp).max()


# -- K11: the three SpMV phases over item ranges of the concatenated planes


def _csr_fields(csr):
    return dict(row_ptr=np.asarray(csr.row_ptr),
                col_ind=np.asarray(csr.col_ind), vals=np.asarray(csr.vals),
                shape=csr.shape, nnz=csr.nnz)


@pytest.fixture(scope="module",
                params=["poisson64", "hpcg16", "poisson128-chunk64"])
def ic0_system(request):
    """(JAX operator, JAX IC(0) factors, the port's plan, the same factors
    for the port, b): both packages on the JAX operator's own plan, or on
    Poisson 128² at chunk 64, whose factor plans' tile bases differ from
    A's chunk by chunk (so a phase that read ``tile_base`` at its plan's
    own chunk index would gather the wrong tiles)."""
    if request.param == "poisson128-chunk64":
        a = poisson2d(128).tocoo()
    else:
        a = _matrix(request.param)[0].tocoo()
    jcoo = JCOO.from_numpy(a.row.astype(np.int32), a.col.astype(np.int32),
                           a.data.astype(np.float32), shape=a.shape,
                           pad_to=128)
    if request.param == "poisson128-chunk64":
        jop = jsp.SellSpMV(jplan.build_sell_plan(
            a.row, a.col, a.data.astype(np.float32), a.shape, chunk=64,
            allow_small_chunk=False))
    else:
        jop = jsp.SellSpMV.from_coo(jcoo)
    jf = jilu.ic0(jcsr_encode(jcoo))
    tf = ic0_factors_from_arrays(_csr_fields(jf.strict),
                                 _csr_fields(jf.strict_t),
                                 np.asarray(jf.diag), device="cpu")
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32)
    return jop, jf, plan_from_arrays(plan_fields(jop.plan)), tf, b


def _ic0_walks(fp, chunk):
    """K11's three SpMV phases as the kernel is given them: A over the
    slots [0, slots_l0), strict(L) over [slots_l0, slots_lt0), strict(L)ᵀ
    over [slots_lt0, n_slots) of the concatenated planes."""
    planes = (fp.vals, fp.lidx, fp.relsl, fp.tile_base)
    bounds = [k * LANES for k in fp.sublane_bounds]
    return [_range_walk(planes, chunk, bounds[k], bounds[k + 1])
            for k in range(3)]


@pytest.mark.parametrize("phase", [0, 1, 2], ids=["A", "L", "Lt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ic0_range_walk_matches_the_plain_sweeps(ic0_system, dtype, phase):
    """Each of K11's item ranges equals the port's plain sweep of its plan
    (``_IC0Planes.sub_planes``); the three ranges are whole chunks of
    items that tile the concatenation."""
    _, _, tp, tf, _ = ic0_system
    op = _operator(tp, dtype)
    fp = P._ic0_planes(op, tf)
    chunk = op.plan.chunk
    assert all(k % chunk == 0 for k in fp.sublane_bounds)
    assert fp.sublane_bounds[-1] * LANES == fp.vals.numel()
    if chunk == 64:  # Poisson 128²: the global chunk index matters
        tb = fp.tile_base.numpy()
        lo, hi = (k // chunk for k in fp.sublane_bounds[phase:phase + 2])
        assert not np.array_equal(tb[lo:hi], tb[: hi - lo]) or phase == 0
    v = np.random.default_rng(phase).standard_normal(len(fp.invd)).astype(
        np.float32)
    q = _apply(_ic0_walks(fp, chunk)[phase], _xin(op, v))
    want = plain_spmv(op)(fp.sub_planes(phase, chunk),
                          torch.from_numpy(v)).numpy()
    assert q.shape == want.shape == (len(fp.invd),)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(q - want).max() <= TOL_SPMV * scale


def _pcg_ic0(op, fp, b, steps, sweeps, spmv):
    """K11's solve in float32 in the kernel's phase order, its SpMV phases
    by ``spmv(k, xin)`` (k: 0 A, 1 strict(L), 2 strict(L)ᵀ) and xin rounded
    to the value dtype where a phase writes it: pass 0 from its first L
    sweep (p = 0), each later pass A, _a_end, then sweeps−1 sweeps of L
    (_l_sweep, _l_last) and of Lᵀ (_lt_sweep, _lt_last and p = w + β·p);
    the last pass stops after its x update."""
    f32 = np.float32
    invd = fp.invd.numpy()
    bt = np.zeros(len(invd), f32)
    bt[: len(b)] = b
    x, r, p, z = np.zeros_like(bt), bt.copy(), np.zeros_like(bt), None
    xin = _xin(op, invd * bt)
    rz = f32(1)
    for pas in range(steps + 1):
        if pas > 0:
            q = spmv(0, xin).astype(f32)
            pq = f32(np.sum((p * q).astype(np.float64)))
            alpha = f32(rz / np.maximum(pq, f32(1e-30)))
            x = x + alpha * p
            r = r - alpha * q
            xin = _xin(op, invd * r)
        if pas == steps:
            break
        for s in range(sweeps - 1):
            v = invd * (r - spmv(1, xin).astype(f32))
            if s == sweeps - 2:
                z = v
                xin = _xin(op, invd * v)
            else:
                xin = _xin(op, v)
        for s in range(sweeps - 1):
            q = spmv(2, xin).astype(f32)
            if s < sweeps - 2:
                xin = _xin(op, invd * (z - q))
                continue
            z = invd * (z - q)
            rz_new = f32(np.sum((r * z).astype(np.float64)))
            beta = f32(0) if pas == 0 else f32(
                rz_new / np.maximum(rz, f32(1e-30)))
            p = z + beta * p
            xin = _xin(op, p)
            rz = rz_new
    return x[: len(b)]


def _walk_spmv(op, fp):
    walks = _ic0_walks(fp, op.plan.chunk)
    return lambda k, v: _apply(walks[k], v)


def _sweep_spmv(op, fp):
    spmv, chunk = plain_spmv(op), op.plan.chunk
    return lambda k, v: spmv(fp.sub_planes(k, chunk),
                             torch.from_numpy(v)).numpy()


@pytest.mark.parametrize("sweeps", [2, 4])
def test_emulated_pcg_ic0_matches_jax(ic0_system, sweeps):
    """Float32: 30 emulated K11 steps against the JAX kernel (interpret
    mode) on the same plan and factors."""
    jop, jf, tp, tf, b = ic0_system
    op = _operator(tp, torch.float32)
    fp = P._ic0_planes(op, tf)
    x = _pcg_ic0(op, fp, b, STEPS, sweeps, _walk_spmv(op, fp))
    xj = np.asarray(jfused_pcg_ic0(jop, jf, jnp.asarray(b), STEPS,
                                   sweeps=sweeps))
    assert np.isfinite(x).all() and x.shape == xj.shape
    assert np.abs(x - xj).max() <= TOL_SOLVER * np.abs(xj).max()


@pytest.mark.parametrize("steps, tol", [(3, TOL_SOLVER),
                                        (STEPS, TOL_SOLVER_BF16)])
@pytest.mark.parametrize("sweeps", [2, 4])
def test_emulated_bf16_pcg_ic0_matches_the_plain_sweeps(ic0_system, sweeps,
                                                       steps, tol):
    """bfloat16: the emulated walk against the plain sweeps in the same
    recurrence, at the card checks' limits."""
    _, _, tp, tf, b = ic0_system
    op = _operator(tp, torch.bfloat16)
    fp = P._ic0_planes(op, tf)
    x = _pcg_ic0(op, fp, b, steps, sweeps, _walk_spmv(op, fp))
    xs = _pcg_ic0(op, fp, b, steps, sweeps, _sweep_spmv(op, fp))
    assert np.isfinite(x).all()
    assert np.abs(x - xs).max() <= tol * np.abs(xs).max()


def _function(text, name):
    """The body of the C++ function or kernel ``name`` in ``text``."""
    start = text.index(name + "(")
    open_ = text.index("{", start)
    depth, i = 0, open_
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[open_:i + 1]
        i += 1


def test_k10_gathers_are_coherent_and_k9_k11_keep_spmv_range():
    """K9's phase (both routes), K10's and K11's three phases run the
    item-range walk with coherent gathers (``SublanePhase<Stage>``:
    ``spmv_items<Stage, Coherent>``, plain loads, never ``__ldg``); K9's
    launch takes the warp-per-sublane checks; K2 with k columns runs the
    k-column body's N-iteration walk. No kernel of the package keeps a
    one-thread-per-slot walk: ``spmv_range``, ``slot``, ``warp_slots``,
    ``mat_sweep`` and the old ``mat_bench_sweeps`` are defined and called
    only in ``csrc/variants/``."""
    solvers = (CSRC / "sell_solvers.cu").read_text()
    common = (CSRC / "sell_common.cuh").read_text()
    for kernel, solve in (("sell_cg_kernel", "cg_solve<SublanePhase<"
                           "MergedWord>>(a);"),
                          ("sell_cg_split_kernel", "cg_solve<SublanePhase<"
                           "SplitPlanes>>(a);"),
                          ("sell_chebyshev_kernel", "chebyshev_solve<"
                           "SublanePhase<MergedWord>>(a);"),
                          ("sell_pcg_ic0_kernel", "pcg_ic0_solve<"
                           "SublanePhase<MergedWord>>(a);")):
        assert solve in _function(solvers, "    " + kernel), kernel
    for solve in ("void cg_solve", "void chebyshev_solve"):
        body = _function(solvers, solve)
        assert "Phase::run(a.spmv, 0, a.spmv.n_slots, tid, stride);" in body
        assert "spmv_range" not in body
    ic0 = _function(solvers, "void pcg_ic0_solve")
    assert "spmv_range" not in ic0
    for lo, hi in (("0", "a.slots_l0"), ("a.slots_l0", "a.slots_lt0"),
                   ("a.slots_lt0", "a.slots_end")):
        assert f"Phase::run(a.spmv, {lo}, {hi}, tid, stride);" in ic0
    phase = solvers[solvers.index("struct SublanePhase {"):]
    assert ("spmv_items<Stage, Coherent>(a, items_before(a, lo), "
            "items_before(a, hi));") in phase[: phase.index("};")]
    items = _function(solvers, "void spmv_items")
    assert "item = lo + blockIdx.x; item < hi; item += gridDim.x" in items
    assert re.search(r"sublane_run<Stage, ResidentY, Streaming, "
                     r"Gather>\(", items)
    coherent = common[common.index("struct Coherent {"):]
    coherent = coherent[: coherent.index("};")]
    assert "return *p;" in coherent and "__ldg" not in coherent
    run = _function(common, "void sublane_run")
    assert "Gather::load(" in run and "__ldg" not in run
    launch = _function(solvers, "cudaError_t launch_solver")
    assert "cudaError_t err = sublane_phase_checks(a);" in launch
    assert "kCg" not in launch
    checks = _function(solvers, "cudaError_t sublane_phase_checks")
    assert "a.slots_l0 % chunk_slots == 0" in checks
    assert "a.slots_lt0 % chunk_slots == 0" in checks
    spmm = (CSRC / "sell_spmm.cu").read_text()
    assert ("sublane_mat_bench_sweeps<MergedWord, MatShape<T, W, P>, "
            "kBenchMatYBuffers>(") in _function(
        spmm, "    sell_bench_spmm_kernel")
    assert (f"constexpr int kBenchMatYBuffers = "
            f"{tsp.MAT_BENCH_Y_BUFFERS};") in spmm
    assert "sublane_mat_run<Stage, Shape>(a, out," in _function(
        common, "void sublane_mat_bench_sweeps")
    walks = ("spmv_range", "slot", "warp_slots", "mat_sweep",
             "mat_bench_sweeps", "bench_sweeps")
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        for walk in walks:
            assert not re.search(rf"(?<![\w]){walk}\s*<", text), (path.name,
                                                                  walk)
            assert not re.search(rf"void {walk}\(", text), (path.name, walk)
    variants = (CSRC / "variants" / "slot_walks.cuh").read_text()
    for walk in ("spmv_range", "slot", "warp_slots", "mat_sweep",
                 "bench_sweeps", "slot_coords"):
        assert re.search(rf"void {walk}\(|bool {walk}\(", variants), walk
    assert "void mat_bench_sweeps(" in (
        CSRC / "variants" / "sell_spmm_variants.cu").read_text()
