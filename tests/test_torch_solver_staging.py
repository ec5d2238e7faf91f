"""K10's SpMV phase on the warp-per-sublane body, emulated in numpy, against
the port's plain sweep and the JAX package's fused Chebyshev.

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

The kernel's gathers of xin are plain loads (``Coherent``), never
``__ldg``: the vector phase rewrites xin between SpMV phases of one
launch, and the read-only path may return the last step's values, which a
few steps at a small size need not show. A source test pins that, and
that K9 and K11 still run ``spmv_range``.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.ops.pcg_fused import fused_chebyshev as jfused_chebyshev
from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
from smvp_toolkit_tpu_torch.ops import pcg_fused as P
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops.cg_fused import (
    pad_state,
    plain_spmv,
    state_tiles,
)
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

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


def _spmv_items(op, xin):
    """q = A·xin on the state vectors (``len(xin)`` = T·128), walked as
    K10's SpMV phase walks it: work item (chunk c, run r) stages up to 64
    sublanes' merged words, then each live sublane's lanes add v·xin[col]
    to q's rows of its slice. Products in float32, sums in float64."""
    word = op.relsl.numpy().astype(np.int64) & 0xFFFFFFFF
    vals = op.vals.float().numpy()
    lidx = op.lidx.numpy().astype(np.int64)
    tile_base = op.tile_base.numpy().astype(np.int64)
    x = np.asarray(xin, np.float32)
    q = np.zeros(len(x))
    chunk = op.plan.chunk
    for c in range(len(tile_base)):
        for first in range(0, chunk, RUN):
            s = c * chunk + first + np.arange(min(RUN, chunk - first))
            rel, sl = word[s] & REL_DEAD, word[s] >> SLICE_SHIFT
            live = (rel != REL_DEAD) & (sl != SLICE_DEAD)
            for j in np.flatnonzero(live):
                col = (tile_base[c] + rel[j]) * LANES + lidx[s[j]]
                p = vals[s[j]] * x[col]
                q[sl[j] * LANES + np.arange(LANES)] += p.astype(np.float64)
    return q


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
    solvers = (CSRC / "sell_solvers.cu").read_text()
    common = (CSRC / "sell_common.cuh").read_text()
    assert "chebyshev_solve<SublanePhase>(a);" in _function(
        solvers, "    sell_chebyshev_kernel")
    cheb = _function(solvers, "void chebyshev_solve")
    assert "Phase::run(a.spmv, tid, stride);" in cheb
    assert "spmv_range" not in cheb
    phase = solvers[solvers.index("struct SublanePhase {"):]
    assert "spmv_items<Coherent>(a);" in phase[: phase.index("};")]
    items = _function(solvers, "void spmv_items")
    assert re.search(r"sublane_run<MergedWord, ResidentY, Streaming, "
                     r"Gather>\(", items)
    coherent = common[common.index("struct Coherent {"):]
    coherent = coherent[: coherent.index("};")]
    assert "return *p;" in coherent and "__ldg" not in coherent
    run = _function(common, "void sublane_run")
    assert "Gather::load(" in run and "__ldg" not in run
    assert "spmv_range<Decode>(a.spmv, 0, a.spmv.n_slots" in _function(
        solvers, "void cg_solve")
    assert _function(solvers, "    sell_pcg_ic0_kernel").count(
        "spmv_range<MergedWord>(a.spmv") == 3
