"""The port's fused solvers (``ops/cg_fused.py``, ``ops/pcg_fused.py``)
against the JAX package's, run as its own tests run them: Pallas in
interpret mode on the CPU.

Both packages run the same plan (``interop.plan_from_arrays``) and K11 the
same IC(0) factors (``interop.ic0_factors_from_arrays``); the port runs on
the CPU, where each wrapper takes its plain version. Tolerance: max |x −
x_jax| ≤ 1e-4 · max |x_jax|, the JAX package's own tolerance for its fused
solvers against their scan loops (the reductions re-associate). The split
-plane K9 case widens the port's plan past 511 tiles
(``rewindow_plan(plan, 512)``) and runs JAX under ``SMVP_SELL_RELSL=0``.
Also: K11's three common-window plans equal the JAX ones field by field,
every refusal, and ``num_iters = 0``.
"""

from __future__ import annotations

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
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import (
    coo_from_triplets,
    ic0_factors_from_arrays,
    plan_fields,
    plan_from_arrays,
)
from smvp_toolkit_tpu_torch.ops import pcg_fused as P
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg, fused_cg_plain
from smvp_toolkit_tpu_torch.ops.ilu import ic0
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    build_streamed_sell_plan,
    rewindow_plan,
)
from smvp_toolkit_tpu_torch.utils.synth import poisson2d

TOL = 1e-4


def _spd(n=300, seed=2):
    """The JAX tests' ``_spd_coo``: sparse, symmetric, diagonally
    dominant."""
    rng = np.random.RandomState(seed)
    a = np.zeros((n, n))
    for _ in range(3 * n):
        i, j = rng.randint(0, n, 2)
        w = rng.rand()
        a[i, j] += w
        a[j, i] += w
    a += np.diag(np.abs(a).sum(axis=1) + 1.0)
    return sp.coo_matrix(a)


def _tridiag(n):
    return sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n, n))


def _system(a, seed=0):
    """Both packages' operators on the JAX plan, both CSRs, b and the
    dense solution."""
    a = sp.coo_matrix(a)
    r, c, v = a.row.astype(np.int32), a.col.astype(np.int32), a.data
    jcoo = JCOO.from_numpy(r, c, v.astype(np.float32), shape=a.shape,
                           pad_to=128)
    jop = jsp.SellSpMV.from_coo(jcoo)
    top = tsp.SellSpMV(plan_from_arrays(plan_fields(jop.plan)), device="cpu")
    tcsr = csr_encode(coo_from_triplets(r, c, v, a.shape, device="cpu")
                      .pad(128))
    b = np.random.RandomState(seed).rand(a.shape[0]).astype(np.float32)
    return dict(jop=jop, top=top, jcsr=jcsr_encode(jcoo), tcsr=tcsr, b=b,
                a=a)


@pytest.fixture(scope="module", params=["poisson12", "spd300"])
def system(request):
    return _system(poisson2d(12) if request.param == "poisson12" else _spd())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _factors(s):
    jf = jilu.ic0(s["jcsr"])

    def fields(csr):
        return dict(row_ptr=np.asarray(csr.row_ptr),
                    col_ind=np.asarray(csr.col_ind),
                    vals=np.asarray(csr.vals), shape=csr.shape, nnz=csr.nnz)

    tf = ic0_factors_from_arrays(fields(jf.strict), fields(jf.strict_t),
                                 np.asarray(jf.diag), device="cpu")
    return jf, tf


def test_fused_cg_matches_jax(system):
    b = system["b"]
    x = fused_cg(system["top"], torch.from_numpy(b), 60)
    xj = np.asarray(jfused_cg(system["jop"], jnp.asarray(b), 60))
    assert x.shape == xj.shape and _rel(x.numpy(), xj) <= TOL


def test_fused_chebyshev_matches_jax(system):
    b = system["b"]
    lam = np.linalg.eigvalsh(system["a"].toarray())
    lo, hi = float(lam[0]), float(lam[-1])
    x = P.fused_chebyshev(system["top"], torch.from_numpy(b), lo, hi, 80)
    xj = np.asarray(jfused_chebyshev(system["jop"], jnp.asarray(b), lo, hi,
                                     80))
    assert _rel(x.numpy(), xj) <= TOL


@pytest.mark.parametrize("sweeps", [2, 4])
def test_fused_pcg_ic0_matches_jax(system, sweeps):
    b = system["b"]
    jf, tf = _factors(system)
    x = P.fused_pcg_ic0(system["top"], tf, torch.from_numpy(b), 40,
                        sweeps=sweeps)
    xj = np.asarray(jfused_pcg_ic0(system["jop"], jf, jnp.asarray(b), 40,
                                   sweeps=sweeps))
    assert _rel(x.numpy(), xj) <= TOL
    # and it solves: the dense float64 solution
    xd = np.linalg.solve(system["a"].toarray(), b.astype(np.float64))
    assert _rel(x.numpy(), xd) <= 1e-3


def test_ic0_factors_from_arrays_equal_port_ic0(system):
    _, tf = _factors(system)
    own = ic0(system["tcsr"])
    for got, want in ((tf.strict, own.strict), (tf.strict_t, own.strict_t)):
        assert torch.equal(got.row_ptr, want.row_ptr)
        assert torch.equal(got.col_ind, want.col_ind)
        assert torch.equal(got.vals, want.vals) and got.nnz == want.nnz
    assert torch.equal(tf.diag, own.diag)


def test_ic0_plans_equal_jax(system):
    jf, tf = _factors(system)
    plans, wt, nsw, bases = P.ic0_plans(system["top"], tf)
    jop = system["jop"]
    n, m = jop.shape

    def jfactor(csr):
        r, c, v, _ = jsp._triplets_from_csr_host(csr)
        return jplan.build_sell_plan(np.asarray(r, np.int64),
                                     np.asarray(c, np.int64), v, (n, m),
                                     chunk=jop.plan.chunk,
                                     allow_small_chunk=False)

    jplans, jwt, jnsw, jbases = jplan.common_window(
        [jop.plan, jfactor(jf.strict), jfactor(jf.strict_t)],
        jop.plan.n_slices)
    assert (wt, nsw) == (jwt, jnsw)
    for got, want, gb, wb in zip(plans, jplans, bases, jbases):
        gf, wf = plan_fields(got), plan_fields(want)
        assert gf.keys() == wf.keys()
        for key in gf:
            if isinstance(wf[key], np.ndarray):
                assert np.array_equal(gf[key], wf[key]), key
                assert gf[key].dtype == wf[key].dtype, key
            else:
                assert gf[key] == wf[key], key
        assert np.array_equal(gb, wb)


def test_plain_versions_are_the_cpu_path(system):
    """On the CPU the wrappers return their plain versions' result and
    count no launch."""
    b = torch.from_numpy(system["b"])
    _, tf = _factors(system)
    op = system["top"]
    before = {k: f.launches for k, f in P.SOLVER_KERNELS.items()}
    assert torch.equal(fused_cg(op, b, 7), fused_cg_plain(op, b, 7))
    assert torch.equal(P.fused_chebyshev(op, b, 0.1, 8.0, 7),
                       P.fused_chebyshev_plain(op, b, 0.1, 8.0, 7))
    assert torch.equal(P.fused_pcg_ic0(op, tf, b, 7),
                       P.fused_pcg_ic0_plain(op, tf, b, 7))
    assert before == {k: f.launches for k, f in P.SOLVER_KERNELS.items()}


def test_bf16_plain_versions_round_the_spmv_input(system):
    """In bfloat16 mode the plain SpMV on the state rounds its input, as
    the kernels do. Without that rounding three CG steps already move by
    more than the 1e-4 that the card check holds the kernels to after 3
    bfloat16 steps, so that check sees a kernel that skips the rounding."""
    from smvp_toolkit_tpu_torch.models.solvers import conjugate_gradient
    from smvp_toolkit_tpu_torch.ops.cg_fused import (
        pad_state,
        plain_spmv,
        state_tiles,
    )

    op = tsp.SellSpMV(system["top"].plan, value_dtype=torch.bfloat16,
                      device="cpu")
    b = torch.from_numpy(system["b"])
    v, planes = pad_state(b, state_tiles(op.plan)), op._planes()
    spmv = plain_spmv(op)
    assert torch.equal(spmv(planes, v),
                       spmv(planes, v.to(torch.bfloat16).float()))

    sweep = getattr(tsp, op.kernel.__name__ + "_plain")
    n_in = op.plan.n_coltiles * 128

    def unrounded(planes, v):
        y = sweep(*planes, v[:n_in], **op._kw())
        return torch.nn.functional.pad(y, (0, v.numel() - y.numel()))

    x, _ = conjugate_gradient(planes, v, num_iters=3, spmv=unrounded)
    assert _rel(fused_cg_plain(op, b, 3).numpy(),
                x[:b.numel()].numpy()) > TOL


def test_fused_cg_split_planes_matches_jax(monkeypatch):
    """K9 on split planes: the port's plan is widened past 511 tiles (the
    grid needs 513 column tiles for that: a window never exceeds CT)."""
    s = _system(_tridiag(513 * 128), seed=1)
    top = tsp.SellSpMV(rewindow_plan(s["top"].plan, 512), device="cpu")
    assert top.route == "split" and s["top"].route == "relsl"
    b = s["b"]
    x = fused_cg(top, torch.from_numpy(b), 30)
    monkeypatch.setenv("SMVP_SELL_RELSL", "0")
    xj = np.asarray(jfused_cg(s["jop"], jnp.asarray(b), 30))
    assert _rel(x.numpy(), xj) <= TOL
    assert _rel(x.numpy(), fused_cg(s["top"], torch.from_numpy(b),
                                    30).numpy()) <= TOL


def test_zero_iterations_return_zeros(system):
    b = torch.from_numpy(system["b"])
    _, tf = _factors(system)
    op = system["top"]
    for x in (fused_cg(op, b, 0), P.fused_chebyshev(op, b, 0.1, 8.0, 0),
              P.fused_pcg_ic0(op, tf, b, 0)):
        assert x.shape == b.shape and x.dtype == torch.float32
        assert not x.any()


def test_refusals():
    rng = np.random.RandomState(0)
    r, c = rng.randint(0, 64, 200), rng.randint(0, 32, 200)
    rect = tsp.SellSpMV.from_coo(coo_from_triplets(
        r, c, rng.randn(200), (64, 32), device="cpu"))
    ones = torch.ones(64)
    with pytest.raises(ValueError, match="square"):
        fused_cg(rect, ones, 5)
    with pytest.raises(ValueError, match="square"):
        P.fused_chebyshev(rect, ones, 0.1, 1.0, 3)

    streamed = tsp.SellSpMV(build_streamed_sell_plan(
        np.arange(6000), np.arange(6000), np.ones(6000), (6000, 6000),
        chunk=256, y_block_rows=2048), device="cpu")
    b6 = torch.ones(6000)
    for fn in (lambda: fused_cg(streamed, b6, 3),
               lambda: P.fused_chebyshev(streamed, b6, 0.5, 2.0, 3)):
        with pytest.raises(ValueError, match="resident-y"):
            fn()

    s = _system(_tridiag(513 * 128), seed=1)
    split = tsp.SellSpMV(rewindow_plan(s["top"].plan, 512), device="cpu")
    tf = ic0(s["tcsr"])
    b = torch.from_numpy(s["b"])
    with pytest.raises(ValueError, match="relsl"):
        P.fused_chebyshev(split, b, 2.0, 6.0, 3)
    with pytest.raises(ValueError, match="relsl"):
        P.fused_pcg_ic0(split, tf, b, 3)
    with pytest.raises(ValueError, match="sweeps"):
        P.fused_pcg_ic0(s["top"], tf, b, 3, sweeps=1)


def test_pcg_ic0_refuses_a_common_window_past_511_tiles():
    """A's plan fits the merged word (WT 416) but strict(L) has a third
    of A's sublanes per tile, so its chunk spans 608 tiles."""
    a = sp.coo_matrix(_tridiag(600 * 128))
    coo = coo_from_triplets(a.row, a.col, a.data, a.shape, device="cpu")
    op = tsp.SellSpMV.from_coo(coo)
    assert op.route == "relsl" and op.plan.window_tiles <= 511
    tf = ic0(csr_encode(coo.pad(128)))
    _, wt, _, _ = P.ic0_plans(op, tf)
    assert wt > 511
    with pytest.raises(ValueError, match="common window"):
        P.fused_pcg_ic0(op, tf, torch.ones(a.shape[0]), 3)


def test_launch_checks_the_state_before_any_pointer_is_passed(system):
    """The kernels index the planes and every state vector unchecked, so
    ``launch`` refuses a wrong length, dtype or device first."""
    from smvp_toolkit_tpu_torch.ops import cg_fused as C

    op = system["top"]
    n = C.state_tiles(op.plan) * 128
    good = dict(b=torch.zeros(n), x=torch.zeros(n), r=torch.zeros(n),
                p=torch.zeros(n), q=torch.zeros(n), xin=torch.zeros(n))
    for name, bad in (("b", torch.zeros(n - 128)),
                      ("q", torch.zeros(n, dtype=torch.float64)),
                      ("xin", torch.zeros(n, dtype=torch.bfloat16))):
        with pytest.raises(ValueError):
            C.launch("sell_cg_kernel", op, route=op.route,
                     planes=C._route_planes(op), iterations=3,
                     **dict(good, **{name: bad}))
    with pytest.raises(ValueError, match="relsl"):
        C.launch("sell_cg_kernel", op, route=op.route, iterations=3,
                 planes=dict(C._route_planes(op), relsl=None), **good)
