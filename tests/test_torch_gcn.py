"""The slice as a whole: GCN training on the port against the JAX GCN.

``gcn_norm`` must build the same CSR arrays bit for bit. The forward pass
and one training step (layer weights only, and layer plus edge weights)
run from the same weights (``interop.gcn_params_from_arrays``) and
features, through the port's default aggregator (the SELL operator's
``differentiable_mat`` / ``differentiable_edges_mat``: the kernels' plain
versions here) and through ``spmm_csr``, against the JAX GCN through its
Pallas seam (interpret mode) and its XLA ``spmm_csr``. Tolerance: rtol
1e-4 / atol 1e-5, the JAX package's own for these steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.models import graph as jg
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.ops import spmv_xla
from smvp_toolkit_tpu_torch.interop import (
    coo_from_triplets,
    gcn_params_from_arrays,
)
from smvp_toolkit_tpu_torch.models import graph as tg
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops import spmv_torch

RTOL, ATOL = 1e-4, 1e-5
N = 300


def _graph(seed=0):
    rng = np.random.RandomState(seed)
    r, c = rng.randint(0, N, 1800), rng.randint(0, N, 1800)
    v = rng.randn(1800)  # signed: gcn_norm rectifies
    j = JCOO.from_numpy(r.astype(np.int32), c.astype(np.int32), v,
                        shape=(N, N))
    t = coo_from_triplets(r, c, v, (N, N), device="cpu")
    return jg.gcn_norm(j), tg.gcn_norm(t)


@pytest.fixture(scope="module")
def case():
    js, ts = _graph()
    rng = np.random.default_rng(0)
    h = rng.standard_normal((N, 8)).astype(np.float32)
    labels = rng.integers(0, 4, N)
    mask = np.arange(N) < 200
    params = jg.gcn_init(jax.random.PRNGKey(0), [8, 16, 12, 4])
    arrays = [(np.asarray(w), np.asarray(b)) for w, b in params]
    return js, ts, h, labels, mask, arrays


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(
        a, torch.Tensor) else a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _jax_seams(js):
    f = jsp.sell_op_csr(js).differentiable_mat()
    fe = jsp.sell_op_csr(js).differentiable_edges_mat()
    return {"pallas": lambda m, X: f(X),
            "pallas-edges": lambda m, X: fe(m.vals[: m.nnz], X),
            "xla": spmv_xla.spmm_csr}


def _port_seams():
    return {"sell": None, "spmm_csr": spmv_torch.spmm_csr}


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gcn_norm_bit_equal(add_self_loops):
    rng = np.random.RandomState(1)
    r, c, v = rng.randint(0, 90, 500), rng.randint(0, 90, 500), rng.randn(500)
    j = jg.gcn_norm(JCOO.from_numpy(r.astype(np.int32), c.astype(np.int32),
                                    v, shape=(90, 90)),
                    add_self_loops=add_self_loops)
    t = tg.gcn_norm(coo_from_triplets(r, c, v, (90, 90), device="cpu"),
                    add_self_loops=add_self_loops)
    assert (t.shape, t.nnz) == (j.shape, j.nnz)
    for name in ("row_ptr", "col_ind", "vals", "row_ids"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    with pytest.raises(ValueError, match="square"):
        tg.gcn_norm(coo_from_triplets(r, c, v, (90, 91), device="cpu"))


@pytest.mark.parametrize("seam", ["sell", "spmm_csr"])
def test_gcn_forward_matches_jax(case, seam):
    js, ts, h, _, _, arrays = case
    model = gcn_params_from_arrays(arrays, device="cpu")
    out = tg.gcn_forward(ts, model, torch.from_numpy(h),
                         spmm=_port_seams()[seam])
    assert out.shape == (N, 4)
    params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in arrays]
    for jseam in ("pallas", "xla"):
        _close(out, jg.gcn_forward(js, params, jnp.asarray(h),
                                   spmm=_jax_seams(js)[jseam]))
    torch.testing.assert_close(model(ts, torch.from_numpy(h),
                                     spmm=_port_seams()[seam]), out)


@pytest.mark.parametrize("seam", ["sell", "spmm_csr"])
def test_gcn_train_step_matches_jax(case, seam):
    js, ts, h, labels, mask, arrays = case
    model = gcn_params_from_arrays(arrays, device="cpu")
    _, loss = tg.gcn_train_step(ts, model, torch.from_numpy(h),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask), lr=0.05,
                                spmm=_port_seams()[seam])
    params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in arrays]
    for jseam in ("pallas", "xla"):
        jp, jloss = jg.gcn_train_step(js, params, jnp.asarray(h),
                                      jnp.asarray(labels), jnp.asarray(mask),
                                      lr=0.05, spmm=_jax_seams(js)[jseam])
        _close(loss, jloss)
        for (w, b), (jw, jb) in zip(model.layers(), jp):
            _close(w, jw)
            _close(b, jb)
    assert not np.allclose(model.layers()[0][0].detach().numpy(),
                           arrays[0][0])  # the step moved the weights


@pytest.mark.parametrize("seam", ["sell", "spmm_csr"])
def test_gcn_train_step_edges_matches_jax(case, seam):
    js, ts, h, labels, mask, arrays = case
    launches = {n: f.launches for n, f in tsp.MAT_KERNELS.items()}
    model = gcn_params_from_arrays(arrays, device="cpu")
    _, ev, loss = tg.gcn_train_step_edges(
        ts, model, ts.vals, torch.from_numpy(h), torch.from_numpy(labels),
        torch.from_numpy(mask), lr=0.05, edge_lr=0.5,
        spmm=_port_seams()[seam])
    assert {n: f.launches for n, f in tsp.MAT_KERNELS.items()} == launches
    params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in arrays]
    for jseam in ("pallas-edges", "xla"):
        jp, jev, jloss = jg.gcn_train_step_edges(
            js, params, js.vals, jnp.asarray(h), jnp.asarray(labels),
            jnp.asarray(mask), lr=0.05, edge_lr=0.5,
            spmm=_jax_seams(js)[jseam])
        _close(loss, jloss)
        _close(ev, jev)
        for (w, b), (jw, jb) in zip(model.layers(), jp):
            _close(w, jw)
            _close(b, jb)
    assert ev.shape == ts.vals.shape
    assert torch.equal(ev[ts.nnz:], ts.vals[ts.nnz:])  # padding stays put
    assert not torch.equal(ev[: ts.nnz], ts.vals[: ts.nnz])


def test_gcn_init_and_module():
    a = tg.gcn_init(torch.Generator().manual_seed(3), [8, 16, 4],
                    device="cpu")
    b = tg.gcn_init(torch.Generator().manual_seed(3), [8, 16, 4],
                    device="cpu")
    assert [tuple(p.shape) for p in a.parameters()] == [(8, 16), (16, 4),
                                                        (16,), (4,)]
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert not a.biases[0].any()
    w = a.weights[0].detach()
    assert abs(float(w.std()) - (2.0 / 24) ** 0.5) < 0.1  # Glorot normal


def test_default_aggregator_runs_the_sell_operator(case, monkeypatch):
    _, ts, h, _, _, arrays = case
    name = tsp.sell_op_csr(ts).spmm_kernel.__name__ + "_plain"
    plain, calls = getattr(tsp, name), []
    monkeypatch.setattr(tsp, name,
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tg.gcn_forward(ts, gcn_params_from_arrays(arrays, device="cpu"),
                   torch.from_numpy(h))
    assert len(calls) == 3  # one SpMM per layer
