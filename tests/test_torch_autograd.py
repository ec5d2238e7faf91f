"""Training hooks: K7's values-gradient plane, ``slot_map``, ``transpose``
and the four ``differentiable*`` callables against the JAX operator's.

The JAX operator runs its Pallas kernels in interpret mode, the port its
kernels' plain versions (CPU tensors). Tolerances: the K7 plane within
1e-6 of max |plane| (both compute each slot's products exactly and differ
in summation order only); ``slot_map`` and the transpose plan exactly;
gradients rtol 1e-4 / atol 1e-5 against ``jax.grad`` and a float64 dense
oracle, the JAX package's own tolerance for these gradients.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch.interop import (
    coo_from_triplets,
    plan_fields,
    plan_from_arrays,
)
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

TOL_PLANE = 1e-6
RTOL, ATOL = 1e-4, 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _plan_pair(route):
    """A relsl plan (400 x 330) or a split one (WT > 511), both with dead
    padding sublanes (live rel, dead slice)."""
    rng = np.random.RandomState(3 if route == "relsl" else 4)
    n, m, nnz = (400, 330, 2000) if route == "relsl" else (300, 70000, 600)
    r, c = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    jp = jplan.build_sell_plan(r, c, rng.randn(nnz), (n, m), chunk=1024)
    return jp, plan_from_arrays(plan_fields(jp))


def _mat(rows, k, seed):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(
        np.float32)


@pytest.mark.parametrize("k", [1, 2, 8, 17])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", ["relsl", "split"])
def test_vals_grad_plane_matches_jax(route, dtype, k):
    jp, tp = _plan_pair(route)
    tdt, jdt = DTYPES[dtype]
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    jop = jsp.SellSpMV(jp, value_dtype=jdt)
    assert op.route == route
    X, G = _mat(tp.shape[1], k, 1), _mat(tp.shape[0], k, 2)
    if k == 1:
        got = op.vjp_vals(torch.from_numpy(X[:, 0]), torch.from_numpy(G[:, 0]))
        want = jop.vjp_vals(jnp.asarray(X[:, 0]), jnp.asarray(G[:, 0]))
    else:
        got = op.vjp_vals_mat(torch.from_numpy(X), torch.from_numpy(G))
        want = jop.vjp_vals_mat(jnp.asarray(X), jnp.asarray(G))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL_PLANE
    dead = (tp.rel_tile.reshape(-1) < 0) | (tp.slice_of.reshape(-1) < 0)
    assert dead.any()  # padding sublanes: live rel, dead slice
    assert not got.numpy()[dead].any() and not want[dead].any()
    live = ~dead
    assert np.count_nonzero(got.numpy()[live]) > np.count_nonzero(
        tp.vals[live])  # padding lanes of live sublanes carry partials


def test_vals_grad_expanded_cotangent():
    _, tp = _plan_pair("relsl")
    op = tsp.SellSpMV(tp, device="cpu")
    X = torch.from_numpy(_mat(tp.shape[1], 3, 1))
    G = torch.ones(1, 1).expand(tp.shape[0], 3)  # stride 0, not contiguous
    assert not G.is_contiguous()
    assert torch.equal(op.vjp_vals_mat(X, G),
                       op.vjp_vals_mat(X, G.contiguous()))


def test_vals_grad_wrapper_checks():
    _, tp = _plan_pair("split")
    op = tsp.SellSpMV(tp, device="cpu")
    kw = op._mat_kw()
    meta = dict(rel=op.rel, slice_of=op.slice_of)
    xr, gr = tp.n_coltiles * 128, tp.n_slices * 128
    X, G = torch.zeros(xr, 2), torch.zeros(gr, 2)
    bad = [
        (torch.zeros(xr - 128, 2), G, ValueError, "rows"),
        (X, torch.zeros(gr - 1, 2), ValueError, "rows"),
        (X, torch.zeros(gr, 3), ValueError, "columns"),
        (X, G.to(torch.bfloat16), TypeError, "float32"),
        (X.to(torch.float64), G, TypeError, "X"),
        (X, torch.zeros(2, gr).t(), ValueError, "contiguous"),
        (X, torch.zeros(gr, 0), ValueError, "k >= 1"),
    ]
    for x, g, err, match in bad:
        with pytest.raises(err, match=match):
            tsp.sell_vals_grad(op.lidx, op.tile_base, x, g, **meta, **kw)
    with pytest.raises(ValueError, match="relsl"):
        tsp.sell_vals_grad(op.lidx, op.tile_base, X, G, rel=op.rel, **kw)
    assert tsp.sell_vals_grad(op.lidx, op.tile_base, X, G, **meta,
                              **kw).shape == op.vals.shape


def test_off_cpu_tensors_never_take_the_plain_version(monkeypatch):
    """The wrappers pick the plain version only for a tensor on the CPU;
    any other tensor launches the kernel or raises."""
    _, tp = _plan_pair("relsl")
    op = tsp.SellSpMV(tp, device="cpu")

    def refuse(*args, **kw):
        raise AssertionError("plain version called off the CPU")

    for name in ("sell_spmm_plain", "sell_split_spmm_plain",
                 "sell_bench_spmm_plain", "sell_vals_grad_plain"):
        monkeypatch.setattr(tsp, name, refuse)
    meta = [t.to("meta") for t in op._planes()]
    kw = op._mat_kw()
    X = torch.zeros(tp.n_coltiles * 128, 2, device="meta")
    G = torch.zeros(tp.n_slices * 128, 2, device="meta")
    calls = [
        lambda: tsp.sell_spmm(*meta, X, **kw),
        lambda: tsp.sell_bench_spmm(*meta, X, iterations=2, **kw),
        lambda: tsp.sell_vals_grad(meta[1], meta[3], X, G, relsl=meta[2],
                                   **kw),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="cuda"):
            call()
    sp = _plan_pair("split")[1]
    sop = tsp.SellSpMV(sp, device="cpu")
    smeta = [t.to("meta") for t in sop._planes()]
    with pytest.raises(ValueError, match="cuda"):
        tsp.sell_split_spmm(*smeta, torch.zeros(
            sp.n_coltiles * 128, 2, device="meta"), **sop._mat_kw())


def _coo_pair(n=220, m=180, nnz=1400, seed=11, dedupe=True, dtype="float32"):
    rng = np.random.RandomState(seed)
    r, c = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    v = rng.randn(nnz).astype(np.float32)
    if dedupe:  # one parameter per edge
        _, keep = np.unique(np.stack([r, c]), axis=1, return_index=True)
        r, c, v = r[keep], c[keep], v[keep]
    tdt, jdt = DTYPES[dtype]
    j = JCOO.from_numpy(r.astype(np.int32), c.astype(np.int32), v,
                        shape=(n, m), dtype=jdt)
    t = coo_from_triplets(r, c, v, (n, m), dtype=tdt, device="cpu")
    return (r, c, v, (n, m)), jsp.SellSpMV.from_coo(j, value_dtype=jdt), (
        tsp.SellSpMV.from_coo(t, value_dtype=tdt))


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")  # both plan at chunk 2048


@pytest.mark.parametrize("dedupe", [True, False])
def test_slot_map_and_transpose_plan_equal_jax(pinned, dedupe):
    _, jop, op = _coo_pair(dedupe=dedupe)
    assert np.array_equal(op.slot_map(), jop.slot_map())
    jt, tt = plan_fields(jop.transpose().plan), plan_fields(
        op.transpose().plan)
    assert jt.keys() == tt.keys()
    for name, want in jt.items():
        got = tt[name]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        else:
            assert got == want, name
    assert np.array_equal(op.transpose().slot_map(),
                          jop.transpose().slot_map())
    assert torch.equal(op.slot_index(), torch.from_numpy(op.slot_map()))


def test_slot_map_scatter_rebuilds_the_values_plane(pinned):
    (r, c, v, _), _, op = _coo_pair(dedupe=False)
    assert torch.equal(op.scatter_values(torch.from_numpy(v)),
                       op.vals)
    with pytest.raises(ValueError, match="triplet"):
        op.scatter_values(torch.from_numpy(v[:-1]))


def test_training_hook_refusals():
    rng = np.random.RandomState(2)
    r, c = rng.randint(0, 3000, 500), rng.randint(0, 3000, 500)
    streamed = jplan.build_streamed_sell_plan(r, c, rng.randn(500),
                                              (3000, 3000), chunk=64,
                                              y_block_rows=2048)
    op = tsp.SellSpMV(plan_from_arrays(plan_fields(streamed)), device="cpu",
                      triplets=(r, c, rng.randn(500)))
    x = torch.ones(3000)
    with pytest.raises(ValueError, match="resident-y plan"):
        op.slot_map()
    with pytest.raises(ValueError, match="resident-y plan"):
        op.vjp_vals(x, x)
    with pytest.raises(ValueError, match="resident-y plan"):
        op.vjp_vals_mat(x[:, None], x[:, None])
    bare = tsp.SellSpMV(_plan_pair("relsl")[1], device="cpu")
    with pytest.raises(ValueError, match="from_coo"):
        bare.transpose()
    with pytest.raises(ValueError, match="from_coo"):
        bare.slot_map()
    (_, _, v, _), _, big = _coo_pair()
    huge = np.broadcast_to(np.int64(0), (1 << 24,))
    big._triplets = (huge, huge, huge)
    with pytest.raises(ValueError, match="2\\^24"):
        big.slot_map()


def _dense(r, c, v, shape):
    a = np.zeros(shape)
    np.add.at(a, (r, c), v.astype(np.float64))
    return a


def _check(got, want_jax, want_dense):
    got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want_jax), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, want_dense, rtol=RTOL, atol=ATOL)


def test_differentiable_grads_match_jax_and_dense(pinned):
    (r, c, v, shape), jop, op = _coo_pair()
    a = _dense(r, c, v, shape)
    x, w = _mat(shape[1], 1, 3)[:, 0], _mat(shape[0], 1, 4)[:, 0]
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(w) * op.differentiable()(xt)).sum().backward()
    fj = jop.differentiable()
    gj = jax.grad(lambda xx: jnp.sum(jnp.asarray(w) * fj(xx)))(jnp.asarray(x))
    _check(xt.grad, gj, a.T @ w.astype(np.float64))


@pytest.mark.parametrize("k", [2, 8, 17])
def test_differentiable_mat_grads_match_jax_and_dense(pinned, k):
    (r, c, v, shape), jop, op = _coo_pair()
    a = _dense(r, c, v, shape)
    X, W = _mat(shape[1], k, 5), _mat(shape[0], k, 6)
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = op.differentiable_mat()(Xt)
    (torch.from_numpy(W) * out).sum().backward()
    fj = jop.differentiable_mat()
    gj = jax.grad(lambda XX: jnp.sum(jnp.asarray(W) * fj(XX)))(jnp.asarray(X))
    _check(Xt.grad, gj, a.T @ W.astype(np.float64))
    _check(out, fj(jnp.asarray(X)), a @ X.astype(np.float64))


def test_differentiable_edges_grads_match_jax_and_dense(pinned):
    (r, c, v, shape), jop, op = _coo_pair()
    a = _dense(r, c, v, shape)
    x, w = _mat(shape[1], 1, 7)[:, 0], _mat(shape[0], 1, 8)[:, 0]
    vt = torch.from_numpy(v).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(w) * op.differentiable_edges()(vt, xt)).sum().backward()
    fj = jop.differentiable_edges()
    gvj, gxj = jax.grad(lambda vv, xx: jnp.sum(jnp.asarray(w) * fj(vv, xx)),
                        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(x))
    wd, xd = w.astype(np.float64), x.astype(np.float64)
    _check(vt.grad, gvj, wd[r] * xd[c])
    _check(xt.grad, gxj, a.T @ wd)


@pytest.mark.parametrize("dtype,k", [("float32", 6), ("float32", 17),
                                     ("bfloat16", 6)])
def test_differentiable_edges_mat_grads_match_jax_and_dense(pinned, dtype, k):
    (r, c, v, shape), jop, op = _coo_pair(dtype=dtype)
    X, W = _mat(shape[1], k, 9), _mat(shape[0], k, 10)
    vt = torch.from_numpy(v).requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    launches = {n: f.launches for n, f in tsp.MAT_KERNELS.items()}
    out = op.differentiable_edges_mat()(vt, Xt)
    out.sum().backward()  # an expanded (stride-0) cotangent
    (torch.from_numpy(W) * op.differentiable_edges_mat()(vt, Xt)).sum(
    ).backward()
    assert {n: f.launches for n, f in tsp.MAT_KERNELS.items()} == launches
    fj = jop.differentiable_edges_mat()
    loss = lambda vv, XX: jnp.sum(fj(vv, XX)) + jnp.sum(  # noqa: E731
        jnp.asarray(W) * fj(vv, XX))
    gvj, gXj = jax.grad(loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(X))
    Wd = W.astype(np.float64) + 1.0

    def rounded(a):  # bf16 mode rounds v, X and (in Aᵀ·G) G before use
        if dtype == "float32":
            return np.asarray(a, np.float64)
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).double().numpy()

    _check(vt.grad, gvj, (Wd[r] * rounded(X)[c]).sum(axis=1))
    # two backward passes, cotangents 1 and W, each rounded on its own
    _check(Xt.grad, gXj, _dense(r, c, rounded(v), shape).T @ (
        1.0 + rounded(W)))


def test_differentiable_mat_on_a_streamed_plan():
    """Streamed-y plans train through matmat's per-column fallback."""
    rng = np.random.RandomState(6)
    n, m = 3000, 400
    r, c, v = rng.randint(0, n, 900), rng.randint(0, m, 900), rng.randn(900)
    plan = jplan.build_streamed_sell_plan(r, c, v, (n, m), chunk=64,
                                          y_block_rows=2048)
    op = tsp.SellSpMV(plan_from_arrays(plan_fields(plan)), device="cpu",
                      triplets=(r, c, v))
    assert op.route == "streamy_relsl"
    X = torch.from_numpy(_mat(m, 3, 1)).requires_grad_(True)
    op.differentiable_mat()(X).sum().backward()
    a = _dense(r, c, v.astype(np.float32), (n, m))
    np.testing.assert_allclose(X.grad.numpy(), a.T @ np.ones((n, 3)),
                               rtol=RTOL, atol=ATOL)
