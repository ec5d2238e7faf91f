"""SELL SpMV: the port's operator against the JAX package's, plan by plan.

Both packages run *the same plan* (handed across with
``interop.plan_from_arrays``). On the CPU the port's wrappers run the
kernels' plain PyTorch versions; the JAX operator runs its Pallas kernels
in interpret mode, as the JAX package's own tests run them. Tolerance:
max |Δ| / max |y| <= 1e-6 in float32 and bfloat16 value modes (the
summation order differs; the gathers are exact in both).
"""

from __future__ import annotations

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as j_csr_encode
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.ops import spmv_xla
from smvp_toolkit_tpu.utils.synth import synth_banded
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import (
    coo_from_triplets,
    plan_fields,
    plan_from_arrays,
)
from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp
from smvp_toolkit_tpu_torch.ops import spmv_torch

from conftest import random_coo

TOL = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a - b).max())


def _triplets(name):
    if name == "synth":
        r, c, v = synth_banded(20000, nnz_per_row=5).to_numpy()
        return r, c, np.asarray(v, np.float64), (20000, 20000)
    rng = np.random.RandomState(11)
    r, c, v = random_coo(rng, 6000, 9000, 40000, allow_duplicates=True)
    r = np.where(r % 3 == 0, r + 1, r).clip(0, 5999)  # many empty rows
    return r, c, v, (6000, 9000)


# chunk 208: a multiple of 16 (the JAX bf16 tiling) but not of 32, so
# both packages store int32 lane indices.
PLANS = [("synth", 2048), ("random", 1024), ("random", 208)]
PLAN_IDS = [f"{n}-c{c}" for n, c in PLANS]


@pytest.fixture(scope="module", params=PLANS, ids=PLAN_IDS)
def case(request):
    name, chunk = request.param
    r, c, v, shape = _triplets(name)
    jp = jplan.build_sell_plan(r, c, v, shape, chunk=chunk,
                               allow_small_chunk=chunk == 2048)
    x = np.random.default_rng(5).standard_normal(shape[1]).astype(np.float32)
    return jp, plan_from_arrays(plan_fields(jp)), x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_call_matches_jax_operator(case, dtype):
    jp, tp, x = case
    tdt, jdt = DTYPES[dtype]
    launches = tsp.sell_spmv.launches
    y_t = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")(torch.from_numpy(x))
    y_j = jsp.SellSpMV(jp, value_dtype=jdt)(jnp.asarray(x))
    assert y_t.dtype == torch.float32 and y_t.shape == (tp.shape[0],)
    assert _rel(y_t.numpy(), y_j) <= TOL
    assert tsp.sell_spmv.launches == launches  # the CPU path launches nothing


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bench_loop_matches_call_and_jax(case, dtype):
    jp, tp, x = case
    tdt, jdt = DTYPES[dtype]
    op = tsp.SellSpMV(tp, value_dtype=tdt, device="cpu")
    xt = torch.from_numpy(x)
    y_loop = op.bench_loop(xt, 3)
    assert torch.equal(y_loop, op(xt))  # bit for bit on the CPU
    y_j = jsp.SellSpMV(jp, value_dtype=jdt).bench_loop(jnp.asarray(x), 3)
    assert _rel(y_loop.numpy(), y_j) <= TOL


def test_bf16_mode_rounds_x_and_vals(case):
    _, tp, x = case
    op = tsp.SellSpMV(tp, value_dtype=torch.bfloat16, device="cpu")
    assert op.vals.dtype == torch.bfloat16
    r = torch.from_numpy(x).to(torch.bfloat16).float()
    ref = tsp.SellSpMV(
        plan_from_arrays({**plan_fields(tp), "vals": op.vals.float().numpy()}),
        device="cpu")(r)
    assert torch.equal(op(torch.from_numpy(x)), ref)


def test_plain_matches_float64_oracle(case):
    import scipy.sparse as sp

    _, tp, x = case
    r, c, v, shape = _triplets("synth" if tp.shape[0] == 20000 else "random")
    a = sp.csr_matrix((np.asarray(v, np.float32).astype(np.float64), (r, c)),
                      shape=shape)
    y = tsp.SellSpMV(tp, device="cpu")(torch.from_numpy(x))
    assert _rel(y.numpy(), a @ x.astype(np.float64)) <= TOL


def _csr_pair(dtype="float32"):
    r, c, v = synth_banded(3000, nnz_per_row=8, seed=4).to_numpy()
    v = np.asarray(v, np.float64)
    j = j_csr_encode(JCOO.from_numpy(r, c, v, shape=(3000, 3000),
                                     dtype=getattr(jnp, dtype)).pad(128))
    t = csr_encode(coo_from_triplets(r, c, v, (3000, 3000),
                                     dtype=getattr(torch, dtype),
                                     device="cpu").pad(128))
    return j, t


def test_spmv_torch_matches_spmv_xla():
    j, t = _csr_pair()
    x = np.random.default_rng(2).standard_normal(3000).astype(np.float32)
    y_t = spmv_torch.spmv_csr(t, torch.from_numpy(x))
    y_j = spmv_xla.spmv_csr(j, jnp.asarray(x))
    assert y_t.dtype == torch.float32
    assert _rel(y_t.numpy(), y_j) <= TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_spmv_csr_sell_matches_spmv_csr_pallas(monkeypatch, dtype):
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")  # both plan at chunk 2048
    j, t = _csr_pair(dtype)
    x = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    y_t = tsp.spmv_csr_sell(t, torch.from_numpy(x).to(tdt))
    y_j = jsp.spmv_csr_pallas(j, jnp.asarray(x, jdt))
    assert _rel(y_t.numpy(), y_j) <= TOL
    assert tsp.sell_op_csr(t).value_dtype == tdt


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_spmv_coo_sell_matches_spmv_coo_pallas(monkeypatch, dtype):
    """The COO operator against the JAX ``spmv_coo_pallas``, duplicates and
    empty rows included; in CSR order it plans CSR's plan."""
    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")  # both plan at chunk 2048
    r, c, v, shape = _triplets("random")
    tdt, jdt = DTYPES[dtype]
    j = JCOO.from_numpy(r, c, v, shape=shape, dtype=jdt).pad(128)
    t = coo_from_triplets(r, c, v, shape, dtype=tdt, device="cpu").pad(128)
    x = np.random.default_rng(4).standard_normal(shape[1]).astype(
        np.float32)
    y_t = tsp.spmv_coo_sell(t, torch.from_numpy(x).to(tdt))
    y_j = jsp.spmv_coo_pallas(j, jnp.asarray(x, jdt))
    assert _rel(y_t.numpy(), y_j) <= TOL
    op = tsp.sell_op_coo(t)
    assert op is tsp.sell_op_coo(t) and op.value_dtype == tdt
    for f, w in plan_fields(jsp.sell_op_coo(j).plan).items():
        got = getattr(op.plan, f)
        assert (np.array_equal(got, w) if isinstance(w, np.ndarray)
                else got == w), f
    ordered = t.canonical_order()
    csr_plan = tsp.sell_op_csr(csr_encode(ordered)).plan
    for f, w in plan_fields(csr_plan).items():
        got = getattr(tsp.sell_op_coo(ordered).plan, f)
        assert (np.array_equal(got, w) if isinstance(w, np.ndarray)
                else got == w), f


def test_operator_cache_is_weak():
    _, t = _csr_pair()
    op = tsp.sell_op_csr(t)
    assert tsp.sell_op_csr(t) is op
    n = len(tsp._CACHE)
    del t, op
    gc.collect()
    assert len(tsp._CACHE) == n - 1


def test_from_coo_and_x_checks():
    r, c, v, shape = _triplets("random")
    coo = coo_from_triplets(r, c, v, shape, device="cpu")
    op = tsp.SellSpMV.from_coo(coo)
    assert op.device.type == "cpu" and op.value_dtype == torch.float32
    x = torch.ones(shape[1])
    assert op(x).shape == (shape[0],)
    with pytest.raises(ValueError, match="entries"):
        op(torch.ones(op.plan.n_coltiles * 128 + 1))
    with pytest.raises(ValueError, match="operator"):
        op(x.to("meta"))


def test_wrappers_never_fall_back_off_cpu():
    r, c, v, shape = _triplets("random")
    op = tsp.SellSpMV.from_coo(coo_from_triplets(r, c, v, shape,
                                                 device="cpu"))
    planes = [t.to("meta") for t in (op.vals, op.lidx, op.relsl,
                                     op.tile_base)]
    x = torch.zeros(op.plan.n_coltiles * 128, device="meta")
    kw = dict(n_slices=op.plan.n_slices, chunk=op.plan.chunk)
    with pytest.raises(ValueError, match="cuda"):
        tsp.sell_spmv(*planes, x, **kw)
    with pytest.raises(ValueError, match="cuda"):
        tsp.sell_bench_loop(*planes, x, iterations=2, **kw)


def test_wrapper_plane_checks():
    r, c, v, shape = _triplets("random")
    op = tsp.SellSpMV.from_coo(coo_from_triplets(r, c, v, shape,
                                                 device="cpu"))
    xt = op._x_tiles(torch.ones(shape[1]))
    kw = dict(n_slices=op.plan.n_slices, chunk=op.plan.chunk)
    good = dict(vals=op.vals, lidx=op.lidx, relsl=op.relsl,
                tile_base=op.tile_base)
    bad = [
        ({"vals": op.vals.double()}, TypeError),
        ({"lidx": op.lidx.long()}, TypeError),
        ({"relsl": op.relsl.long()}, TypeError),
        ({"vals": op.vals.t().contiguous().t()}, ValueError),
        ({"relsl": op.relsl[:-1]}, ValueError),
    ]
    for change, err in bad:
        args = {**good, **change}
        with pytest.raises(err):
            tsp.sell_spmv(args["vals"], args["lidx"], args["relsl"],
                          args["tile_base"], xt, **kw)
    with pytest.raises(TypeError):
        tsp.sell_spmv(*good.values(), xt.to(torch.bfloat16), **kw)
    with pytest.raises(ValueError, match="iterations"):
        tsp.sell_bench_loop(*good.values(), xt, iterations=0, **kw)
