"""The fuzz sweep of the SELL operator on the CPU: the port's plain versions
against the float64 oracle and against the JAX operator.

``smvp_toolkit_tpu_torch.utils.fuzz.CASES``: the JAX suite's ten cases
(``tests/test_fuzz_sell.py``, verbatim) and the route cases. Every rung
(``__call__``, ``matmat`` at each width, ``bench_loop(x, 3)``,
``bench_loop_mat(X, 3)``, ``vjp_vals_mat``, the double-float operator) is
held to the oracle at the JAX suite's tolerances (2e-5 of max |y| in float32, 3e-2 in bfloat16 with
the oracle's values and x rounded to bfloat16; the double-float pair
5e-14), and to the JAX ``SellSpMV.from_coo`` in interpret mode on the same
plan under ``SMVP_SELL_AUTOTUNE=0``: 1e-6 of max |y|, the SpMM tolerance
of ``bench_variants.spmm_tolerance`` for k columns, 1e-6 for the values
cotangent, 1e-13 for the double-float pair (both within 5e-14 of the
oracle). Under ``SMVP_SELL_REDUCE2`` (case5) the JAX operator runs a lossy
bf16 reduction the port does not follow, so the port is held to the oracle
only; under ``SMVP_SELL_NOWINDOW`` (case6), which shapes TPU VMEM only, it
is held to the JAX result as in every other case.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu.ops.precision import df_split as j_split
from smvp_toolkit_tpu.ops.precision import df_to_f64 as j_to_f64
from smvp_toolkit_tpu.ops.spmv_df64 import SellDf64SpMV as JDf64
from smvp_toolkit_tpu_torch.bench.bench_variants import spmm_tolerance
from smvp_toolkit_tpu_torch.interop import plan_fields
from smvp_toolkit_tpu_torch.utils import fuzz as F

IDS = [case.name for case in F.CASES]


def _jax_rungs(case, data, jop, port_labels):
    """The JAX operator's result per rung label of the port's run."""
    x = jnp.asarray(data["x"])
    out = {"spmv": jop(x)}
    for k in case.widths:
        out[f"matmat k={k}"] = jop.matmat(jnp.asarray(data["X"][k]))
    if "bench_loop(3)" in port_labels:
        out["bench_loop(3)"] = jop.bench_loop(x, 3)
    for label in port_labels:
        if label.startswith("bench_loop_mat"):
            k = int(label.rsplit("=", 1)[1])
            out[label] = jop.bench_loop_mat(jnp.asarray(data["X"][k]), 3)
    if "vjp_vals_mat" in port_labels:
        out["vjp_vals_mat"] = jop.vjp_vals_mat(jnp.asarray(data["Xg"]),
                                               jnp.asarray(data["G"]))
    if "df64" in port_labels:
        jdf = JDf64.from_coo_f64(data["r"], data["c"], data["v64"],
                                 (case.n, case.m))
        pair = j_split(data["x64"])
        out["df64"] = j_to_f64(*jdf(*pair))
        out["df64 bench_loop(3)"] = j_to_f64(*jdf.bench_loop(*pair, 3))
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def _jax_operator(case, data):
    jdt = jnp.bfloat16 if case.dtype == "bf16" else jnp.float32
    r, c, v = data["r"], data["c"], data["v"]
    if case.y_block_rows:
        plan = jplan.build_streamed_sell_plan(
            r, c, v, (case.n, case.m), chunk=case.chunk,
            y_block_rows=case.y_block_rows)
        return jsp.SellSpMV(plan, value_dtype=jdt)
    coo = JCOO.from_numpy(r, c, v, shape=(case.n, case.m), pad_to=64)
    return jsp.SellSpMV.from_coo(coo, value_dtype=jdt)


@pytest.fixture(scope="module", params=F.CASES, ids=IDS)
def run(request):
    """The case through the port on the CPU and through the JAX operator
    on the same plan."""
    case = request.param
    data = F.case_data(case)
    with F.case_env(case, SMVP_SELL_AUTOTUNE="0"):
        op = F.build_operator(case, data, "cpu")
        df = F.build_df64(case, data, "cpu")
        mismatch = F.route_mismatch(case, op)
        port = {label: fn(df if label.startswith("df64") else op)
                for label, fn in F.rungs(case, data, op, df)}
        jop = _jax_operator(case, data)
        jax = _jax_rungs(case, data, jop, port)
    slot = None if op.plan.y_block_slices else op.slot_map()
    return case, data, op, slot, mismatch, port, jop, jax


def test_route(run):
    case, _, op, _, mismatch, port, _, _ = run
    assert mismatch is None
    assert op.device.type == "cpu"
    assert ("bench_loop(3)" in port) == (case.bench_route is not None)
    assert ("vjp_vals_mat" in port) == (not case.y_block_rows)


def test_plain_matches_oracle(run):
    case, data, _, slot, _, port, _, _ = run
    for label, got in port.items():
        at = slot if label == "vjp_vals_mat" else None
        want, tol = F.oracle(case, data, label)
        y = F.as_f64(got, at)
        assert np.isfinite(y).all(), label
        assert F.rel_err(y, want) < tol, label


def test_plain_matches_jax_operator(run):
    case, data, op, _, _, port, jop, jax = run
    if case.lossy_jax:
        # case5: the JAX y is off the exact sums by its lossy reduction
        # (within the oracle's tolerance), so the port, exact, is held to
        # the oracle only.
        want, tol = F.oracle(case, data, "spmv")
        assert F.rel_err(jax["spmv"], want) < tol
        assert F.rel_err(F.as_f64(port["spmv"]), jax["spmv"]) > 1e-6
        return
    for f, v in plan_fields(jop.plan).items():
        w = getattr(op.plan, f)
        assert (np.array_equal(v, w) if isinstance(v, np.ndarray)
                else v == w), f
    assert set(jax) == set(port)
    spmm_tol = spmm_tolerance(op.plan)[0]
    for label, got in port.items():
        tol = (spmm_tol if "k=" in label else
               1e-13 if label.startswith("df64") else 1e-6)
        assert F.rel_err(F.as_f64(got), jax[label]) <= tol, label


def test_jax_cases_are_the_jax_suite():
    """The sweep's first ten cases are the JAX suite's ``_CASES``."""
    import test_fuzz_sell

    assert F.JAX_CASES == test_fuzz_sell._CASES
    assert [c.name for c in F.CASES[:10]] == [f"case{i}" for i in range(10)]
