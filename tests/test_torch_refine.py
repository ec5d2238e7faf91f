"""Mixed-precision iterative refinement: the port's ``models.refine_solve``
against the JAX package's, on the cases of ``tests/test_refine.py``.

The inner solver is CG in float32 (the port's ``conjugate_gradient`` on
the SELL operator's plain version; the JAX CG beside it), the residual
the double-float CSR SpMV. Bounds as in the JAX suite: Poisson 24² to a
float64 relative residual below 1e-12, four orders below the float32
solve, each sweep contracting the residual by 1e-3; Poisson 12² below
1e-11; float64 operator values (``vals_lo``) below 1e-12 against the
true operator, while the float32-rounded operator floors above 1e-9. The
port's x agrees with the JAX x within 1e-10 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as j_csr_encode
from smvp_toolkit_tpu.models import conjugate_gradient as j_cg
from smvp_toolkit_tpu.models import refine_solve as j_refine
from smvp_toolkit_tpu.ops.precision import df_to_f64 as j_to_f64
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.models import conjugate_gradient, refine_solve
from smvp_toolkit_tpu_torch.ops.precision import df_split, df_to_f64

from conftest import poisson2d


def _csrs(a, vals=None, pad_to=128):
    """The JAX and port CSR of dense ``a`` (float32 values, or ``vals`` at
    its nonzeros)."""
    r, c = np.nonzero(a)
    v = (a[r, c] if vals is None else vals).astype(np.float32)
    j = j_csr_encode(JCOO.from_numpy(r.astype(np.int32), c.astype(np.int32),
                                     v, shape=a.shape, pad_to=pad_to))
    t = csr_encode(coo_from_triplets(r, c, v, a.shape, device="cpu").pad(
        pad_to))
    return j, t


def _inners(jcsr, tcsr):
    def t_inner(r):
        return conjugate_gradient(tcsr, r, num_iters=200, tol=1e-7)[0]

    def j_inner(r):
        return j_cg(jcsr, r, num_iters=200, tol=1e-7)[0]

    return t_inner, j_inner


def _rel(a, x, b):
    return np.linalg.norm(a @ x - b) / np.linalg.norm(b)


def _agree(xt, xj):
    return np.linalg.norm(xt - xj) / np.linalg.norm(xj)


def test_refine_reaches_f64_floor():
    a = poisson2d(24)
    jcsr, tcsr = _csrs(a)
    t_inner, j_inner = _inners(jcsr, tcsr)
    b = np.random.RandomState(0).randn(a.shape[0])

    xh, xl, norms = refine_solve(tcsr, b, inner=t_inner, num_refinements=3)
    assert xh.dtype == xl.dtype == torch.float32 and xh.device.type == "cpu"
    assert isinstance(norms, np.ndarray) and norms.shape == (3,)
    x64 = df_to_f64(xh, xl)
    rel = _rel(a, x64, b)
    assert rel < 1e-12
    x32 = t_inner(torch.from_numpy(b.astype(np.float32))).double().numpy()
    assert rel < 1e-4 * _rel(a, x32, b)  # orders below the f32 floor
    assert norms[1] < 1e-3 * norms[0]  # each sweep contracts hard

    jh, jl, jnorms = j_refine(jcsr, b, inner=j_inner, num_refinements=3)
    assert _agree(x64, j_to_f64(jh, jl)) <= 1e-10
    np.testing.assert_allclose(norms[0], jnorms[0], rtol=1e-12)


def test_refine_plain_cg_inner():
    a = poisson2d(12)
    jcsr, tcsr = _csrs(a, pad_to=64)
    t_inner, j_inner = _inners(jcsr, tcsr)
    b = np.random.RandomState(1).randn(a.shape[0])
    xh, xl, _ = refine_solve(tcsr, b, inner=t_inner, num_refinements=3)
    x64 = df_to_f64(xh, xl)
    assert _rel(a, x64, b) < 1e-11
    jh, jl, _ = j_refine(jcsr, b, inner=j_inner, num_refinements=3)
    assert _agree(x64, j_to_f64(jh, jl)) <= 1e-10


def test_refine_f64_operator_values():
    a64 = poisson2d(10) * (1.0 / 3.0)  # values not float32-representable
    n = a64.shape[0]
    r, c = np.nonzero(a64)
    v64 = a64[r, c]
    v_hi, v_lo = df_split(v64, device="cpu")
    jcsr, tcsr = _csrs(a64, vals=v_hi.numpy(), pad_to=64)
    # vals_lo must align with the encoded (sorted, padded) value plane
    _, tlo = _csrs(a64, vals=v_lo.numpy(), pad_to=64)
    jlo, _ = _csrs(a64, vals=v_lo.numpy(), pad_to=64)
    t_inner, j_inner = _inners(jcsr, tcsr)
    b = np.random.RandomState(3).randn(n)

    xh, xl, _ = refine_solve(tcsr, b, inner=t_inner, num_refinements=4,
                             vals_lo=tlo.vals)
    x64 = df_to_f64(xh, xl)
    assert _rel(a64, x64, b) < 1e-12
    jh, jl, _ = j_refine(jcsr, b, inner=j_inner, num_refinements=4,
                         vals_lo=jlo.vals)
    assert _agree(x64, j_to_f64(jh, jl)) <= 1e-10

    xh2, xl2, _ = refine_solve(tcsr, b, inner=t_inner, num_refinements=4)
    assert _rel(a64, df_to_f64(xh2, xl2), b) > 1e-9  # the f32 operator


@pytest.mark.parametrize("as_tensor", [False, True])
def test_refine_takes_float32_and_tensor_rhs(as_tensor):
    a = poisson2d(8)
    _, tcsr = _csrs(a, pad_to=64)
    b32 = np.random.RandomState(4).randn(a.shape[0]).astype(np.float32)
    b = torch.from_numpy(b32) if as_tensor else b32
    xh, xl, norms = refine_solve(
        tcsr, b, inner=lambda r: conjugate_gradient(tcsr, r, num_iters=100,
                                                    tol=1e-7)[0],
        num_refinements=3)
    assert np.isclose(norms[0], np.linalg.norm(b32.astype(np.float64)))
    assert _rel(a, df_to_f64(xh, xl), b32.astype(np.float64)) < 1e-11
