"""Double-float arithmetic: the port's ``ops/precision.py`` against the JAX
package's.

The error-free transformations (``two_sum``, ``two_prod``, ``_df_add``)
and ``df_split`` give the JAX functions' bits on float32 inputs, ±0 and
2^±100 among them. Subnormal inputs and results: XLA's CPU backend
flushes them to zero, torch keeps them; under ``torch.set_flush_denormal``
(the same flush) the port gives XLA's bits, and without it its results
stay error-free with gradual underflow. ``spmv_csr_df64`` (float64
products and row sums) against the JAX compensated scan and the float64
oracle, with and without the values' low words, on a banded synthetic
matrix and on rows whose sums cancel: <= 1e-12 of max |y|, the bound of
``tests/test_precision.py``. The oracle takes the values the pair holds
(hi + lo, 48 bits of each float64 value). On the cancelling rows the JAX
scan is held to its own design bound instead, 2^-46 of the prefix
magnitude (about 1e-7 of these rows' sums), which the port's float64 row
sums beat.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as j_csr_encode
from smvp_toolkit_tpu.ops import precision as J
from smvp_toolkit_tpu.utils.synth import synth_banded
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.ops import precision as T

NORMAL = np.array([0.0, -0.0, 2.0 ** 100, -2.0 ** 100, 2.0 ** -100,
                   -2.0 ** -100, 1.0, -1.5, 3.0e30, 1.0e-30], np.float32)
SUBNORMAL = np.array([1e-40, -3e-42, 1.4e-45, 1e-39], np.float32)


def _inputs(special, seed):
    rng = np.random.default_rng(seed)
    scale = np.exp2(rng.integers(-60, 60, 300)).astype(np.float32)
    a = np.concatenate([special, special[::-1],
                        rng.standard_normal(300).astype(np.float32) * scale])
    b = np.concatenate([special[::-1], np.ones_like(special),
                        rng.standard_normal(300).astype(np.float32)])
    return a, b


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _same(jax_out, torch_out):
    for u, v in zip(jax_out, torch_out):
        u, v = np.asarray(u), v.numpy()
        assert np.array_equal(_bits(u), _bits(v))


@pytest.mark.parametrize("name", ["two_sum", "two_prod"])
def test_error_free_transforms_bit_equal(name):
    a, b = _inputs(NORMAL, 0)
    _same(getattr(J, name)(jnp.asarray(a), jnp.asarray(b)),
          getattr(T, name)(torch.from_numpy(a), torch.from_numpy(b)))


def test_df_add_bit_equal():
    a, b = _inputs(NORMAL, 1)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same(J._df_add((ja, jb), (jb, ja)), T._df_add((ta, tb), (tb, ta)))


@pytest.mark.parametrize("name", ["two_sum", "two_prod"])
def test_subnormals_bit_equal_under_the_same_flush(name):
    a, b = _inputs(SUBNORMAL, 2)
    was = torch.set_flush_denormal(True)
    assert was  # x86: the flush is available
    try:
        out = getattr(T, name)(torch.from_numpy(a), torch.from_numpy(b))
    finally:
        torch.set_flush_denormal(False)
    _same(getattr(J, name)(jnp.asarray(a), jnp.asarray(b)), out)


def test_subnormals_error_free_with_gradual_underflow():
    a, b = _inputs(SUBNORMAL, 3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    s, e = T.two_sum(ta, tb)
    exact = a.astype(np.float64) + b.astype(np.float64)
    assert np.array_equal(s.double().numpy() + e.double().numpy(), exact)
    p, e = T.two_prod(ta[:4], torch.full((4,), 3.0))  # products stay exact
    assert np.array_equal(p.double().numpy() + e.double().numpy(),
                          a[:4].astype(np.float64) * 3.0)


def test_df_split_and_to_f64_bit_equal():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(200) * np.exp(rng.standard_normal(200) * 5)
    x = np.concatenate([x, [0.0, -0.0, 2.0 ** 100 + 2.0 ** 60,
                            2.0 ** -100 * (1 + 2.0 ** -40)]])
    jh, jl = J.df_split(x)
    th, tl = T.df_split(x, device="cpu")
    assert th.dtype == tl.dtype == torch.float32
    _same((jh, jl), (th, tl))
    assert np.array_equal(J.df_to_f64(jh, jl), T.df_to_f64(th, tl))
    assert np.abs(T.df_to_f64(th, tl) - x).max() <= 1e-14 * np.abs(x).max()
    # a tensor is split on its own device
    h2, l2 = T.df_split(torch.from_numpy(x))
    assert torch.equal(h2, th) and torch.equal(l2, tl)


def _oracle(r, c, v64, x64, n):
    y = np.zeros(n)
    np.add.at(y, r, v64 * x64[c])
    return y


def _matrix(name):
    """(rows, cols, float64 values, shape)."""
    if name == "synth":
        r, c, v = synth_banded(3000, nnz_per_row=7).to_numpy()
        rng = np.random.default_rng(5)
        v64 = np.asarray(v, np.float64) * (1.0 + rng.standard_normal(
            len(v)) * 1e-3)  # not float32-representable
        return r, c, v64, (3000, 3000)
    # cancelling rows: pairs (b, -b + 1e-4·noise), b ~ 1e4
    rng = np.random.RandomState(3)
    n = 512
    base = rng.randn(n // 2) * 1e4
    r = np.repeat(np.arange(n // 2), 2)
    c = np.arange(n)
    v64 = np.empty(n)
    v64[0::2] = base
    v64[1::2] = -base + 1e-4 * rng.randn(n // 2)
    return r, c, v64, (n // 2, n)


def _both_csr(r, c, v64, shape):
    """The JAX and port CSR of the float32 values, and the low words of
    the float64 values in the port's CSR order."""
    hi = v64.astype(np.float32)
    lo = (v64 - hi.astype(np.float64)).astype(np.float32)
    jcsr = j_csr_encode(JCOO.from_numpy(r.astype(np.int32),
                                        c.astype(np.int32), hi, shape=shape,
                                        pad_to=128))
    tcsr = csr_encode(coo_from_triplets(r, c, hi, shape, device="cpu").pad(
        128))
    tlo = csr_encode(coo_from_triplets(r, c, lo, shape, device="cpu").pad(
        128)).vals
    jlo = j_csr_encode(JCOO.from_numpy(r.astype(np.int32),
                                       c.astype(np.int32), lo, shape=shape,
                                       pad_to=128)).vals
    return jcsr, tcsr, jlo, tlo, hi


@pytest.mark.parametrize("with_lo", [False, True])
@pytest.mark.parametrize("name", ["synth", "cancel"])
def test_spmv_csr_df64_matches_jax_and_oracle(name, with_lo):
    r, c, v64, shape = _matrix(name)
    jcsr, tcsr, jlo, tlo, hi = _both_csr(r, c, v64, shape)
    x64 = np.random.default_rng(6).standard_normal(shape[1])
    if name == "cancel":
        x64 = np.ones(shape[1])
    jx = J.df_split(x64)
    tx = T.df_split(x64, device="cpu")
    yj = J.df_to_f64(*J.spmv_csr_df64(jcsr, *jx, jlo if with_lo else None))
    yt_pair = T.spmv_csr_df64(tcsr, *tx, tlo if with_lo else None)
    assert all(t.dtype == torch.float32 and t.shape == (shape[0],)
               for t in yt_pair)
    yt = T.df_to_f64(*yt_pair)
    held = hi.astype(np.float64)
    if with_lo:
        held = held + (v64 - held).astype(np.float32)
    oracle = _oracle(r, c, held, x64, shape[0])
    scale = np.abs(oracle).max()
    assert np.abs(yt - oracle).max() <= 1e-12 * scale
    if name == "cancel":  # the scan's error follows the prefix, not the row
        assert np.abs(yj - oracle).max() <= 2.0 ** -46 * np.abs(v64).max()
    else:
        assert np.abs(yj - oracle).max() <= 1e-12 * scale


def test_spmv_csr_df64_beats_float32_on_cancelling_rows():
    r, c, v64, shape = _matrix("cancel")
    _, tcsr, _, tlo, hi = _both_csr(r, c, v64, shape)
    x = torch.ones(shape[1])
    held = hi.astype(np.float64) + (v64 - hi).astype(np.float32)
    oracle = _oracle(r, c, held, np.ones(shape[1]), shape[0])
    y = T.df_to_f64(*T.spmv_csr_df64(tcsr, x, torch.zeros_like(x), tlo))
    f32 = np.zeros(shape[0], np.float32)
    np.add.at(f32, r, hi)
    scale = np.abs(oracle).max()
    assert np.abs(y - oracle).max() / scale < 1e-12
    assert np.abs(f32 - oracle).max() / scale > 1e-6
