"""The port's remaining I/O, checkpoint and utility modules against the
JAX package's: ``io.mtx.write_mtx_array`` (byte for byte, real and
complex), the ``readtest`` / ``writetest`` programs (equal stdout), SELL
plan and AMG hierarchy checkpoints written by one package and loaded by
the other in both directions (every array equal element for element,
streamed-y plans included), ``utils.padding`` and ``utils.reorder``
(``rcm_permutation`` equal, ``permute_symmetric`` triplets bit-equal,
``bandwidth``, ``round_up`` and ``pad_to`` equal), and the package
exports of ``ops``, ``bench`` and ``io``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu import models as jmodels
from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr_encode
from smvp_toolkit_tpu.io import mtx as jmtx
from smvp_toolkit_tpu.io import readtest as jreadtest
from smvp_toolkit_tpu.io import writetest as jwritetest
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu.utils import checkpoint as jck
from smvp_toolkit_tpu.utils import padding as jpad
from smvp_toolkit_tpu.utils import reorder as jreorder
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.io import mtx as tmtx
from smvp_toolkit_tpu_torch.io import readtest, writetest
from smvp_toolkit_tpu_torch.models import amg
from smvp_toolkit_tpu_torch.ops import sell_plan as tplan
from smvp_toolkit_tpu_torch.utils import checkpoint as tck
from smvp_toolkit_tpu_torch.utils import padding, reorder
from smvp_toolkit_tpu_torch.utils.synth import poisson2d


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_write_mtx_array_byte_equal(tmp_path, kind):
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((7, 4))
    if kind == "complex":
        dense = dense + 1j * rng.standard_normal((7, 4))
    tp, jp = tmp_path / "t.mtx", tmp_path / "j.mtx"
    tmtx.write_mtx_array(str(tp), torch.from_numpy(dense), comment="a\nb")
    jmtx.write_mtx_array(str(jp), dense, comment="a\nb")
    assert tp.read_bytes() == jp.read_bytes()
    buf = io.StringIO()
    tmtx.write_mtx_array(buf, dense)
    assert buf.getvalue().startswith(
        f"%%MatrixMarket matrix array {kind} general\n7 4\n")
    with pytest.raises(ValueError):
        tmtx.write_mtx_array(buf, np.ones(3))


@pytest.mark.parametrize("field", ["real", "complex", "pattern", "symm"])
def test_readtest_stdout_equal(tmp_path, field):
    path = str(tmp_path / "m.mtx")
    r, c = np.array([0, 2, 3, 3]), np.array([0, 1, 0, 3])
    v = {"real": np.array([1.5, -2.0, 3.25, 1e-7]),
         "complex": np.array([1 + 2j, -3j, 0.5, 4]),
         "pattern": None, "symm": np.array([1.5, -2.0, 3.25, 1e-7])}[field]
    tmtx.write_mtx(path, r, c, v, (4, 4),
                   symmetry="symmetric" if field == "symm" else "general")
    assert _stdout(readtest.main, [path]) == _stdout(jreadtest.main, [path])
    assert _stdout(readtest.main, [])[0] == 2


def test_writetest_stdout_equal():
    assert _stdout(writetest.main) == _stdout(jwritetest.main)


def _triplets(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 8 * n)
    c = np.clip(r + rng.integers(-300, 300, 8 * n), 0, n - 1)
    key = np.unique(r * n + c)
    return ((key // n).astype(np.int32), (key % n).astype(np.int32),
            rng.standard_normal(len(key)).astype(np.float32), (n, n))


PLANS = {
    "flat": lambda m, r, c, v, s: m.build_sell_plan(r, c, v, s),
    "streamed": lambda m, r, c, v, s: m.build_streamed_sell_plan(
        r, c, v, s, y_block_rows=2048),
}


def _same_plan(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind", list(PLANS))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_plan_checkpoint_across_packages(tmp_path, kind, writer):
    r, c, v, shape = _triplets()
    jp = PLANS[kind](jplan, r, c, v, shape)
    tp = PLANS[kind](tplan, r, c, v, shape)
    _same_plan(tp, jp)
    path = str(tmp_path / "plan.npz")
    if writer == "jax":
        jck.save_plan(path, jp)
        loaded = tck.load_plan(path)
        _same_plan(loaded, tp)
    else:
        tck.save_plan(path, tp)
        loaded = jck.load_plan(path)
        _same_plan(loaded, jp)
    assert bool(loaded.y_block_slices) == (kind == "streamed")
    with pytest.raises(ValueError, match="SellPlan"):
        tck.load_plan(_matrix_file(tmp_path))


def _matrix_file(tmp_path):
    path = str(tmp_path / "m.npz")
    tck.save_matrix(path, COOMatrix.from_numpy(
        np.array([0]), np.array([0]), np.array([1.0]), shape=(1, 1),
        device="cpu"))
    return path


@pytest.fixture(scope="module")
def hierarchies():
    a = poisson2d(24).tocoo()
    r, c = a.row.astype(np.int32), a.col.astype(np.int32)
    v = a.data.astype(np.float32)
    jc = jcsr_encode(JCOO.from_numpy(r, c, v, shape=a.shape, pad_to=128))
    tc = csr_encode(COOMatrix.from_numpy(r, c, v, shape=a.shape, pad_to=128,
                                         device="cpu"))
    return (jmodels.amg_setup(jc, coarse_size=64),
            amg.amg_setup(tc, coarse_size=64))


def _arr(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _same_levels(a, b):
    assert len(a) == len(b) >= 2
    for la, lb in zip(a, b):
        assert la.n == lb.n and la.omega == lb.omega and la.rho == lb.rho
        for name in ("inv_diag", "coarse_inv"):
            x, y = _arr(getattr(la, name)), _arr(getattr(lb, name))
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(x, y), name
        for name in ("a_csr", "p_csr", "pt_csr"):
            x, y = getattr(la, name), getattr(lb, name)
            assert (x is None) == (y is None)
            if x is None:
                continue
            assert tuple(x.shape) == tuple(y.shape) and x.nnz == y.nnz
            for f in ("row_ptr", "col_ind", "vals"):
                assert np.array_equal(_arr(getattr(x, f)),
                                      _arr(getattr(y, f))), (name, f)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hierarchy_checkpoint_across_packages(tmp_path, hierarchies, writer):
    jl, tl = hierarchies
    path = str(tmp_path / "amg.npz")
    if writer == "jax":
        jck.save_hierarchy(path, jl)
        loaded = tck.load_hierarchy(path, device="cpu")
        _same_levels(loaded, jl)
        for lv in loaded[:-1]:  # row ids, as a fresh encode carries them
            assert lv.a_csr.row_ids is not None
    else:
        tck.save_hierarchy(path, tl)
        loaded = jck.load_hierarchy(path)
        _same_levels(loaded, tl)
    # the reloaded hierarchy preconditions as the fresh one does
    fresh = tck.load_hierarchy(path, device="cpu")
    rhs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tl[0].n).astype(np.float32))
    m1 = amg.amg_preconditioner(tl[0].a_csr, levels=tl)
    m2 = amg.amg_preconditioner(tl[0].a_csr, levels=fresh)
    assert torch.allclose(m1(rhs), m2(rhs), rtol=0, atol=1e-6)


def test_padding_matches_jax():
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 8), (5, 1), (0, 0), (130, 128)):
        assert padding.round_up(x, m) == jpad.round_up(x, m)
    a = np.arange(5, dtype=np.float32)
    got = padding.pad_to(torch.from_numpy(a), 9, fill=-1)
    assert np.array_equal(got.numpy(), np.asarray(
        jpad.pad_to(jnp.asarray(a), 9, fill=-1)))
    assert padding.pad_to(torch.from_numpy(a), 3).shape == (5,)


def test_reorder_matches_jax():
    rng = np.random.default_rng(4)
    n = 300
    r = rng.integers(0, n, 2000)
    c = rng.permutation(n)[r % n]
    key = np.unique(r * n + c)
    r, c = (key // n).astype(np.int32), (key % n).astype(np.int32)
    v = rng.standard_normal(len(r)).astype(np.float32)
    jc = JCOO.from_numpy(r, c, v, shape=(n, n), pad_to=128)
    tc = COOMatrix.from_numpy(r, c, v, shape=(n, n), pad_to=128,
                              device="cpu")
    assert reorder.bandwidth(tc) == jreorder.bandwidth(jc)
    perm = reorder.rcm_permutation(tc)
    assert np.array_equal(perm, jreorder.rcm_permutation(jc))
    tp, jp = reorder.permute_symmetric(tc, perm), jreorder.permute_symmetric(
        jc, perm)
    for a, b in zip(tp.to_numpy(), jp.to_numpy()):
        assert a.tobytes() == np.asarray(b).tobytes()
    assert reorder.bandwidth(tp) == jreorder.bandwidth(jp) < reorder.bandwidth(
        tc)
    with pytest.raises(ValueError):
        reorder.permute_symmetric(tc, perm[:-1])


def test_package_exports():
    import smvp_toolkit_tpu.bench as jb
    import smvp_toolkit_tpu.io as ji
    import smvp_toolkit_tpu.ops as jo
    import smvp_toolkit_tpu_torch.bench as tb
    import smvp_toolkit_tpu_torch.io as ti
    import smvp_toolkit_tpu_torch.ops as to

    for tmod, jmod, absent in ((to, jo, {"spmv_cisr"}),
                               (tb, jb, {"bench_spmv_fused"}),
                               (ti, ji, set())):
        assert set(jmod.__all__) - set(tmod.__all__) == absent
        for name in tmod.__all__:
            assert getattr(tmod, name) is not None
    from smvp_toolkit_tpu_torch.ops import spmv_cisr

    assert callable(spmv_cisr.spmv_cisr)
