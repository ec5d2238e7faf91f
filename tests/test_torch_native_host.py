"""The port's native host paths against its numpy and torch paths and JAX.

* The SELL planner's C++ pass (``csrc/sellplan.cpp``) at 1 and 8 sorting
  threads against the numpy flow and the JAX planner, element for element:
  chunk 2048, 256 and 8, with and without ``allow_small_chunk``, nnz 0,
  duplicates, a hub row that forces split planes, streamed-y plans, the
  operator's planes under ``SMVP_SELL_LIDX32=1``, and a column count whose
  tile field overflows the native key (numpy then plans).
* The MatrixMarket reader (``csrc/mtxio.cpp``) against the Python reader
  and the JAX package's readers, including a coordinate written as
  ``1.0`` (which the JAX native reader refuses) and the "truncated header"
  message.
* The CSR and TJDS encode orders (``csrc/encode.cpp``) against the torch
  sort encoders and JAX's.
* The switches: ``SMVP_NO_NATIVE_PLAN``, ``use_native``,
  ``SMVP_NATIVE_ENCODE``; and a native library that cannot be built
  raises rather than falls back.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as j_csr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode as j_tjds_encode
from smvp_toolkit_tpu.io import mtx as jmtx
from smvp_toolkit_tpu.io import native as jnative
from smvp_toolkit_tpu.ops import sell_plan as jplan
from smvp_toolkit_tpu_torch.formats import encode_native as en
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix as TCOO
from smvp_toolkit_tpu_torch.formats.csr import csr_encode as t_csr_encode
from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode as t_tjds_encode
from smvp_toolkit_tpu_torch.io import mtx as tmtx
from smvp_toolkit_tpu_torch.io import native as tnative
from smvp_toolkit_tpu_torch.ops import _build
from smvp_toolkit_tpu_torch.ops import sell_plan as tplan
from smvp_toolkit_tpu_torch.ops import spmv_sell as S

from test_torch_cisr import _assert_plans_equal


def _random(seed, n=3000, m=5000, nnz=20000, dups=False, empty=True):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, m, nnz)
    if empty:
        keep = r % 5 != 2
        r, c = r[keep], c[keep]
    if dups:  # repeated (row, col) pairs, several per lane and tile
        r = np.concatenate([r, r[:3000], r[:1000]])
        c = np.concatenate([c, c[:3000], c[:1000]])
    v = rng.standard_normal(len(r))
    return r.astype(np.int64), c.astype(np.int64), v, (n, m)


def _hub(seed):
    """A row with entries over 600 column tiles beside few others, so that
    one chunk spans them: a window past 511 tiles, and the operator takes
    the split planes."""
    r, c, v, _ = _random(seed, n=3000, m=90000, nnz=800)
    hub_c = np.arange(600) * 128 + 5
    r = np.concatenate([r, np.full(600, 1000)])
    c = np.concatenate([c, hub_c])
    v = np.concatenate([v, np.ones(600)])
    return r, c, v, (3000, 90000)


CASES = {
    "rand": lambda: _random(0),
    "dups": lambda: _random(1, dups=True),
    "wide": lambda: _random(2, n=700, m=200000, nnz=30000),
    "hub": lambda: _hub(3),
}


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("small", [True, False])
@pytest.mark.parametrize("chunk", [2048, 256, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_plan_equals_numpy_and_jax(case, chunk, small, threads):
    r, c, v, shape = CASES[case]()
    kw = dict(chunk=chunk, allow_small_chunk=small)
    native = tplan.build_sell_plan(r, c, v, shape, use_native=True,
                                   threads=threads, **kw)
    _assert_plans_equal(native, tplan.build_sell_plan(
        r, c, v, shape, use_native=False, **kw))
    _assert_plans_equal(native, jplan.build_sell_plan(r, c, v, shape, **kw))


def test_hub_plan_takes_the_split_planes():
    r, c, v, shape = _hub(3)
    plan = tplan.build_sell_plan(r, c, v, shape, chunk=2048)
    assert plan.window_tiles > 511 and not plan.merged_word
    assert S.plan_route(plan) == "split"


@pytest.mark.parametrize("small", [True, False])
def test_nnz0_plan(small):
    e = np.zeros(0, np.int64)
    kw = dict(chunk=256, allow_small_chunk=small)
    a = tplan.build_sell_plan(e, e, np.zeros(0), (300, 200), use_native=True,
                              **kw)
    _assert_plans_equal(a, tplan.build_sell_plan(
        e, e, np.zeros(0), (300, 200), use_native=False, **kw))
    _assert_plans_equal(a, jplan.build_sell_plan(e, e, np.zeros(0),
                                                 (300, 200), **kw))


@pytest.mark.parametrize("threads", [1, 8])
def test_native_streamed_plan_equals_numpy_and_jax(threads):
    r, c, v, shape = _random(4, n=2 * 2048 + 300, m=3000, nnz=20000)
    kw = dict(chunk=256, y_block_rows=2048)
    a = tplan.build_streamed_sell_plan(r, c, v, shape, use_native=True,
                                       threads=threads, **kw)
    _assert_plans_equal(a, tplan.build_streamed_sell_plan(
        r, c, v, shape, use_native=False, **kw))
    _assert_plans_equal(a, jplan.build_streamed_sell_plan(r, c, v, shape,
                                                          **kw))


def test_tile_field_overflow_plans_in_numpy(monkeypatch):
    """ncols past 2^33: the native key's tile field overflows, the native
    pass declines and the numpy flow plans, as in the JAX planner."""
    r, c, v, _ = _random(5, n=500, m=4000, nnz=2000)
    shape = (500, 1 << 34)
    calls = []
    real = tplan._build_native
    monkeypatch.setattr(tplan, "_build_native", lambda *a, **k: calls.append(
        1) or real(*a, **k))
    a = tplan.build_sell_plan(r, c, v, shape, chunk=256)
    assert calls and real(r, c, v, shape, len(r), 1, 1, chunk=256,
                          min_window_tiles=8, allow_small_chunk=True) is None
    _assert_plans_equal(a, tplan.build_sell_plan(r, c, v, shape, chunk=256,
                                                 use_native=False))
    _assert_plans_equal(a, jplan.build_sell_plan(r, c, v, shape, chunk=256))


def test_too_many_duplicates_refused_on_both_paths():
    r = np.zeros((1 << 16) + 1, np.int64)
    c = np.zeros((1 << 16) + 1, np.int64)
    v = np.ones((1 << 16) + 1)
    for native in (True, False):
        with pytest.raises(ValueError, match="65535 duplicate"):
            tplan.build_sell_plan(r, c, v, (4, 4), use_native=native)


def test_lidx32_operator_planes_equal(monkeypatch):
    monkeypatch.setenv("SMVP_SELL_LIDX32", "1")
    r, c, v, shape = _random(6)
    a = S.SellSpMV(tplan.build_sell_plan(r, c, v, shape, chunk=2048,
                                         use_native=True), device="cpu")
    b = S.SellSpMV(tplan.build_sell_plan(r, c, v, shape, chunk=2048,
                                         use_native=False), device="cpu")
    assert a.lidx.dtype == torch.int32
    for f in ("vals", "lidx", "relsl", "tile_base"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_no_native_plan_switch_takes_numpy(monkeypatch):
    r, c, v, shape = _random(7)

    def boom(*a, **k):
        raise AssertionError("native pass taken")

    monkeypatch.setattr(tplan, "_build_native", boom)
    with pytest.raises(AssertionError, match="native pass"):
        tplan.build_sell_plan(r, c, v, shape)
    monkeypatch.setenv("SMVP_NO_NATIVE_PLAN", "1")
    tplan.build_sell_plan(r, c, v, shape)  # numpy, no native call
    tplan.build_sell_plan(r, c, v, shape, use_native=False)


def _broken_build(monkeypatch):
    def fail(name, signatures):
        raise _build.KernelBuildError(f"build failed: {name}")

    monkeypatch.setattr(_build, "load", fail)


def test_failed_builds_raise(monkeypatch, tmp_path):
    """No quiet fallback: a host library that cannot be built raises from
    the planner, the reader, the encoders and the CISR scheduler."""
    from smvp_toolkit_tpu_torch.formats.cisr import cisr_encode

    r, c, v, shape = _random(8, n=300, m=300, nnz=2000)
    coo = TCOO.from_numpy(r, c, v, shape=shape, device="cpu")
    path = str(tmp_path / "m.mtx")
    tmtx.write_mtx(path, r, c, v, shape)
    _broken_build(monkeypatch)
    for call in (lambda: tplan.build_sell_plan(r, c, v, shape),
                 lambda: tmtx.read_mtx(path, device="cpu"),
                 lambda: t_csr_encode(coo), lambda: t_tjds_encode(coo),
                 lambda: cisr_encode(coo, 16)):
        with pytest.raises(_build.KernelBuildError, match="build failed"):
            call()


def test_host_sources_build_with_threads():
    assert {"cisr", "sellplan", "mtxio", "encode"} <= set(_build.sources())
    assert "-pthread" in _build.CXX_FLAGS
    assert "-ffp-contract=off" in _build.CXX_FLAGS


# -- the MatrixMarket reader ---------------------------------------------------


def _write_kind(path, kind, seed):
    rng = np.random.default_rng(seed)
    r, c, v, shape = _random(seed, n=400, m=300, nnz=3000)
    if kind == "real":
        jmtx.write_mtx(path, r, c, v, shape)
    elif kind == "integer":
        jmtx.write_mtx(path, r, c, rng.integers(-50, 50, len(r)), shape)
    elif kind == "pattern":
        jmtx.write_mtx(path, r, c, None, shape)
    else:
        lo = r % 300 >= c
        jmtx.write_mtx(path, r[lo] % 300, c[lo], v[lo], (300, 300),
                       symmetry=kind)


def _raw_equal(a, b):
    assert str(a[0]) == str(b[0]) and a[1:3] == b[1:3]
    for x, y in zip(a[3:], b[3:]):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("kind", ["real", "integer", "pattern", "symmetric",
                                  "skew-symmetric"])
def test_native_reader_equals_python_and_jax(tmp_path, kind):
    path = str(tmp_path / "m.mtx")
    _write_kind(path, kind, seed=len(kind))
    got = tnative.read_mtx_raw_native(path)
    _raw_equal(got, tmtx.read_mtx_raw(path))
    _raw_equal(got, jmtx.read_mtx_raw(path))
    _raw_equal(got, jnative.read_mtx_raw_native(path))
    a = tmtx.read_mtx(path, device="cpu", expand_symmetry=True)
    b = tmtx.read_mtx(path, device="cpu", expand_symmetry=True,
                      use_native=False)
    for x, y in zip(a.to_numpy(), b.to_numpy()):
        assert x.tobytes() == y.tobytes()


_BANNER = "%%MatrixMarket matrix coordinate real general\n"


@pytest.mark.parametrize("body,rows,cols,jax_native", [
    ("3 3 3\n1.0 1 2.5\n2 2.0 -1\n3e0 3 4\n", [0, 1, 2], [0, 1, 2],
     "refuses"),
    ("2 2 2\n%mid\n1 2 7\n  +2   1.9 8\n", [0, 1], [1, 0], "misreads"),
    ("2 3 1\n 2.9 3 1e-3", [1], [2], "refuses"),
    ("2 3 2\n2 3 1e-3\n1 1 -0\n", [1, 0], [2, 0], "reads"),
])
def test_numeric_coordinates_read_as_python_reads_them(
        tmp_path, body, rows, cols, jax_native):
    path = tmp_path / "f.mtx"
    path.write_text(_BANNER + body)
    got = tnative.read_mtx_raw_native(str(path))
    _raw_equal(got, tmtx.read_mtx_raw(str(path)))
    _raw_equal(got, jmtx.read_mtx_raw(str(path)))
    np.testing.assert_array_equal(got[3], rows)
    np.testing.assert_array_equal(got[4], cols)
    # the JAX native reader reads digits only: it stops at a '.' or 'e'
    # (its known gap), or, where a fraction follows the last coordinate,
    # takes the fraction as the value
    if jax_native == "reads":
        _raw_equal(got, jnative.read_mtx_raw_native(str(path)))
    elif jax_native == "refuses":
        with pytest.raises(jmtx.MTXError, match="fewer than"):
            jnative.read_mtx_raw_native(str(path))
    else:
        j = jnative.read_mtx_raw_native(str(path))
        assert j[5].tobytes() != got[5].tobytes()


@pytest.mark.parametrize("text,exc,match", [
    ("", tmtx.MTXPrematureEOF, "truncated header"),
    (_BANNER, tmtx.MTXPrematureEOF, "truncated header"),
    (_BANNER + "3 3\n", tmtx.MTXPrematureEOF, "truncated header"),
    (_BANNER + "3 3 2\n1 1 1\n", tmtx.MTXPrematureEOF, "fewer than 2"),
    ("1 1 1\n1 1 1\n", tmtx.MTXNoHeader, "missing %%MatrixMarket"),
    (_BANNER + "2 2 1\n3 1 1\n", tmtx.MTXError, "out of declared bounds"),
    (_BANNER + "2 2 1\n0.5 1 1\n", tmtx.MTXError, "out of declared bounds"),
    (_BANNER + "2 2 1\n1 99999999999999 1\n", tmtx.MTXError,
     "out of declared bounds"),
])
def test_native_reader_errors_match_jax_wording(tmp_path, text, exc, match):
    path = tmp_path / "bad.mtx"
    path.write_text(text)
    with pytest.raises(exc, match=match) as te:
        tnative.read_mtx_raw_native(str(path))
    with pytest.raises(jmtx.MTXError) as je:
        jnative.read_mtx_raw_native(str(path))
    if "0.5" not in text:  # the JAX native reader's gap words it otherwise
        assert type(je.value).__name__ == type(te.value).__name__
        assert str(te.value) == str(je.value)
    with pytest.raises(tmtx.MTXError):
        tmtx.read_mtx(str(path), device="cpu")


def test_unsupported_formats_take_the_python_reader(tmp_path):
    dense = tmp_path / "d.mtx"
    jmtx.write_mtx_array(str(dense), np.arange(12.0).reshape(3, 4))
    with pytest.raises(tnative.NativeUnavailable):
        tnative.read_mtx_raw_native(str(dense))
    a = tmtx.read_mtx(str(dense), device="cpu")
    b = jmtx.read_mtx(str(dense))
    assert a.nnz == b.nnz == 12
    cplx = tmp_path / "c.mtx"
    jmtx.write_mtx(str(cplx), np.array([0]), np.array([1]),
                   np.array([1 + 2j]), (2, 2))
    assert tmtx.read_mtx(str(cplx), device="cpu").dtype == torch.complex64


def test_symmetric_non_square_refused_after_the_native_read(tmp_path):
    path = tmp_path / "s.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    "3 2 1\n1 1 1\n")
    with pytest.raises(tmtx.MTXError, match="must be square") as te:
        tmtx.read_mtx(str(path), device="cpu")
    with pytest.raises(jmtx.MTXError) as je:
        jmtx.read_mtx(str(path))
    assert str(te.value) == str(je.value)


def test_missing_file_is_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        tmtx.read_mtx(str(tmp_path / "nope.mtx"), device="cpu")


# -- the CSR and TJDS encode orders --------------------------------------------


def _encode_inputs(seed, dtype):
    r, c, v, shape = _random(seed, n=900, m=700, nnz=6000, dups=True)
    tc = TCOO.from_numpy(r, c, v, shape=shape, dtype=dtype, device="cpu",
                         pad_to=128)
    jc = JCOO.from_numpy(r.astype(np.int32), c.astype(np.int32),
                         v.astype(np.float32), shape=shape).pad(128)
    return tc, jc


def _fields_equal(a, b, names):
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f
        else:
            assert x == y, f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.complex64])
def test_native_encoders_equal_torch_encoders(dtype, monkeypatch):
    tc, _ = _encode_inputs(9, dtype)
    a_csr, a_tj = t_csr_encode(tc), t_tjds_encode(tc)
    monkeypatch.setenv("SMVP_NATIVE_ENCODE", "0")
    assert not en.use_native(tc)
    b_csr, b_tj = t_csr_encode(tc), t_tjds_encode(tc)
    _fields_equal(a_csr, b_csr, ("row_ptr", "col_ind", "vals", "row_ids",
                                 "nnz", "shape"))
    _fields_equal(a_tj, b_tj, ("vals", "row_ind", "start_pos", "perm",
                               "offsets", "num_diags", "nnz", "shape"))


def test_native_encoders_equal_jax():
    tc, jc = _encode_inputs(10, torch.float32)
    a, b = t_csr_encode(tc), j_csr_encode(jc)
    for f in ("row_ptr", "col_ind", "vals", "row_ids"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)))
    a, b = t_tjds_encode(tc), j_tjds_encode(jc)
    for f in ("vals", "row_ind", "start_pos", "perm", "offsets"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)))
    assert a.num_diags == int(b.num_diags)


def test_padding_sentinels_are_forced():
    """A COO whose padding carries garbage encodes as if it held the
    sentinels (row nrows, col 0, value 0), on both paths."""
    tc, _ = _encode_inputs(11, torch.float32)
    n = tc.nnz
    rows, cols, vals = tc.rows.clone(), tc.cols.clone(), tc.vals.clone()
    rows[n:], cols[n:], vals[n:] = 3, 5, 7.0
    dirty = TCOO(rows=rows, cols=cols, vals=vals, shape=tc.shape, nnz=n)
    _fields_equal(t_csr_encode(dirty), t_csr_encode(tc),
                  ("row_ptr", "col_ind", "vals", "row_ids"))
    _fields_equal(t_tjds_encode(dirty), t_tjds_encode(tc),
                  ("vals", "row_ind", "start_pos", "perm", "offsets"))


def test_use_native_rule(monkeypatch):
    tc, _ = _encode_inputs(12, torch.float32)
    monkeypatch.delenv("SMVP_NATIVE_ENCODE", raising=False)
    assert en.use_native(tc)
    monkeypatch.setenv("SMVP_NATIVE_ENCODE", "1")
    assert en.use_native(tc)
    monkeypatch.setenv("SMVP_NATIVE_ENCODE", "0")
    assert not en.use_native(tc)


def test_empty_and_columnless_encodes():
    e = np.zeros(0, np.int64)
    for shape in ((5, 4), (3, 0)):
        tc = TCOO.from_numpy(e, e, np.zeros(0), shape=shape, device="cpu",
                             pad_to=128)
        csr = t_csr_encode(tc)
        assert csr.row_ptr.tolist() == [0] * (shape[0] + 1)
        tj = t_tjds_encode(tc)
        assert tj.num_diags == 0 and tj.perm.numel() == shape[1]
