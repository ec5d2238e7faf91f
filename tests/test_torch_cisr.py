"""The CISR slice: the port's schedule, its images and its SpMVs against
the JAX package.

Inputs are random matrices from numpy seeds with empty rows (and one with
so many empty rows that the ``.coe`` flushes row-length words past the
value words). The schedule (native and Python, at 1, 3, 16 and 255 slots)
must equal the JAX package's element for element; the decode, the pack
words, the ``.coe`` text and the TJDS LUT text byte for byte; the
complex refusal too. ``CisrSpMV`` and ``spmv_cisr_sell`` on the CPU meet
JAX's ``spmv_cisr`` and ``spmv_cisr_pallas`` (interpret mode) within 1e-6
of max |y|, and the CISR replan's plan equals the CSR replan's and the
JAX package's. Also the ``.npz`` checkpoints across packages, the debug
dumps' text and the CISR byte count.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.bench import roofline as jroof
from smvp_toolkit_tpu.formats import cisr as jcisr
from smvp_toolkit_tpu.formats import vivado as jviv
from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as j_csr_encode
from smvp_toolkit_tpu.formats.tjds import tjds_encode as j_tjds_encode
from smvp_toolkit_tpu.utils import checkpoint as jck
from smvp_toolkit_tpu.utils import debug as jdebug
from smvp_toolkit_tpu_torch.bench import roofline as troof
from smvp_toolkit_tpu_torch.formats import cisr as tcisr
from smvp_toolkit_tpu_torch.formats import vivado as tviv
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix as TCOO
from smvp_toolkit_tpu_torch.formats.csr import csr_encode as t_csr_encode
from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode as t_tjds_encode
from smvp_toolkit_tpu_torch.interop import cisr_from_arrays, plan_fields
from smvp_toolkit_tpu_torch.ops import spmv_cisr as tspmv_cisr
from smvp_toolkit_tpu_torch.ops import spmv_sell as S
from smvp_toolkit_tpu_torch.utils import checkpoint as tck
from smvp_toolkit_tpu_torch.utils import debug as tdebug

SLOTS = [1, 3, 16, 255]
TOL = 1e-6


def _triplets(kind, seed=0):
    """(r, c, v, shape): ``rand`` has every 7th row empty and values up to
    a few thousand (both signs, so the 12-bit field wraps); ``sparse``
    leaves most rows empty (the row-length flush); ``big`` carries values
    past 2^53 and 2^63."""
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        n, m = 1200, 300
        r = rng.choice(np.arange(0, n, 40), size=90)
        c = rng.integers(0, m, 90)
    else:
        n, m = 700, 500
        r = rng.integers(0, n, 5000)
        c = rng.integers(0, m, 5000)
        keep = r % 7 != 3
        r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r)) * 3000.0
    if kind == "big":
        v[::5] *= 1e16
        v[1::11] = np.float32(-9.5e18)
        v[2::13] = np.float32(2.7e30)
    return r.astype(np.int32), c.astype(np.int32), v.astype(np.float32), (n, m)


def _coos(kind, seed=0):
    r, c, v, shape = _triplets(kind, seed)
    return (JCOO.from_numpy(r, c, v, shape=shape),
            TCOO.from_numpy(r, c, v, shape=shape, device="cpu"))


def _assert_cisr_equal(a, b):
    for f in ("vals", "col_ind", "row_of", "row_lengths"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert (a.slot_count, tuple(a.shape), a.nnz) == (
        b.slot_count, tuple(b.shape), b.nnz)
    assert a.num_groups == b.num_groups


@pytest.mark.parametrize("kind", ["rand", "sparse"])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("slots", SLOTS)
def test_encode_matches_jax(kind, native, slots):
    jc, tc = _coos(kind)
    j = jcisr.cisr_encode(jc, slots)
    _assert_cisr_equal(tcisr.cisr_encode(tc, slots, use_native=native), j)
    # from CSR too (the JAX _csr_host's other branch)
    _assert_cisr_equal(tcisr.cisr_encode(t_csr_encode(tc), slots,
                                         use_native=native),
                       jcisr.cisr_encode(j_csr_encode(jc), slots))


@pytest.mark.parametrize("slots", SLOTS)
def test_native_equals_python_with_empty_rows(slots):
    _, tc = _coos("sparse", seed=3)
    _assert_cisr_equal(tcisr.cisr_encode(tc, slots, use_native=True),
                       tcisr.cisr_encode(tc, slots, use_native=False))


def test_encode_refuses_zero_slots():
    _, tc = _coos("rand")
    with pytest.raises(ValueError, match="slot_count"):
        tcisr.cisr_encode(tc, 0)


def test_complex_values_take_the_python_path_and_refuse_the_coe():
    r, c, v, shape = _triplets("rand")
    vc = v.astype(np.complex64) * (1 + 2j)
    tc = TCOO.from_numpy(r, c, vc, shape=shape, dtype=torch.complex64,
                         device="cpu")
    jc = JCOO.from_numpy(r, c, vc, shape=shape, dtype=np.complex64)
    t = tcisr.cisr_encode(tc, 16)
    _assert_cisr_equal(t, jcisr.cisr_encode(jc, 16))
    assert t.vals.dtype == np.complex128
    with pytest.raises(ValueError, match="complex") as te:
        tcisr.write_coe(t)
    with pytest.raises(ValueError) as je:
        jcisr.write_coe(jcisr.cisr_encode(jc, 16))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("slots", [1, 16])
@pytest.mark.parametrize("kind", ["rand", "sparse"])
def test_decode_round_trip(kind, slots):
    jc, tc = _coos(kind)
    t = tcisr.cisr_encode(tc, slots)
    dec = tcisr.cisr_decode(t, device="cpu")
    assert dec.dtype == torch.float64 and dec.device.type == "cpu"
    r, c, v = dec.to_numpy()
    R, C, V = tc.canonical_order().to_numpy()
    np.testing.assert_array_equal(r, R)
    np.testing.assert_array_equal(c, C)
    assert v.tobytes() == V.astype(np.float64).tobytes()
    jr, jcol, jv = jcisr.cisr_decode(jcisr.cisr_encode(jc, slots)).to_numpy()
    np.testing.assert_array_equal(r, np.asarray(jr))
    np.testing.assert_array_equal(c, np.asarray(jcol))
    np.testing.assert_array_equal(v.astype(np.float32), np.asarray(jv))


def test_pack_words_match_jax():
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.standard_normal(200) * 5000, [
        0.0, -0.0, 0.99, -0.99, 4095.7, 4096.0, -4096.5, 1e19, -9.5e18,
        2.7e30, -3.3e38, 2.0 ** 63, -(2.0 ** 63) - 2048.0]])
    for i, val in enumerate(vals):
        col, slot = int(rng.integers(0, 1 << 20)), int(rng.integers(0, 300))
        assert tcisr.pack_value_word(val, col, slot) == \
            jcisr.pack_value_word(val, col, slot)
    for a, b in ((0, None), (5, 7), (4095, 4096), (70000, None)):
        assert tcisr.pack_rowlen_word(a, b) == jcisr.pack_rowlen_word(a, b)


@pytest.mark.parametrize("kind", ["rand", "sparse", "big"])
@pytest.mark.parametrize("slots", SLOTS)
def test_write_coe_bytes_equal_jax(kind, slots, tmp_path):
    jc, tc = _coos(kind)
    j = jcisr.cisr_encode(jc, slots)
    t = tcisr.cisr_encode(tc, slots)
    text = tcisr.write_coe(t)
    assert text == jcisr.write_coe(j)
    if kind == "sparse" and slots == 1:  # more row-length than value words
        assert text.count("\n02") > text.count("\n01")
    path = tmp_path / "x.coe"
    assert tcisr.write_coe(t, str(path)) == text
    assert path.read_text() == text
    buf = io.StringIO()
    tcisr.write_coe(t, buf)
    assert buf.getvalue() == text


def test_write_coe_of_an_empty_matrix_matches_jax():
    r = np.zeros(0, np.int32)
    jc = JCOO.from_numpy(r, r, np.zeros(0, np.float32), shape=(5, 4))
    tc = TCOO.from_numpy(r, r, np.zeros(0, np.float32), shape=(5, 4),
                         device="cpu")
    t = tcisr.cisr_encode(tc, 16)
    assert t.num_groups == 0
    assert tcisr.write_coe(t) == jcisr.write_coe(jcisr.cisr_encode(jc, 16))


def test_write_coe_refuses_non_finite_values():
    r, c, v, shape = _triplets("rand")
    v[3] = np.nan
    t = tcisr.cisr_encode(TCOO.from_numpy(r, c, v, shape=shape,
                                          device="cpu"), 16)
    with pytest.raises(ValueError, match="finite"):
        tcisr.write_coe(t)


@pytest.mark.parametrize("kw", [{}, {"max_diags": 3},
                                {"signal": "lut_x", "max_diags": 100}])
def test_write_tjds_lut_bytes_equal_jax(kw, tmp_path):
    jc, tc = _coos("rand", seed=5)
    jt, tt = j_tjds_encode(jc), t_tjds_encode(tc)
    text = tviv.write_tjds_lut(tt, **kw)
    assert text == jviv.write_tjds_lut(jt, **kw)
    assert text.count("\n") == text.count("assign ") > 0
    path = tmp_path / "x.lut"
    tviv.write_tjds_lut(tt, str(path), **kw)
    assert path.read_text() == text


def _jax_x(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("slots", [1, 16])
@pytest.mark.parametrize("kind", ["rand", "sparse"])
def test_cisr_spmv_matches_jax(kind, slots):
    from smvp_toolkit_tpu.ops.spmv_cisr import spmv_cisr as j_spmv_cisr

    jc, tc = _coos(kind)
    j = jcisr.cisr_encode(jc, slots)
    t = tcisr.cisr_encode(tc, slots)
    x = _jax_x(tc.shape[1], 1)
    yj = np.asarray(j_spmv_cisr(j, x))
    op = tspmv_cisr.CisrSpMV(t, device="cpu")
    yt = op(torch.from_numpy(x))
    assert yt.dtype == torch.float32 and yt.shape == (tc.shape[0],)
    assert _rel(yt, yj) <= TOL
    # the cached entry point on x's device
    y2 = tspmv_cisr.spmv_cisr(t, torch.from_numpy(x))
    assert torch.equal(y2, yt)
    assert tspmv_cisr.spmv_cisr(t, torch.from_numpy(x)) is not None
    assert tspmv_cisr._CACHE[t].device.type == "cpu"


def test_cisr_spmv_needs_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tc = _coos("rand")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmv_cisr.CisrSpMV(tcisr.cisr_encode(tc, 16))


def _assert_plans_equal(a, b):
    fa, fb = plan_fields(a), plan_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, k
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k
        else:
            assert x == y, k


@pytest.mark.parametrize("slots", [1, 7, 16])
@pytest.mark.parametrize("n", [3000, 5000])
def test_cisr_replan_equals_csr_replan_and_jax(n, slots, monkeypatch):
    from smvp_toolkit_tpu.ops import spmv_pallas as jp

    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")
    rng = np.random.default_rng(n + slots)
    nnz = 6 * n
    r = rng.integers(0, n, nnz).astype(np.int32)
    c = rng.integers(0, n, nnz).astype(np.int32)
    v = rng.standard_normal(nnz).astype(np.float32)
    tc = TCOO.from_numpy(r, c, v, shape=(n, n), device="cpu")
    t = tcisr.cisr_encode(tc, slots)
    cisr_plan = S.sell_op_cisr(t, "cpu").plan
    _assert_plans_equal(cisr_plan, S.sell_op_csr(t_csr_encode(tc)).plan)
    jc = JCOO.from_numpy(r, c, v, shape=(n, n))
    j = jcisr.cisr_encode(jc, slots)
    _assert_plans_equal(cisr_plan,
                        jp._cached_op(j, jp._triplets_from_cisr_host).plan)


def test_sell_op_cisr_is_cached_per_device():
    _, tc = _coos("rand")
    t = tcisr.cisr_encode(tc, 16)
    op = S.sell_op_cisr(t, "cpu")
    assert S.sell_op_cisr(t, "cpu") is op
    assert S.sell_op_cisr(t, torch.device("cpu")) is op
    assert op.value_dtype == torch.float32 and op.device.type == "cpu"


@pytest.mark.parametrize("slots", [3, 16])
def test_spmv_cisr_sell_matches_jax_pallas_interpret(slots, monkeypatch):
    from smvp_toolkit_tpu.ops import spmv_pallas as jp

    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", "0")
    jc, tc = _coos("rand", seed=7)
    x = _jax_x(tc.shape[1], 2)
    yj = np.asarray(jp.spmv_cisr_pallas(jcisr.cisr_encode(jc, slots), x))
    t = tcisr.cisr_encode(tc, slots)
    yt = S.spmv_cisr_sell(t, torch.from_numpy(x))
    assert yt.shape == (tc.shape[0],)
    assert _rel(yt, yj) <= TOL
    # and the schedule's own SpMV
    assert _rel(tspmv_cisr.spmv_cisr(t, torch.from_numpy(x)), yj) <= TOL


def test_bench_loop_on_the_cisr_operator():
    _, tc = _coos("rand", seed=8)
    t = tcisr.cisr_encode(tc, 16)
    x = torch.from_numpy(_jax_x(tc.shape[1], 3))
    op = S.sell_op_cisr(t, "cpu")
    assert _rel(op.bench_loop(x, 3), op(x)) <= TOL


def test_cisr_from_arrays_carries_a_jax_schedule():
    jc, tc = _coos("sparse", seed=2)
    j = jcisr.cisr_encode(jc, 7)
    t = cisr_from_arrays({
        "vals": j.vals, "col_ind": j.col_ind, "row_of": j.row_of,
        "row_lengths": j.row_lengths, "slot_count": j.slot_count,
        "shape": j.shape, "nnz": j.nnz})
    _assert_cisr_equal(t, j)
    _assert_cisr_equal(t, tcisr.cisr_encode(tc, 7))
    assert tcisr.write_coe(t) == jcisr.write_coe(j)


@pytest.mark.parametrize("args", [(100, 16, 50, 4), (7, 255, 3, 2),
                                  (0, 1, 10, 4)])
def test_spmv_bytes_cisr_matches_jax(args):
    assert troof.spmv_bytes_cisr(*args) == jroof.spmv_bytes_cisr(*args)


# -- checkpoints --------------------------------------------------------------


def _port_matrices(tc):
    return {"coo": tc, "csr": t_csr_encode(tc), "tjds": t_tjds_encode(tc)}


def _jax_matrices(jc):
    return {"coo": jc, "csr": j_csr_encode(jc), "tjds": j_tjds_encode(jc)}


_FIELDS = {"coo": ("rows", "cols", "vals"),
           "csr": ("row_ptr", "col_ind", "vals"),
           "tjds": ("vals", "row_ind", "start_pos", "perm", "offsets")}


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    return np.asarray(a)


def _assert_same_matrix(kind, a, b):
    assert tuple(a.shape) == tuple(b.shape) and a.nnz == b.nnz
    for f in _FIELDS[kind]:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        np.testing.assert_array_equal(x, y.astype(x.dtype))
        assert x.tobytes() == y.astype(x.dtype).tobytes(), f
    if kind == "tjds":
        assert int(a.num_diags) == int(b.num_diags)
    if kind == "coo":
        assert str(a.typecode) == str(b.typecode)


@pytest.mark.parametrize("kind", ["coo", "csr", "tjds"])
def test_checkpoints_cross_load(kind, tmp_path):
    jc, tc = _coos("rand", seed=9)
    tm, jm = _port_matrices(tc)[kind], _jax_matrices(jc)[kind]
    tpath, jpath = tmp_path / "t.npz", tmp_path / "j.npz"
    tck.save_matrix(str(tpath), tm)
    jck.save_matrix(str(jpath), jm)
    # the port's file in both packages, the JAX file in the port
    _assert_same_matrix(kind, tck.load_matrix(str(tpath), device="cpu"), tm)
    _assert_same_matrix(kind, jck.load_matrix(str(tpath)), tm)
    back = tck.load_matrix(str(jpath), device="cpu")
    _assert_same_matrix(kind, back, jm)
    assert back.dtype == torch.float32 and back.device.type == "cpu"
    with np.load(str(tpath)) as a, np.load(str(jpath)) as b:
        assert set(a.files) == set(b.files)


def test_bfloat16_checkpoint_round_trip(tmp_path):
    r, c, v, shape = _triplets("rand", seed=10)
    tc = TCOO.from_numpy(r, c, v, shape=shape, dtype=torch.bfloat16,
                         device="cpu")
    for m in _port_matrices(tc).values():
        path = str(tmp_path / "b.npz")
        tck.save_matrix(path, m)
        back = tck.load_matrix(path, device="cpu")
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.vals, m.vals)


def test_checkpoint_refuses_other_types(tmp_path):
    with pytest.raises(TypeError, match="cannot checkpoint"):
        tck.save_matrix(str(tmp_path / "x.npz"), object())


# -- debug dumps --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11])
def test_debug_dumps_match_jax(seed):
    jc, tc = _coos("rand", seed=seed)
    jc, tc = jc.pad(128), tc.pad(128)
    for dump, jm, tm in (
        ("dump_coo", jc, tc),
        ("dump_csr", j_csr_encode(jc), t_csr_encode(tc)),
        ("dump_tjds", j_tjds_encode(jc), t_tjds_encode(tc)),
    ):
        a, b = io.StringIO(), io.StringIO()
        getattr(tdebug, dump)(tm, file=a)
        getattr(jdebug, dump)(jm, file=b)
        assert a.getvalue() == b.getvalue(), dump
        assert a.getvalue().startswith("[DEBUG]\t")


def test_debug_enabled_reads_the_environment(monkeypatch):
    for val, want in (("", False), ("0", False), ("false", False),
                      ("1", True), ("yes", True)):
        monkeypatch.setenv("SMVP_DEBUG", val)
        assert tdebug.debug_enabled() == jdebug.debug_enabled() == want
