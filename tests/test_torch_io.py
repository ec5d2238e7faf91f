"""MatrixMarket I/O: the port's reader against the JAX package's.

Files are written with the JAX package's ``write_mtx`` (synthetic and
random matrices; real, integer, pattern and symmetric fields; plain and
``.gz``) and read by both packages. Triplets must be bit-identical to the
JAX reader's native path (its default) and to its Python path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.io import mtx as jmtx
from smvp_toolkit_tpu.io import native as jnative
from smvp_toolkit_tpu.utils.synth import synth_banded as j_synth_banded
from smvp_toolkit_tpu_torch.io import mtx as tmtx

from conftest import random_coo


def _write(path, kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "synth":
        r, c, v = j_synth_banded(700, nnz_per_row=7, seed=seed).to_numpy()
        jmtx.write_mtx(path, r, c, np.asarray(v, np.float64), (700, 700))
    elif kind == "random":
        r, c, v = random_coo(rng, 300, 450, 4000)
        jmtx.write_mtx(path, r, c, v, (300, 450))
    elif kind == "integer":
        r, c, _ = random_coo(rng, 200, 150, 1500)
        jmtx.write_mtx(path, r, c, rng.randint(-50, 50, len(r)), (200, 150))
    elif kind == "pattern":
        r, c, _ = random_coo(rng, 250, 250, 2000)
        jmtx.write_mtx(path, r, c, None, (250, 250))
    elif kind == "symmetric":
        r, c, v = random_coo(rng, 300, 300, 3000)
        lo = r >= c
        jmtx.write_mtx(path, r[lo], c[lo], v[lo], (300, 300),
                       symmetry="symmetric")
    elif kind == "skew":
        r, c, v = random_coo(rng, 200, 200, 2000)
        lo = r > c
        jmtx.write_mtx(path, r[lo], c[lo], v[lo], (200, 200),
                       symmetry="skew-symmetric")
    else:
        raise AssertionError(kind)


KINDS = ["synth", "random", "integer", "pattern", "symmetric", "skew"]


def _assert_raw_equal(a, b):
    ta, ma, na, ra, ca, va = a
    tb, mb, nb, rb, cb, vb = b
    assert str(ta) == str(tb)
    assert (ma, na) == (mb, nb)
    for x, y in ((ra, rb), (ca, cb)):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    assert va.dtype == vb.dtype
    assert va.tobytes() == vb.tobytes()  # bit for bit


@pytest.mark.parametrize("kind", KINDS)
def test_raw_triplets_match_native_reader(tmp_path, kind):
    if not jnative.native_available():
        pytest.fail("the JAX package's native reader is not built")
    path = str(tmp_path / f"{kind}.mtx")
    _write(path, kind, seed=KINDS.index(kind))
    _assert_raw_equal(tmtx.read_mtx_raw(path),
                      jnative.read_mtx_raw_native(path))


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_raw_triplets_match_python_reader(tmp_path, kind, gz):
    path = str(tmp_path / f"{kind}.mtx{'.gz' if gz else ''}")
    _write(path, kind, seed=10 + KINDS.index(kind))
    _assert_raw_equal(tmtx.read_mtx_raw(path), jmtx.read_mtx_raw(path))


@pytest.mark.parametrize("expand", [False, True])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_read_mtx_coo_matches(tmp_path, kind, use_native, expand):
    path = str(tmp_path / f"{kind}.mtx")
    _write(path, kind, seed=20 + KINDS.index(kind))
    j = jmtx.read_mtx(path, expand_symmetry=expand, use_native=use_native)
    t = tmtx.read_mtx(path, expand_symmetry=expand, device="cpu")
    assert t.shape == j.shape and t.nnz == j.nnz
    assert str(t.typecode) == str(j.typecode)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    for a, b in zip(t.to_numpy(), j.to_numpy()):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.tobytes() == np.asarray(b).tobytes()


def test_read_mtx_bfloat16_values_round_like_jax(tmp_path):
    import jax.numpy as jnp

    path = str(tmp_path / "r.mtx")
    _write(path, "random", seed=3)
    j = jmtx.read_mtx(path, dtype=jnp.bfloat16)
    t = tmtx.read_mtx(path, dtype=torch.bfloat16, device="cpu")
    assert t.dtype == torch.bfloat16
    jv = np.asarray(j.to_numpy()[2]).astype(np.float32)
    np.testing.assert_array_equal(t.to_numpy()[2], jv)


def test_array_format_matches(tmp_path):
    path = str(tmp_path / "dense.mtx")
    dense = np.random.RandomState(5).randn(13, 9)
    jmtx.write_mtx_array(path, dense)
    _assert_raw_equal(tmtx.read_mtx_raw(path), jmtx.read_mtx_raw(path))


@pytest.mark.parametrize("gz", [False, True])
def test_empty_file_raises_premature_eof(tmp_path, gz):
    path = tmp_path / f"empty.mtx{'.gz' if gz else ''}"
    if gz:
        import gzip

        with gzip.open(path, "wb"):
            pass
    else:
        path.write_bytes(b"")
    # the native reader (plain paths) words it as the JAX native reader
    # does; the Python reader (.gz) as the JAX Python reader does
    with pytest.raises(tmtx.MTXPrematureEOF,
                       match="empty file" if gz else "truncated header"):
        tmtx.read_mtx(str(path), device="cpu")
    with pytest.raises(tmtx.MTXPrematureEOF, match="empty file"):
        tmtx.read_mtx(str(path), device="cpu", use_native=False)
    with pytest.raises(jmtx.MTXPrematureEOF):
        jmtx.read_mtx(str(path))


def test_typed_errors_match(tmp_path):
    cases = {
        "nobanner.mtx": "1 1 1\n1 1 1.0\n",
        "short.mtx": "%%MatrixMarket matrix coordinate real general\n"
                     "3 3 4\n1 1 1.0\n",
        "vector.mtx": "%%MatrixMarket vector coordinate real general\n",
        "oob.mtx": "%%MatrixMarket matrix coordinate real general\n"
                   "2 2 1\n3 1 1.0\n",
    }
    for name, text in cases.items():
        p = tmp_path / name
        p.write_text(text)
        with pytest.raises(jmtx.MTXError) as je:
            jmtx.read_mtx_raw(str(p))
        with pytest.raises(tmtx.MTXError) as te:
            tmtx.read_mtx_raw(str(p))
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)


def test_complex_needs_complex_dtype(tmp_path):
    path = str(tmp_path / "c.mtx")
    jmtx.write_mtx(path, np.array([0, 1]), np.array([1, 0]),
                   np.array([1 + 2j, -3j]), (2, 2))
    coo = tmtx.read_mtx(path, device="cpu")
    assert coo.dtype == torch.complex64
    np.testing.assert_array_equal(coo.to_numpy()[2],
                                  np.array([1 + 2j, -3j], np.complex64))
    with pytest.raises(tmtx.MTXUnsupportedType, match="complex"):
        tmtx.read_mtx(path, dtype=torch.float32, device="cpu")


def test_port_writer_matches_jax_writer(tmp_path):
    rng = np.random.RandomState(8)
    r, c, v = random_coo(rng, 40, 30, 200)
    for field_vals in (v, None, rng.randint(0, 9, len(r))):
        a, b = tmp_path / "a.mtx", tmp_path / "b.mtx"
        jmtx.write_mtx(str(a), r, c, field_vals, (40, 30), comment="x\ny")
        tmtx.write_mtx(str(b), r, c, field_vals, (40, 30), comment="x\ny")
        assert a.read_bytes() == b.read_bytes()
