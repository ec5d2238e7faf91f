"""The port's native host backend (``ops/spmv_native.py`` over
``csrc/spmv.cpp``) against the JAX package's (``ops/spmv_native.py`` over
its ``native/libspmv.so``).

Both libraries are the same source built with the same flags on the same
host (the port's ``_build.SPMV_CXX_FLAGS`` are the JAX Makefile's), so at
``threads=1`` y agrees bit for bit, for CSR and TJDS, at one iteration and
at several. With 4 threads TJDS sums each row from per-thread partial
sums, which the two libraries also form alike; it is held within 1e-6 of
max |y| (the partial-sum regrouping's bound) and CSR, whose rows are not
split, bit for bit. Then ``bench_native_batched``'s samples, and the CLI:
``-c -t --kernel native`` on one written ``.mtx`` through both CLIs, the
report cells equal at ``%g``.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu import cli as jcli
from smvp_toolkit_tpu.bench.harness import (
    bench_native_batched as j_batched,
)
from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr
from smvp_toolkit_tpu.formats.tjds import tjds_encode as jtjds
from smvp_toolkit_tpu.ops import spmv_native as jn
from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch.bench.harness import bench_native_batched
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
from smvp_toolkit_tpu_torch.io.mtx import write_mtx
from smvp_toolkit_tpu_torch.ops import spmv_native as tn

TOL_THREADS = 1e-6  # of max |y|, TJDS at 4 threads


def _triplets(n=3000, nnz=60000, seed=0):
    """Rows of mixed length (some over 8 entries, so the AVX2 gather path
    runs, some under), duplicates merged."""
    rng = np.random.default_rng(seed)
    r = np.minimum(rng.zipf(1.6, nnz) - 1, n - 1).astype(np.int32)
    c = rng.integers(0, n, nnz).astype(np.int32)
    key = np.unique(r.astype(np.int64) * n + c)
    r, c = (key // n).astype(np.int32), (key % n).astype(np.int32)
    v = rng.standard_normal(len(r)).astype(np.float32)
    return r, c, v, (n, n)


@pytest.fixture(scope="module")
def pair():
    r, c, v, shape = _triplets()
    jc = JCOO.from_numpy(r, c, v, shape=shape, pad_to=128)
    tc = COOMatrix.from_numpy(r, c, v, shape=shape, pad_to=128, device="cpu")
    x = np.random.default_rng(1).standard_normal(shape[1]).astype(np.float32)
    return (jcsr(jc), jtjds(jc)), (csr_encode(tc), tjds_encode(tc)), x


def test_library_builds_here():
    assert tn.native_spmv_available()
    assert jn.native_spmv_available()


@pytest.mark.parametrize("fmt", ["csr", "tjds"])
@pytest.mark.parametrize("iterations", [1, 3])
def test_serial_bit_for_bit(pair, fmt, iterations):
    (jc, jt), (tc, tt), x = pair
    if fmt == "csr":
        jop, top = jn.NativeCsrSpMV(jc, threads=1), tn.NativeCsrSpMV(
            tc, threads=1)
    else:
        jop, top = jn.NativeTjdsSpMV(jt, threads=1), tn.NativeTjdsSpMV(
            tt, threads=1)
    yj = jop(x, iterations=iterations)
    yt = top(torch.from_numpy(x), iterations=iterations)
    assert yt.dtype == np.float32 and yt.shape == yj.shape
    assert yt.tobytes() == yj.tobytes()
    if iterations == 1:  # the one-shot helpers build the default operator
        one = (tn.spmv_csr_native(tc, x) if fmt == "csr"
               else tn.spmv_tjds_native(tt, x))
        assert np.array_equal(one, yj)


@pytest.mark.parametrize("fmt", ["csr", "tjds"])
def test_four_threads(pair, fmt):
    (jc, jt), (tc, tt), x = pair
    cls = {"csr": (jn.NativeCsrSpMV, tn.NativeCsrSpMV, jc, tc),
           "tjds": (jn.NativeTjdsSpMV, tn.NativeTjdsSpMV, jt, tt)}[fmt]
    yj = cls[0](cls[2], threads=4)(x, iterations=2)
    yt = cls[1](cls[3], threads=4)(x, iterations=2)
    if fmt == "csr":
        assert yt.tobytes() == yj.tobytes()
    else:
        assert np.abs(yt - yj).max() <= TOL_THREADS * np.abs(yj).max()
    serial = cls[1](cls[3], threads=1)(x)
    assert np.abs(yt - serial).max() <= TOL_THREADS * np.abs(serial).max()


def test_thread_rule(pair):
    (jc, _), (tc, _), _ = pair
    assert tn.NativeCsrSpMV(tc).threads == jn.NativeCsrSpMV(jc).threads
    assert tn.NativeCsrSpMV(tc, threads=64).threads == 16
    r, c, v, shape = _triplets(n=200, nnz=1000)
    small = csr_encode(COOMatrix.from_numpy(r, c, v, shape=shape,
                                            device="cpu"))
    assert tn.NativeCsrSpMV(small).threads == 1
    with pytest.raises(ValueError, match="x too short"):
        tn.NativeCsrSpMV(small)(np.ones(3, np.float32))


@pytest.mark.parametrize("iterations,repeats", [(100, 8), (5, 8), (1, 1)])
def test_batched_samples(pair, iterations, repeats):
    (jc, _), (tc, _), x = pair
    st = bench_native_batched(tn.NativeCsrSpMV(tc), torch.from_numpy(x),
                              iterations=iterations, repeats=repeats)
    sj = j_batched(jn.NativeCsrSpMV(jc), x, iterations=iterations,
                   repeats=repeats)
    assert st.times_ms.shape == sj.times_ms.shape == (iterations,)
    assert st.iterations == iterations and st.per_launch == sj.per_launch
    assert st.per_launch == (iterations // min(repeats, iterations) > 1)
    assert np.all(st.times_ms > 0)


def _cells(tmp, alg):
    (path,) = glob.glob(os.path.join(tmp, f"smvp-toolbox_report_{alg}_*.txt"))
    with open(path) as f:
        lines = f.read().splitlines()
    i = lines.index("Output vector (one cell per line):")
    return lines[i + 2: lines.index("]", i)], lines


def test_cli_native_report_matches_jax_cli(tmp_path):
    r, c, v, shape = _triplets(n=900, nnz=9000, seed=3)
    path = str(tmp_path / "m.mtx")
    write_mtx(path, r, c, v, shape)
    jd, td = tmp_path / "j", tmp_path / "t"
    jd.mkdir(), td.mkdir()
    common = ["-c", "-t", "-n", "3", "--kernel", "native", "--x", "random:1"]
    assert jcli.main([*common, "-d", str(jd), path]) == 0
    assert tcli.main([*common, "--device", "cpu", "-d", str(td), path]) == 0
    for alg in ("CSR", "TJDS"):
        jcells, _ = _cells(str(jd), alg)
        tcells, tlines = _cells(str(td), alg)
        assert tcells == jcells
        assert "Kernel: native" in tlines
    # --fused batches in the C loop too; --shards has no native variant
    assert tcli.main([*common, "--fused", "--device", "cpu", "--no-report",
                      path]) == 0
