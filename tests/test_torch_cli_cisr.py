"""The reference's full CLI on the port against the JAX CLI.

Both CLIs run ``-a -n 2 --coe-out --lut-out --save-encoded --debug`` on
the same ``.mtx`` file (written with ``write_mtx``: a random matrix with
empty rows), the port with ``--device cpu``. The ``.coe`` and LUT files
and the debug text must be byte-equal, the checkpoints load in both
packages, and the three reports (CSR, TJDS, CISR) agree line for line
apart from the header name, timings and the device block, their vectors
within 1e-6 of max |y|. Also every validation exit code of the new flags,
the ``.coe`` on stdout, the failed export, and the kernel each
``--kernel`` runs CISR on.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os

import numpy as np
import pytest

from smvp_toolkit_tpu import cli as jcli
from smvp_toolkit_tpu.io.mtx import write_mtx
from smvp_toolkit_tpu.utils import checkpoint as jck
from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch.utils import checkpoint as tck

from test_torch_cli import _close, _layout, _report, _vector

N, M, NNZ = 2000, 1500, 12000
ALGS = ("CSR", "TJDS", "CISR")


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    rng = np.random.default_rng(19)
    r = rng.integers(0, N, NNZ)
    c = rng.integers(0, M, NNZ)
    keep = r % 9 != 4  # empty rows
    v = rng.standard_normal(keep.sum()) * 100.0
    path = str(tmp_path_factory.mktemp("mtx") / "rand.mtx")
    write_mtx(path, r[keep], c[keep], v, (N, M))
    return path


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _debug(text):
    return [ln for ln in text.splitlines() if ln.startswith("[DEBUG]")]


@pytest.fixture(scope="module")
def full_runs(mtx, tmp_path_factory):
    """Both CLIs with -a and every export flag."""
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        d = str(tmp_path_factory.mktemp(name))
        argv = ["-a", "-n", "2", "-d", d, "--x", "random:5", "--coe-out",
                os.path.join(d, "x.coe"), "--lut-out",
                os.path.join(d, "x.lut"), "--save-encoded",
                os.path.join(d, "enc"), "--debug", "--json-out",
                os.path.join(d, "r.jsonl"), *extra, mtx]
        rc, stdout, stderr = _run(main, argv)
        assert rc == 0, stdout + stderr
        out[name] = (d, stdout, stderr)
    return out


@pytest.mark.parametrize("name", ["x.coe", "x.lut"])
def test_images_byte_equal(full_runs, name):
    (jd, _, _), (td, _, _) = full_runs["jax"], full_runs["port"]
    with open(os.path.join(jd, name), "rb") as a, \
            open(os.path.join(td, name), "rb") as b:
        ja, tb = a.read(), b.read()
    assert ja == tb and len(ja) > 1000


def test_debug_text_equal(full_runs):
    j, t = _debug(full_runs["jax"][2]), _debug(full_runs["port"][2])
    assert j == t
    assert any("CSR (2000, 1500)" in ln for ln in t)
    assert any("TJDS (2000, 1500)" in ln for ln in t)


@pytest.mark.parametrize("alg", ["csr", "tjds"])
def test_checkpoints_load_in_both_packages(full_runs, alg):
    (jd, _, _), (td, _, _) = full_runs["jax"], full_runs["port"]
    jpath = os.path.join(jd, f"enc_{alg}.npz")
    tpath = os.path.join(td, f"enc_{alg}.npz")
    a = tck.load_matrix(jpath, device="cpu")
    b = tck.load_matrix(tpath, device="cpu")
    c = jck.load_matrix(tpath)
    for f in ("vals", ("row_ptr" if alg == "csr" else "start_pos")):
        x = getattr(a, f).numpy()
        np.testing.assert_array_equal(x, getattr(b, f).numpy())
        np.testing.assert_array_equal(x, np.asarray(getattr(c, f)))


@pytest.mark.parametrize("alg", ALGS)
def test_reports_agree(full_runs, alg):
    j = _report(full_runs["jax"][0], alg)
    t = _report(full_runs["port"][0], alg)
    assert _close(_vector(t), _vector(j))
    i = t.index("Output vector (one cell per line):")
    assert _layout(t)[:i] == _layout(j)[:i]
    assert len(t) == len(j) and t[-1] == j[-1]
    assert t[0].endswith(f"{alg} algorithm")


def test_records_and_log(full_runs):
    d, stdout, _ = full_runs["port"]
    with open(os.path.join(d, "r.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["alg"] for r in recs] == list(ALGS)
    assert all(r["kernel"] == "sell-plain" for r in recs)
    assert "Generating CISR schedule with 16 slots." in stdout
    assert "CISR COE image saved as" in stdout
    assert "TJDS Verilog LUT image saved as" in stdout
    assert "CSR checkpoint:" in stdout and "TJDS checkpoint:" in stdout


@pytest.mark.parametrize("argv", [
    ["-a", "-c"], ["-a", "-t"], ["-a", "-g"], ["-g", "-s", "0"],
    ["-g", "-s", "256"], ["-c", "--lut-out", "x.lut"],
    ["-g", "--lut-out", "x.lut"], ["-g", "--save-encoded", "p"],
    ["-g", "--decode-check"], ["-a", "-n", "0"], [],
])
def test_validation_exit_codes_match_jax(mtx, argv):
    rc_j, _, err_j = _run(jcli.main, argv + ["--no-report", mtx])
    rc_t, _, err_t = _run(tcli.main, argv + ["--no-report", "--device",
                                             "cpu", mtx])
    assert rc_j == rc_t == 2
    assert err_t.strip().splitlines()[-1] == err_j.strip().splitlines()[-1]


def _coe(stdout):
    lines = stdout.splitlines()
    start = lines.index(";*********************************************")
    end = next(i for i, ln in enumerate(lines) if ln == "03ffffffff;")
    return "\n".join(lines[start:end + 1])


@pytest.mark.parametrize("slots", ["1", "7"])
def test_coe_on_stdout_matches_jax(mtx, slots):
    rc_j, out_j, _ = _run(jcli.main, ["-g", "-n", "1", "-s", slots,
                                      "--no-report", mtx])
    rc_t, out_t, _ = _run(tcli.main, ["-g", "-n", "1", "-s", slots,
                                      "--no-report", "--device", "cpu", mtx])
    assert rc_j == rc_t == 0
    assert _coe(out_t) == _coe(out_j)
    assert f"count of: {slots}" in out_t


def test_failed_export_exits_1(tmp_path):
    path = str(tmp_path / "nan.mtx")
    write_mtx(path, np.array([0, 1, 2]), np.array([0, 1, 2]),
              np.array([1.0, np.nan, 3.0]), (3, 3))
    rc_j, _, err_j = _run(jcli.main, ["-g", "-n", "1", "--no-report", path])
    rc_t, _, err_t = _run(tcli.main, ["-g", "-n", "1", "--no-report",
                                      "--device", "cpu", path])
    assert rc_j == rc_t == 1
    assert "COE export failed" in err_j and "COE export failed" in err_t


@pytest.mark.parametrize("kernel,want", [
    ("auto", "sell-plain"), ("pallas", "sell-plain"), ("torch", "torch"),
    ("xla", "torch"), ("df64", "torch"),
])
def test_cisr_kernel_choice(mtx, tmp_path, kernel, want):
    rec = str(tmp_path / "r.jsonl")
    rc, out, err = _run(tcli.main, [
        "-g", "-n", "2", "--kernel", kernel, "--device", "cpu", "-d",
        str(tmp_path), "--x", "random:3", "--json-out", rec, "--coe-out",
        str(tmp_path / "x.coe"), mtx])
    assert rc == 0, out + err
    with open(rec) as f:
        (r,) = [json.loads(ln) for ln in f]
    assert r["alg"] == "CISR" and r["kernel"] == want
    jd = tmp_path / "jax"
    jd.mkdir()
    rc, _, _ = _run(jcli.main, ["-g", "-n", "1", "-d", str(jd), "--x",
                                "random:3", "--coe-out",
                                str(jd / "x.coe"), mtx])
    assert rc == 0
    assert _close(_vector(_report(str(tmp_path), "CISR")),
                  _vector(_report(str(jd), "CISR")))


def test_all_algs_decode_check_covers_cisr(mtx, tmp_path):
    rc, out, _ = _run(tcli.main, ["-a", "-n", "1", "--no-report",
                                  "--decode-check", "--device", "cpu",
                                  "--coe-out", str(tmp_path / "x.coe"), mtx])
    assert rc == 0
    for alg in ALGS:
        assert f"{alg} decode round-trip: bit-exact" in out


def test_cisr_runs_unsharded_under_fused(mtx, tmp_path):
    rec = str(tmp_path / "r.jsonl")
    rc, out, err = _run(tcli.main, [
        "-g", "-n", "3", "--fused", "--device", "cpu", "--no-report",
        "--json-out", rec, "--coe-out", str(tmp_path / "x.coe"), mtx])
    assert rc == 0, out + err
    with open(rec) as f:
        (r,) = [json.loads(ln) for ln in f]
    assert r["kernel"] == "sell-plain" and r["per_launch_stats"]


def test_out_dir_writes_the_cisr_vector(mtx, tmp_path):
    rc, out, err = _run(tcli.main, [
        "-a", "-n", "1", "--device", "cpu", "--no-report", "--x", "random:4",
        "--out-dir", str(tmp_path), "--coe-out", str(tmp_path / "x.coe"),
        mtx])
    assert rc == 0, out + err
    y = np.load(tmp_path / "y.npy")
    yc = np.load(tmp_path / "cisr.npy")
    assert y.dtype == yc.dtype == np.float32 and y.shape == yc.shape == (N,)
    assert np.abs(yc - y).max() <= 1e-6 * np.abs(y).max()
    assert not (tmp_path / "tjds.npy").exists()


def test_reports_are_named_per_algorithm(full_runs):
    d = full_runs["port"][0]
    names = sorted(os.path.basename(p).split("_")[2]
                   for p in glob.glob(os.path.join(d, "smvp-toolbox_*")))
    assert names == sorted(ALGS)
