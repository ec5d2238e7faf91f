"""The slice as a whole: the port's CLI against the JAX CLI.

Both run ``-c -n 2`` (and ``-t -n 2``) on ``synth:4096:40960``; the JAX
CLI on its Pallas SELL kernels (interpret mode on the CPU, autotune pinned
off so both plan at chunk 2048), the port with ``--device cpu`` (the
kernels' plain versions). The report vectors agree to 1e-6 of max |y|
(plus one unit in the sixth significant digit the report prints), and the
report layouts are the same line for line apart from the header name,
timings and the device-metrics block. Also ``-c -t --decode-check``
against a float64 oracle, and the error probes' exit codes.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu import cli as jcli
from smvp_toolkit_tpu.bench.harness import TimingStats as JStats
from smvp_toolkit_tpu.bench.report import generate_report_text as j_report
from smvp_toolkit_tpu.io.mtx import write_mtx
from smvp_toolkit_tpu.ops import spmv_pallas as jsp
from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch.bench.harness import TimingStats as TStats
from smvp_toolkit_tpu_torch.bench.report import generate_report_text as t_report

SPEC = "synth:4096:40960"
TIMING = ("Total Time:", "Average Time:", "Fastest Time:",
          "Slowest Time:", "Time StDev:")


def _report(tmp, alg="CSR"):
    (path,) = glob.glob(os.path.join(tmp, f"smvp-toolbox_report_{alg}_*.txt"))
    with open(path) as f:
        return f.read().splitlines()


def _vector(lines):
    i = lines.index("[")
    return np.array([float(t) for t in lines[i + 1:lines.index("]", i)]])


def _layout(lines):
    """The report with the header name, timings and device block masked."""
    out, in_device = [], False
    for ln in lines:
        if ln.startswith("Execution results for"):
            ln = ln.replace("smvp-toolkit-tpu-torch", "smvp-toolkit-tpu")
        if ln == "Device metrics:":
            in_device = True
        elif in_device and not ln:
            in_device = False
        if in_device and ln != "Device metrics:":
            ln = ln.split(":", 1)[0] + ": <device>"
        elif ln.startswith("Generated on"):
            ln = "Generated on <unix time>"
        elif ln.startswith(TIMING):
            ln = ln.split(":", 1)[0] + ": <time>"
        out.append(ln)
    return out


def _close(a, b):
    """|a - b| within 1e-6 of max |b| plus one unit in the last %g digit."""
    ulp6 = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(b), 1e-30))) - 5)
    return bool(np.all(np.abs(a - b) <= 1e-6 * np.abs(b).max() + ulp6))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on the same spec, for each x mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SMVP_SELL_AUTOTUNE", "0")
    out = {}
    try:
        for xmode in ("ones", "random:5"):
            tj = str(tmp_path_factory.mktemp("jax"))
            tt = str(tmp_path_factory.mktemp("torch"))
            assert jcli.main(["-c", "-n", "2", "--kernel", "pallas", "-d", tj,
                              "--x", xmode, SPEC]) == 0
            assert tcli.main(["-c", "-n", "2", "--device", "cpu", "-d", tt,
                              "--x", xmode, "--json-out",
                              os.path.join(tt, "r.jsonl"), SPEC]) == 0
            out[xmode] = (_report(tj), _report(tt), tt)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("xmode", ["ones", "random:5"])
def test_report_vectors_agree(runs, xmode):
    j, t, _ = runs[xmode]
    yj, yt = _vector(j), _vector(t)
    assert yt.shape == yj.shape == (4096,)
    assert _close(yt, yj)


@pytest.mark.parametrize("xmode", ["ones", "random:5"])
def test_report_layout_line_for_line(runs, xmode):
    j, t, _ = runs[xmode]
    i = t.index("Output vector (one cell per line):")
    assert _layout(t)[:i] == _layout(j)[:i]
    assert len(t) == len(j) and t[i:i + 2] == j[i:i + 2] and t[-1] == j[-1]
    assert t[0] == ("Execution results for smvp-toolkit-tpu-torch v.0.1.0, "
                    "CSR algorithm")
    assert "Device: cpu (cpu)" in t and "Kernel: sell-plain" in t


def test_json_record(runs):
    _, _, tt = runs["ones"]
    with open(os.path.join(tt, "r.jsonl")) as f:
        rec = json.loads(f.readline())
    assert rec["alg"] == "CSR" and rec["nnz"] == 39378
    assert rec["kernel"] == "sell-plain" and rec["device"] == "cpu (cpu)"
    assert rec["iterations"] == 2 and not rec["per_launch_stats"]


@pytest.mark.parametrize("per_launch", [False, True])
def test_generate_report_text_byte_identical(per_launch):
    times = np.array([0.25, 0.5, 0.125, 1.0 / 3.0])
    y = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    kw = dict(alg_name="CSR", input_file="m.mtx", nnz=1234, iterations=4,
              output_vector=y, unix_time=1700000000,
              extra_metrics={"Device": "cpu (cpu)", "Kernel": "k"})
    a = t_report(stats=TStats(times, 4, per_launch), **kw)
    b = j_report(stats=JStats(times, 4, per_launch), **kw)
    assert a == b.replace("smvp-toolkit-tpu v.", "smvp-toolkit-tpu-torch v.",
                          1)


@pytest.mark.parametrize("extra", [[], ["--fused"], ["--kernel", "torch"],
                                   ["--dtype", "bfloat16"]])
def test_cli_paths_agree_with_oracle(tmp_path, extra):
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    rc = tcli.main(["-c", "-n", "2", "--device", "cpu", "-d", str(tmp_path),
                    "--x", "random:2", *extra, SPEC])
    assert rc == 0
    y = _vector(_report(str(tmp_path)))
    bf16 = "bfloat16" in extra
    dt = torch.bfloat16 if bf16 else torch.float32
    r, c, v = parse_synth_spec(SPEC, dtype=dt, device="cpu").to_numpy()
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    ref = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(4096, 4096))
    ref = ref @ x.astype(np.float64)
    assert _close(y, ref)


def test_error_probes(tmp_path):
    empty = tmp_path / "empty.mtx"
    empty.write_bytes(b"")
    base = ["--device", "cpu"]
    assert tcli.main(["-c", "-n", "0", *base, SPEC]) == 2
    assert tcli.main(["-c", "-n", "1", "-d", "/nope", *base, SPEC]) == 2
    assert tcli.main(["-c", "-n", "1", *base, "/no/such/file.mtx"]) == 1
    assert tcli.main(["-c", "-n", "1", *base, str(empty)]) == 1
    assert tcli.main(["-n", "1", *base, SPEC]) == 2  # no algorithm
    assert tcli.main(["-t", "-n", "1", "--no-report", *base, SPEC]) == 0
    assert tcli.main(["-c", "-n", "1", *base, "synth:bad"]) == 2
    assert tcli.main(["-c", "-n", "1", "--x", "bogus", *base, SPEC]) == 2
    assert tcli.main(["-c", "-n", "1", "--x", "random:q", *base, SPEC]) == 2
    assert tcli.main(["-c", "--fused", "--kernel", "torch", *base,
                      SPEC]) == 2
    # -a with -c is refused as the JAX CLI refuses it; -g and the JAX
    # kernel names are ported (tests/test_torch_cli_cisr.py), and so are
    # --eigs (tests/test_torch_cli_solve.py), --profile and --export-aot
    # (tests/test_torch_frontends.py, tests/test_torch_aot.py)
    assert tcli.main(["-c", "-a", *base, SPEC]) == 2
    assert jcli.main(["-c", "-a", SPEC]) == 2
    assert tcli.main(["-c", "-g", "-n", "1", "--no-report", "--kernel",
                      "pallas", *base, SPEC]) == 0
    assert tcli.main(["-g", "--export-aot", "p", *base, SPEC]) == 2
    # --shards is ported: more shards than ranks exits 1, a count below 1
    # exits 2, as in the JAX CLI (tests/test_torch_dist.py)
    assert tcli.main(["-c", "--shards", "2", *base, SPEC]) == 1
    assert tcli.main(["-c", "--shards", "0", *base, SPEC]) == 2
    # the JAX CLI gives the same codes for the probes both have
    assert jcli.main(["-c", "-n", "0", SPEC]) == 2
    assert jcli.main(["-c", "-n", "1", "-d", "/nope", SPEC]) == 2
    assert jcli.main(["-c", "-n", "1", "/no/such/file.mtx"]) == 1
    assert jcli.main(["-c", "-n", "1", str(empty)]) == 1


def test_complex_matrix_refused(tmp_path):
    """A complex matrix runs (complex64, the plain PyTorch SpMVs); what
    the JAX CLI refuses on it, and only that, still exits 2
    (tests/test_torch_complex.py holds the results to the JAX CLI's)."""
    path = str(tmp_path / "c.mtx")
    write_mtx(path, np.array([0, 1]), np.array([1, 0]),
              np.array([1 + 2j, -3j]), (2, 2))
    base = ["-c", "-n", "1", "--device", "cpu", "--no-report"]
    assert tcli.main([*base, "-t", path]) == 0
    for refused in (["--eigs", "1"], ["--solve", "chebyshev"],
                    ["--solve", "cg-fused"], ["--solve", "pcg-amg"],
                    ["--solve", "gmres-ilu"]):
        assert tcli.main([*base, *refused, path]) == 2
        assert tcli._complex_refusal(tcli.build_parser().parse_args(
            [*base, *refused, path]))
    for method in tcli.COMPLEX_METHODS:
        assert tcli._complex_refusal(tcli.build_parser().parse_args(
            [*base, "--solve", method, path])) is None


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main(["-c", "-n", "1", "--no-report", SPEC]) == 1


@pytest.fixture(scope="module")
def tjds_runs(tmp_path_factory):
    """Both CLIs with ``-t --decode-check`` on the same spec."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SMVP_SELL_AUTOTUNE", "0")
    try:
        tj = str(tmp_path_factory.mktemp("jax_t"))
        tt = str(tmp_path_factory.mktemp("torch_t"))
        assert jcli.main(["-t", "-n", "2", "--kernel", "pallas", "-d", tj,
                          "--decode-check", "--x", "random:5", SPEC]) == 0
        assert tcli.main(["-t", "-n", "2", "--device", "cpu", "-d", tt,
                          "--decode-check", "--x", "random:5", "--json-out",
                          os.path.join(tt, "r.jsonl"), SPEC]) == 0
    finally:
        mp.undo()
    return _report(tj, "TJDS"), _report(tt, "TJDS"), tt


def test_tjds_report_matches_jax_cli(tjds_runs):
    j, t, tt = tjds_runs
    assert _close(_vector(t), _vector(j))
    i = t.index("Output vector (one cell per line):")
    assert _layout(t)[:i] == _layout(j)[:i]
    assert t[0] == ("Execution results for smvp-toolkit-tpu-torch v.0.1.0, "
                    "TJDS algorithm")
    with open(os.path.join(tt, "r.jsonl")) as f:
        rec = json.loads(f.readline())
    assert rec["alg"] == "TJDS" and rec["nnz"] == 39378
    assert rec["kernel"] == "sell-plain"


def _oracle(bf16, seed):
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    dt = torch.bfloat16 if bf16 else torch.float32
    r, c, v = parse_synth_spec(SPEC, dtype=dt, device="cpu").to_numpy()
    x = np.random.default_rng(seed).standard_normal(4096).astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    ref = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(4096, 4096))
    return ref @ x.astype(np.float64)


@pytest.mark.parametrize("extra", [[], ["--fused"], ["--kernel", "torch"],
                                   ["--dtype", "bfloat16", "--fused"]])
def test_csr_and_tjds_together_agree_with_oracle(tmp_path, extra, capsys):
    rc = tcli.main(["-c", "-t", "-n", "2", "--device", "cpu", "--decode-check",
                    "-d", str(tmp_path), "--x", "random:3", *extra, SPEC])
    assert rc == 0
    out = capsys.readouterr().out
    assert "CSR decode round-trip: bit-exact" in out
    assert "TJDS decode round-trip: bit-exact" in out
    ref = _oracle("--dtype" in extra, 3)
    y_c = _vector(_report(str(tmp_path), "CSR"))
    y_t = _vector(_report(str(tmp_path), "TJDS"))
    assert _close(y_c, ref) and _close(y_t, ref)


def test_decode_check_failure_exits_3(monkeypatch, capsys):
    import dataclasses

    from smvp_toolkit_tpu_torch.formats import tjds as ttjds

    real = ttjds.tjds_decode

    def corrupt(tj):
        coo = real(tj)
        return dataclasses.replace(coo, vals=coo.vals * 2)

    monkeypatch.setattr(ttjds, "tjds_decode", corrupt)
    assert tcli.main(["-t", "-n", "1", "--device", "cpu", "--no-report",
                      "--decode-check", SPEC]) == 3
    assert "TJDS decode round-trip FAILED" in capsys.readouterr().err


# -- --solve and --expand-symmetry ------------------------------------------


@pytest.fixture(scope="module")
def spd_file(tmp_path_factory):
    """2-D Poisson 20² stored as its lower triangle (symmetric .mtx)."""
    import scipy.sparse as sp

    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (20, 20))
    a = sp.tril(sp.kron(sp.eye(20), t) + sp.kron(t, sp.eye(20))).tocoo()
    path = str(tmp_path_factory.mktemp("spd") / "poisson20.mtx")
    write_mtx(path, a.row, a.col, a.data, a.shape, symmetry="symmetric")
    return path


def _solve(tmp_path, path, spec, *extra):
    out = str(tmp_path / "run.jsonl")
    rc = tcli.main(["-c", "-n", "2", "-d", str(tmp_path), "--device", "cpu",
                    "--expand-symmetry", "--x", "random:1", "--json-out", out,
                    "--solve", spec, *extra, path])
    recs = [json.loads(ln) for ln in open(out)] if os.path.exists(out) else []
    return rc, recs


@pytest.mark.parametrize("method", tcli.SOLVE_METHODS)
def test_solve_methods_on_cpu(tmp_path, spd_file, method, capsys):
    rc, recs = _solve(tmp_path, spd_file, f"{method}:150")
    assert rc == 0
    (rec,) = [r for r in recs if r["alg"].startswith("SOLVE")]
    assert rec["alg"] == f"SOLVE-{method.upper()}"
    assert set(rec) == {"alg", "file", "iterations", "wall_ms",
                        "relative_residual", "device"}
    # GMRES runs whole restarts of 20: 150 rounds up to 160
    want = 160 if method.startswith("gmres") else 150
    assert rec["iterations"] == want and rec["device"] == "cpu (cpu)"
    # Chebyshev's interval has a 0.3x lower cushion: it converges slower
    assert rec["relative_residual"] <= (1e-2 if "cheb" in method else 1e-4)
    lines = _report(str(tmp_path), f"SOLVE-{method.upper()}")
    assert len(_vector(lines)) == 400
    assert f"SOLVE {method}: {want} iterations" in capsys.readouterr().out


def test_solve_matches_jax_cli(tmp_path, spd_file):
    """cg:20 through both CLIs (short of convergence, so the residual is
    not float32 noise): the same relative residual to 1e-3 and the same
    solution vector to 1e-4 of its max (the reports' 6 digits)."""
    (tmp_path / "port").mkdir()
    rc, recs = _solve(tmp_path / "port", spd_file, "cg:20")
    assert rc == 0
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jout = str(jdir / "run.jsonl")
    assert jcli.main(["-c", "-n", "2", "-d", str(jdir), "--expand-symmetry",
                      "--x", "random:1", "--json-out", jout, "--solve",
                      "cg:20", spd_file]) == 0
    jrec = [json.loads(ln) for ln in open(jout)][-1]
    trec = recs[-1]
    assert jrec["alg"] == trec["alg"] == "SOLVE-CG"
    assert jrec["iterations"] == trec["iterations"] == 20
    assert abs(trec["relative_residual"] - jrec["relative_residual"]) <= (
        1e-3 * jrec["relative_residual"])
    xt = _vector(_report(str(tmp_path / "port"), "SOLVE-CG"))
    xj = _vector(_report(str(jdir), "SOLVE-CG"))
    assert np.abs(xt - xj).max() <= 1e-4 * np.abs(xj).max()


def test_expand_symmetry_reads_the_full_matrix(tmp_path, spd_file, capsys):
    assert tcli.main(["-c", "-n", "1", "--no-report", "--device", "cpu",
                      "--expand-symmetry", spd_file]) == 0
    assert "400x400 matrix, 1920 non-zeros (matrix coordinate real " \
        "general)" in capsys.readouterr().out
    assert tcli.main(["-c", "-n", "1", "--no-report", "--device", "cpu",
                      spd_file]) == 0
    assert "400x400 matrix, 1160 non-zeros" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["-t", "--solve", "cg"],
    ["-c", "--solve", "sor"],
    ["-c", "--eigs", "2:x"],
    ["-t", "--eigs", "2"],
    ["-c", "--solve", "cg:x"],
    ["-c", "--solve", "cg:0"],
    ["-c", "--solve", "cg:10:2"],
    ["-c", "--solve", "cg:10:1e-6:3"],
])
def test_solve_validation_exit_2(spd_file, argv, capsys):
    assert tcli.main(argv + ["--device", "cpu", "--no-report", spd_file]) == 2
    err = capsys.readouterr()
    text = err.out + err.err
    assert "not ported yet" not in text
    if "--eigs" in argv:  # the JAX CLI's --eigs checks
        assert ("bad --eigs spec" in text if "-c" in argv
                else "--eigs requires the CSR algorithm" in text)


def test_solve_non_square_exits_2(tmp_path, capsys):
    path = str(tmp_path / "rect.mtx")
    write_mtx(path, np.array([0, 1]), np.array([0, 2]), np.array([1.0, 2.0]),
              (2, 3))
    assert tcli.main(["-c", "-n", "1", "--no-report", "--device", "cpu",
                      "--solve", "cg", path]) == 2
    out = capsys.readouterr()
    assert "square" in out.out + out.err


@pytest.mark.parametrize("method", ["cg-fused", "pcg-ic0-fused",
                                    "chebyshev-fused"])
def test_fused_methods_report_their_count_with_a_tolerance(
        tmp_path, spd_file, method, capsys):
    """The JAX CLI reads a fused method's one-entry residual as a history
    and reports 1 iteration; the port reports the count it ran."""
    rc, recs = _solve(tmp_path, spd_file, f"{method}:40:1e-6")
    assert rc == 0 and recs[-1]["iterations"] == 40
    assert f"SOLVE {method}: 40 iterations" in capsys.readouterr().out


def test_tolerance_reports_the_achieved_count(tmp_path, spd_file):
    rc, recs = _solve(tmp_path, spd_file, "cg:300:1e-5")
    assert rc == 0 and 10 < recs[-1]["iterations"] < 300


def test_solve_out_writes_the_solution(tmp_path, spd_file):
    import scipy.sparse as sp

    out = tmp_path / "out"
    out.mkdir()
    rc, recs = _solve(tmp_path, spd_file, "pcg-ic0:60", "--out-dir",
                      str(out))
    x = np.load(out / "solve.npy")
    assert rc == 0 and x.shape == (400,) and x.dtype == np.float32
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (20, 20))
    a = sp.kron(sp.eye(20), t) + sp.kron(t, sp.eye(20))
    b = np.random.default_rng(1).standard_normal(400).astype(np.float32)
    r = b - a @ x.astype(np.float64)
    assert abs(np.linalg.norm(r) / np.linalg.norm(b)
               - recs[-1]["relative_residual"]) <= 1e-6
    assert sorted(os.listdir(out)) == ["solve.npy", "y.npy"]


def test_ic0_failure_exits_2(tmp_path, spd_file, monkeypatch, capsys):
    from smvp_toolkit_tpu_torch.ops import ilu

    def broken(csr, **kw):
        raise ValueError("ic0: factorization kept breaking down")

    monkeypatch.setattr(ilu, "ic0", broken)
    rc, _ = _solve(tmp_path, spd_file, "pcg-ic0-fused:5")
    assert rc == 2
    out = capsys.readouterr()
    assert "kept breaking down" in out.out + out.err


# -- --kernel df64 and the packed bf16 route ---------------------------------


def _within_one_ulp(y, ref):
    """Each float32 y within one float32 ulp of the float64 oracle rounded
    to float32."""
    r32 = ref.astype(np.float32)
    return np.abs(y.astype(np.float64) - r32.astype(np.float64)) <= \
        np.spacing(np.abs(r32)).astype(np.float64)


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("mode", ["call", "fused", "xla"])
def test_df64_csr_within_one_ulp(tmp_path, mode, monkeypatch):
    if mode == "xla":
        monkeypatch.setenv("SMVP_DF64_XLA", "1")
    jp = str(tmp_path / "r.jsonl")
    extra = ["--fused"] if mode == "fused" else []
    assert tcli.main(["-c", "-t", "-n", "2", "--device", "cpu",
                      "--kernel", "df64", "--x", "random:1", "--no-report",
                      "--json-out", jp, "--out-dir", str(tmp_path), *extra,
                      SPEC]) == 0
    y = np.load(tmp_path / "y.npy")
    assert y.dtype == np.float32 and y.shape == (4096,)
    assert _within_one_ulp(y, _oracle(False, 1)).all()
    csr, tjds = _records(jp)
    assert csr["kernel"] == ("df64-torch" if mode == "xla" else "df64-plain")
    assert tjds["alg"] == "TJDS" and tjds["kernel"] == "sell-plain"
    if mode != "xla":  # the record's bytes: SellDf64SpMV.traffic_bytes()
        from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV
        from smvp_toolkit_tpu_torch.ops.spmv_sell import (
            _triplets_from_csr_host,
        )
        from smvp_toolkit_tpu_torch.formats.csr import csr_encode
        from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

        r, c, v, shape = _triplets_from_csr_host(csr_encode(
            parse_synth_spec(SPEC, device="cpu").pad(128)))
        nb = SellDf64SpMV.from_coo_f64(r, c, v, shape,
                                       device="cpu").traffic_bytes()
        assert np.isclose(csr["eff_gb_s"], nb / (csr["avg_ms"] * 1e-3) / 1e9)


def test_df64_logs_tjds_fallback_and_float32_control(tmp_path, capsys):
    assert tcli.main(["-c", "-t", "-n", "1", "--device", "cpu", "--kernel",
                      "df64", "--no-report", "--x", "random:1", SPEC]) == 0
    out = capsys.readouterr().out
    assert "df64 is CSR-only; TJDS runs its ordinary SELL kernel." in out
    assert "Benchmarking TJDS SpMV (sell-plain kernel)" in out
    assert "Benchmarking CSR SpMV (df64-plain kernel)" in out
    # the float32 path misses the one-ulp check on some rows
    assert tcli.main(["-c", "-n", "1", "--device", "cpu", "--no-report",
                      "--x", "random:1", "--out-dir", str(tmp_path),
                      SPEC]) == 0
    assert not _within_one_ulp(np.load(tmp_path / "y.npy"),
                               _oracle(False, 1)).all()


def test_df64_spmm_runs_on_spmm_csr(tmp_path, capsys):
    jp = str(tmp_path / "r.jsonl")
    for extra in ([], ["--fused"]):
        assert tcli.main(["-c", "-n", "2", "--device", "cpu", "--kernel",
                          "df64", "--spmm", "3", "--no-report", "--json-out",
                          jp, *extra, SPEC]) == 0
    out = capsys.readouterr().out
    assert out.count("--spmm runs on the plain-PyTorch kernel (no df64 "
                     "SpMM variant).") == 2
    spmm = [r for r in _records(jp) if r["alg"] == "SPMM-CSR"]
    assert [r["kernel"] for r in spmm] == ["torch", "torch"]
    assert spmm[1]["timing"] == "N calls between one pair of events"


def test_out_dir_needs_csr_and_a_directory(tmp_path):
    assert tcli.main(["-t", "-n", "1", "--device", "cpu", "--out-dir",
                      str(tmp_path), SPEC]) == 2
    assert tcli.main(["-c", "-n", "1", "--device", "cpu", "--out-dir",
                      str(tmp_path / "nope"), SPEC]) == 2
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("fused", [False, True])
def test_packed_bf16_agrees_with_oracle(tmp_path, fused, monkeypatch):
    from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    calls = []
    for name in ("sell_packed_plain", "sell_bench_packed_plain"):
        fn = getattr(tsp, name)
        monkeypatch.setattr(tsp, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    assert tcli.main(["-c", "-n", "2", "--device", "cpu", "--dtype",
                      "bfloat16", "--no-report", "--x", "random:2",
                      "--out-dir", str(tmp_path),
                      *(["--fused"] if fused else []), SPEC]) == 0
    # the N-iteration plain version repeats the forward one
    assert ("sell_bench_packed_plain" in calls) == fused
    assert "sell_packed_plain" in calls
    assert _close(np.load(tmp_path / "y.npy"), _oracle(True, 2))


def test_packed_fused_on_a_streamed_plan_fails(monkeypatch, capsys):
    from smvp_toolkit_tpu_torch.ops import spmv_sell as tsp

    monkeypatch.setenv("SMVP_SELL_PACK", "1")
    # a 2048-row y cut makes the small spec's plan streamed
    monkeypatch.setattr(tsp, "_RESIDENT_Y_LIMIT", 2048 * 4)
    monkeypatch.setattr(tsp, "_STREAM_Y_BLOCK_ROWS", 2048)
    argv = ["-c", "-n", "1", "--device", "cpu", "--dtype", "bfloat16",
            "--no-report", SPEC]
    assert tcli.main(argv) == 0  # per call: K5 on streamed y
    assert tcli.main(argv + ["--fused"]) == 2
    err = capsys.readouterr().err
    assert "streamed-y bench_loop supports relsl/split-plane modes" in err


# -- --cocluster and --analyze ---------------------------------------------


def _oracle_y(bf16=False, seed=2):
    import scipy.sparse as sp

    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    dt = torch.bfloat16 if bf16 else torch.float32
    r, c, v = parse_synth_spec(SPEC, dtype=dt, device="cpu").to_numpy()
    x = np.random.default_rng(seed).standard_normal(4096).astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(4096, 4096))
    return a @ x.astype(np.float64)


@pytest.mark.parametrize("extra", [[], ["--fused"], ["--dtype", "bfloat16"],
                                   ["--fused", "--dtype", "bfloat16"]])
def test_cocluster_runs_agree_with_oracle(tmp_path, extra, capsys):
    rc = tcli.main(["-c", "-t", "-n", "2", "--device", "cpu", "-d",
                    str(tmp_path), "--x", "random:2", "--cocluster",
                    "--json-out", str(tmp_path / "r.jsonl"), *extra, SPEC])
    assert rc == 0
    out = capsys.readouterr().out
    # the plan at the chunk the card's autotuner picks (cocluster_plan's
    # chunk=None), on the CSR's triplets as the CLI plans them
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.ops.cocluster import cocluster_plan
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _triplets_from_csr_host
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    bf16 = "bfloat16" in extra
    csr = csr_encode(parse_synth_spec(
        SPEC, dtype=torch.bfloat16 if bf16 else torch.float32, device="cpu"))
    chunk = cocluster_plan(*_triplets_from_csr_host(csr), bf16=bf16)[1].chunk
    assert "co-clustered plan: occupancy" in out and f"(chunk {chunk};" in out
    ref = _oracle_y("bfloat16" in extra)
    for alg in ("CSR", "TJDS"):
        assert _close(_vector(_report(str(tmp_path), alg)), ref)
    with open(tmp_path / "r.jsonl") as f:
        kernels = [json.loads(ln)["kernel"] for ln in f]
    assert kernels == ["sell-plain-cocluster", "sell-plain"]


def test_cocluster_report_agrees_with_jax_cli(tmp_path):
    tj, tt = tmp_path / "jax", tmp_path / "torch"
    tj.mkdir()
    tt.mkdir()
    assert jcli.main(["-c", "-n", "2", "--kernel", "pallas", "--cocluster",
                      "-d", str(tj), "--x", "random:5", SPEC]) == 0
    assert tcli.main(["-c", "-n", "2", "--device", "cpu", "--cocluster",
                      "-d", str(tt), "--x", "random:5", SPEC]) == 0
    assert _close(_vector(_report(str(tt))), _vector(_report(str(tj))))


def test_cocluster_ignored_off_the_sell_kernels(tmp_path, capsys):
    assert tcli.main(["-c", "-n", "1", "--device", "cpu", "--no-report",
                      "--kernel", "torch", "--cocluster", SPEC]) == 0
    out = capsys.readouterr().out
    assert "ignored on this path" in out and "co-clustered plan" not in out


def _analysis_lines(text):
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines) if "Matrix analysis:" in ln)
    return [ln for ln in lines[i + 1:] if ln.startswith("\t")]


def test_analyze_prints_the_jax_cli_lines(tmp_path, capsys, monkeypatch):
    """The structural lines are the JAX CLI's; the two plan lines describe
    the card's autotuned plan (the JAX CLI's its TPU plan)."""
    assert jcli.main(["-c", "-n", "1", "--kernel", "xla", "--no-report",
                      "--analyze", SPEC]) == 0
    want = _analysis_lines(capsys.readouterr().out)
    assert tcli.main(["-c", "-n", "1", "--device", "cpu", "--no-report",
                      "--analyze", SPEC]) == 0
    got = _analysis_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 6
    plan = [ln for ln in got if ln.startswith("\tSELL")]
    assert [ln for ln in got if ln not in plan] == \
        [ln for ln in want if not ln.startswith("\tSELL")]
    assert len(plan) == 2
    assert plan[0].startswith("\tSELL plan (autotuned for the card): ")
    assert " route relsl" in plan[0] and "VMEM" not in plan[0]
    assert " model " in plan[1] and plan[1].endswith(" us")


def _analysis_matrix(kind):
    from smvp_toolkit_tpu_torch.utils.synth import (
        parse_synth_spec,
        synth_powerlaw,
    )

    if kind == "banded":
        return parse_synth_spec("synth:30000:300000", device="cpu")
    if kind == "powerlaw":
        return synth_powerlaw(20000, 150000, seed=0, device="cpu")
    if kind == "empty-rows":
        from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

        rng = np.random.default_rng(1)
        r = rng.integers(0, 1000, 6000) * 3
        c = rng.integers(0, 5000, 6000)
        return COOMatrix.from_numpy(r, c, rng.standard_normal(6000),
                                    shape=(3100, 5000), device="cpu")
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    e = np.zeros(0, np.int64)
    return COOMatrix.from_numpy(e, e, np.zeros(0), shape=(50, 70),
                                device="cpu")


@pytest.mark.parametrize("autotune", ["1", "0"])
@pytest.mark.parametrize("kind", ["banded", "powerlaw", "empty-rows",
                                  "nnz0"])
def test_analyze_dict_equals_jax(kind, autotune, monkeypatch):
    from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
    from smvp_toolkit_tpu.utils.analyze import analyze as janalyze
    from smvp_toolkit_tpu.utils.analyze import format_analysis as jformat
    from smvp_toolkit_tpu_torch.utils.analyze import analyze, format_analysis

    """The structural statistics equal the JAX dict; the ``sell`` block is
    the card's plan: the JAX planner's at the chunk the card's autotuner
    picks (2048 under ``SMVP_SELL_AUTOTUNE=0``), its route, the port's
    bytes per launch and the model's time."""
    from smvp_toolkit_tpu_torch.interop import plan_fields, plan_from_arrays
    from smvp_toolkit_tpu_torch.ops import autotune as ta

    monkeypatch.setenv("SMVP_SELL_AUTOTUNE", autotune)
    coo = _analysis_matrix(kind)
    r, c, v = coo.to_numpy()
    jcoo = JCOO.from_numpy(r, c, v, shape=coo.shape)
    got, want = analyze(coo), janalyze(jcoo)
    sell, jsell = got.pop("sell", None), want.pop("sell", None)
    assert got == want
    assert (sell is None) == (jsell is None) == (kind == "nnz0")
    if sell is not None:
        pick = ta._tuned_plan(r, c, v, coo.shape, bf16=False)[0].chunk
        assert sell["chunk"] == pick
        if autotune == "0":
            assert pick == jsell["chunk"] and pick <= 2048
        jp = plan_from_arrays(plan_fields(jsp._auto_plan(
            r, c, v, coo.shape, chunk=pick)))
        rates = ta.production_rates()
        assert sell == {
            "sublanes": jp.n_sublanes, "slots": jp.slots(),
            "padding_factor": float(jp.slots() / coo.nnz),
            "window_tiles": jp.window_tiles, "col_tiles": jp.n_coltiles,
            "chunks": jp.n_chunks, "chunk": jp.chunk,
            "route": ta.plan_route(jp),
            "traffic_f32_bytes": ta.plan_bytes(jp, 4),
            "traffic_bf16_bytes": ta.plan_bytes(jp, 2),
            "model_f32_us": ta.plan_cost_us(jp, 4, rates),
            "model_bf16_us": ta.plan_cost_us(jp, 2, rates)}
        got["sell"], want["sell"] = sell, jsell
    lines, jlines = (format_analysis(got).splitlines(),
                     jformat(want).splitlines())
    assert [ln for ln in lines if not ln.startswith("SELL")] == \
        [ln for ln in jlines if not ln.startswith("SELL")]
    assert len(lines) == len(jlines)
