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
    for flag in (["-a"], ["-g"], ["--kernel", "pallas"], ["--shards", "2"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(["-c", *flag, *base, SPEC])
        assert e.value.code == 2
    # the JAX CLI gives the same codes for the probes both have
    assert jcli.main(["-c", "-n", "0", SPEC]) == 2
    assert jcli.main(["-c", "-n", "1", "-d", "/nope", SPEC]) == 2
    assert jcli.main(["-c", "-n", "1", "/no/such/file.mtx"]) == 1
    assert jcli.main(["-c", "-n", "1", str(empty)]) == 1


def test_complex_matrix_refused(tmp_path):
    path = str(tmp_path / "c.mtx")
    write_mtx(path, np.array([0, 1]), np.array([1, 0]),
              np.array([1 + 2j, -3j]), (2, 2))
    assert tcli.main(["-c", "-n", "1", "--device", "cpu", path]) == 1


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
