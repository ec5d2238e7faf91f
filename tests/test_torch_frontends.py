"""The port's profiler (``bench/profile.py`` on ``torch.profiler``, CLI
``--profile``) and interactive front end (``interactive.py``).

``--profile DIR`` on the CPU writes one Chrome trace per format
(``DIR/<ALG>/trace.json``) that names the SpMV's operators, per call and
with ``--fused``; ``profile_fn`` returns its function's result. The
interactive dialog, driven by a scripted stdin, runs the CLI with the
answers (the JAX dialog's questions, then the device), and aborts with 2
on end of input, as the JAX one does.
"""

from __future__ import annotations

import glob
import io
import json
import os

import pytest
import torch

from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch import interactive
from smvp_toolkit_tpu_torch.bench import profile
from smvp_toolkit_tpu_torch.io.mtx import write_mtx
from smvp_toolkit_tpu_torch.utils.synth import synth_banded


def _names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events}


@pytest.mark.parametrize("fused", [False, True], ids=["per-call", "fused"])
def test_cli_profile_writes_traces(tmp_path, fused):
    out = str(tmp_path / "prof")
    args = ["-c", "-t", "-n", "2", "--no-report", "--device", "cpu",
            "--profile", out, "synth:900:4000"]
    assert tcli.main(args + (["--fused"] if fused else [])) == 0
    for alg in ("CSR", "TJDS"):
        (trace,) = glob.glob(os.path.join(out, alg, profile.TRACE_FILE))
        names = _names(trace)
        assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_profile_fn(tmp_path):
    x = torch.arange(4.0)
    y = profile.profile_fn(torch.mul, x, x, log_dir=str(tmp_path),
                           iterations=3)
    assert torch.equal(y, x * x)
    assert "aten::mul" in _names(tmp_path / profile.TRACE_FILE)


@pytest.fixture()
def small_mtx(tmp_path):
    coo = synth_banded(300, nnz_per_row=4, seed=0, device="cpu")
    path = str(tmp_path / "m.mtx")
    write_mtx(path, *coo.to_numpy(), coo.shape)
    return path


def test_interactive_runs_the_cli(tmp_path, small_mtx):
    reports = tmp_path / "reports"
    reports.mkdir()
    stdin = io.StringIO(f"/no/such.mtx\n{small_mtx}\ny\ny\n3\n{reports}\n"
                        "cpu\n")
    stdout = io.StringIO()
    assert interactive.main(stdin=stdin, stdout=stdout) == 0
    text = stdout.getvalue()
    assert "file not found: /no/such.mtx" in text
    assert "Device (cuda/cpu) [cuda]" in text
    names = sorted(p.name.split("_")[2] for p in reports.iterdir())
    assert names == ["CSR", "TJDS"]


@pytest.mark.parametrize("script", ["", "{mtx}\ny\n", "{mtx}\nn\nn\n1\n.\ncpu\n"],
                         ids=["eof-at-file", "eof-midway", "nothing-chosen"])
def test_interactive_aborts(small_mtx, script):
    stdin = io.StringIO(script.format(mtx=small_mtx))
    assert interactive.main(stdin=stdin, stdout=io.StringIO()) == 2
