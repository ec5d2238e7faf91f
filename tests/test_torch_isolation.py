"""The port stands alone: no JAX, nothing of the JAX package, no quiet CPU.

(a) No source file of ``smvp_toolkit_tpu_torch`` imports ``jax`` or names
the JAX package. (b) A fresh interpreter imports the port, plans a matrix
and runs the CPU path without ``jax`` or ``smvp_toolkit_tpu`` entering
``sys.modules``. (c) With no CUDA device, every entry point that is not
asked for the CPU raises.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import smvp_toolkit_tpu_torch

PKG = Path(smvp_toolkit_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
SOURCES = sorted(p for p in PKG.rglob("*") if p.suffix in (".py", ".cu",
                                                            ".cuh"))


def test_package_sources_found():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES}
    assert {"cli.py", "interop.py", "io/mtx.py", "ops/spmv_sell.py",
            "formats/tjds.py", "csrc/sell_spmv.cu", "csrc/sell_bench.cu",
            "csrc/sell_common.cuh"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(PKG).as_posix() for p in SOURCES])
def test_no_jax_or_jax_package_reference(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", text, re.M)
    assert not re.search(r"smvp_toolkit_tpu(?!_torch)", text)


_PROBE = r"""
import sys
import numpy as np
import torch
import smvp_toolkit_tpu_torch as port
from smvp_toolkit_tpu_torch.cli import main
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.ops.spmv_sell import spmv_csr_sell
from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

coo = parse_synth_spec("synth:2000:10000", device="cpu").pad(128)
y = spmv_csr_sell(csr_encode(coo), torch.ones(2000))
assert y.shape == (2000,) and bool(torch.isfinite(y).all())
assert main(["-c", "-n", "1", "--no-report", "--device", "cpu",
             "synth:500:2000"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "smvp_toolkit_tpu" or m.startswith("smvp_toolkit_tpu."))
assert not bad, bad
print("ISOLATED", port.__version__)
"""


def test_fresh_interpreter_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_operator_without_device_raises():
    _no_card()
    from smvp_toolkit_tpu_torch.ops.sell_plan import build_sell_plan
    from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV

    plan = build_sell_plan(np.array([0, 1]), np.array([1, 0]),
                           np.array([1.0, 2.0]), (2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SellSpMV(plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SellSpMV(plan, device="cuda")
    assert SellSpMV(plan, device="cpu").device.type == "cpu"


def test_other_entry_points_without_device_raise(tmp_path):
    _no_card()
    from smvp_toolkit_tpu_torch.io.mtx import read_mtx, write_mtx
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    path = str(tmp_path / "m.mtx")
    write_mtx(path, np.array([0]), np.array([0]), np.array([1.0]), (1, 1))
    for fn in (lambda: read_mtx(path),
               lambda: parse_synth_spec("synth:10:20"),
               lambda: smvp_toolkit_tpu_torch.COOMatrix.from_numpy(
                   np.array([0]), np.array([0]), np.array([1.0]),
                   shape=(1, 1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
