"""The port's ahead-of-time export (``utils/aot.py`` on ``torch.export``).

An exported ``.pt2`` SpMV program (CSR, TJDS, COO; float32 and complex64)
loads in a fresh interpreter that imports only ``torch`` and returns y
within 1e-6 of max |y| of the plain PyTorch SpMV of the same matrix (the
JAX module's artifact is a ``.jaxexport`` StableHLO module: a stated
departure). The SELL operator and its functions are refused with a stated
``TypeError``, never exported as their plain version. ``export_program``
and ``save_program`` / ``load_program`` round trip a closure, and the
CLI's ``--export-aot PREFIX`` writes ``PREFIX_csr.pt2`` and
``PREFIX_tjds.pt2``.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
from smvp_toolkit_tpu_torch.ops import spmv_sell, spmv_torch
from smvp_toolkit_tpu_torch.utils import aot

TOL = 1e-6

_LOAD = r"""
import sys
import numpy as np
import torch
args = sys.argv[1:]
for prog, xin, out in zip(args[0::3], args[1::3], args[2::3]):
    call = torch.export.load(prog).module()
    np.save(out, call(torch.from_numpy(np.load(xin))).numpy())
    print("LOADED")
bad = sorted(m for m in sys.modules if m.startswith(("smvp", "jax")))
assert not bad, bad
"""


def _matrix(dtype, n=500, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 4000)
    c = rng.integers(0, n, 4000)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = rng.standard_normal(len(key))
    x = rng.standard_normal(n)
    if dtype == torch.complex64:
        v, x = v + 1j * rng.standard_normal(len(key)), x + 0.5j
    coo = COOMatrix.from_numpy(r, c, v, shape=(n, n), dtype=dtype,
                               pad_to=128, device="cpu")
    return coo, torch.from_numpy(x).to(dtype)


def test_exported_program_in_fresh_process(tmp_path):
    """CSR in float32 and complex64, loaded in one fresh interpreter."""
    jobs = []
    for dtype in (torch.float32, torch.complex64):
        coo, x = _matrix(dtype)
        csr = csr_encode(coo)
        tag = str(dtype).split(".")[-1]
        path, xin = str(tmp_path / f"{tag}.pt2"), tmp_path / f"x_{tag}.npy"
        aot.write_blob(path, aot.export_spmv(csr))
        np.save(xin, x.numpy())
        jobs.append((path, str(xin), str(tmp_path / f"y_{tag}.npy"),
                     spmv_torch.spmv_csr(csr, x).numpy()))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD, *[a for j in jobs for a in j[:3]]],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("LOADED") == 2
    for _, _, out, want in jobs:
        y = np.load(out)
        assert y.dtype == want.dtype and y.shape == want.shape
        assert np.abs(y - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("fmt", ["tjds", "coo"])
def test_exported_formats(fmt):
    coo, x = _matrix(torch.complex64, n=200)
    m, fn = ((tjds_encode(coo), spmv_torch.spmv_tjds) if fmt == "tjds"
             else (coo, spmv_torch.spmv_coo))
    blob = aot.export_spmv(m)
    y, want = aot.import_program(blob)(x), fn(m, x)
    assert float((y - want).abs().max()) <= TOL * float(want.abs().max())
    # a complex matrix exports a complex signature
    ep = torch.export.load(io.BytesIO(blob))
    (arg,) = [n for n in ep.graph.nodes if n.op == "placeholder"
              and n.name in ep.graph_signature.user_inputs]
    assert arg.meta["val"].dtype == torch.complex64


def test_sell_operator_refused():
    coo, x = _matrix(torch.float32, n=300)
    csr = csr_encode(coo)
    op = spmv_sell.sell_op_csr(csr)
    for kernel in (op, op.__call__, spmv_sell.spmv_csr_sell,
                   spmv_sell.spmv_tjds_sell):
        with pytest.raises(TypeError, match="SELL operator cannot be"):
            aot.export_spmv(csr, kernel=kernel)
    with pytest.raises(TypeError, match="no default SpMV"):
        aot.export_spmv(op.plan)


def test_program_round_trip(tmp_path):
    w = torch.arange(6, dtype=torch.float32)
    path = str(tmp_path / "f.pt2")
    aot.save_program(path, lambda a, b: w * a + b, ((6,), torch.float32),
                     torch.ones(6))
    call = aot.load_program(path)
    assert torch.equal(call(torch.ones(6), torch.zeros(6)), w)
    assert not any(p.name.startswith("f.pt2.tmp") for p in tmp_path.iterdir())


def test_cli_export_aot(tmp_path):
    prefix = str(tmp_path / "smoke")
    assert tcli.main(["-c", "-t", "-n", "1", "--no-report", "--device", "cpu",
                      "--export-aot", prefix, "synth:900:4000"]) == 0
    x = torch.ones(900)
    from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

    coo = parse_synth_spec("synth:900:4000", device="cpu").pad(128)
    for alg, m, fn in (("csr", csr_encode(coo), spmv_torch.spmv_csr),
                       ("tjds", tjds_encode(coo), spmv_torch.spmv_tjds)):
        y = aot.load_program(f"{prefix}_{alg}.pt2")(x)
        want = fn(m, x)
        assert float((y - want).abs().max()) <= TOL * float(want.abs().max())
    assert tcli.main(["-g", "-n", "1", "--device", "cpu", "--export-aot",
                      prefix, "synth:900:4000"]) == 2
