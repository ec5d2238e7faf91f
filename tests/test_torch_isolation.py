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
                                                            ".cuh", ".cpp"))


def test_package_sources_found():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES}
    assert {"cli.py", "interop.py", "io/mtx.py", "ops/spmv_sell.py",
            "formats/tjds.py", "csrc/sell_spmv.cu", "csrc/sell_bench.cu",
            "csrc/sell_common.cuh", "csrc/sell_spmm.cu",
            "csrc/sell_vals_grad.cu", "ops/spmv_autograd.py",
            "models/graph.py", "models/__init__.py", "models/solvers.py",
            "ops/algebra.py", "ops/ilu.py", "ops/cg_fused.py",
            "ops/pcg_fused.py", "csrc/sell_solvers.cu",
            "csrc/ilu.cpp", "ops/precision.py", "ops/spmv_df64.py",
            "csrc/sell_df64.cu", "csrc/sell_packed.cu",
            "csrc/cocluster.cpp", "csrc/sell_onehot.cu", "ops/cocluster.py",
            "ops/autotune.py", "utils/analyze.py", "bench/headline.py",
            "bench/bench_variants.py", "csrc/variants/sell_bench_variants.cu",
            "parallel/__init__.py", "parallel/mesh.py", "parallel/launch.py",
            "parallel/spmv_dist.py", "parallel/spmv_2d.py",
            "parallel/sell_dist.py", "parallel/traffic.py",
            "formats/cisr.py", "formats/vivado.py", "formats/encode_native.py",
            "ops/spmv_cisr.py", "io/native.py", "utils/debug.py",
            "utils/checkpoint.py", "csrc/cisr.cpp", "csrc/sellplan.cpp",
            "csrc/mtxio.cpp", "csrc/encode.cpp"} <= names


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
             "--spmm", "3", "synth:500:2000"]) == 0
from smvp_toolkit_tpu_torch.models import gcn_init, gcn_norm, gcn_train_step
s = gcn_norm(parse_synth_spec("synth:300:1500", device="cpu"))
model = gcn_init(torch.Generator().manual_seed(0), [4, 8, 3], device="cpu")
_, loss = gcn_train_step(s, model, torch.ones(300, 4),
                         torch.zeros(300, dtype=torch.long),
                         torch.ones(300, dtype=torch.bool))
assert bool(torch.isfinite(loss))
from smvp_toolkit_tpu_torch.models import conjugate_gradient, lanczos_eigsh
from smvp_toolkit_tpu_torch.ops.ilu import ic0
from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg
from smvp_toolkit_tpu_torch.ops.pcg_fused import fused_chebyshev, fused_pcg_ic0
from smvp_toolkit_tpu_torch.ops.spmv_sell import sell_op_csr
csr = csr_encode(parse_synth_spec("synth:2000:10000", device="cpu").pad(128))
f = ic0(csr)
x, res = conjugate_gradient(csr, torch.ones(2000), num_iters=5)
op = sell_op_csr(csr)
for x in (fused_cg(op, torch.ones(2000), 3),
          fused_chebyshev(op, torch.ones(2000), 0.5, 2.0, 3),
          fused_pcg_ic0(op, f, torch.ones(2000), 3)):
    assert x.shape == (2000,)
assert main(["-c", "-n", "1", "--no-report", "--device", "cpu",
             "--solve", "pcg-ic0-fused:3", "synth:500:2000"]) == 0
from smvp_toolkit_tpu_torch.models import refine_solve
from smvp_toolkit_tpu_torch.ops.precision import df_split
from smvp_toolkit_tpu_torch.ops.spmv_df64 import sell_df64_op
hi, lo = sell_df64_op(parse_synth_spec("synth:900:4000", device="cpu"))(
    *df_split(np.ones(900), device="cpu"))
assert hi.shape == lo.shape == (900,)
xh, xl, norms = refine_solve(csr, np.ones(2000), num_refinements=2,
                             inner=lambda r: fused_cg(op, r, 5))
assert main(["-c", "-t", "-n", "1", "--no-report", "--device", "cpu",
             "--kernel", "df64", "--fused", "synth:500:2000"]) == 0
import os
os.environ["SMVP_SELL_PACK"] = "1"
assert main(["-c", "-n", "1", "--no-report", "--device", "cpu", "--dtype",
             "bfloat16", "--spmm", "3", "synth:500:2000"]) == 0
os.environ["SMVP_SELL_PACK"] = "0"
assert main(["-c", "-t", "-n", "1", "--no-report", "--device", "cpu",
             "--cocluster", "--analyze", "--fused", "synth:900:4000"]) == 0
from smvp_toolkit_tpu_torch.ops.cocluster import cocluster
from smvp_toolkit_tpu_torch.ops.autotune import pick_plan
from smvp_toolkit_tpu_torch.bench import headline
r, c, v = parse_synth_spec("synth:900:4000", device="cpu").to_numpy()
assert cocluster(r, c, (900, 900), passes=2).s_true > 0
assert pick_plan(r, c, v, (900, 900))[0].nnz == len(r)
os.environ["SMVP_SELL_COMPAT"] = "1"
assert main(["-c", "-n", "1", "--no-report", "--device", "cpu",
             "synth:900:4000"]) == 0
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


def test_df64_entry_points_without_device_raise():
    _no_card()
    from smvp_toolkit_tpu_torch.ops.precision import df_split
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    r, c = np.array([0, 1]), np.array([1, 0])
    for fn in (lambda: df_split(np.ones(3)),
               lambda: SellDf64SpMV.from_coo_f64(r, c, np.ones(2), (2, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    op = SellDf64SpMV.from_coo_f64(r, c, np.ones(2), (2, 2), device="cpu")
    assert op.device.type == "cpu"


def test_solver_entry_points_without_device_raise():
    _no_card()
    from smvp_toolkit_tpu_torch.interop import (
        csr_from_arrays,
        ic0_factors_from_arrays,
    )

    fields = dict(row_ptr=np.array([0, 1]), col_ind=np.array([0]),
                  vals=np.array([2.0]), shape=(1, 1), nnz=1)
    for fn in (lambda: csr_from_arrays(fields),
               lambda: ic0_factors_from_arrays(fields, fields, [2.0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    f = ic0_factors_from_arrays(fields, fields, [2.0], device="cpu")
    assert f.diag.device.type == "cpu" and f.shape == (1, 1)


def test_training_entry_points_without_device_raise():
    _no_card()
    from smvp_toolkit_tpu_torch.interop import gcn_params_from_arrays
    from smvp_toolkit_tpu_torch.models import gcn_init

    pairs = [(np.ones((2, 3), np.float32), np.zeros(3, np.float32))]
    for fn in (lambda: gcn_init(torch.Generator(), [2, 3]),
               lambda: gcn_params_from_arrays(pairs),
               lambda: gcn_params_from_arrays(pairs, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert gcn_params_from_arrays(pairs, device="cpu").weights[0].shape == (
        2, 3)


def test_parallel_entry_points_without_device_raise(monkeypatch):
    _no_card()
    from smvp_toolkit_tpu_torch import parallel

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for fn in (parallel.make_mesh, lambda: parallel.make_mesh_2d(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.distributed_init()
    from smvp_toolkit_tpu_torch.parallel.launch import main as launch

    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(["synth:100:300", "-n", "1"])
    assert parallel.make_mesh(device="cpu").device.type == "cpu"
