"""smvp_toolkit_tpu_torch — the PyTorch/CUDA port of the JAX package.

The same sparse-matrix codec and SpMV benchmark as the JAX package,
written in PyTorch for an NVIDIA Hopper card. The SELL SpMV kernels are
hand-written CUDA C++ (``csrc/``), built with ``nvcc`` on first use; they
run every plan the JAX planner builds (resident or streamed y, merged
rel‖slice word or split planes). Every
entry point runs on ``cuda`` unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead.

Module layout follows the JAX package so each module's counterpart is
found under the same name:

* ``io.mtx`` — MatrixMarket reading and writing.
* ``formats.coo`` / ``formats.csr`` / ``formats.tjds`` — COO triplets and
  the CSR and TJDS codecs.
* ``ops.sell_plan`` — the SELL-T1 planner, flat and streamed-y (host, numpy).
* ``ops.spmv_sell`` — the SELL operator over the CUDA kernels (SpMV,
  SpMM, the values gradient).
* ``ops.spmv_autograd`` — ``torch.autograd.Function``s over the operator.
* ``ops.spmv_torch`` — plain-PyTorch CSR and TJDS SpMV and CSR SpMM.
* ``models.graph`` — the GCN, trained on the operator's kernels.
* ``models.solvers`` — CG, preconditioned CG, Chebyshev and Lanczos, one
  SpMV launch per step.
* ``ops.ilu`` / ``ops.algebra`` — IC(0) factors (host C++ pass) and the
  matrix diagonal.
* ``ops.cg_fused`` / ``ops.pcg_fused`` — whole CG, Chebyshev and
  IC(0)-PCG solves in one launch of a CUDA kernel each.
* ``bench`` — timing, roofline and report files.
* ``cli`` — the ``-c`` / ``-t`` / ``--spmm`` / ``--solve`` command line.

Exports are lazy: importing the package imports neither the kernels'
build machinery nor the formats.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "COOMatrix": "smvp_toolkit_tpu_torch.formats.coo",
    "CSRMatrix": "smvp_toolkit_tpu_torch.formats.csr",
    "csr_encode": "smvp_toolkit_tpu_torch.formats.csr",
    "csr_decode": "smvp_toolkit_tpu_torch.formats.csr",
    "TJDSMatrix": "smvp_toolkit_tpu_torch.formats.tjds",
    "tjds_encode": "smvp_toolkit_tpu_torch.formats.tjds",
    "tjds_decode": "smvp_toolkit_tpu_torch.formats.tjds",
    "read_mtx": "smvp_toolkit_tpu_torch.io.mtx",
    "write_mtx": "smvp_toolkit_tpu_torch.io.mtx",
    "SellPlan": "smvp_toolkit_tpu_torch.ops.sell_plan",
    "build_sell_plan": "smvp_toolkit_tpu_torch.ops.sell_plan",
    "build_streamed_sell_plan": "smvp_toolkit_tpu_torch.ops.sell_plan",
    "SellSpMV": "smvp_toolkit_tpu_torch.ops.spmv_sell",
    "spmv_csr_sell": "smvp_toolkit_tpu_torch.ops.spmv_sell",
    "spmv_tjds_sell": "smvp_toolkit_tpu_torch.ops.spmv_sell",
    "GCN": "smvp_toolkit_tpu_torch.models.graph",
    "gcn_norm": "smvp_toolkit_tpu_torch.models.graph",
    "gcn_train_step": "smvp_toolkit_tpu_torch.models.graph",
    "conjugate_gradient": "smvp_toolkit_tpu_torch.models.solvers",
    "pcg_precond": "smvp_toolkit_tpu_torch.models.solvers",
    "ic0": "smvp_toolkit_tpu_torch.ops.ilu",
    "fused_cg": "smvp_toolkit_tpu_torch.ops.cg_fused",
    "fused_chebyshev": "smvp_toolkit_tpu_torch.ops.pcg_fused",
    "fused_pcg_ic0": "smvp_toolkit_tpu_torch.ops.pcg_fused",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
