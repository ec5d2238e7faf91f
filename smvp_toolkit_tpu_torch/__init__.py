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

* ``io.mtx`` / ``io.native`` — MatrixMarket reading (the native parser
  ``csrc/mtxio.cpp`` by default) and writing.
* ``formats.coo`` / ``formats.csr`` / ``formats.tjds`` — COO triplets
  (with their scipy, ``torch.sparse`` and dense bridges) and the CSR and
  TJDS codecs (``formats.encode_native``: the host counting
  sorts of ``csrc/encode.cpp``).
* ``formats.cisr`` / ``formats.vivado`` — the CISR channel schedule
  (``csrc/cisr.cpp``), its Vivado ``.coe`` image and the TJDS LUT;
  ``ops.spmv_cisr`` — the SpMV from the schedule, channel per lane.
* ``ops.sell_plan`` — the SELL-T1 planner, flat and streamed-y (host: the
  native pass ``csrc/sellplan.cpp`` or the numpy flow).
* ``ops.spmv_sell`` — the SELL operator over the CUDA kernels (SpMV,
  SpMM, the values gradient; the packed bf16 plane under
  ``SMVP_SELL_PACK=1``).
* ``ops.precision`` / ``ops.spmv_df64`` — double-float arithmetic, the
  float64 CSR SpMV, and the double-float SELL operator on its CUDA kernel.
* ``ops.spmv_autograd`` — ``torch.autograd.Function``s over the operator.
* ``ops.spmv_torch`` — plain-PyTorch CSR and TJDS SpMV and CSR SpMM.
* ``models.graph`` — the GCN, trained on the operator's kernels.
* ``models.solvers`` — CG, preconditioned CG, Chebyshev and Lanczos, one
  SpMV launch per step, and mixed-precision refinement.
* ``ops.ilu`` / ``ops.algebra`` — IC(0) factors (host C++ pass) and the
  matrix diagonal.
* ``ops.cg_fused`` / ``ops.pcg_fused`` — whole CG, Chebyshev and
  IC(0)-PCG solves in one launch of a CUDA kernel each.
* ``parallel`` — data-parallel SpMV and SpMM over a ``torch.distributed``
  process group, one rank per device (NCCL on cards, gloo on the CPU):
  CSR row blocks, TJDS stripes, a 2-D grid, the SELL kernels per rank
  (K2-sharded: ``bench_loop_sharded``), the traffic model, ``launch``.
* ``ops.spmv_native`` — the host C++ CSR and TJDS backend
  (``csrc/spmv.cpp``), the CLI's ``--kernel native``.
* ``bench`` — timing, roofline and report files, ``bench.profile`` the
  ``torch.profiler`` traces; ``utils.debug`` and ``utils.checkpoint`` —
  debug dumps and ``.npz`` checkpoints of matrices, SELL plans and AMG
  hierarchies; ``utils.aot`` — ``torch.export`` programs of the SpMV
  (``.pt2``); ``utils.padding`` and ``utils.reorder`` — padding helpers,
  RCM and the symmetric permute.
* ``cli`` — the ``-a`` / ``-c`` / ``-t`` / ``-g`` / ``--spmm`` /
  ``--solve`` / ``--kernel df64|native`` / ``--shards`` / ``--export-aot``
  / ``--profile`` command line; ``interactive`` — its terminal dialog;
  ``io.readtest`` / ``io.writetest`` — the reference's ``.mtx`` test
  programs.

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
    "spmv_coo_sell": "smvp_toolkit_tpu_torch.ops.spmv_sell",
    "sell_op_coo": "smvp_toolkit_tpu_torch.ops.spmv_sell",
    "spmv_cisr_sell": "smvp_toolkit_tpu_torch.ops.spmv_sell",
    "CISRMatrix": "smvp_toolkit_tpu_torch.formats.cisr",
    "cisr_encode": "smvp_toolkit_tpu_torch.formats.cisr",
    "cisr_decode": "smvp_toolkit_tpu_torch.formats.cisr",
    "write_coe": "smvp_toolkit_tpu_torch.formats.cisr",
    "CisrSpMV": "smvp_toolkit_tpu_torch.ops.spmv_cisr",
    "GCN": "smvp_toolkit_tpu_torch.models.graph",
    "gcn_norm": "smvp_toolkit_tpu_torch.models.graph",
    "gcn_train_step": "smvp_toolkit_tpu_torch.models.graph",
    "conjugate_gradient": "smvp_toolkit_tpu_torch.models.solvers",
    "pcg_precond": "smvp_toolkit_tpu_torch.models.solvers",
    "refine_solve": "smvp_toolkit_tpu_torch.models.solvers",
    "SellDf64SpMV": "smvp_toolkit_tpu_torch.ops.spmv_df64",
    "spmv_csr_df64": "smvp_toolkit_tpu_torch.ops.precision",
    "ic0": "smvp_toolkit_tpu_torch.ops.ilu",
    "fused_cg": "smvp_toolkit_tpu_torch.ops.cg_fused",
    "fused_chebyshev": "smvp_toolkit_tpu_torch.ops.pcg_fused",
    "fused_pcg_ic0": "smvp_toolkit_tpu_torch.ops.pcg_fused",
    "distributed_init": "smvp_toolkit_tpu_torch.parallel.mesh",
    "make_mesh": "smvp_toolkit_tpu_torch.parallel.mesh",
    "shard_csr": "smvp_toolkit_tpu_torch.parallel.spmv_dist",
    "spmv_csr_sharded": "smvp_toolkit_tpu_torch.parallel.spmv_dist",
    "shard_sell": "smvp_toolkit_tpu_torch.parallel.sell_dist",
    "spmv_sell_sharded": "smvp_toolkit_tpu_torch.parallel.sell_dist",
    "bench_loop_sharded": "smvp_toolkit_tpu_torch.parallel.sell_dist",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
