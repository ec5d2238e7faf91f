"""Data-parallel SpMV over a process group, one rank per device.

Counterpart of the JAX package's ``parallel`` subpackage on
``torch.distributed`` (NCCL between cards, gloo between CPU processes):
CSR row blocks and TJDS nnz stripes (``spmv_dist``), the 2-D row ×
column grid (``spmv_2d``), the SELL kernels per rank with K2-sharded
(``sell_dist``), the traffic model (``traffic``) and the ``torchrun``
runner (``launch``). x is replicated; y is reassembled in row order by
an all-gather for row blocks and an all-reduce for stripes. Exports are
lazy.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "mesh": ("make_mesh", "distributed_init", "device_count"),
    "spmv_dist": ("ShardedCSR", "ShardedTJDS", "shard_csr", "shard_tjds",
                  "spmv_csr_sharded", "spmm_csr_sharded",
                  "spmv_tjds_sharded", "shard_and_bench"),
    "spmv_2d": ("ShardedCSR2D", "make_mesh_2d", "shard_csr_2d",
                "spmv_csr_2d", "spmm_csr_2d"),
    "sell_dist": ("ShardedSell", "differentiable_spmm_sharded",
                  "shard_sell", "shard_sell_transpose", "spmm_sell_sharded",
                  "spmm_sell_sharded_t", "spmv_sell_sharded"),
}
_EXPORTS = {name: f"{__name__}.{mod}"
            for mod, names in _MODULES.items() for name in names}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
