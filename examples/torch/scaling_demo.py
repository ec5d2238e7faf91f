#!/usr/bin/env python
"""Parallel-scaling tour: the sharding strategies on one skewed matrix.

Shows 1-D equal-rows and nnz-balanced CSR row blocks, the 2-D row x
column grid (x split by column blocks), and the SELL kernels on row-block
shards (each shard's SpMV, and N of them in one launch: K2-sharded).

One process plays every rank here, on one device: each rank's local part
runs in turn (``for_rank`` / ``for_cell``) and the result is assembled as
the collective would assemble it (the all-gather of row blocks, the
grid row's all-reduce). Under ``torchrun`` with one process per card, the
public functions (``spmv_csr_sharded``, ``spmv_csr_2d``,
``spmv_sell_sharded``, ``bench_loop_sharded``) run the same parts with
the collectives (NCCL on cards, gloo with ``--device cpu``).

Run: python examples/torch/scaling_demo.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.ops.algebra import transpose
from smvp_toolkit_tpu_torch.parallel.mesh import Mesh
from smvp_toolkit_tpu_torch.parallel.sell_dist import (
    _local_bench,
    _local_spmv,
    shard_sell,
)
from smvp_toolkit_tpu_torch.parallel.spmv_2d import (
    Mesh2D,
    _local_2d,
    shard_csr_2d,
)
from smvp_toolkit_tpu_torch.parallel.spmv_dist import _local_csr, shard_csr
from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
p.add_argument("--n", type=int, default=3000, help="matrix dimension")
args = p.parse_args()
dev = torch.device(args.device)

# Power-law row lengths (hub rows): the worst case for equal-rows shards.
coo = transpose(synth_powerlaw(args.n, 20 * args.n, alpha=1.2, seed=0,
                               device=dev).pad(512))
csr = csr_encode(coo)
x_np = np.random.RandomState(1).randn(coo.shape[1]).astype(np.float32)
x = torch.from_numpy(x_np).to(dev)
r, c, v = coo.to_numpy()
y_ref = np.zeros(coo.shape[0])
np.add.at(y_ref, r, v.astype(np.float64) * x_np[c])


def check(y, what):
    np.testing.assert_allclose(y.double().cpu().numpy(), y_ref, rtol=1e-4,
                               atol=1e-4, err_msg=what)


for balance in ("rows", "nnz"):
    sh = shard_csr(csr, Mesh(8, 0, dev), balance=balance)
    ends = sh.nnz_starts[1:] + (sh.nnz,)
    widths = np.array([e - s for s, e in zip(sh.nnz_starts, ends)])
    y = torch.cat([_local_csr(sh.for_rank(k, dev), x)[: sh.block_rows()[k]]
                   for k in range(8)])
    check(y, f"1-D {balance}")
    print(f"1-D balance={balance:4s}: per-device nnz "
          f"max/mean = {widths.max()}/{widths.mean():.0f} "
          f"(imbalance {widths.max() / widths.mean():.2f}x)")

sh2 = shard_csr_2d(csr, Mesh2D(2, 4, 0, 0, dev))
y2 = torch.cat([sum(_local_2d(sh2.for_cell(i, j, dev), x) for j in range(4))
                for i in range(2)])[: coo.shape[0]]
check(y2, "2-D")
print("2-D (2x4): x split along columns, grid-row sums — correct ✓")

shs = shard_sell(coo, Mesh(4, 0, dev))
ranks = [shs.for_rank(k, dev) for k in range(4)]
for name, run in (("SpMV", lambda s: _local_spmv(s, x)),
                  ("N = 20 in one launch", lambda s: _local_bench(s, x, 20))):
    y = torch.cat([run(s)[: shs.rows_per_shard] for s in ranks])
    check(y[: coo.shape[0]], f"SELL shards, {name}")
    print(f"SELL row blocks x 4, {name}: correct ✓")
