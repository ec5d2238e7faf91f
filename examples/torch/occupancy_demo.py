#!/usr/bin/env python
"""Occupancy engineering: the co-clustering planner end to end.

The SELL kernels' slot rate is linear in slot occupancy. This demo shows
the pipeline on one matrix:

1. the natural-order plan's occupancy (what a fixed layout gives),
2. the joint row x column co-clustering refinement (``ops/cocluster.py``,
   a host C++ local search over the exact sublane objective),
3. the permuted-coordinate operator (``CoClusteredSellSpMV``) with its
   boundary conversions, its SpMV on the SELL kernel in bfloat16, held
   to a float64 oracle of the bfloat16-rounded operands.

The matrix is ``SMVP_DEMO_MTX`` (a ``.mtx`` path) when it is set, else a
synthetic power-law matrix.

Run: SMVP_DEMO_MTX=m.mtx python examples/torch/occupancy_demo.py
     [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from smvp_toolkit_tpu_torch.io.mtx import read_mtx
from smvp_toolkit_tpu_torch.ops.autotune import _split_policy
from smvp_toolkit_tpu_torch.ops.cocluster import cocluster
from smvp_toolkit_tpu_torch.ops.spmv_sell import CoClusteredSellSpMV
from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    mtx = os.environ.get("SMVP_DEMO_MTX")
    coo = (read_mtx(mtx, device=args.device) if mtx else
           synth_powerlaw(8192, 65536, alpha=1.2, seed=0, device=args.device))
    r, c, v = coo.to_numpy()
    print(f"matrix: {mtx or 'synthetic power-law'}  "
          f"{coo.shape[0]}x{coo.shape[1]}  nnz={coo.nnz}")

    res = cocluster(np.asarray(r, np.int64), np.asarray(c, np.int64),
                    coo.shape)
    occ_nat = coo.nnz / (res.s_true_natural * 128.0)
    print(f"occupancy: natural {occ_nat:.3f} -> co-clustered "
          f"{res.occupancy(coo.nnz):.3f} "
          f"({res.occupancy(coo.nnz) / occ_nat:.2f}x; "
          f"{res.moves} refinement moves)")

    op = CoClusteredSellSpMV(coo, value_dtype=torch.bfloat16)
    plan = op.inner.plan
    print(f"plan: chunk {plan.chunk}, chain split "
          f"{_split_policy(plan.chunk, 1)}, window {plan.window_tiles} "
          f"tiles, {plan.n_chunks} chunk(s), route {op.inner.route}")

    x = np.random.RandomState(0).randn(coo.shape[1]).astype(np.float32)
    y = op(torch.from_numpy(x).to(args.device)).double().cpu().numpy()
    vb = torch.from_numpy(v.astype(np.float32)).bfloat16().double().numpy()
    xb = torch.from_numpy(x).bfloat16().double().numpy()
    oracle = np.zeros(coo.shape[0])
    np.add.at(oracle, r, vb * xb[c])
    err = np.abs(y - oracle).max() / (np.abs(oracle).max() + 1e-30)
    print(f"permuted-coordinate SpMV vs bf16 oracle: rel err {err:.2e}")
    assert err < 1e-3
    print("OK: solvers keep x and y in permuted space through "
          "op.to_permuted/from_permuted at the boundaries.")


if __name__ == "__main__":
    main()
