#!/usr/bin/env python
"""The preconditioner ladder on a 2-D Poisson system.

The whole family on one SPD problem: plain CG, Jacobi scaling, the
truncated-Neumann polynomial, SSOR, block Jacobi (batched dense block
inverses), IC(0) (host-factored, fixed-sweep Neumann trisolves) and
smoothed-aggregation AMG (host-built hierarchy, a V-cycle whose levels
run on their own SELL operators). Every preconditioner cuts plain CG's
iteration count to a 1e-6 relative residual; AMG's count stays about
the same as the grid grows, where every one-level method degrades.

Run: python examples/torch/precond_demo.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from smvp_toolkit_tpu_torch import csr_encode
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.models import (
    amg_preconditioner,
    block_jacobi_preconditioner,
    conjugate_gradient,
    ic0_preconditioner,
    jacobi_preconditioner,
    pcg_precond,
    ssor_preconditioner,
)
from smvp_toolkit_tpu_torch.ops.algebra import diagonal
from smvp_toolkit_tpu_torch.ops.ilu import ic0
from smvp_toolkit_tpu_torch.ops.spmv_sell import sell_op_csr

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
p.add_argument("--nx", type=int, default=48, help="grid points a side")
args = p.parse_args()

NX = args.nx
TOL = 1e-6

n = NX * NX
rows, cols, vals = [], [], []
for i in range(NX):
    for j in range(NX):
        k = i * NX + j
        rows.append(k), cols.append(k), vals.append(4.0)
        for dk in (-NX, -1):
            if (dk == -NX and i > 0) or (dk == -1 and j > 0):
                rows += [k, k + dk]
                cols += [k + dk, k]
                vals += [-1.0, -1.0]
r = np.asarray(rows, np.int32)
c = np.asarray(cols, np.int32)
v = np.asarray(vals, np.float64)
order = np.lexsort((c, r))
coo = COOMatrix.from_numpy(r[order], c[order], v[order], shape=(n, n),
                           pad_to=128, device=args.device)
csr = csr_encode(coo)
b = torch.from_numpy(
    np.random.RandomState(0).randn(n).astype(np.float32)).to(args.device)
b_norm = float(torch.linalg.vector_norm(b))
d = diagonal(coo)

ladder = {
    "cg (none)": None,
    "jacobi": lambda rr: (1.0 / d) * rr,
    "neumann o3": jacobi_preconditioner(csr, d, order=3),
    "ssor s4": ssor_preconditioner(csr, sweeps=4, op_builder=sell_op_csr),
    "block-jacobi 48": block_jacobi_preconditioner(csr, block=NX),
    "ic0 s4": ic0_preconditioner(ic0(csr), sweeps=4, op_builder=sell_op_csr),
    "amg v(1,1)": amg_preconditioner(csr, op_builder=sell_op_csr),
}
print(f"2-D Poisson {NX}x{NX} (n={n}) -> relative residual {TOL}")
for name, m in ladder.items():
    if m is None:
        _, res = conjugate_gradient(csr, b, num_iters=400, tol=TOL)
    else:
        _, res = pcg_precond(csr, b, m, num_iters=400, tol=TOL)
    ok = res.cpu().numpy() / b_norm < TOL
    iters = int(np.argmax(ok)) + 1 if ok.any() else ">400"
    print(f"  {name:16s} {iters:>4} iterations")
