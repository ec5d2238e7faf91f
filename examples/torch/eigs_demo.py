#!/usr/bin/env python
"""Smallest eigenpairs of a 2-D Laplacian: LOBPCG + AMG + the SpMM kernel.

The block eigensolver's SpMMs run on the SELL k-column kernel, the
preconditioner is the smoothed-aggregation V-cycle with every level on
its own SELL operator, and the Ritz values land on the analytic
Dirichlet-Laplacian spectrum 4sin²(iπ/2(nx+1)) + 4sin²(jπ/2(nx+1)).

Run: python examples/torch/eigs_demo.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import scipy.sparse as sp
import torch

from smvp_toolkit_tpu_torch import csr_encode
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.models import amg_preconditioner, lobpcg
from smvp_toolkit_tpu_torch.ops.spmv_sell import sell_op_csr

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
p.add_argument("--nx", type=int, default=40, help="grid points a side")
args = p.parse_args()

NX, K, ITERS = args.nx, 4, 40

n = NX * NX
eye = sp.eye(NX)
t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (NX, NX))
a = (sp.kron(eye, t) + sp.kron(t, eye)).tocoo()
coo = COOMatrix.from_numpy(
    a.row.astype(np.int32), a.col.astype(np.int32),
    a.data.astype(np.float32), shape=(n, n), pad_to=128, device=args.device,
)
csr = csr_encode(coo)

op = sell_op_csr(csr)                                   # the SpMM kernel
m = amg_preconditioner(csr, op_builder=sell_op_csr)     # V-cycle
X0 = torch.from_numpy(
    np.random.RandomState(0).standard_normal((n, K)).astype(np.float32)
).to(args.device)
theta, X, res = lobpcg(csr, X0, num_iters=ITERS, m=m,
                       spmm=lambda _m, Z: op.matmat(Z))

s = np.sin(np.arange(1, NX + 1) * np.pi / (2 * (NX + 1))) ** 2
analytic = np.sort((4 * s[:, None] + 4 * s[None, :]).ravel())[:K]
print(f"2-D Dirichlet Laplacian {NX}x{NX}, {K} smallest eigenvalues, "
      f"{ITERS} LOBPCG iterations (AMG-preconditioned, SELL SpMM):")
for j, (th, an, r) in enumerate(
        zip(theta.cpu().numpy(), analytic, res[-1].cpu().numpy())):
    print(f"  λ{j}: {th:.6f}  (analytic {an:.6f}, residual {r:.1e})")
