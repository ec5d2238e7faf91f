#!/usr/bin/env python
"""Solve A x = b with CG on the SELL kernel, checked in double-float.

Builds a sparse SPD system, solves it with CG (one SELL SpMV launch a
step), checks the residual in double-float arithmetic, then refines the
solution to about float64 accuracy: double-float residuals, float32 CG
corrections.

Run: python examples/torch/solve_demo.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from smvp_toolkit_tpu_torch import csr_encode
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.models import conjugate_gradient, refine_solve
from smvp_toolkit_tpu_torch.ops.precision import (
    df_split,
    df_to_f64,
    spmv_csr_df64,
)
from smvp_toolkit_tpu_torch.utils.synth import synth_banded

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
p.add_argument("--n", type=int, default=2000, help="matrix dimension")
args = p.parse_args()

# A sparse SPD system: symmetrize a banded pattern and add a dominant
# diagonal (host numpy; encoded once on the device).
coo = synth_banded(args.n, nnz_per_row=7, bandwidth=32, seed=0, device="cpu")
r, c, v = coo.to_numpy()
r2 = np.concatenate([r, c])
c2 = np.concatenate([c, r])
v2 = np.concatenate([v, v])  # A + Aᵀ
absrow = np.zeros(coo.shape[0])
np.add.at(absrow, r2, np.abs(v2))
rd = np.arange(coo.shape[0], dtype=r.dtype)
spd = COOMatrix.from_numpy(
    np.concatenate([r2, rd]), np.concatenate([c2, rd]),
    np.concatenate([v2, absrow + 1.0]), shape=coo.shape, pad_to=512,
    device=args.device,
)
csr = csr_encode(spd)

b = torch.ones(coo.shape[0], device=args.device)
x, res = conjugate_gradient(csr, b, num_iters=200)
print("CG residual: first", float(res[0]), "last", float(res[-1]))
assert float(res[-1]) < 1e-3 * float(res[0])

# The residual in double-float arithmetic.
x_hi, x_lo = df_split(x.double())
ax = df_to_f64(*spmv_csr_df64(csr, x_hi, x_lo))
print("df64 residual inf-norm:", float(np.abs(ax - 1.0).max()))

# Mixed-precision iterative refinement: the same system to about float64
# accuracy with float32 arithmetic in the inner solves.
inner = lambda rr: conjugate_gradient(csr, rr, num_iters=200,  # noqa: E731
                                      tol=1e-7)[0]
xh, xl, sweeps = refine_solve(csr, np.ones(coo.shape[0]), inner=inner)
x64 = df_to_f64(xh, xl)
r64 = df_to_f64(*spmv_csr_df64(
    csr, *df_split(torch.from_numpy(x64).to(args.device)))) - 1.0
print("refined residual inf-norm:", float(np.abs(r64).max()),
      f"(per-sweep norms {[f'{float(s):.1e}' for s in sweeps]})")
