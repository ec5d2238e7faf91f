#!/usr/bin/env python
"""Spectral graph partitioning with the block eigensolver.

Treats a sparse matrix's pattern as a graph, builds the graph Laplacian
L = D − W, and finds the Fiedler vector (the eigenvector of the
second-smallest eigenvalue) with AMG-preconditioned LOBPCG, its SpMMs and
the V-cycle's levels on the SELL kernels. The sign of the Fiedler vector
bisects the graph; a good spectral cut crosses far fewer edges than a
random balanced split.

The matrix is ``SMVP_DEMO_MTX`` (a ``.mtx`` path) when it is set, else a
synthetic banded matrix.

Run: SMVP_DEMO_MTX=m.mtx python examples/torch/spectral_demo.py
     [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from smvp_toolkit_tpu_torch import csr_encode, read_mtx
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.models import amg_preconditioner, lobpcg
from smvp_toolkit_tpu_torch.ops.spmv_sell import sell_op_csr
from smvp_toolkit_tpu_torch.utils.synth import synth_banded

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

mtx = os.environ.get("SMVP_DEMO_MTX")
coo = (read_mtx(mtx, device=args.device) if mtx else
       synth_banded(4096, nnz_per_row=8, bandwidth=32, seed=0,
                    device=args.device))
n = coo.shape[0]
r, c, _ = coo.to_numpy()

# Symmetrized unweighted adjacency (deduplicated through the u<v edges).
off = r != c
u = np.minimum(r[off], c[off]).astype(np.int64)
v = np.maximum(r[off], c[off]).astype(np.int64)
edges = np.unique(u * n + v)
u, v = edges // n, edges % n

deg = np.bincount(u, minlength=n) + np.bincount(v, minlength=n)
lr = np.concatenate([u, v, np.arange(n)])
lc = np.concatenate([v, u, np.arange(n)])
lv = np.concatenate([
    -np.ones(2 * len(u)), deg.astype(np.float64) + 1e-3  # a tiny shift:
]).astype(np.float32)  # L is singular (its nullspace is ones); keep it PD
lap = csr_encode(COOMatrix.from_numpy(
    lr.astype(np.int32), lc.astype(np.int32), lv, shape=(n, n),
    pad_to=128, device=args.device,
))

X0 = torch.from_numpy(
    np.random.RandomState(0).standard_normal((n, 2)).astype(np.float32)
).to(args.device)
# Graph Laplacians have tightly clustered small eigenvalues: without a
# preconditioner LOBPCG stalls; the AMG V-cycle, applied to the whole
# 2-column block at once, makes the bottom of the spectrum reachable.
theta, X, res = lobpcg(lap, X0, num_iters=60,
                       m=amg_preconditioner(lap, op_builder=sell_op_csr))
fiedler = X[:, 1].cpu().numpy()

part = fiedler >= np.median(fiedler)  # balanced spectral bisection
cut = int((part[u] != part[v]).sum())
rand = np.random.RandomState(1).permutation(n) < n // 2
rand_cut = int((rand[u] != rand[v]).sum())
print(f"graph: {mtx or 'synthetic banded'} pattern, {n} nodes, "
      f"{len(u)} edges")
print(f"algebraic connectivity (lambda_2): {float(theta[1]):.6f}")
print(f"spectral bisection cut: {cut} edges "
      f"({part.sum()} / {n - part.sum()} nodes)")
print(f"random balanced cut:    {rand_cut} edges")
assert cut < 0.5 * rand_cut, "spectral cut should beat random easily"
