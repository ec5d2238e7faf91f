#!/usr/bin/env python
"""Graph convolution on a sparse matrix's pattern, on the SpMM kernels.

Treats the matrix's sparsity pattern as a graph, builds the Kipf-Welling
normalized adjacency, and trains a 2-layer GCN to classify nodes by the
parity of their row degree (a toy label that needs neighborhood
information): first with the plain PyTorch SpMM, then with the
aggregation on the SELL SpMM kernel (forward A·X, backward Aᵀ·G).

The matrix is ``SMVP_DEMO_MTX`` (a ``.mtx`` path) when it is set, else a
synthetic banded graph.

Run: SMVP_DEMO_MTX=m.mtx python examples/torch/gcn_demo.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from smvp_toolkit_tpu_torch import read_mtx
from smvp_toolkit_tpu_torch.models import gcn_init, gcn_norm, gcn_train_step
from smvp_toolkit_tpu_torch.ops.spmv_torch import spmm_csr
from smvp_toolkit_tpu_torch.utils.synth import synth_banded

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

MTX = os.environ.get("SMVP_DEMO_MTX")
coo = (read_mtx(MTX, device=args.device) if MTX else
       synth_banded(2048, nnz_per_row=8, bandwidth=64, seed=0,
                    device=args.device))
n = coo.shape[0]
print(f"graph: {MTX or 'synthetic banded'}, {n} nodes, {coo.nnz} entries")
s = gcn_norm(coo)

r, c, v = coo.to_numpy()
deg = np.bincount(r, minlength=n)
labels = torch.from_numpy((deg % 2).astype(np.int64)).to(args.device)
h = torch.from_numpy(
    np.random.RandomState(0).randn(n, 8).astype(np.float32)).to(args.device)
mask = torch.ones(n, dtype=torch.bool, device=args.device)

for name, spmm in (("plain PyTorch SpMM", spmm_csr),
                   ("SELL SpMM kernel", None)):
    params = gcn_init(torch.Generator().manual_seed(0), [8, 16, 2],
                      device=args.device)
    losses = []
    for _ in range(100):
        params, loss = gcn_train_step(s, params, h, labels, mask, lr=0.1,
                                      spmm=spmm)
        losses.append(float(loss))
    print(f"loss ({name}): {losses[0]:.3f} -> {losses[-1]:.3f}")
