#!/usr/bin/env python
"""Learn the edge values of a sparse operator on the SELL kernels.

The reference toolkit stops at y = A·x with fixed values
(main-cli.c:410-416); here the values are a trainable parameter:
``SellSpMV.differentiable_edges_mat`` gives ``f(v, X) = A(v)·X`` with
gradients in both arguments, its forward pass on the k-column SpMM kernel,
d/dX through the transpose's operator and d/dv on the values-gradient
kernel. The demo recovers hidden edge weights from (X, Y) observations
with Adam.

Run: python examples/torch/edge_train_demo.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV
from smvp_toolkit_tpu_torch.utils.synth import synth_banded

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
p.add_argument("--steps", type=int, default=1000)
p.add_argument("--n", type=int, default=1500, help="matrix dimension")
args = p.parse_args()

# A sparse operator with secret edge values that the model must recover.
coo = synth_banded(args.n, nnz_per_row=6, bandwidth=48, seed=0,
                   device=args.device)
r, c, v_secret = coo.to_numpy()
op = SellSpMV.from_coo(coo)          # plan once (host), planes on the device
f = op.differentiable_edges_mat()    # f(v, X) = A(v)·X, grads in v and X

# Observations: Y = A(v_secret)·X for 16 random probes (the columns of X).
rng = np.random.default_rng(1)
X = torch.from_numpy(rng.standard_normal((coo.shape[1], 16)).astype(
    np.float32)).to(args.device)
v_true = torch.from_numpy(v_secret.astype(np.float32)).to(args.device)
with torch.no_grad():
    Y = f(v_true, X)

v = torch.zeros_like(v_true, requires_grad=True)  # start from no edges
opt = torch.optim.Adam([v], lr=2e-2)
for i in range(args.steps):
    opt.zero_grad()
    loss = torch.mean((f(v, X) - Y) ** 2)
    loss.backward()
    opt.step()
    if i % 250 == 0:
        print(f"step {i:4d}  loss {loss.item():.3e}")

with torch.no_grad():
    final = float(torch.mean((f(v, X) - Y) ** 2))
    rel = float((v - v_true).abs().max() / v_true.abs().max())
print(f"final loss {final:.3e}  max edge error {rel:.3f}")
