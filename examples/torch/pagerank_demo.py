#!/usr/bin/env python
"""PageRank over a sparse matrix on the SELL SpMV kernel.

The matrix is ``SMVP_DEMO_MTX`` (a ``.mtx`` path) when it is set, else a
synthetic power-law matrix.

Run: SMVP_DEMO_MTX=m.mtx python examples/torch/pagerank_demo.py
     [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

from smvp_toolkit_tpu_torch import csr_encode, read_mtx
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.models import pagerank
from smvp_toolkit_tpu_torch.utils.synth import synth_powerlaw

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

mtx = os.environ.get("SMVP_DEMO_MTX")
coo = (read_mtx(mtx, device=args.device) if mtx else
       synth_powerlaw(4096, 40960, alpha=1.2, seed=0, device=args.device))
# Column-normalize so the link matrix is column-stochastic (link weights
# are magnitudes: a signed matrix's column sums may vanish).
r, c, v = coo.to_numpy()
v = np.abs(v)
colsum = np.bincount(c, weights=v, minlength=coo.shape[1])
v_norm = v / np.where(colsum[c] > 0, colsum[c], 1.0)
coo_n = COOMatrix.from_numpy(r, c, v_norm, shape=coo.shape, pad_to=128,
                             device=args.device)

rank = pagerank(csr_encode(coo_n), num_iters=100).cpu().numpy()
top = np.argsort(-rank)[:5]
print("top-5 nodes:", top.tolist())
print("ranks:", np.round(rank[top], 4).tolist())
