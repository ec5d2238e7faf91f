#!/usr/bin/env python
"""Encode once, serve many: plan checkpoint -> reload -> iterated SpMV.

The deployment pattern: planning (host CPU, the C++ pass) happens once at
ingest; serving processes load the kernel-ready planes and run iterated
SpMV on the device. The alternative artifact is the SpMV program itself,
exported with ``torch.export`` (``.pt2``): a serving process loads it
with ``torch.export.load`` alone, with no planner and no import of this
package.

The matrix is ``SMVP_DEMO_MTX`` (a ``.mtx`` path) when it is set, else a
synthetic banded matrix.

Run: SMVP_DEMO_MTX=m.mtx python examples/torch/serving_demo.py
     [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch

from smvp_toolkit_tpu_torch import read_mtx
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.models import power_iteration
from smvp_toolkit_tpu_torch.ops.sell_plan import build_sell_plan
from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV
from smvp_toolkit_tpu_torch.utils.aot import export_spmv, import_program
from smvp_toolkit_tpu_torch.utils.checkpoint import load_plan, save_plan
from smvp_toolkit_tpu_torch.utils.synth import synth_banded

p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

with tempfile.TemporaryDirectory() as tmp:
    # --- ingest side: parse, plan, checkpoint ---
    mtx = os.environ.get("SMVP_DEMO_MTX")
    coo = (read_mtx(mtx, device=args.device) if mtx else
           synth_banded(8192, nnz_per_row=9, bandwidth=64, seed=0,
                        device=args.device)).pad(512)
    r, c, v = coo.to_numpy()
    plan = build_sell_plan(r, c, v, coo.shape)
    ckpt = os.path.join(tmp, "plan.npz")
    save_plan(ckpt, plan)
    print(f"plan: {plan.n_sublanes} sublanes -> plan.npz "
          f"({os.path.getsize(ckpt) / 1e6:.1f} MB)")

    # --- serving side: reload, build the operator, iterate on device ---
    op = SellSpMV(load_plan(ckpt), device=args.device)
    x0 = torch.ones(coo.shape[1], device=args.device)
    lam, vec = power_iteration(None, x0, num_iters=50,
                               spmv=lambda _m, x: op(x))
    print(f"dominant |eigenvalue| estimate: {float(lam):.6g}")

    # --- the other artifact: the exported SpMV program (.pt2) ---
    blob = export_spmv(csr_encode(coo))
    path = os.path.join(tmp, "spmv.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    print(f"AOT artifact: spmv.pt2 ({len(blob) / 1e6:.1f} MB)")
    call = import_program(blob)
    y = call(torch.ones(coo.shape[1], device=args.device))
    y_sell = op(torch.ones(coo.shape[1], device=args.device))
    print(f"served y checksum: {float(y.sum()):.6g} (SELL operator "
          f"{float(y_sell[: coo.shape[0]].sum()):.6g})")
