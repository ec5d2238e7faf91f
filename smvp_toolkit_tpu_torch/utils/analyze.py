"""Matrix structure analysis: the numbers behind the plan choices.

The counterpart of the JAX package's ``utils/analyze.py``: the structural
statistics the SELL-T1 planner keys on (row-length distribution,
column-tile spread, window sizes) plus classic sparse metrics (bandwidth,
density), equal to the JAX dict for the same matrix, and the plan the
card runs. Used by the CLI's ``--analyze`` flag and by tests.

The ``sell`` block is the operators' plan: the chunk the card's autotuner
picks (``autotune._tuned_plan``, chunk 2048 under
``SMVP_SELL_AUTOTUNE=0``), the route a launch on it takes, the bytes one
launch moves in float32 and bfloat16 (``autotune.plan_bytes``, the
port's ``SellPlan.traffic_bytes`` of that route) and the cost model's
time for each. The JAX dict's ``sell`` block describes its TPU plan
instead (chain split, VMEM budget, its kernel's bytes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["analyze", "format_analysis"]


def analyze(coo) -> Dict:
    """Compute structure statistics for a COO matrix (host-side)."""
    r, c, v = coo.to_numpy()
    nrows, ncols = coo.shape
    nnz = coo.nnz
    out: Dict = {
        "shape": coo.shape,
        "nnz": int(nnz),
        "density": float(nnz / max(nrows * ncols, 1)),
    }
    if nnz == 0:
        return out

    rl = np.bincount(r, minlength=nrows)
    cl = np.bincount(c, minlength=ncols)
    out["row_len"] = {
        "mean": float(rl.mean()),
        "p50": int(np.percentile(rl, 50)),
        "p90": int(np.percentile(rl, 90)),
        "p99": int(np.percentile(rl, 99)),
        "max": int(rl.max()),
        "empty": int((rl == 0).sum()),
    }
    out["col_len"] = {
        "mean": float(cl.mean()),
        "max": int(cl.max()),
        "empty": int((cl == 0).sum()),
    }
    spread = np.abs(r.astype(np.int64) - c.astype(np.int64))
    out["bandwidth"] = {
        "p50": int(np.percentile(spread, 50)),
        "p90": int(np.percentile(spread, 90)),
        "max": int(spread.max()),
    }
    from smvp_toolkit_tpu_torch.ops.autotune import (
        _tuned_plan,
        plan_bytes,
        plan_cost_us,
        plan_route,
        production_rates,
    )

    plan, _ = _tuned_plan(r, c, v, coo.shape, bf16=False)
    rates = production_rates()
    out["sell"] = {
        "sublanes": plan.n_sublanes,
        "slots": plan.slots(),
        "padding_factor": float(plan.slots() / nnz),
        "window_tiles": plan.window_tiles,
        "col_tiles": plan.n_coltiles,
        "chunks": plan.n_chunks,
        "chunk": plan.chunk,
        "route": plan_route(plan),
        # Bytes one launch on the card moves, f32 and bf16 values.
        "traffic_f32_bytes": plan_bytes(plan, 4),
        "traffic_bf16_bytes": plan_bytes(plan, 2),
        "model_f32_us": plan_cost_us(plan, 4, rates),
        "model_bf16_us": plan_cost_us(plan, 2, rates),
    }
    out["tjds_diags"] = int(cl.max())
    return out


def format_analysis(stats: Dict) -> str:
    """Human-readable rendering of :func:`analyze` output."""
    lines = [
        f"shape {stats['shape'][0]}x{stats['shape'][1]}  nnz {stats['nnz']}"
        f"  density {stats['density']:.2e}",
    ]
    if "row_len" in stats:
        r = stats["row_len"]
        lines.append(
            f"row len: mean {r['mean']:.1f}  p50 {r['p50']}  p90 {r['p90']}"
            f"  p99 {r['p99']}  max {r['max']}  empty {r['empty']}"
        )
        b = stats["bandwidth"]
        lines.append(
            f"bandwidth |r-c|: p50 {b['p50']}  p90 {b['p90']}  max {b['max']}"
        )
        s = stats["sell"]
        lines.append(
            f"SELL plan (autotuned for the card): {s['sublanes']} sublanes "
            f"({s['padding_factor']:.1f}x slots), window "
            f"{s['window_tiles']}/{s['col_tiles']} tiles, "
            f"{s['chunks']} chunk(s) of {s['chunk']}, route {s['route']}"
        )
        lines.append(
            f"SELL traffic/launch: f32 "
            f"{s['traffic_f32_bytes']/1e6:.2f} MB, bf16 "
            f"{s['traffic_bf16_bytes']/1e6:.2f} MB "
            f"(occupancy {1.0/s['padding_factor']:.2f}); model "
            f"{s['model_f32_us']:.1f} / {s['model_bf16_us']:.1f} us"
        )
        lines.append(f"TJDS diagonals: {stats['tjds_diags']}")
    return "\n".join(lines)
