"""Matrix structure analysis: the numbers behind the plan choices.

A copy of the JAX package's ``utils/analyze.py``: the structural
statistics the SELL-T1 planner keys on (row-length distribution,
column-tile spread, slot padding, window sizes) plus classic sparse
metrics (bandwidth, density), as one dict equal to the JAX package's for
the same matrix. Used by the CLI's ``--analyze`` flag and by tests.

The plan metrics are the JAX operator's production plan: the autotuned
chunk (``autotune._tuned_plan``, chunk 2048 under
``SMVP_SELL_AUTOTUNE=0``), its chain split and TPU VMEM budget, and the
JAX package's bytes per launch (``autotune.jax_traffic_bytes``). They
describe the TPU plan the JAX package would run; the port's operators
run chunk 2048 and count their own bytes (``SellPlan.traffic_bytes``).
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
        _split_policy,
        _tuned_plan,
        jax_traffic_bytes,
    )

    plan, vmem = _tuned_plan(r, c, v, coo.shape, bf16=False)
    out["sell"] = {
        "sublanes": plan.n_sublanes,
        "slots": plan.slots(),
        "padding_factor": float(plan.slots() / nnz),
        "window_tiles": plan.window_tiles,
        "col_tiles": plan.n_coltiles,
        "chunks": plan.n_chunks,
        "chunk": plan.chunk,
        "split_chain": _split_policy(plan.chunk, 1),
        "vmem_mb": vmem,
        # Bytes one TPU launch moves in f32 and bf16 value modes.
        "traffic_f32_bytes": jax_traffic_bytes(plan, 4, None, 4),
        "traffic_bf16_bytes": jax_traffic_bytes(plan, 2, None, 2),
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
            f"SELL plan (autotuned): {s['sublanes']} sublanes "
            f"({s['padding_factor']:.1f}x slots), window "
            f"{s['window_tiles']}/{s['col_tiles']} tiles, "
            f"{s['chunks']} chunk(s) of {s['chunk']}, "
            f"chain split {s['split_chain']}"
            + (f", VMEM {s['vmem_mb']} MB" if s['vmem_mb'] else "")
        )
        lines.append(
            f"SELL traffic/launch: f32 "
            f"{s['traffic_f32_bytes']/1e6:.2f} MB, bf16 "
            f"{s['traffic_bf16_bytes']/1e6:.2f} MB "
            f"(occupancy {1.0/s['padding_factor']:.2f})"
        )
        lines.append(f"TJDS diagonals: {stats['tjds_diags']}")
    return "\n".join(lines)
