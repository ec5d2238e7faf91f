"""SELL plan auto-tuning logic: the chunk size by a calibrated cost model.

A copy of the JAX package's ``ops/autotune.py`` with its shipped rates
(``autotune_rates.json``, the port's own copy), plus the pieces of its
``spmv_pallas.py`` that the model and the co-clustered path read: the
chain-split policy (``_split_policy``, the split half of
``_chain_setting``) and the production plan choice (``_tuned_plan``).
``pick_plan`` gives the JAX package's pick, chunk and cost, for the same
matrix.

The model prices the TPU kernel: HBM traffic, one-hot MXU table and
reduce matmuls, the lane shuffle and a per-grid-step cost, with rates
fitted on v5e cells. It says nothing about the card, so the port's
operators keep chunk 2048 (``spmv_sell._auto_plan``) and use the model
only where the JAX package's own default runs through it:
``cocluster_plan(chunk=None)`` and ``utils/analyze.py``. ``pick_vmem_mb``
returns the TPU VMEM budget for parity; nothing on the card reads it.

The model charges the JAX package's byte count for a plan
(``jax_traffic_bytes``), which differs from the port's
``SellPlan.traffic_bytes``: that one counts the port's route, this one
the TPU kernel's (two split metadata words per sublane, x read once or
per window, no ``y_block_id``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable, Optional, Tuple

import numpy as np

from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    lidx_bytes_for_chunk,
)

__all__ = ["RATES", "production_rates", "plan_cost_us", "pick_plan",
           "pick_vmem_mb", "calibrate_rates", "check_pick_plan",
           "jax_traffic_bytes", "chain_split"]

# The model's defaults (round-1 v5e microbenchmarks, as in the JAX
# module); production_rates() overlays the shipped calibration.
RATES = {
    "hbm_gb_s": 819.0,          # HBM speed of light
    "mxu_mac_us": 4.0e7,        # sustained MXU MAC/us per DEFAULT pass
    "shuffle_gel_s": 150.0,     # take_along_axis lane shuffle
    "grid_step_us": 0.5,        # per-grid-step overhead
}

_RATES_FILE = Path(__file__).resolve().parent / "autotune_rates.json"
_PRODUCTION_RATES: Optional[dict] = None

# Above this many bytes of x the JAX operator leaves its VMEM-resident x
# for a windowed one (``_RESIDENT_X_LIMIT`` there); the byte count
# charges x once when resident, else one window per chunk.
_RESIDENT_X_LIMIT = 6 * 2**20

# Chunks past this need a raised Mosaic VMEM budget on the TPU.
_VMEM_CHUNK_THRESHOLD = 4096
_VMEM_MB = 100


def production_rates() -> dict:
    """The shipped calibration (``autotune_rates.json``) over ``RATES``.

    The JAX module falls back to ``RATES`` when its file is missing; the
    port's file ships in the package, and a missing or unreadable one
    raises.
    """
    global _PRODUCTION_RATES
    if _PRODUCTION_RATES is None:
        data = json.loads(_RATES_FILE.read_text())
        rates = dict(RATES)
        rates.update({k: v for k, v in data.items() if k in RATES})
        _PRODUCTION_RATES = rates
    return _PRODUCTION_RATES


def pick_vmem_mb(chunk: int) -> Optional[int]:
    """The TPU VMEM budget the JAX operator raises for big chunks (MB),
    or None; returned for parity only."""
    return _VMEM_MB if chunk > _VMEM_CHUNK_THRESHOLD else None


def _split_policy(chunk: int, k: int) -> int:
    """The JAX operator's chain split: four sub-chunk chains at chunks of
    at least 2048 that are multiples of 512, else one."""
    if chunk >= 2048 and chunk % (4 * LANES) == 0:
        return 4
    return 1


def chain_split(chunk: int) -> int:
    """The chain split of a k = 1 launch: ``SMVP_SELL_SPLIT_CHAIN`` when
    set, else ``_split_policy`` (the split half of the JAX
    ``_chain_setting``, read at call time as there)."""
    env = os.environ.get("SMVP_SELL_SPLIT_CHAIN")
    return int(env) if env else _split_policy(chunk, 1)


def jax_traffic_bytes(plan: SellPlan, value_bytes: int = 4,
                      lidx_bytes: Optional[int] = None,
                      x_bytes: int = 4) -> int:
    """The JAX package's ``SellPlan.traffic_bytes`` for one k = 1 launch.

    The values and lane-index planes, the rel_tile and slice_of words
    (int32 each), ``tile_base``, x and y once. x is read once when its
    ``CT·128·x_bytes`` fits ``_RESIDENT_X_LIMIT``, else one window of
    ``WT`` tiles per chunk. ``lidx_bytes`` defaults to the lane width the
    operator picks (``SMVP_SELL_LIDX32=1`` included).
    """
    if lidx_bytes is None:
        lidx_bytes = lidx_bytes_for_chunk(plan.chunk)
    if plan.n_coltiles * LANES * x_bytes <= _RESIDENT_X_LIMIT:
        x_traffic = plan.n_coltiles * LANES * x_bytes
    else:
        x_traffic = plan.n_chunks * plan.window_tiles * LANES * x_bytes
    s = plan.n_sublanes
    return int(
        s * LANES * (value_bytes + lidx_bytes)
        + s * 4 + s * 4                       # rel_tile, slice_of
        + plan.n_chunks * 4                   # tile_base
        + x_traffic
        + plan.n_slices * LANES * 4           # y
    )


def plan_cost_us(
    plan: SellPlan,
    value_dtype_bytes: int = 4,
    *,
    table_passes: int = 6,
    reduce_passes: int = 6,
    rates: Optional[dict] = None,
) -> float:
    """Modelled single-launch TPU kernel time in microseconds."""
    r = dict(RATES)
    if rates:
        r.update(rates)
    s = plan.n_sublanes
    traffic = jax_traffic_bytes(plan, value_dtype_bytes, None,
                                value_dtype_bytes)
    t_hbm = traffic / (r["hbm_gb_s"] * 1e3)  # bytes / (GB/s) -> us
    t_table = (
        s * plan.window_tiles * LANES * table_passes / r["mxu_mac_us"]
    )
    t_reduce = (  # the windowed reduce contracts NSW, not NS
        plan.reduce_window()[1] * s * LANES * reduce_passes
        / r["mxu_mac_us"]
    )
    t_shuffle = s * LANES / (r["shuffle_gel_s"] * 1e3)
    t_grid = plan.n_chunks * r["grid_step_us"]
    return float(max(t_hbm, t_table + t_reduce + t_shuffle) + t_grid)


def pick_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    *,
    chunks: Iterable[int] = (512, 1024, 2048, 4096, 8192),
    value_dtype_bytes: int = 4,
    bf16: bool = False,
    rates: Optional[dict] = None,
) -> Tuple[SellPlan, float]:
    """Build candidate plans across chunk sizes, return (best, cost_us).

    bf16 value mode prices a single-pass table matmul and a 3-pass
    reduce, f32 6-pass both. Split-compatible chunks (``_split_policy``
    4) are discounted to 0.78 of their cost, and within 1.2x of the best
    cost a split-compatible chunk wins, as in the JAX module. A small
    matrix whose planner shrinks the chunk stops the sweep there.
    """
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan

    table_p = 1 if bf16 else 6
    reduce_p = 3 if bf16 else 6
    vb = 2 if bf16 else value_dtype_bytes
    split_factor = {1: 1.0, 4: 0.78}

    cands = []
    for chunk in sorted(chunks):
        plan = _auto_plan(rows, cols, vals, shape, chunk=chunk)
        split = _split_policy(plan.chunk, 1)
        cost = plan_cost_us(
            plan, vb, table_passes=table_p, reduce_passes=reduce_p,
            rates=rates,
        ) * split_factor.get(split, 1.0)
        cands.append((plan, cost, split))
        if plan.chunk < chunk:
            break  # the planner shrank the chunk: larger ones repeat it
    best_cost = min(c for _p, c, _s in cands)
    near = [t for t in cands if t[1] <= 1.2 * best_cost]
    plan, cost, _split = min(near, key=lambda t: (-t[2], t[1]))
    return plan, cost


def _tuned_plan(rows, cols, vals, shape, *, bf16: bool):
    """The JAX operator's production plan choice, ``(plan, vmem_mb)``:
    ``pick_plan`` at the shipped rates, or chunk 2048 (``_auto_plan``)
    under ``SMVP_SELL_AUTOTUNE=0``."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan

    if os.environ.get("SMVP_SELL_AUTOTUNE") == "0":
        return _auto_plan(rows, cols, vals, shape), None
    plan, _cost = pick_plan(rows, cols, vals, shape, bf16=bf16,
                            rates=production_rates())
    return plan, pick_vmem_mb(plan.chunk)


def _passes(rec: dict) -> Tuple[int, int]:
    """(table_passes, reduce_passes) implied by a session record's flags:
    bf16 value mode runs a single-pass table matmul; the reduce is 3-pass
    (HIGH) for bf16 and f32-HIGH, 6-pass (HIGHEST) for plain f32; the
    double-bf16 reduce2 ladder replaces both with 2 single-pass matmuls
    (the table stays single-pass in bf16 value mode)."""
    # "HIGHEST" contains "HIGH": classify it as the 6-pass default.
    prec = str(rec.get("precision") or "")
    high = "HIGH" in prec and "HIGHEST" not in prec
    if rec.get("bf16"):
        table = 1
    elif rec.get("reduce2"):
        table = 2
    else:
        table = 3 if high else 6
    if rec.get("reduce2"):
        reduce = 2
    else:
        reduce = 3 if (rec.get("bf16") or high) else 6
    return table, reduce


def _cost_terms(rec: dict) -> Tuple[float, float, float, float]:
    """(total MACs, shuffle elements, grid steps, traffic bytes)."""
    tp, rp = _passes(rec)
    macs = rec["S"] * rec["WT"] * LANES * tp + rec["NSW"] * rec["S"] * (
        LANES * rp
    )
    return (float(macs), float(rec["S"] * LANES),
            float(rec["n_chunks"]), float(rec["traffic_bytes"]))


def _usable(records: Iterable[dict]) -> list:
    return [
        r for r in records
        if r.get("avg_us") and r.get("err", 1.0) < 1e-2
        and not r.get("env_compat") and not r.get("env_nowindow")
        # only plain SpMV stages carry the plan geometry the cost terms
        # need (grad/spmm records have no "S"/"WT")
        and "S" in r and "WT" in r
    ]


def calibrate_rates(records: Iterable[dict]) -> dict:
    """Fit RATES from measured session records.

    Fits the additive model t = a·MACs + b·shuffle + c·chunks +
    d·traffic by non-negative least squares (terms the data cannot
    identify keep their default RATES). Returns a full rates dict
    usable by ``pick_plan``.
    """
    recs = _usable(records)
    out = dict(RATES)
    if len(recs) < 3:
        return out
    A = np.array([_cost_terms(r) for r in recs])
    y = np.array([r["avg_us"] for r in recs])
    try:
        from scipy.optimize import nnls

        coef, _ = nnls(A, y)
    except Exception:
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        coef = np.clip(coef, 0.0, None)
    a, b, c, d = coef
    if a > 0:
        out["mxu_mac_us"] = 1.0 / a
    if b > 0:
        out["shuffle_gel_s"] = 1.0 / (b * 1e3)
    if c > 0:
        out["grid_step_us"] = float(c)
    if d > 0:
        out["hbm_gb_s"] = 1.0 / (d * 1e3)
    out["calibrated_on"] = len(recs)
    return out


def check_pick_plan(records: Iterable[dict], rates: dict) -> list:
    """Compare the model's chunk choice with the measured best per
    (matrix, bf16) group that has a chunk sweep. Returns verdict lines.
    """
    r = {k: v for k, v in rates.items() if k in RATES}
    groups: dict = {}
    for rec in _usable(records):
        # only sweep-comparable rows: the default kernel configuration
        if rec.get("reduce2") or rec.get("lidx32") or rec.get("precision") \
                or rec.get("resident") is not None \
                or rec.get("stream_y_blocks"):
            continue
        groups.setdefault((rec["name"], bool(rec.get("bf16"))), {})[
            rec["chunk"]
        ] = rec
    verdicts = []
    for (name, bf16), by_chunk in sorted(groups.items()):
        if len(by_chunk) < 2:
            continue
        measured_best = min(by_chunk, key=lambda ch: by_chunk[ch]["avg_us"])

        def model_us(rec):
            macs, shuf, chunks, traffic = _cost_terms(rec)
            return max(
                traffic / (r["hbm_gb_s"] * 1e3),
                macs / r["mxu_mac_us"] + shuf / (r["shuffle_gel_s"] * 1e3),
            ) + chunks * r["grid_step_us"]

        model_best = min(by_chunk, key=lambda ch: model_us(by_chunk[ch]))
        ok = measured_best == model_best
        verdicts.append(
            f"{name} bf16={bf16}: measured best chunk={measured_best} "
            f"({by_chunk[measured_best]['avg_us']:.1f} us), model picks "
            f"{model_best} -> {'MATCH' if ok else 'MISMATCH'}"
        )
    return verdicts
