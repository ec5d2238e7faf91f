"""SELL plan autotuning: the chunk by a cost model calibrated on the card.

The counterpart of the JAX package's ``ops/autotune.py`` and of its
production plan choice (``spmv_pallas._tuned_plan``). The JAX model prices
its TPU kernel (MXU passes, a lane shuffle, grid steps) with rates fitted
on that chip; this one prices the launch the port's operator makes for a
plan on the card, with rates fitted there (``autotune_rates.json``, fitted
by ``python -m smvp_toolkit_tpu_torch.bench.calibrate`` from the records
in ``autotune_records.jsonl``).

What the chunk moves. The planner sorts a matrix's sublanes tile-major
whatever the chunk and only then cuts them into chunks
(``sell_plan.rechunk_plan``), so the chunk sets three things: the padding
sublanes that round each plan (each y block of a streamed plan) up to a
whole chunk, the tile window WT of the widest chunk, and through WT the
route: the merged rel‖slice word where WT <= 511, the split planes above
(``SellSpMV.route``). ``lidx_bytes_for_chunk`` moves the lane width of
chunks that are not a multiple of 32 sublanes.

The cost model, one k = 1 forward launch of the plan's route
(``plan_route``: resident or streamed y, merged word or split planes,
under ``SMVP_SELL_RELSL``), additive and linear in what the plan gives:

* bytes: what the launch moves: ``SellPlan.traffic_bytes``
  of that route and value width (the planes, the per-sublane words, the
  per-chunk words, x and y once) less the planes of the dead sublanes,
  which a kernel skips before any plane load (``sell_common.cuh``: a
  warp reads a dead sublane's metadata word and nothing else); over the
  card's byte rate, fitted apart for float32 and bfloat16 values (bf16
  launches read fewer bytes but not proportionally faster);
* a term per live sublane of the most loaded slice (``hub_sublanes``):
  the sublanes of one slice add into the same 128 rows of y, so their
  atomics serialise; gcn_arxiv's Aᵀ, whose one hub row of 168,430
  products fills most of its sublanes, runs 6x longer than smoke's plan
  of about as many sublanes and bytes;
* a launch term.

Three more terms were fitted on the same records and left out. A term
per sublane, the padding ones included, took the 27% more bytes of L1's
chunk 8192 plan than its chunk 512 plan (all padding sublanes) for a
cost, where the card runs the two within 0.3%; counted on the live
sublanes it fits to 0, as a live sublane's work is in its bytes. A
per-chunk term took 6.4 ns a chunk from the differences between
matrices, while within a matrix the chunk count moves nothing (smoke:
368 chunks at 53.74 µs, 23 at 53.38). A per-sublane term of the split
routes fitted to 0: their second metadata word is in the bytes already.

The pick (``pick_plan``). On the card the chunk moves a launch little
(``autotune_records.jsonl``, an H100 80GB HBM3 at 700 W): within each
calibration matrix the candidates lie within 1% of each other, but for
the bfloat16 sweeps of gcn_arxiv's A (4.8%, the merged word below chunk
2048 against the split planes) and poisson1024 (2.8%); the repeats of
one launch spread by up to 2.7%. So the sweep keeps ``_auto_plan``'s
chunk 2048 unless its cheapest candidate is modelled ``MARGIN`` (2%)
faster: a difference the model cannot tell from noise moves no plan,
and the plans stay put across recalibrations. This departs from the
JAX sweep, which keeps the cheapest.

``calibrate_rates`` fits the four by non-negative least squares on
measured records (geometry and the median card µs of queued launches);
a term the fit sets to 0 is one the data could not see. The TPU model's
MXU passes, lane shuffle, chain-split discount and VMEM budget have no
counterpart here: the card has no MXU and no VMEM.

``_tuned_plan`` keeps the JAX function's result pair, ``(plan, None)``:
the second place holds the JAX operator's VMEM budget there, which the
card has no use for. ``tuned_plan`` returns the pick's modelled µs in its
place, for the operator's route gate.

The ``csr`` route's gate (``takes_csr``). The same model prices K12, the
merge-path CSR SpMV (``ops/csr_merge.py``), on the bytes it moves
(``csr_bytes``: each nonzero's column and value, the row pointer, x and y
once) and one launch. ``SellSpMV.__call__`` takes the route where that
cost is at most ``1 / CSR_GAIN`` of the plan's: a plan whose sublanes hold
few nonzeros each (a permuted power-law graph, one sublane a nonzero). With
the launch term in both costs, no plan under about 26 MB of planes
qualifies.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    lidx_bytes_for_chunk,
    rechunk_plan,
)
from smvp_toolkit_tpu_torch.utils import tracing

__all__ = ["RATES", "CHUNKS", "DEFAULT_CHUNK", "MARGIN", "production_rates",
           "plan_route", "plan_bytes", "hub_sublanes", "plan_cost_us",
           "sweep_plans", "pick_plan", "calibrate_rates", "check_pick_plan",
           "plan_record", "chain_split", "tuned_plan", "CSR_GAIN",
           "csr_bytes", "csr_cost_us", "takes_csr"]

# The candidate chunks of the sweep (the JAX module's), and the default.
CHUNKS = (512, 1024, 2048, 4096, 8192)
DEFAULT_CHUNK = 2048
# The modelled gain over the default a pick must clear: the spread of one
# launch's repeats and calibrations on the card (module docstring).
MARGIN = 0.02
# How many times cheaper than the plan the csr route must be modelled.
CSR_GAIN = 2.0

# The model's defaults, before a calibration: the H100's data-sheet
# memory rate (3.35 TB/s, SXM, 700 W) and no other cost;
# production_rates() overlays the shipped calibration.
RATES = {
    "gb_s_f32": 3350.0,       # bytes of a float32 launch, GB/s
    "gb_s_bf16": 3350.0,      # bytes of a bfloat16 launch, GB/s
    "hub_sublane_ns": 0.0,    # per live sublane of the most loaded slice, ns
    "launch_us": 0.0,         # per launch, us
}

_RATES_FILE = Path(__file__).resolve().parent / "autotune_rates.json"
RECORDS_FILE = Path(__file__).resolve().parent / "autotune_records.jsonl"
_PRODUCTION_RATES: Optional[dict] = None

_SPLIT_ROUTES = ("split", "streamy")


def production_rates() -> dict:
    """The shipped calibration (``autotune_rates.json``) over ``RATES``.

    The file ships in the package; a missing or unreadable one raises."""
    global _PRODUCTION_RATES
    if _PRODUCTION_RATES is None:
        data = json.loads(_RATES_FILE.read_text())
        rates = dict(RATES)
        rates.update({k: float(data[k]) for k in RATES})
        _PRODUCTION_RATES = rates
    return _PRODUCTION_RATES


def _split_policy(chunk: int, k: int) -> int:
    """The JAX operator's chain split: four sub-chunk chains at chunks of
    at least 2048 that are multiples of 512, else one. K2-subwin reads it
    (``spmv_sell.subwin_split``); the cost model does not."""
    if chunk >= 2048 and chunk % (4 * LANES) == 0:
        return 4
    return 1


def chain_split(chunk: int) -> int:
    """The chain split of a k = 1 launch: ``SMVP_SELL_SPLIT_CHAIN`` when
    set, else ``_split_policy`` (the split half of the JAX
    ``_chain_setting``, read at call time as there)."""
    env = os.environ.get("SMVP_SELL_SPLIT_CHAIN")
    return int(env) if env else _split_policy(chunk, 1)


def plan_route(plan: SellPlan) -> str:
    """The route ``SellSpMV.route`` takes for ``plan`` under the plane
    switch ``SMVP_SELL_RELSL`` (the opt-in K5 and K6 switches are not
    priced): ``relsl``/``split`` on a resident-y plan,
    ``streamy_relsl``/``streamy`` on a streamed one."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _relsl_on

    merged = plan.merged_word and _relsl_on()
    if plan.y_block_slices:
        return "streamy_relsl" if merged else "streamy"
    return "relsl" if merged else "split"


def plan_bytes(plan: SellPlan, value_bytes: int = 4) -> int:
    """``SellPlan.traffic_bytes`` of one k = 1 launch of the plan's route
    (x in the value dtype): a merged-word plan run on the split planes
    (``SMVP_SELL_RELSL=0``) reads two metadata words a sublane."""
    extra = (plan.n_sublanes * 4
             if plan.merged_word and plan_route(plan) in _SPLIT_ROUTES
             else 0)
    return plan.traffic_bytes(value_bytes, x_bytes=value_bytes) + extra


def _live(plan: SellPlan) -> np.ndarray:
    return ((plan.rel_tile.reshape(-1) >= 0)
            & (plan.slice_of.reshape(-1) >= 0))


def _live_sublanes(plan: SellPlan) -> int:
    return int(np.count_nonzero(_live(plan)))


def hub_sublanes(plan: SellPlan) -> int:
    """The live sublanes of the plan's most loaded slice (slices of a
    streamed plan counted apart per y block)."""
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    if plan.y_block_slices:
        sl = sl + np.repeat(plan.y_block_id.astype(np.int64),
                            plan.chunk) * plan.y_block_slices
    live = sl[_live(plan)]
    return int(np.bincount(live).max()) if live.size else 0


def _terms(nbytes: float, bf16: bool, hub: float) -> np.ndarray:
    """The model's terms in the order of ``_COEF``."""
    return np.array([0.0 if bf16 else nbytes, nbytes if bf16 else 0.0,
                     hub, 1.0])


# Each term's rate key and its coefficient (µs per unit) from the rate.
_COEF = (
    ("gb_s_f32", lambda r: 1.0 / (r * 1e3)),
    ("gb_s_bf16", lambda r: 1.0 / (r * 1e3)),
    ("hub_sublane_ns", lambda r: r * 1e-3),
    ("launch_us", lambda r: r),
)
# ... and the rate from a fitted coefficient.
_RATE = (
    lambda c: 1.0 / (c * 1e3),
    lambda c: 1.0 / (c * 1e3),
    lambda c: c * 1e3,
    lambda c: c,
)


def _coefs(rates: Optional[dict]) -> np.ndarray:
    r = dict(RATES)
    if rates:
        r.update({k: v for k, v in rates.items() if k in RATES})
    return np.array([f(float(r[k])) for k, f in _COEF])


def plan_record(plan: SellPlan, value_bytes: int = 4) -> dict:
    """The geometry the model reads from a plan, as a calibration record
    holds it (``us`` is the measurement's)."""
    return {
        "chunk": plan.chunk,
        "route": plan_route(plan),
        "dtype": "bfloat16" if value_bytes == 2 else "float32",
        "S": plan.n_sublanes,
        "live": _live_sublanes(plan),
        "hub": hub_sublanes(plan),
        "n_chunks": plan.n_chunks,
        "WT": plan.window_tiles,
        "lidx_bytes": lidx_bytes_for_chunk(plan.chunk),
        "traffic_bytes": plan_bytes(plan, value_bytes),
    }


def _record_terms(rec: dict) -> np.ndarray:
    # the bytes the launch moves: no kernel loads a dead sublane's values
    # and lane indices
    bf16 = rec["dtype"] == "bfloat16"
    moved = rec["traffic_bytes"] - (rec["S"] - rec["live"]) * LANES * (
        (2 if bf16 else 4) + rec["lidx_bytes"])
    return _terms(moved, bf16, rec["hub"])


def plan_cost_us(plan: SellPlan, value_bytes: int = 4,
                 rates: Optional[dict] = None) -> float:
    """Modelled time of one k = 1 forward launch of the plan's route on
    the card, in µs (``rates`` over ``RATES``)."""
    return float(_record_terms(plan_record(plan, value_bytes))
                 @ _coefs(rates))


def sweep_plans(rows, cols, vals, shape, *, chunks: Iterable[int] = CHUNKS,
                base: Optional[SellPlan] = None,
                planes: bool = True) -> Iterator[SellPlan]:
    """The sweep's candidate plans in chunk order, one at a time.

    The first is ``_auto_plan`` at the smallest chunk (or ``base``, a plan
    of the same triplets at any chunk, cut again), each other the same
    sublanes cut at its chunk (``rechunk_plan``: field for field
    ``_auto_plan`` at that chunk, with no second sort; ``planes`` False
    leaves their values and lane-index planes out). A small matrix whose
    planner shrinks the chunk ends the sweep there, as larger chunks
    would repeat it (the JAX sweep's rule)."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan

    for i, chunk in enumerate(sorted(chunks)):
        if base is None:
            base = plan = _auto_plan(rows, cols, vals, shape, chunk=chunk)
        elif i == 0 and base.chunk == chunk:
            plan = base
        else:
            plan = rechunk_plan(base, chunk, planes=planes)
        yield plan
        if plan.chunk < chunk:
            return  # the planner shrank the chunk: larger ones repeat it


def _choose(costs: dict, default: int) -> int:
    """The chunk ``pick_plan`` keeps of ``costs`` (chunk -> µs): the
    cheapest (the smaller of equal costs) where it is modelled ``MARGIN``
    faster than ``default``, else ``default``."""
    best = min(costs, key=lambda ch: (costs[ch], ch))
    return best if costs[best] < (1 - MARGIN) * costs[default] else default


def pick_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    *,
    chunks: Iterable[int] = CHUNKS,
    bf16: bool = False,
    rates: Optional[dict] = None,
    base: Optional[SellPlan] = None,
) -> Tuple[SellPlan, float]:
    """Price the sweep's candidates (``sweep_plans``) and return
    ``(plan, cost_us)`` of the one ``_choose`` keeps: the cheapest where
    it beats the default chunk 2048 by ``MARGIN``, else chunk 2048's (the
    last candidate where the planner shrank the chunk below 2048, the plan
    ``_auto_plan`` gives at 2048). ``bf16`` prices bfloat16 values.

    One plan is sorted (``_auto_plan`` at the smallest chunk, or ``base``
    where given); the candidates are priced on their geometry alone, with
    no planes of their own, and only the pick is cut with its planes, so
    the host pays one planner sort and at most one more copy of the
    planes."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan

    vb = 2 if bf16 else 4
    chunks = sorted(chunks)
    if base is None:
        base = _auto_plan(rows, cols, vals, shape, chunk=chunks[0])
    with tracing.span("plan.tune"):
        costs, default = {}, None
        for want, plan in zip(chunks, sweep_plans(rows, cols, vals, shape,
                                                  chunks=chunks, base=base,
                                                  planes=False)):
            costs[plan.chunk] = plan_cost_us(plan, vb, rates)
            if want <= DEFAULT_CHUNK or default is None:
                default = plan.chunk
        pick = _choose(costs, default)
        return (base if base.chunk == pick else rechunk_plan(base, pick),
                costs[pick])


def tuned_plan(rows, cols, vals, shape, *,
               bf16: bool) -> Tuple[SellPlan, Optional[float]]:
    """The operators' plan choice, ``(plan, cost_us)``: ``pick_plan`` at
    the shipped rates and its modelled µs, or ``_auto_plan`` at chunk 2048
    and None (not priced) under ``SMVP_SELL_AUTOTUNE=0``."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan

    if os.environ.get("SMVP_SELL_AUTOTUNE") == "0":
        return _auto_plan(rows, cols, vals, shape), None
    return pick_plan(rows, cols, vals, shape, bf16=bf16,
                     rates=production_rates())


def _tuned_plan(rows, cols, vals, shape, *, bf16: bool):
    """``tuned_plan``'s plan as the JAX function's pair, ``(plan, None)``:
    the JAX function returns its VMEM budget in the second place; the card
    has none, so it is None here."""
    return tuned_plan(rows, cols, vals, shape, bf16=bf16)[0], None


def csr_bytes(nnz: int, nrows: int, ncols: int, value_bytes: int = 4) -> int:
    """The bytes one K12 launch moves: each nonzero's column (4) and value,
    the row pointer, x in the value dtype and y (float32), once each."""
    return (nnz * (value_bytes + 4) + (nrows + 1) * 4 + ncols * value_bytes
            + nrows * 4)


def csr_cost_us(nnz: int, nrows: int, ncols: int, value_bytes: int = 4,
                rates: Optional[dict] = None) -> float:
    """Modelled time of one K12 launch on the card, in µs: its bytes at
    the byte rate of its value dtype, and a launch."""
    return float(_terms(csr_bytes(nnz, nrows, ncols, value_bytes),
                        value_bytes == 2, 0.0) @ _coefs(rates))


def takes_csr(plan: SellPlan, nnz: int, value_bytes: int = 4,
              plan_us: Optional[float] = None,
              rates: Optional[dict] = None) -> bool:
    """Whether K12 on the plan's ``nnz`` triplets is modelled ``CSR_GAIN``
    times cheaper than a launch of the plan: ``plan_us`` where the
    autotuner priced it (``tuned_plan``), else ``plan_cost_us``; at the
    shipped rates unless ``rates`` are given."""
    rates = production_rates() if rates is None else rates
    if plan_us is None:
        plan_us = plan_cost_us(plan, value_bytes, rates)
    nrows, ncols = plan.shape
    return (CSR_GAIN * csr_cost_us(nnz, nrows, ncols, value_bytes, rates)
            <= plan_us)


def _usable(records: Iterable[dict]) -> list:
    """The records a fit takes: a measured time, the kernel held to its
    plain version (``err`` within the record's ``tol``, 1e-6 where it
    has none) and repeats that agree (``spread``, (max - min) / median of
    the repeats, at most 0.1)."""
    return [r for r in records
            if r.get("us") and r.get("err", 1.0) <= r.get("tol", 1e-6)
            and r.get("spread", 1.0) <= 0.1]


def calibrate_rates(records: Iterable[dict]) -> dict:
    """Fit ``RATES`` on measured records by non-negative least squares.

    Each record is a plan's geometry (``plan_record``) and ``us``, the
    median card time of its forward launch. A term the fit sets to 0
    keeps its ``RATES`` default (the byte rates the data sheet's, the
    other terms 0). Returns a
    full rates dict for ``pick_plan`` with ``calibrated_on``, the number
    of records fitted. Fewer than ``len(RATES)`` usable records raise."""
    from scipy.optimize import nnls

    recs = _usable(records)
    if len(recs) < len(RATES):
        raise ValueError(f"{len(recs)} usable records; the fit needs at "
                         f"least {len(RATES)}")
    A = np.array([_record_terms(r) for r in recs])
    y = np.array([float(r["us"]) for r in recs])
    # Columns scaled to one, so that the bytes (1e8) and the launch (1)
    # weigh alike in the solver's tolerance.
    scale = np.abs(A).max(axis=0)
    scale[scale == 0] = 1.0
    coef, _res = nnls(A / scale, y)
    coef = coef / scale
    out = dict(RATES)
    for (key, _f), to_rate, c in zip(_COEF, _RATE, coef):
        if c > 0:
            out[key] = float(to_rate(c))
    out["calibrated_on"] = len(recs)
    return out


def check_pick_plan(records: Iterable[dict], rates: dict) -> list:
    """The model's chunk (``_choose`` of the modelled costs, chunk 2048
    the default) against the measured best, per (matrix, dtype) with a
    sweep of at least two chunks: one verdict line each, with the pick's
    time over the best and over chunk 2048 where it was measured."""
    coefs = _coefs(rates)
    groups: dict = {}
    for rec in _usable(records):
        groups.setdefault((rec["name"], rec["dtype"]), {})[rec["chunk"]] = rec
    verdicts = []
    for (name, dtype), by_chunk in sorted(groups.items()):
        if len(by_chunk) < 2:
            continue
        best = min(by_chunk, key=lambda ch: by_chunk[ch]["us"])
        default = (DEFAULT_CHUNK if DEFAULT_CHUNK in by_chunk
                   else max(by_chunk))
        pick = _choose({ch: float(_record_terms(rec) @ coefs)
                        for ch, rec in by_chunk.items()}, default)
        t_pick = by_chunk[pick]["us"]
        vs_2048 = (f", {t_pick / by_chunk[2048]['us']:.3f}x chunk 2048"
                   if 2048 in by_chunk else "")
        verdicts.append(
            f"{name} {dtype}: measured best chunk={best} "
            f"({by_chunk[best]['us']:.2f} us), model picks {pick} "
            f"({t_pick:.2f} us, {t_pick / by_chunk[best]['us']:.3f}x the "
            f"best{vs_2048}) -> {'MATCH' if pick == best else 'MISMATCH'}")
    return verdicts
