"""Per-device memory and link traffic of the sharded SpMV paths.

Counterpart of the JAX package's ``parallel/traffic.py``: for each
sharding scheme, from the unsharded plan, the bytes each device moves per
SpMV iteration:

* device memory: the shard's share of the SELL planes, its x pass and its
  y block, and
* links: what an iterative consumer (a solver) pays per step to re-form
  its next input: an all-gather of y for row blocks, an all-reduce for
  stripes, an all-reduce along grid rows plus an all-gather along grid
  columns for the 2-D grid. Ring costs: an all-gather moves (D-1)/D of the
  full vector through each device's links, an all-reduce twice that.

The projection takes ``t = max(t_memory, t_link, t_compute)`` per
iteration. The constants are the card's, not the TPU's:

* ``H100_HBM_GBS`` 3,350 GB/s, the H100 SXM data sheet's device-memory
  rate, the figure PERF.md's bounds use;
* ``SLOT_RATE_PER_S`` 163e9 slots/s, the low end of the 163-193 G
  slots/s the k = 1 SELL kernels reached on every route on one NVIDIA
  H100 80GB HBM3 at 700 W (PERF.md section 5, ``chip_smoke.py``);
* ``NVLINK_GBS`` 450 GB/s, NVLink 4's data-sheet rate per direction
  between two cards of one host: data sheet, not measured, since every
  measured run so far had one card.

The JAX module charges the x term it subtracts from the plan's bytes as
one resident pass while its plan may have charged a larger windowed x
pass, leaving x bytes in the per-device plane share. Here the planes'
share is the plan's bytes with no x term (``x_bytes=0``) less the y term
it charged, so x is counted once, per scheme.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from smvp_toolkit_tpu_torch.ops.sell_plan import LANES, SellPlan

__all__ = [
    "TrafficModel", "sharded_spmv_traffic", "scaling_projection",
    "H100_HBM_GBS", "NVLINK_GBS", "SLOT_RATE_PER_S",
]

H100_HBM_GBS = 3350.0
NVLINK_GBS = 450.0
SLOT_RATE_PER_S = 163e9


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Per-device, per-iteration byte counts and projected times."""

    scheme: str
    devices: int
    hbm_bytes: int          # device memory: planes + x + y
    link_bytes: int         # bytes through each device's links
    collectives: tuple      # e.g. ("all_gather(y)",)
    slots: int              # local SELL slots (the compute term)
    plane_bytes: int        # the planes' share of hbm_bytes

    def times_us(self, hbm_gbs: float = H100_HBM_GBS,
                 link_gbs: float = NVLINK_GBS) -> Dict[str, float]:
        t_hbm = self.hbm_bytes / (hbm_gbs * 1e3)
        t_link = self.link_bytes / (link_gbs * 1e3)
        t_compute = self.slots / (SLOT_RATE_PER_S * 1e-6)
        return {
            "hbm_us": t_hbm,
            "link_us": t_link,
            "compute_us": t_compute,
            "iter_us": max(t_hbm, t_link, t_compute),
        }


def _ring_all_gather_bytes(total_bytes: int, d: int) -> int:
    """Bytes through each device's links for a ring all-gather of a
    vector whose full size is ``total_bytes``."""
    if d <= 1:
        return 0
    return int(total_bytes * (d - 1) / d)


def sharded_spmv_traffic(
    plan: SellPlan,
    nrows: int,
    ncols: int,
    devices: int,
    scheme: str = "rowblock",
    *,
    value_bytes: int = 2,
    iterative: bool = True,
    dpr: Optional[int] = None,
) -> TrafficModel:
    """Traffic of one SpMV iteration under a sharding scheme.

    ``plan`` is the global (unsharded) plan; its plane bytes divide by D.
    ``iterative=True`` charges the collective a consumer pays to re-form
    its next input; a one-shot row-block y = A·x with its y left on its
    rank pays none.

    Schemes: ``rowblock`` (``sell_dist``: x replicated, local y block;
    iterative pays all_gather(y)), ``stripe`` (TJDS stripes: partial y on
    every rank; all_reduce(y) always), ``2d`` (``spmv_2d``: dpr × dpc
    grid; all_reduce of the y block along grid rows, all_gather along grid
    columns).
    """
    d = max(int(devices), 1)
    y_bytes = nrows * 4
    x_bytes = ncols * value_bytes
    plane_only = (plan.traffic_bytes(value_bytes, None, x_bytes=0)
                  - plan.n_slices * LANES * 4)
    plane_local = plane_only // d
    slots_local = plan.slots() // d

    if scheme == "rowblock":
        hbm = plane_local + x_bytes + y_bytes // d
        link = _ring_all_gather_bytes(y_bytes, d) if iterative else 0
        coll = ("all_gather(y)",) if (iterative and d > 1) else ()
    elif scheme == "stripe":
        hbm = plane_local + x_bytes + y_bytes
        link = 2 * _ring_all_gather_bytes(y_bytes, d)
        coll = ("all_reduce(y)",) if d > 1 else ()
    elif scheme == "2d":
        if dpr is None:
            dpr = int(np.sqrt(d))
            while d % dpr:
                dpr -= 1
        dpc = d // dpr
        hbm = plane_local + x_bytes // dpr + y_bytes // dpr
        link = 2 * _ring_all_gather_bytes(y_bytes // dpr, dpc) \
            + _ring_all_gather_bytes(y_bytes, dpr)
        coll = tuple(c for c, on in (("all_reduce(y_block)", dpc > 1),
                                     ("all_gather(y)", dpr > 1)) if on)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return TrafficModel(
        scheme=scheme, devices=d, hbm_bytes=int(hbm), link_bytes=int(link),
        collectives=coll, slots=int(slots_local),
        plane_bytes=int(plane_local),
    )


def scaling_projection(plan: SellPlan, nrows: int, ncols: int,
                       device_counts, scheme: str = "rowblock",
                       **kw) -> list:
    """Projected per-iteration time and parallel efficiency against D:
    efficiency(D) = t(1) / (D · t(D))."""
    rows = []
    t1 = None
    for d in device_counts:
        tm = sharded_spmv_traffic(plan, nrows, ncols, d, scheme, **kw)
        t = tm.times_us()
        if d == 1 or t1 is None:
            t1 = t["iter_us"] * d  # d == 1 first by convention
        rows.append({
            "devices": d,
            "scheme": scheme,
            "hbm_bytes": tm.hbm_bytes,
            "link_bytes": tm.link_bytes,
            "collectives": list(tm.collectives),
            **{k: round(v, 3) for k, v in t.items()},
            "efficiency": round(t1 / (d * t["iter_us"]), 4),
            "bound": max(("hbm_us", "link_us", "compute_us"),
                         key=lambda k: t[k]).replace("_us", ""),
        })
    return rows
