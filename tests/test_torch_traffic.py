"""The port's traffic model (``parallel/traffic.py``) against the JAX
package's: the same x, y and collective terms for every scheme and device
count, the planes' share without an x term, and the card's constants.

The planes' own bytes differ by design: the port charges the route's
kernel (``SellPlan.traffic_bytes``: one merged word per sublane where it
fits), the JAX module its TPU launch. The traffic model runs no
collective, so no process group is needed here.
"""

from __future__ import annotations

import numpy as np
import pytest

from smvp_toolkit_tpu.ops.sell_plan import build_sell_plan as jplan
from smvp_toolkit_tpu.parallel import traffic as JT
from smvp_toolkit_tpu_torch.ops.sell_plan import LANES, build_sell_plan
from smvp_toolkit_tpu_torch.parallel import traffic as PT

from conftest import random_coo

# JAX's collective names, as torch.distributed names them.
NAMES = {"psum(y)": "all_reduce(y)", "psum(y_block)": "all_reduce(y_block)",
         "all_gather(y)": "all_gather(y)"}


def _plans(n=4096, m=3000, nnz=30000, chunk=256):
    rng = np.random.RandomState(7)
    r, c, v = random_coo(rng, n, m, nnz)
    args = (r.astype(np.int64), c.astype(np.int64), v.astype(np.float32),
            (n, m))
    return jplan(*args, chunk=chunk), build_sell_plan(*args, chunk=chunk)


def _jax_plane_local(jp, d, vb):
    """The JAX model's per-device plane share, as its module computes it."""
    charged = jp.traffic_bytes(vb, None, vb)
    return (charged - jp.n_coltiles * LANES * vb
            - jp.n_slices * LANES * 4) // d


@pytest.mark.parametrize("iterative", [True, False])
@pytest.mark.parametrize("vb", [2, 4])
@pytest.mark.parametrize("scheme", ["rowblock", "stripe", "2d"])
def test_terms_equal_jax(scheme, vb, iterative):
    jp, pp = _plans()
    n, m = pp.shape
    for d in (1, 2, 4, 8, 16, 64):
        j = JT.sharded_spmv_traffic(jp, n, m, d, scheme, value_bytes=vb,
                                    iterative=iterative)
        p = PT.sharded_spmv_traffic(pp, n, m, d, scheme, value_bytes=vb,
                                    iterative=iterative)
        assert p.link_bytes == j.ici_bytes
        assert p.collectives == tuple(NAMES[c] for c in j.collectives)
        assert p.slots == j.slots and p.devices == j.devices
        assert (p.hbm_bytes - p.plane_bytes
                == j.hbm_bytes - _jax_plane_local(jp, d, vb))


@pytest.mark.parametrize("d", [1, 3, 8])
def test_plane_share_counts_no_x(d):
    """The planes' share is the plan's bytes with no x pass, less the y
    it charged, over D: x enters once, in the scheme's own term."""
    _, pp = _plans()
    n, m = pp.shape
    p = PT.sharded_spmv_traffic(pp, n, m, d, "rowblock", value_bytes=4)
    planes = pp.traffic_bytes(4, None, x_bytes=0) - pp.n_slices * LANES * 4
    assert p.plane_bytes == planes // d
    assert p.hbm_bytes == p.plane_bytes + m * 4 + n * 4 // d
    x_charged = pp.n_coltiles * LANES * 4
    assert pp.traffic_bytes(4, None, 4) - pp.traffic_bytes(4, None, 0) \
        == x_charged


def test_card_constants_and_times():
    _, pp = _plans()
    n, m = pp.shape
    assert (PT.H100_HBM_GBS, PT.NVLINK_GBS, PT.SLOT_RATE_PER_S) == (
        3350.0, 450.0, 163e9)
    tm = PT.sharded_spmv_traffic(pp, n, m, 4, "rowblock")
    t = tm.times_us()
    assert t["hbm_us"] == tm.hbm_bytes / 3350e3
    assert t["link_us"] == tm.link_bytes / 450e3
    assert t["compute_us"] == tm.slots / 163e3
    assert t["iter_us"] == max(t["hbm_us"], t["link_us"], t["compute_us"])


@pytest.mark.parametrize("scheme", ["rowblock", "stripe", "2d"])
def test_scaling_projection_rows(scheme):
    jp, pp = _plans()
    n, m = pp.shape
    counts = [1, 2, 4, 8, 64, 256]
    rows = PT.scaling_projection(pp, n, m, counts, scheme)
    jrows = JT.scaling_projection(jp, n, m, counts, scheme)
    assert rows[0]["efficiency"] == 1.0
    for r, j in zip(rows, jrows):
        assert r["devices"] == j["devices"] and r["scheme"] == scheme
        assert r["link_bytes"] == j["ici_bytes"]
        assert r["collectives"] == [NAMES[c] for c in j["collectives"]]
        assert r["bound"] in ("hbm", "link", "compute")
        t = PT.sharded_spmv_traffic(pp, n, m, r["devices"], scheme)
        assert r["iter_us"] == round(t.times_us()["iter_us"], 3)
    effs = [r["efficiency"] for r in rows]
    for i in range(1, len(rows)):
        if rows[i - 1]["bound"] == "link":
            assert effs[i] <= effs[i - 1] + 1e-9
    with pytest.raises(ValueError, match="unknown scheme"):
        PT.sharded_spmv_traffic(pp, n, m, 2, "ring")
