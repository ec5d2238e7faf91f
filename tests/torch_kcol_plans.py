"""Plans for the k-column kernels (K1 and K4 with k columns), numpy only,
shared by the CPU tests (tests/test_torch_sell_plan.py,
tests/test_torch_spmm.py) and the card tests (tests/test_torch_cuda.py).

Their kernels walk work items of 64 sublanes of one chunk and sum a run of
sublanes of one slice (a row's duplicate sublanes in one tile lie next to
each other in plan order) per row before one atomic. ``hub_row_plan`` puts
a row of 200 entries in one column tile (duplicate coordinates, summed by
the kernels as separate products), so its 200 duplicate sublanes run past
several 64-sublane items, beside random entries, on the merged-word route
(``relsl``: 3000 x 3000) or the split planes (``split``: 547 column tiles,
a window over 511). ``runs`` gives each plan's runs of consecutive live
sublanes with one (tile, slice) cell; ``cells_adjacent`` says whether
every cell's sublanes lie next to each other.
"""

from __future__ import annotations

import numpy as np

from smvp_toolkit_tpu_torch.ops.sell_plan import build_sell_plan

HUB_ROW = 1000
HUB_ENTRIES = 200
HUB_TILE = 3
ITEM = 64  # sublanes of one work item (sell_common.cuh, kRun)


def hub_row_triplets(route: str):
    """(rows, cols, values, shape, chunk) of ``hub_row_plan``."""
    rng = np.random.RandomState(13)
    if route == "relsl":
        shape, nnz, chunk = (3000, 3000), 20000, 2048
    else:
        shape, nnz, chunk = (3000, 70000), 800, 1024
    r = rng.randint(0, shape[0], nnz)
    c = rng.randint(0, shape[1], nnz)
    hr = np.full(HUB_ENTRIES, HUB_ROW)
    hc = rng.randint(HUB_TILE * 128, (HUB_TILE + 1) * 128, HUB_ENTRIES)
    r, c = np.concatenate([r, hr]), np.concatenate([c, hc])
    return r, c, rng.randn(r.size), shape, chunk


def hub_row_plan(route: str):
    r, c, v, shape, chunk = hub_row_triplets(route)
    return build_sell_plan(r, c, v, shape, chunk=chunk)


def _cells(plan):
    """Per sublane: its (tile, slice) cell as one int64, -1 when dead."""
    s = np.arange(plan.n_sublanes)
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    sl = plan.slice_of.reshape(-1).astype(np.int64)
    tile = plan.tile_base.astype(np.int64)[s // plan.chunk] + rel
    return np.where((rel < 0) | (sl < 0), -1, tile * (1 << 32) + sl)


def runs(plan):
    """(first sublane, length) of each run of consecutive live sublanes of
    one (tile, slice) cell, in plan order."""
    key = _cells(plan)
    if not key.size:
        return np.zeros((0, 2), np.int64)
    start = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    length = np.diff(np.r_[start, key.size])
    live = key[start] >= 0
    return np.stack([start[live], length[live]], axis=1)


def cells_adjacent(plan) -> bool:
    """Whether the live sublanes of each (tile, slice) cell are one run."""
    key = _cells(plan)
    live = key[key >= 0]
    return len(runs(plan)) == len(np.unique(live))
