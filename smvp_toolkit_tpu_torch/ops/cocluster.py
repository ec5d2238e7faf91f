"""Joint row x column co-clustering for the SELL-T1 planner.

A copy of the JAX package's ``ops/cocluster.py``: the same
initializations, the same refinement (``csrc/cocluster.cpp``, the port's
copy of the C++ pass) and the same map construction, so ``row_map``,
``col_map``, ``s_true``, ``s_true_natural``, ``moves``, ``init`` and
``shape_padded`` equal the JAX package's element for element.

SELL-T1 occupancy (nnz / slots, the linear factor of the kernels' slot
rate) is fixed by the row->slice and col->tile assignments: every
(slice, tile) cell costs ``max_r count(r, tile)`` sublanes. This module
optimizes both assignments jointly:

1. an initialization (natural order with capacity slack, or rows sorted
   by column-tile support signature for fragmentation-dominated
   matrices),
2. greedy alternating refinement over exact objective deltas in C++:
   column moves between nearby tiles and row moves between nearby
   slices, capacities <= 128, locality-bounded so the per-chunk
   tile/slice windows of the plan stay narrow.

The result is a pair of injective coordinate maps (row_map, col_map)
into padded row/col spaces. The SpMV then runs in PERMUTED coordinates:
x is scattered once at the boundary and y is gathered back to natural
order (``spmv_sell.CoClusteredSellSpMV``).

Departures from the JAX module: the library is built from the port's
own source by ``ops/_build.py`` on first use, and a missing compiler or a
failed build raises (the JAX ``cocluster`` returns None when its library
is absent); arguments the library rejects (coordinates or assignments
out of range) raise ``ValueError`` where the JAX functions return None
or -1. Refining a large matrix is minutes of host work (a 10M-nnz
banded matrix takes about three minutes at the default 12 passes), so
``cocluster`` keeps its last two results in the process, keyed by a
digest of the coordinates, the shape and the options: a second operator
of the same matrix (the bf16 one beside the f32 one, a CLI run after an
API run) reuses the refinement.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import threading
from typing import Optional, Tuple

import numpy as np

from smvp_toolkit_tpu_torch.ops import _build

__all__ = [
    "CoClusterResult", "cocluster", "cocluster_plan",
    "cocluster_objective",
]

LANES = 128

_LL = ctypes.c_longlong
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "cocluster_refine": (_LL, [
        _I64P, _I64P, _LL, _LL, _LL, _I32P, _I32P, _LL, _LL,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _LL, ctypes.c_int,
        _LL, ctypes.POINTER(_LL),
    ]),
    "cocluster_objective": (_LL, [
        _I64P, _I64P, _LL, _LL, _LL, _I32P, _I32P, _LL, _LL,
    ]),
}


# The last results of ``cocluster`` in this process, by digest (oldest
# first).
_MEMO: dict = {}
_MEMO_SIZE = 2
_MEMO_LOCK = threading.Lock()


def _digest(rows: np.ndarray, cols: np.ndarray, key: tuple) -> str:
    h = hashlib.blake2b(repr(key).encode(), digest_size=16)
    h.update(rows.tobytes())
    h.update(cols.tobytes())
    return h.hexdigest()


def _lib() -> ctypes.CDLL:
    """The library of ``csrc/cocluster.cpp``, built on first use
    (``KernelBuildError`` when no host compiler is found or it fails)."""
    return _build.load("cocluster", _SIGNATURES)


@dataclasses.dataclass(frozen=True)
class CoClusterResult:
    """Injective coordinate maps into padded spaces + plan statistics."""

    row_map: np.ndarray  # int64 (n,): natural row -> permuted row id
    col_map: np.ndarray  # int64 (m,): natural col -> permuted col id
    shape_padded: Tuple[int, int]  # (n_slices*128, n_tiles*128)
    s_true: int  # objective: total true sublanes after refinement
    s_true_natural: int  # objective of the natural assignment
    moves: int  # accepted refinement moves
    init: str  # initialization that produced this result

    def occupancy(self, nnz: int) -> float:
        return nnz / float(max(self.s_true, 1) * LANES)

    def row_inverse(self) -> np.ndarray:
        """Padded-row -> natural-row map (-1 for padding rows)."""
        inv = np.full(self.shape_padded[0], -1, dtype=np.int64)
        inv[self.row_map] = np.arange(len(self.row_map))
        return inv

    def col_inverse(self) -> np.ndarray:
        inv = np.full(self.shape_padded[1], -1, dtype=np.int64)
        inv[self.col_map] = np.arange(len(self.col_map))
        return inv


def _spread_assign(n: int, groups: int) -> np.ndarray:
    """Assign n items to ``groups`` groups preserving order, uniform
    fill (floor(i * groups / n)): natural adjacency plus even slack."""
    return ((np.arange(n, dtype=np.int64) * groups) // max(n, 1)).astype(
        np.int32
    )


def _signature_row_order(
    rows: np.ndarray, cols: np.ndarray, n: int, k: int = 6
) -> np.ndarray:
    """Rows ordered by their column-tile support signature.

    Rows with identical/similar tile supports become adjacent so they
    land in the same slice and SHARE sublanes (the fragmentation fix for
    scattered matrices). Signature = first ``k`` distinct tiles of the
    row's sorted support, lexicographic; ties by natural id keep
    locality. Empty rows sort to the end (their slices are dead anyway).
    Returns the new order (old row ids in new sequence).
    """
    tile = (cols >> 7).astype(np.int64)
    order = np.lexsort((tile, rows))
    r_s, t_s = rows[order], tile[order]
    keep = np.ones(len(r_s), dtype=bool)  # dedup (row, tile) pairs
    keep[1:] = (r_s[1:] != r_s[:-1]) | (t_s[1:] != t_s[:-1])
    r_s, t_s = r_s[keep], t_s[keep]
    idx = np.arange(len(r_s))  # rank of each pair within its row
    row_start = np.where(np.r_[True, r_s[1:] != r_s[:-1]], idx, 0)
    np.maximum.accumulate(row_start, out=row_start)
    rank = idx - row_start
    sig = np.full((n, k), np.iinfo(np.int64).max, dtype=np.int64)
    sel = rank < k
    sig[r_s[sel], rank[sel]] = t_s[sel]
    keys = [np.arange(n)] + [sig[:, j] for j in range(k - 1, -1, -1)]
    return np.lexsort(keys)


def _rejected(what: str) -> ValueError:
    return ValueError(
        f"{what}: the co-clustering library rejected the arguments "
        "(a coordinate or an assignment out of range, or an empty shape)"
    )


def cocluster(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    *,
    row_slack: float = 0.04,
    col_slack: float = 0.04,
    passes: Optional[int] = None,
    col_radius: Optional[int] = None,
    row_radius: Optional[int] = None,
    alpha: int = 2,
    pot_kind: int = 0,
    s_weight: int = 0,
    init: str = "natural",
) -> Optional[CoClusterResult]:
    """Optimize row/col group assignments; None for an empty matrix.

    ``init``: "natural" (slack-spread natural order), "signature"
    (support-signature row sort, for scattered patterns) or "auto" (run
    both, keep the better objective). ``alpha`` weighs cell
    consolidation in the plateau potential.

    ``passes``/radii default by nnz, as in the JAX module: 30 passes and
    radius 16 below 1M nnz, 12 passes and radius 6 below 20M, 6 passes
    above.
    """
    n, m = shape
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = len(rows)
    if nnz == 0 or n == 0 or m == 0:
        return None
    lib = _lib()

    if passes is None:
        passes = 30 if nnz < 1_000_000 else (12 if nnz < 20_000_000 else 6)
    if col_radius is None:
        col_radius = 16 if nnz < 1_000_000 else 6
    if row_radius is None:
        row_radius = col_radius
    key = _digest(rows, cols, (n, m, row_slack, col_slack, passes,
                               col_radius, row_radius, alpha, pot_kind,
                               s_weight, init))
    with _MEMO_LOCK:
        if key in _MEMO:
            return _MEMO[key]

    ns_nat = max(-(-n // LANES), 1)
    nt_nat = max(-(-m // LANES), 1)
    n_slices = max(int(np.ceil(n / LANES * (1.0 + row_slack))), ns_nat)
    n_tiles = max(int(np.ceil(m / LANES * (1.0 + col_slack))), nt_nat)

    # The natural assignment's objective: the baseline the refinement
    # must beat.
    nat_row = (np.arange(n, dtype=np.int64) // LANES).astype(np.int32)
    nat_col = (np.arange(m, dtype=np.int64) // LANES).astype(np.int32)
    s_nat = int(lib.cocluster_objective(rows, cols, nnz, n, m, nat_row,
                                        nat_col, ns_nat, nt_nat))
    if s_nat < 0:
        raise _rejected("cocluster")

    inits = ["natural", "signature"] if init == "auto" else [init]
    best = None
    for mode in inits:
        if mode == "signature":
            order = _signature_row_order(rows, cols, n)
        elif mode == "natural":
            order = np.arange(n, dtype=np.int64)
        else:
            raise ValueError(f"unknown init {mode!r}")
        ra = np.empty(n, dtype=np.int32)  # position-in-order spread
        ra[order] = _spread_assign(n, n_slices)
        ca = _spread_assign(m, n_tiles)
        moves = _LL(0)
        s = int(lib.cocluster_refine(
            rows, cols, nnz, n, m, ra, ca, n_slices, n_tiles, passes,
            col_radius, row_radius, alpha, pot_kind, s_weight,
            ctypes.byref(moves)))
        if s < 0:
            raise _rejected("cocluster")
        if best is None or s < best[0]:
            best = (s, int(moves.value), ra, ca, mode)

    s_true, n_moves, ra, ca, mode = best
    # Injective maps: new id = group*128 + rank within the group (rank by
    # natural id, which keeps in-group natural adjacency).
    res = CoClusterResult(
        row_map=_group_map(ra, n_slices),
        col_map=_group_map(ca, n_tiles),
        shape_padded=(n_slices * LANES, n_tiles * LANES),
        s_true=s_true,
        s_true_natural=s_nat,
        moves=n_moves,
        init=mode,
    )
    res.row_map.flags.writeable = False
    res.col_map.flags.writeable = False
    with _MEMO_LOCK:
        while len(_MEMO) >= _MEMO_SIZE:
            _MEMO.pop(next(iter(_MEMO)))
        _MEMO[key] = res
    return res


def _group_map(assign: np.ndarray, groups: int) -> np.ndarray:
    """item -> group*128 + rank_within_group (stable by item id)."""
    order = np.argsort(assign, kind="stable")
    sorted_groups = assign[order].astype(np.int64)
    idx = np.arange(len(assign), dtype=np.int64)
    grp_start = np.where(
        np.r_[True, sorted_groups[1:] != sorted_groups[:-1]], idx, 0
    )
    np.maximum.accumulate(grp_start, out=grp_start)
    rank = idx - grp_start
    if rank.size and int(rank.max()) >= LANES:
        raise AssertionError("group capacity exceeded (native bug)")
    out = np.empty(len(assign), dtype=np.int64)
    out[order] = sorted_groups * LANES + rank
    return out


def cocluster_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    *,
    chunk: Optional[int] = None,
    bf16: bool = False,
    **cocluster_kw,
):
    """Co-cluster, then build the SELL plan in permuted coordinates.

    Returns ``(CoClusterResult, SellPlan, vmem_mb)``, or None for an
    empty matrix. The plan's shape is the PADDED permuted space
    (``result.shape_padded``). ``chunk=None`` lets the autotuner
    (``ops/autotune.py``) pick the chunk on the permuted coordinates, as
    the JAX function does, and returns its VMEM figure (the card does
    not use it); an explicit chunk plans with ``_auto_plan`` and returns
    ``vmem_mb`` None.
    """
    res = cocluster(rows, cols, shape, **cocluster_kw)
    if res is None:
        return None
    r2 = res.row_map[np.asarray(rows, dtype=np.int64)]
    c2 = res.col_map[np.asarray(cols, dtype=np.int64)]
    if chunk is None:
        from smvp_toolkit_tpu_torch.ops.autotune import (
            pick_plan,
            pick_vmem_mb,
            production_rates,
        )

        plan, _cost = pick_plan(r2, c2, vals, res.shape_padded, bf16=bf16,
                                rates=production_rates())
        return res, plan, pick_vmem_mb(plan.chunk)
    from smvp_toolkit_tpu_torch.ops.spmv_sell import _auto_plan

    return res, _auto_plan(r2, c2, vals, res.shape_padded, chunk=chunk), None


def cocluster_objective(
    rows: np.ndarray,
    cols: np.ndarray,
    shape: Tuple[int, int],
    row_assign: Optional[np.ndarray] = None,
    col_assign: Optional[np.ndarray] = None,
) -> int:
    """Exact S_true (total sublanes) for an assignment (natural default).

    Raises ``ValueError`` where the library rejects the arguments (the
    JAX function returns its -1).
    """
    lib = _lib()
    n, m = shape
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    if row_assign is None:
        row_assign = (np.arange(n, dtype=np.int64) // LANES).astype(np.int32)
    if col_assign is None:
        col_assign = (np.arange(m, dtype=np.int64) // LANES).astype(np.int32)
    ns = int(row_assign.max()) + 1 if n else 1
    nt = int(col_assign.max()) + 1 if m else 1
    s = int(lib.cocluster_objective(
        rows, cols, len(rows), n, m,
        np.ascontiguousarray(row_assign, dtype=np.int32),
        np.ascontiguousarray(col_assign, dtype=np.int32), ns, nt))
    if s < 0:
        raise _rejected("cocluster_objective")
    return s
