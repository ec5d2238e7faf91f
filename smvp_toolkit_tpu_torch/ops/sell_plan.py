"""SELL-T1 execution plan (host-side planner).

A copy of the JAX package's planner (``ops/sell_plan.py`` there), both of
its paths: the native pass (``csrc/sellplan.cpp``, one threaded sort and
linear scans, built by ``ops/_build.py`` on first use) by default, and the
numpy flow where the caller asks for it (``use_native=False`` or
``SMVP_NO_NATIVE_PLAN=1``) or where a field of the native sort key would
overflow. Both feed one windowing tail, and every plan array equals the
JAX planner's element for element on either path. A native pass that
cannot be built raises; it never falls back to numpy quietly.

Layout rule — one **slot** per nonzero:

* ``lane  = row mod 128``  (output lane)
* ``slice = row div 128``  (output row group; y is (NS, 128))
* each **sublane** (a row of the (S, 128) planes) holds entries of ONE
  slice whose columns fall in ONE 128-wide column tile; a row with
  several entries in the same tile occupies duplicate sublanes.

Sublanes are sorted tile-major and cut into chunks of ``chunk``
sublanes; each chunk's tiles lie in a window
``[tile_base[c], tile_base[c] + WT)`` and the sublane stores its tile
relative to that base (``rel_tile``). The CUDA kernels compute
``y[(ybase[c] + slice)·128 + l] += vals[s, l] · x[(tile_base[c] + rel[s])·128 + lidx[s, l]]``
straight from these planes, with ``ybase`` 0 for a resident-y plan.

Above a y size, rows are cut into y blocks of ``y_block_rows`` rows and
each block is planned on its own (``build_streamed_sell_plan``): its
chunks never straddle two blocks, ``slice_of`` holds block-local slice
ids and ``ybase[c] = y_block_id[c] · y_block_slices``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "LANES",
    "REL_DEAD",
    "SLICE_SHIFT",
    "SLICE_DEAD",
    "SellPlan",
    "build_sell_plan",
    "build_streamed_sell_plan",
    "common_window",
    "rewindow_plan",
    "lidx_bytes_for_chunk",
]

LANES = 128

# The merged rel‖slice word (one int32 per sublane): rel in bits 0..8,
# 511 marking a dead sublane; the slice id in bits 9..31, all ones marking
# a dead sublane. Plans whose window or slice count does not fit it keep
# the split rel_tile / slice_of planes.
REL_DEAD = (1 << 9) - 1
SLICE_SHIFT = 9
SLICE_DEAD = (1 << (32 - SLICE_SHIFT)) - 1


def _round_up(x: int, m: int) -> int:
    return -(-max(int(x), 1) // m) * m


def lidx_bytes_for_chunk(chunk: int) -> int:
    """Lane indices are stored as int8 when the chunk is a multiple of 32
    sublanes and ``SMVP_SELL_LIDX32`` is not 1, else as int32 (the JAX
    operator's rule, read at each call as there, kept so that both
    packages read the same planes)."""
    return (1 if chunk % 32 == 0
            and os.environ.get("SMVP_SELL_LIDX32") != "1" else 4)


@dataclasses.dataclass(frozen=True)
class SellPlan:
    """Host-side arrays + static metadata for the SELL-T1 SpMV kernels.

    S = padded sublane count (multiple of ``chunk``), CT = column tiles
    (padded to 128), NS = row slices (padded to 16), WT = window tiles
    per chunk (padded to 16). The paddings are the JAX planner's and are
    kept so that plans compare field by field.
    """

    vals: np.ndarray  # f32 (S, 128); 0 in dead slots
    lane_idx: np.ndarray  # i32 (S, 128): column offset within tile [0,128)
    rel_tile: np.ndarray  # i32 (S, 1): tile - tile_base[chunk]; -1 = dead
    slice_of: np.ndarray  # i32 (n_chunks, chunk): slice id (-1 = dead)
    tile_base: np.ndarray  # i32 (n_chunks,): window start tile per chunk
    shape: Tuple[int, int]
    nnz: int
    n_slices: int  # NS (padded)
    n_coltiles: int  # CT (padded)
    window_tiles: int  # WT
    chunk: int  # sublanes per chunk
    # Per-chunk slice-window start + window size NSW (None/0 = the full
    # NS window).
    slice_base: Optional[np.ndarray] = None  # i32 (n_chunks,)
    slice_window: int = 0
    # Streamed-y plans (``build_streamed_sell_plan``) set these; then
    # ``slice_of``/``slice_base`` are local to each chunk's y block and
    # ``n_slices`` is the total (n_blocks × y_block_slices).
    y_block_id: Optional[np.ndarray] = None  # i32 (n_chunks,)
    y_block_slices: int = 0  # NSB (0 = resident-y plan)

    def reduce_window(self) -> Tuple[np.ndarray, int]:
        """(slice_base, NSW) with the full-window fallback applied."""
        if self.slice_base is None or self.slice_window <= 0:
            return (
                np.zeros(self.n_chunks, dtype=np.int32),
                self.n_slices,
            )
        return self.slice_base, self.slice_window

    @property
    def n_sublanes(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_chunks(self) -> int:
        return self.n_sublanes // self.chunk

    def slots(self) -> int:
        return self.n_sublanes * LANES

    @property
    def merged_word(self) -> bool:
        """Whether rel and slice fit the merged rel‖slice word (the JAX
        operator's gate, ``spmv_pallas.py`` relsl route)."""
        return self.window_tiles <= REL_DEAD and self.n_slices < SLICE_DEAD

    def traffic_bytes(
        self, value_bytes: int = 4, lidx_bytes: Optional[int] = None,
        x_bytes: int = 4, k: int = 1, packed: bool = False,
    ) -> int:
        """Device-memory bytes one launch of the port's kernel for this
        plan moves over k columns, each input read once and y written once.

        The planes are dense (S × 128) whatever the occupancy, so padding
        slots cost real bandwidth. Per launch: the values and lane-index
        planes, the per-sublane metadata the route reads (one merged
        rel‖slice int32 word, or the split rel_tile and slice_of words),
        ``tile_base``, ``y_block_id`` on a streamed plan, then x and y
        once per column: the k-column kernels take all k columns in one
        launch, so the planes are read once whatever k. (The JAX planner's
        figure always charges the two split words and no ``y_block_id``,
        and for k > 1 charges the planes ``ceil(k / 8)`` times, once per
        launch group of its VMEM-sized ``spmm_launch_group``, or k times
        where its operator falls back to one launch per column.)

        The same figure bounds the values-gradient kernel with
        ``value_bytes=4``: it reads no values plane but writes a float32
        plane of the same shape, and reads G (NS·128 × k float32) where
        the SpMM writes y.

        ``packed`` is the packed route (``SMVP_SELL_PACK=1``, bf16): one
        int32 val‖rel‖lane word per slot in place of the values and
        lane-index planes, and one slice id per sublane as its metadata.
        """
        if lidx_bytes is None:
            lidx_bytes = lidx_bytes_for_chunk(self.chunk)
        s = self.n_sublanes
        words = 1 if self.merged_word else 2
        if packed:
            value_bytes, lidx_bytes, words = 4, 0, 1
        per_chunk = 2 if self.y_block_slices else 1  # tile_base, y_block_id
        return int(
            s * LANES * (value_bytes + lidx_bytes)  # vals + lane_idx
            + s * 4 * words                         # per-sublane metadata
            + self.n_chunks * 4 * per_chunk
            + k * self.n_coltiles * LANES * x_bytes  # x, k columns
            + k * self.n_slices * LANES * 4         # y (f32), k columns
        )

    # Dense one-hot views of the plan: the operands of the one-hot kernel
    # (K6, ``spmv_sell.sell_onehot``), which takes them per chunk. They are
    # O(S × WT) and O(NS × S), the JAX planner's views bit for bit.
    def oht_dense(self) -> np.ndarray:
        """(S, WT) float32: 1 at (s, rel_tile[s]) for every sublane whose
        rel lies in the window, 0 elsewhere."""
        if self.y_block_slices:
            raise ValueError("dense views undefined for streamed-y plans")
        oht = np.zeros((self.n_sublanes, self.window_tiles), dtype=np.float32)
        rel = self.rel_tile.reshape(-1)
        ok = (rel >= 0) & (rel < self.window_tiles)
        oht[np.arange(self.n_sublanes)[ok], rel[ok]] = 1.0
        return oht

    def seg_dense(self) -> np.ndarray:
        """(NS, S) float32: 1 at (slice_of[s], s) for every live sublane."""
        if self.y_block_slices:
            raise ValueError("dense views undefined for streamed-y plans")
        seg = np.zeros((self.n_slices, self.n_sublanes), dtype=np.float32)
        sl = self.slice_of.reshape(-1)
        ok = (sl >= 0) & (sl < self.n_slices)
        seg[sl[ok], np.arange(self.n_sublanes)[ok]] = 1.0
        return seg


def build_sell_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    *,
    chunk: int = 1024,
    min_window_tiles: int = 8,
    allow_small_chunk: bool = True,
    use_native: Optional[bool] = None,
    threads: Optional[int] = None,
) -> SellPlan:
    """Build the SELL-T1 plan from COO triplets (host, encode-time).

    ``min_window_tiles`` forces WT at least that wide. ``use_native``
    (default: unless ``SMVP_NO_NATIVE_PLAN=1``) takes the native pass on
    ``threads`` sorting threads (default ``min(cpu_count, 8)``, the JAX
    planner's); the numpy flow gives the same plan.
    """
    nrows, ncols = shape
    nnz = len(rows)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if np.iscomplexobj(np.asarray(vals)):
        # Silent imaginary-part truncation is a correctness trap.
        raise TypeError("SELL plan values must be real")
    v = np.asarray(vals, dtype=np.float32)

    ct_true = max(-(-ncols // LANES), 1)
    ns_true = max(-(-nrows // LANES), 1)
    CT = _round_up(ct_true, LANES)
    NS = _round_up(ns_true, 16)

    if nnz == 0:
        if allow_small_chunk:
            chunk = 8
        S = chunk
        return SellPlan(
            vals=np.zeros((S, LANES), dtype=np.float32),
            lane_idx=np.zeros((S, LANES), dtype=np.int32),
            rel_tile=np.full((S, 1), -1, dtype=np.int32),
            slice_of=np.full((1, S), -1, dtype=np.int32),
            tile_base=np.zeros((1,), dtype=np.int32),
            shape=shape,
            nnz=0,
            n_slices=NS,
            n_coltiles=CT,
            window_tiles=16,
            chunk=chunk,
            slice_base=np.zeros((1,), dtype=np.int32),
            slice_window=min(16, NS),
        )

    if use_native is None:
        use_native = os.environ.get("SMVP_NO_NATIVE_PLAN") != "1"
    if use_native:
        # The native pass; None only where a key field would overflow.
        native = _build_native(
            rows, cols, v, shape, nnz, CT, NS, chunk=chunk,
            min_window_tiles=min_window_tiles,
            allow_small_chunk=allow_small_chunk, threads=threads,
        )
        if native is not None:
            return native

    slice_ = rows >> 7
    lane = rows & 127
    tile = cols >> 7

    # Stable sort by (slice, tile, lane): entries of one (slice, tile)
    # cell are adjacent, lanes ascending.
    order = np.lexsort((lane, tile, slice_))
    sl_s = slice_[order]
    tl_s = tile[order]
    ln_s = lane[order]
    lo_s = (cols & 127)[order].astype(np.int32)
    v_s = v[order]

    # dup = occurrence index within (slice, tile, lane) runs.
    cell = sl_s * ct_true + tl_s
    same_lane = np.zeros(nnz, dtype=bool)
    same_lane[1:] = (cell[1:] == cell[:-1]) & (ln_s[1:] == ln_s[:-1])
    idx = np.arange(nnz)
    run_start = np.where(~same_lane, idx, 0)
    np.maximum.accumulate(run_start, out=run_start)
    dup = idx - run_start

    # sublane key = (tile, slice, dup): tile-major so each chunk of
    # consecutive sublanes covers a narrow column-tile window.
    # Field widths: tile 24b, slice 24b, dup 16b — guarded, not assumed.
    if dup.size:
        _check_dup(int(dup.max()))
    if int(sl_s.max()) >= (1 << 24) or int(tl_s.max()) >= (1 << 24):
        raise ValueError("matrix dimensions exceed 2^31 rows/cols")
    sub_key = (
        (tl_s.astype(np.int64) << 40)
        | (sl_s.astype(np.int64) << 16)
        | dup.astype(np.int64)
    )
    uniq, sub_id = np.unique(sub_key, return_inverse=True)
    S_true = len(uniq)
    # Small matrices: shrink the chunk to the real sublane count.
    if allow_small_chunk and S_true <= chunk:
        chunk = _round_up(S_true, 8)
    S = _round_up(S_true, chunk)

    vals_a = np.zeros((S, LANES), dtype=np.float32)
    lidx_a = np.zeros((S, LANES), dtype=np.int32)
    vals_a[sub_id, ln_s] = v_s
    lidx_a[sub_id, ln_s] = lo_s

    # Per-sublane tile and slice (uniq keys decode, tile-sorted).
    u_tile = np.full(S, -1, dtype=np.int64)
    u_slice = np.zeros(S, dtype=np.int64)
    u_tile[:S_true] = uniq >> 40
    u_slice[:S_true] = (uniq >> 16) & 0xFFFFFF
    if S > S_true:  # dead padding sublanes adopt the last real tile
        u_tile[S_true:] = u_tile[S_true - 1]

    return _finish_plan(
        vals_a, lidx_a, u_tile, u_slice, S_true, S, chunk,
        CT=CT, NS=NS, shape=shape, nnz=nnz,
        min_window_tiles=min_window_tiles,
    )


def _check_dup(max_dup: int) -> None:
    if max_dup >= (1 << 16):
        raise ValueError(
            "more than 65535 duplicate entries share one (row, col-tile); "
            "coalesce duplicates before encoding"
        )


_LL = ctypes.c_longlong
_VP = ctypes.c_void_p
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_PLAN_SIGNATURES = {
    "sell_plan_create": (_VP, [_I64P, _I64P, _LL, _LL, _LL, ctypes.c_int]),
    "sell_plan_sublanes": (_LL, [_VP]),
    "sell_plan_max_dup": (_LL, [_VP]),
    "sell_plan_fill": (None, [_VP, _I64P, _F32P, _LL, _F32P, _I32P, _I64P,
                              _I64P]),
    "sell_plan_free": (None, [_VP]),
}


def _plan_lib() -> ctypes.CDLL:
    """The library of ``csrc/sellplan.cpp``, built on first use
    (``KernelBuildError`` when no host compiler is found or it fails)."""
    from smvp_toolkit_tpu_torch.ops import _build

    return _build.load("sellplan", _PLAN_SIGNATURES)


def _build_native(
    rows, cols, v, shape, nnz, CT, NS, *,
    chunk, min_window_tiles, allow_small_chunk, threads=None,
):
    """Plan via the C++ pass; None where its key fields (tile 26 bits,
    slice 31 bits, triplet index 32 bits) overflow, as in the JAX
    planner's ``_build_native``."""
    if nnz >= (1 << 32):
        return None
    lib = _plan_lib()
    rows64 = np.ascontiguousarray(rows, dtype=np.int64)
    cols64 = np.ascontiguousarray(cols, dtype=np.int64)
    v32 = np.ascontiguousarray(v, dtype=np.float32)
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    handle = lib.sell_plan_create(rows64, cols64, nnz, shape[0], shape[1],
                                  int(threads))
    if not handle:
        return None
    try:
        _check_dup(int(lib.sell_plan_max_dup(handle)))
        S_true = int(lib.sell_plan_sublanes(handle))
        if allow_small_chunk and S_true <= chunk:
            chunk = _round_up(S_true, 8)
        S = _round_up(S_true, chunk)
        vals_a = np.zeros((S, LANES), dtype=np.float32)
        lidx_a = np.zeros((S, LANES), dtype=np.int32)
        u_tile = np.empty(S, dtype=np.int64)
        u_slice = np.empty(S, dtype=np.int64)
        lib.sell_plan_fill(handle, cols64, v32, S, vals_a.reshape(-1),
                           lidx_a.reshape(-1), u_tile, u_slice)
    finally:
        lib.sell_plan_free(handle)
    return _finish_plan(
        vals_a, lidx_a, u_tile, u_slice, S_true, S, chunk,
        CT=CT, NS=NS, shape=shape, nnz=nnz,
        min_window_tiles=min_window_tiles,
    )


def _finish_plan(
    vals_a, lidx_a, u_tile, u_slice, S_true, S, chunk, *,
    CT, NS, shape, nnz, min_window_tiles,
):
    """Tile windows, relative tiles and slice windows (the planner's tail)."""
    # Per-chunk tile windows; bases align down to 16 tiles and WT rounds
    # to 16 (the JAX planner's alignment, kept for plan equality).
    n_chunks = S // chunk
    tiles_2d = u_tile.reshape(n_chunks, chunk)
    t_lo = (tiles_2d.min(axis=1) // 16) * 16
    t_hi = tiles_2d.max(axis=1)
    WT = _round_up(max(int((t_hi - t_lo).max()) + 1, min_window_tiles), 16)
    WT = min(WT, CT)
    # Clamp windows to stay inside the padded tile range.
    tile_base = np.minimum(t_lo, max(CT - WT, 0)).astype(np.int32)

    rel = (u_tile - np.repeat(tile_base.astype(np.int64), chunk)).astype(
        np.int32
    )
    rel[(rel < 0) | (rel >= WT)] = -1  # out of window -> dead
    slice_compact = np.full(S, -1, dtype=np.int32)
    slice_compact[:S_true] = u_slice[:S_true]

    # Per-chunk slice windows.
    sl_2d = slice_compact.reshape(n_chunks, chunk)
    live = sl_2d >= 0
    sl_min = np.where(live, sl_2d, np.iinfo(np.int32).max).min(axis=1)
    sl_max = np.where(live, sl_2d, -1).max(axis=1)
    sl_min = np.where(sl_min > sl_max, 0, sl_min)  # all-dead chunk
    s_lo = (sl_min // 16) * 16
    NSW = _round_up(max(int((sl_max - s_lo).max()) + 1, 8), 16)
    NSW = min(NSW, NS)
    slice_base = np.minimum(s_lo, max(NS - NSW, 0)).astype(np.int32)

    return SellPlan(
        vals=vals_a,
        lane_idx=lidx_a,
        rel_tile=rel.reshape(S, 1),
        slice_of=sl_2d,
        tile_base=tile_base,
        shape=shape,
        nnz=nnz,
        n_slices=NS,
        n_coltiles=CT,
        window_tiles=WT,
        chunk=chunk,
        slice_base=slice_base,
        slice_window=NSW,
    )


def build_streamed_sell_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
    *,
    chunk: int = 1024,
    y_block_rows: int = 512 * LANES,
    use_native: Optional[bool] = None,
    threads: Optional[int] = None,
) -> SellPlan:
    """SELL-T1 plan whose y is cut into blocks of ``y_block_rows`` rows.

    Rows are partitioned into y blocks (``y_block_rows`` a multiple of
    2048, so every block is ``NSB = y_block_rows / 128`` slices), each
    block is planned on its own and the sub-plans are concatenated.
    Chunks therefore never straddle a block boundary and the per-chunk
    block ids are non-decreasing; a block with no entries still gets one
    all-dead chunk.

    ``slice_of`` / ``slice_base`` in the result are LOCAL to each chunk's
    y block; ``n_slices`` is the total padded slice count.
    """
    if y_block_rows % (16 * LANES) != 0:
        raise ValueError("y_block_rows must be a multiple of 2048")
    nrows, ncols = shape
    nsb = y_block_rows // LANES
    n_blocks = max(-(-nrows // y_block_rows), 1)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    v = np.asarray(vals)

    blk_of = rows // y_block_rows
    order = np.argsort(blk_of, kind="stable")
    bounds = np.searchsorted(blk_of[order], np.arange(n_blocks + 1))

    subs = []
    for g in range(n_blocks):
        sel = order[bounds[g]:bounds[g + 1]]
        subs.append(
            build_sell_plan(
                rows[sel] - g * y_block_rows, cols[sel], v[sel],
                (y_block_rows, ncols), chunk=chunk,
                allow_small_chunk=False, use_native=use_native,
                threads=threads,
            )
        )
    subs, wt_common, nsw_common, sub_bases = common_window(subs, nsb)

    return SellPlan(
        vals=np.concatenate([p.vals for p in subs]),
        lane_idx=np.concatenate([p.lane_idx for p in subs]),
        rel_tile=np.concatenate([p.rel_tile for p in subs]),
        slice_of=np.concatenate([p.slice_of for p in subs]),
        tile_base=np.concatenate([p.tile_base for p in subs]),
        shape=shape,
        nnz=len(rows),
        n_slices=n_blocks * nsb,
        n_coltiles=subs[0].n_coltiles,
        window_tiles=wt_common,
        chunk=chunk,
        slice_base=np.concatenate(sub_bases),
        slice_window=nsw_common,
        y_block_id=np.concatenate(
            [np.full(p.n_chunks, g, dtype=np.int32)
             for g, p in enumerate(subs)]
        ),
        y_block_slices=nsb,
    )


def common_window(plans, ns_cap: int):
    """Align per-block plans to one (tile window, slice window) pair.

    Takes the max per-plan tile window (rewindowed, O(S)), the max
    per-plan slice window capped at ``ns_cap``, and re-clamps each plan's
    slice bases so every window stays inside the cap.

    Returns ``(plans, wt_common, nsw_common, bases)`` with ``bases[i]``
    the re-clamped int32 slice_base of ``plans[i]``.
    """
    plans = [
        rewindow_plan(p, max(q.window_tiles for q in plans)) for p in plans
    ]
    # Recompute after rewindowing: a plan whose own column-tile count is
    # below the requested window clamps to it (WT = min(WT, CT)).
    wt_common = max(p.window_tiles for p in plans)
    nsw_common = min(max(p.reduce_window()[1] for p in plans), ns_cap)
    bases = [
        np.minimum(
            p.reduce_window()[0].astype(np.int32),
            max(ns_cap - nsw_common, 0),
        )
        for p in plans
    ]
    return plans, wt_common, nsw_common, bases


def rewindow_plan(plan: SellPlan, min_window_tiles: int) -> SellPlan:
    """Widen an existing plan's per-chunk column-tile window.

    Equal to rebuilding with ``build_sell_plan(..., min_window_tiles=...)``
    but O(S): the absolute tile of every sublane is recovered from
    ``rel_tile + tile_base`` and only the windowing tail reruns.
    """
    rel = plan.rel_tile.reshape(-1).astype(np.int64)
    if plan.nnz == 0 or (rel < 0).all():
        # Empty plan: rel carries no tiles; its window [0, WT) already
        # sits at base 0 and widening changes nothing it computes.
        return plan
    if (rel < 0).any():
        # Out-of-window sublanes lost their absolute tile (never produced
        # by build_sell_plan).
        raise ValueError("plan has out-of-window sublanes; rebuild it")
    chunk = plan.chunk
    u_tile = rel + np.repeat(plan.tile_base.astype(np.int64), chunk)
    tiles_2d = u_tile.reshape(plan.n_chunks, chunk)
    t_lo = (tiles_2d.min(axis=1) // 16) * 16
    t_hi = tiles_2d.max(axis=1)
    CT = plan.n_coltiles
    WT = _round_up(max(int((t_hi - t_lo).max()) + 1, min_window_tiles), 16)
    WT = min(WT, CT)
    tile_base = np.minimum(t_lo, max(CT - WT, 0)).astype(np.int32)
    new_rel = (
        u_tile - np.repeat(tile_base.astype(np.int64), chunk)
    ).astype(np.int32)
    new_rel[(new_rel < 0) | (new_rel >= WT)] = -1
    return dataclasses.replace(
        plan,
        rel_tile=new_rel.reshape(-1, 1),
        tile_base=tile_base,
        window_tiles=WT,
    )
