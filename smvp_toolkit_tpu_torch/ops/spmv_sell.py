"""SELL-T1 SpMV operator over the hand-written CUDA kernels.

Counterpart of the main-path part of the JAX package's
``ops/spmv_pallas.py``
(``relsl_plane_host``, ``SellSpMV``, ``_auto_plan``, ``_cached_op``,
``spmv_csr_pallas``/``sell_op_csr``, ``spmv_tjds_pallas``). The operator
picks one of four routes from its plan, as the JAX operator's
``_apply_tiles`` and ``bench_loop`` do; each route has a forward wrapper
(one y = A·x) and a bench wrapper (N SpMVs in one launch):

* ``relsl``: K1 ``sell_spmv``, K2 ``sell_bench_loop``;
* ``streamy_relsl``: K3 ``sell_streamy_relsl``, ``sell_bench_streamy_relsl``;
* ``streamy``: K3 ``sell_streamy``, ``sell_bench_streamy``;
* ``split``: K4 ``sell_split``, ``sell_bench_split``.

``relsl`` and ``streamy_relsl`` read one merged rel‖slice word per
sublane, taken where ``window_tiles <= 511`` and ``n_slices < 2^23 - 1``;
``streamy`` and ``split`` read the split ``rel_tile`` and ``slice_of``
planes. The two ``streamy`` routes run plans from
``build_streamed_sell_plan`` (y in blocks, block-local slice ids,
``y_block_id`` per chunk). The forward kernels are built from
``csrc/sell_spmv.cu``, the bench kernels from ``csrc/sell_bench.cu``.

Each wrapper launches its kernel for a CUDA tensor, or raises; only a
tensor that lies on the CPU goes to the plain PyTorch version beside it
(``<wrapper>_plain``). Each wrapper counts its launches in a plain integer
attribute, ``launches``, which the smoke test reads to show that the main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import host_tensor
from smvp_toolkit_tpu_torch.ops import _build
from smvp_toolkit_tpu_torch.ops.plan_checks import (
    REL_DEAD,
    SLICE_DEAD,
    SLICE_SHIFT,
    check_plan,
    check_planes,
)
from smvp_toolkit_tpu_torch.ops.sell_plan import (
    LANES,
    SellPlan,
    build_sell_plan,
    build_streamed_sell_plan,
    lidx_bytes_for_chunk,
)
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = [
    "SellSpMV",
    "ROUTES",
    "plan_route",
    "relsl_plane_host",
    "lidx_dtype",
    "sell_spmv",
    "sell_spmv_plain",
    "sell_streamy_relsl",
    "sell_streamy_relsl_plain",
    "sell_streamy",
    "sell_streamy_plain",
    "sell_split",
    "sell_split_plain",
    "sell_bench_loop",
    "sell_bench_loop_plain",
    "sell_bench_streamy_relsl",
    "sell_bench_streamy_relsl_plain",
    "sell_bench_streamy",
    "sell_bench_streamy_plain",
    "sell_bench_split",
    "sell_bench_split_plain",
    "bench_blocks",
    "spmv_csr_sell",
    "sell_op_csr",
    "spmv_tjds_sell",
    "sell_op_tjds",
]

# Above this many bytes of y the JAX operator leaves its resident-y plan
# (``_RESIDENT_Y_LIMIT`` there, a TPU VMEM limit) for a streamed-y plan
# with y blocks of ``_STREAM_Y_BLOCK_ROWS`` rows. The card has no VMEM, but
# the port keeps the same cut so that both packages run the same plan and
# compare plan by plan.
_RESIDENT_Y_LIMIT = 8 * 2**20
_STREAM_Y_BLOCK_ROWS = 512 * LANES

# Route names and their ids in csrc/sell_common.cuh (sell::Route).
ROUTES = ("relsl", "streamy_relsl", "streamy", "split")
_ROUTE_IDS = {name: i for i, name in enumerate(ROUTES)}


def plan_route(plan: SellPlan) -> str:
    """The route a plan runs on: merged word or split planes, resident or
    streamed y (the JAX operator's gates, ``spmv_pallas.py:2382-2389``)."""
    if plan.y_block_slices:
        return "streamy_relsl" if plan.merged_word else "streamy"
    return "relsl" if plan.merged_word else "split"


def relsl_plane_host(plan: SellPlan) -> np.ndarray:
    """Merged rel‖slice word per sublane, (n_chunks, chunk) int32.

    rel sits in bits 0..8 (511 = dead), the slice id in bits 9..31
    (all ones = dead). The same packing rule as the JAX package.
    """
    rel = np.where(
        plan.rel_tile < 0, REL_DEAD, plan.rel_tile
    ).astype(np.uint32).reshape(plan.n_chunks, plan.chunk)
    sl = np.where(
        plan.slice_of < 0, SLICE_DEAD, plan.slice_of
    ).astype(np.uint32)
    return (rel | (sl << SLICE_SHIFT)).view(np.int32)


def lidx_dtype(chunk: int) -> torch.dtype:
    """int8 lane indices when ``chunk % 32 == 0``, else int32."""
    return torch.int8 if lidx_bytes_for_chunk(chunk) == 1 else torch.int32


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------


def _sweep_plain(vals, lidx, rel, sl, tile_base, ybase, x, *, n_slices: int,
                 chunk: int) -> torch.Tensor:
    """The kernels' function: direct gather, ``index_add_`` reduce.

    ``rel`` and ``sl`` are int64 per sublane with dead sublanes negative;
    ``ybase`` is the first y slice of each chunk's block (int64 per chunk)
    or None for a resident y. Returns y as float32 of length
    ``n_slices * 128``. Values and x are read in their storage dtype and
    multiplied in float32.
    """
    live = ((rel >= 0) & (sl >= 0)).nonzero().squeeze(1)
    c = live // chunk
    tile = tile_base.long()[c] + rel[live]
    col = (tile * LANES)[:, None] + lidx[live].long()
    prod = vals[live].float() * x.reshape(-1)[col].float()
    slice_ = sl[live] if ybase is None else ybase[c] + sl[live]
    row = (slice_ * LANES)[:, None] + torch.arange(LANES, device=x.device)
    y = torch.zeros(n_slices * LANES, dtype=torch.float32, device=x.device)
    return y.index_add_(0, row.reshape(-1), prod.reshape(-1))


def _decode_word(relsl):
    """(rel, slice) int64 per sublane from the merged word, -1 if dead."""
    word = relsl.reshape(-1).long() & 0xFFFFFFFF
    rel = word & REL_DEAD
    sl = word >> SLICE_SHIFT
    dead = (rel == REL_DEAD) | (sl == SLICE_DEAD)
    return rel.masked_fill(dead, -1), sl.masked_fill(dead, -1)


def _block_base(y_block_id, nsb: int):
    return y_block_id.long() * nsb


def sell_spmv_plain(vals, lidx, relsl, tile_base, x, *, n_slices: int,
                    chunk: int) -> torch.Tensor:
    """K1's function in plain PyTorch (merged word, resident y)."""
    rel, sl = _decode_word(relsl)
    return _sweep_plain(vals, lidx, rel, sl, tile_base, None, x,
                        n_slices=n_slices, chunk=chunk)


def sell_streamy_relsl_plain(vals, lidx, relsl, tile_base, y_block_id, x, *,
                             n_slices: int, chunk: int,
                             nsb: int) -> torch.Tensor:
    """K3-relsl's function in plain PyTorch (merged word, streamed y)."""
    rel, sl = _decode_word(relsl)
    return _sweep_plain(vals, lidx, rel, sl, tile_base,
                        _block_base(y_block_id, nsb), x,
                        n_slices=n_slices, chunk=chunk)


def sell_streamy_plain(vals, lidx, rel, slice_of, tile_base, y_block_id, x,
                       *, n_slices: int, chunk: int,
                       nsb: int) -> torch.Tensor:
    """K3-split's function in plain PyTorch (split planes, streamed y)."""
    return _sweep_plain(vals, lidx, rel.reshape(-1).long(),
                        slice_of.reshape(-1).long(), tile_base,
                        _block_base(y_block_id, nsb), x,
                        n_slices=n_slices, chunk=chunk)


def sell_split_plain(vals, lidx, rel, slice_of, tile_base, x, *,
                     n_slices: int, chunk: int) -> torch.Tensor:
    """K4's function in plain PyTorch (split planes, resident y)."""
    return _sweep_plain(vals, lidx, rel.reshape(-1).long(),
                        slice_of.reshape(-1).long(), tile_base, None, x,
                        n_slices=n_slices, chunk=chunk)


def _repeat(plain, iterations, *args, **kw):
    """``iterations`` fresh SpMVs of ``plain``; the last y."""
    y = None
    for _ in range(iterations):
        y = plain(*args, **kw)
    return y


def sell_bench_loop_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """K2's function in plain PyTorch: ``iterations`` fresh K1 SpMVs."""
    return _repeat(sell_spmv_plain, iterations, *args, **kw)


def sell_bench_streamy_relsl_plain(*args, iterations: int,
                                   **kw) -> torch.Tensor:
    """The streamed K2's function: ``iterations`` fresh K3-relsl SpMVs."""
    return _repeat(sell_streamy_relsl_plain, iterations, *args, **kw)


def sell_bench_streamy_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """The streamed split K2's function: ``iterations`` K3-split SpMVs."""
    return _repeat(sell_streamy_plain, iterations, *args, **kw)


def sell_bench_split_plain(*args, iterations: int, **kw) -> torch.Tensor:
    """The split K2's function: ``iterations`` fresh K4 SpMVs."""
    return _repeat(sell_split_plain, iterations, *args, **kw)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_PLANE_ARGS = [ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP]
_SPMV_SIGNATURES = {
    "sell_spmv_launch": (ctypes.c_int, _PLANE_ARGS + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_BENCH_SIGNATURES = {
    "sell_bench_launch": (ctypes.c_int, _PLANE_ARGS + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
    ]),
    "sell_bench_blocks": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]),
    "sell_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# Kernel names per (route, bench), as csrc/ names them.
KERNEL_NAMES = {
    ("relsl", False): "sell_spmv_kernel",
    ("streamy_relsl", False): "sell_streamy_relsl_kernel",
    ("streamy", False): "sell_streamy_kernel",
    ("split", False): "sell_split_kernel",
    ("relsl", True): "sell_bench_kernel",
    ("streamy_relsl", True): "sell_bench_streamy_relsl_kernel",
    ("streamy", True): "sell_bench_streamy_kernel",
    ("split", True): "sell_bench_split_kernel",
}


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sell_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _kinds(vals: torch.Tensor, lidx: torch.Tensor):
    return (int(vals.dtype == torch.bfloat16), int(lidx.dtype == torch.int32))


def _launch_device(vals: torch.Tensor) -> torch.device:
    if vals.device.type != "cuda":
        raise ValueError(
            f"the SELL kernels run on cuda tensors (got {vals.device}); "
            "only CPU tensors take the plain version"
        )
    return vals.device


def _launch(route: str, *, vals, lidx, tile_base, x, n_slices: int,
            chunk: int, relsl=None, rel=None, slice_of=None,
            y_block_id=None, nsb: int = 0,
            iterations: Optional[int] = None) -> torch.Tensor:
    """One launch of the route's forward kernel (``iterations`` None) or
    its bench kernel; returns y (float32, ``n_slices * 128``)."""
    dev = _launch_device(vals)
    vk, lk = _kinds(vals, lidx)
    n_out = n_slices * LANES
    stream = torch.cuda.current_stream(dev).cuda_stream
    planes = [None if t is None else t.data_ptr() for t in (
        vals, lidx, relsl if relsl is not None else rel, slice_of,
        tile_base, y_block_id)]
    bench = iterations is not None
    name = KERNEL_NAMES[(route, bench)]
    if bench:
        lib = _build.load("sell_bench", _BENCH_SIGNATURES)
        y = torch.empty(n_out, dtype=torch.float32, device=dev)
        rc = lib.sell_bench_launch(
            _ROUTE_IDS[route], *planes, x.data_ptr(), y.data_ptr(),
            vals.numel(), n_out, chunk, nsb, iterations, vk, lk, dev.index,
            stream)
        _check_rc(lib, rc, f"{name} cooperative launch")
    else:
        lib = _build.load("sell_spmv", _SPMV_SIGNATURES)
        y = torch.zeros(n_out, dtype=torch.float32, device=dev)
        rc = lib.sell_spmv_launch(
            _ROUTE_IDS[route], *planes, x.data_ptr(), y.data_ptr(),
            vals.numel(), chunk, nsb, vk, lk, dev.index, stream)
        _check_rc(lib, rc, f"{name} launch")
    return y


def _dispatch(wrapper, plain, route: str, planes: dict, x, *, n_slices: int,
              chunk: int, **kw) -> torch.Tensor:
    """Check the planes, then run ``plain`` on CPU tensors or launch the
    route's kernel (counted on ``wrapper``) on CUDA ones; ``kw`` carries
    ``nsb`` on streamed routes and ``iterations`` on bench kernels."""
    if kw.get("iterations", 1) < 1:
        raise ValueError("iterations must be >= 1")
    check_planes(**planes, x=x, chunk=chunk)
    if planes["vals"].device.type == "cpu":
        return plain(*planes.values(), x, n_slices=n_slices, chunk=chunk,
                     **kw)
    y = _launch(route, **planes, x=x, n_slices=n_slices, chunk=chunk, **kw)
    wrapper.launches += 1
    return y


def sell_spmv(vals, lidx, relsl, tile_base, x, *, n_slices: int,
              chunk: int) -> torch.Tensor:
    """K1: y = A·x over the SELL planes, y float32 of ``n_slices * 128``."""
    return _dispatch(sell_spmv, sell_spmv_plain, "relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk)


def sell_streamy_relsl(vals, lidx, relsl, tile_base, y_block_id, x, *,
                       n_slices: int, chunk: int, nsb: int) -> torch.Tensor:
    """K3-relsl: y = A·x, merged word, y in blocks of ``nsb`` slices."""
    return _dispatch(sell_streamy_relsl, sell_streamy_relsl_plain,
                     "streamy_relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb)


def sell_streamy(vals, lidx, rel, slice_of, tile_base, y_block_id, x, *,
                 n_slices: int, chunk: int, nsb: int) -> torch.Tensor:
    """K3-split: y = A·x, split planes, y in blocks of ``nsb`` slices."""
    return _dispatch(sell_streamy, sell_streamy_plain, "streamy",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb)


def sell_split(vals, lidx, rel, slice_of, tile_base, x, *, n_slices: int,
               chunk: int) -> torch.Tensor:
    """K4: y = A·x, split planes, resident y."""
    return _dispatch(sell_split, sell_split_plain, "split",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk)


def sell_bench_loop(vals, lidx, relsl, tile_base, x, *, n_slices: int,
                    chunk: int, iterations: int) -> torch.Tensor:
    """K2: ``iterations`` K1 SpMVs in one cooperative launch; the last y."""
    return _dispatch(sell_bench_loop, sell_bench_loop_plain, "relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk,
                     iterations=iterations)


def sell_bench_streamy_relsl(vals, lidx, relsl, tile_base, y_block_id, x, *,
                             n_slices: int, chunk: int, nsb: int,
                             iterations: int) -> torch.Tensor:
    """K2 on the streamed merged-word route: ``iterations`` K3-relsl SpMVs
    in one cooperative launch; the last y."""
    return _dispatch(sell_bench_streamy_relsl, sell_bench_streamy_relsl_plain,
                     "streamy_relsl",
                     dict(vals=vals, lidx=lidx, relsl=relsl,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb,
                     iterations=iterations)


def sell_bench_streamy(vals, lidx, rel, slice_of, tile_base, y_block_id, x,
                       *, n_slices: int, chunk: int, nsb: int,
                       iterations: int) -> torch.Tensor:
    """K2 on the streamed split route: ``iterations`` K3-split SpMVs in one
    cooperative launch; the last y."""
    return _dispatch(sell_bench_streamy, sell_bench_streamy_plain, "streamy",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base, y_block_id=y_block_id),
                     x, n_slices=n_slices, chunk=chunk, nsb=nsb,
                     iterations=iterations)


def sell_bench_split(vals, lidx, rel, slice_of, tile_base, x, *,
                     n_slices: int, chunk: int,
                     iterations: int) -> torch.Tensor:
    """K2 on the split route: ``iterations`` K4 SpMVs in one cooperative
    launch; the last y."""
    return _dispatch(sell_bench_split, sell_bench_split_plain, "split",
                     dict(vals=vals, lidx=lidx, rel=rel, slice_of=slice_of,
                          tile_base=tile_base),
                     x, n_slices=n_slices, chunk=chunk,
                     iterations=iterations)


for _fn in (sell_spmv, sell_streamy_relsl, sell_streamy, sell_split,
            sell_bench_loop, sell_bench_streamy_relsl, sell_bench_streamy,
            sell_bench_split):
    _fn.launches = 0

# The forward and bench wrapper and their plain versions, per route.
_ROUTE_FNS = {
    "relsl": (sell_spmv, sell_bench_loop),
    "streamy_relsl": (sell_streamy_relsl, sell_bench_streamy_relsl),
    "streamy": (sell_streamy, sell_bench_streamy),
    "split": (sell_split, sell_bench_split),
}


def bench_blocks(value_dtype: torch.dtype, lidx_dt: torch.dtype,
                 device=None, route: str = "relsl") -> int:
    """Blocks of one bench launch of ``route`` on ``device`` (SMs ×
    co-resident blocks)."""
    dev = resolve_device(device)
    lib = _build.load("sell_bench", _BENCH_SIGNATURES)
    out = ctypes.c_int(0)
    rc = lib.sell_bench_blocks(_ROUTE_IDS[route],
                               int(value_dtype == torch.bfloat16),
                               int(lidx_dt == torch.int32), dev.index,
                               ctypes.byref(out))
    _check_rc(lib, rc, f"{KERNEL_NAMES[(route, True)]} occupancy query")
    return out.value


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


class SellSpMV:
    """Encoded SELL-T1 operator: ``y = op(x)`` through the route's kernel,
    on one device.

    Build once per matrix (host planning + one upload), call many times.
    ``value_dtype`` is float32 or bfloat16; in bf16 mode vals and x are
    stored as bf16 and products accumulate in float32, as in the JAX
    operator. Only the planes the route reads are uploaded: ``relsl`` on
    merged-word routes, ``rel`` and ``slice_of`` (int32 per sublane, -1 =
    dead) on split ones, ``y_block_id`` on streamed ones; the others are
    None.
    """

    def __init__(self, plan: SellPlan, value_dtype: Optional[torch.dtype] = None,
                 device=None):
        self.device = resolve_device(device)
        check_plan(plan)
        self.value_dtype = torch.float32 if value_dtype is None else value_dtype
        if self.value_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("value_dtype must be float32 or bfloat16")
        self.plan = plan
        self.shape = plan.shape
        self.route = plan_route(plan)
        dev = self.device

        def upload(a):
            return host_tensor(np.asarray(a).reshape(-1), np.int32).to(dev)

        self.vals = host_tensor(plan.vals, np.float32).to(
            self.value_dtype).to(dev)
        self.lidx = host_tensor(plan.lane_idx, np.int32).to(
            lidx_dtype(plan.chunk)).to(dev)
        self.tile_base = upload(plan.tile_base)
        self.relsl = self.rel = self.slice_of = self.y_block_id = None
        if plan.merged_word:
            self.relsl = upload(relsl_plane_host(plan))
        else:
            self.rel = upload(plan.rel_tile)
            self.slice_of = upload(plan.slice_of)
        if plan.y_block_slices:
            self.y_block_id = upload(plan.y_block_id)
        self.kernel, self.bench_kernel = _ROUTE_FNS[self.route]

    @staticmethod
    def from_coo(coo, value_dtype: Optional[torch.dtype] = None,
                 device=None) -> "SellSpMV":
        r, c, v = coo.to_numpy()
        return SellSpMV(_auto_plan(r, c, v, coo.shape),
                        value_dtype=value_dtype,
                        device=coo.device if device is None else device)

    def _x_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """x cast to the value dtype and zero-padded to CT·128."""
        if x.device != self.device:
            raise ValueError(
                f"x is on {x.device}, the operator on {self.device}"
            )
        ncols_pad = self.plan.n_coltiles * LANES
        x = x.reshape(-1)
        if x.shape[0] > ncols_pad:
            raise ValueError(f"x has {x.shape[0]} entries, the matrix "
                             f"{self.shape[1]} columns")
        out = torch.zeros(ncols_pad, dtype=self.value_dtype, device=x.device)
        out[: x.shape[0]] = x.to(self.value_dtype)
        return out

    def _planes(self):
        """The route's planes, in its wrappers' positional order."""
        return tuple(t for t in (self.vals, self.lidx, self.relsl, self.rel,
                                 self.slice_of, self.tile_base,
                                 self.y_block_id) if t is not None)

    def _kw(self):
        kw = dict(n_slices=self.plan.n_slices, chunk=self.plan.chunk)
        if self.plan.y_block_slices:
            kw["nsb"] = self.plan.y_block_slices
        return kw

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self.kernel(*self._planes(), self._x_tiles(x), **self._kw())
        return y[: self.shape[0]]

    def bench_loop(self, x: torch.Tensor, iterations: int) -> torch.Tensor:
        """N SpMVs in ONE launch of the route's bench kernel; returns the
        last iteration's y."""
        y = self.bench_kernel(*self._planes(), self._x_tiles(x),
                              iterations=iterations, **self._kw())
        return y[: self.shape[0]]


# ---------------------------------------------------------------------------
# Format-level wrappers with per-matrix operator caching
# ---------------------------------------------------------------------------


def _auto_plan(rows, cols, vals, shape, chunk: int = 2048) -> SellPlan:
    """The plan at chunk 2048: flat while y fits ``_RESIDENT_Y_LIMIT``,
    streamed-y beyond it.

    This is the JAX package's ``_auto_plan``, which its operator uses
    under ``SMVP_SELL_AUTOTUNE=0``. By default the JAX operator autotunes
    the chunk per matrix (``_tuned_plan``); the port has no autotuner yet,
    so its plan equals the JAX default plan only where the autotuner also
    picks chunk 2048. Both give the same y within tolerance.
    """
    if shape[0] * 4 > _RESIDENT_Y_LIMIT:  # NS·128·4 ≈ nrows·4 bytes
        return build_streamed_sell_plan(
            rows, cols, vals, shape, chunk=chunk,
            y_block_rows=_STREAM_Y_BLOCK_ROWS,
        )
    return build_sell_plan(rows, cols, vals, shape, chunk=chunk)


_CACHE: "weakref.WeakKeyDictionary[object, SellSpMV]" = (
    weakref.WeakKeyDictionary()
)


def _host_vals(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _triplets_from_csr_host(csr):
    """Host (numpy) CSR → COO triplets."""
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col = csr.col_ind[: csr.nnz].cpu().numpy()
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), np.diff(row_ptr))
    return rows, col, _host_vals(csr.vals[: csr.nnz]), csr.shape


def _triplets_from_tjds_host(tjds):
    """Host (numpy) TJDS → COO triplets, in the TJDS storage order (the
    decode of ``formats/tjds.py`` on the host)."""
    sp = tjds.start_pos.cpu().numpy().astype(np.int64)
    j = np.arange(tjds.nnz, dtype=np.int64)
    d = np.searchsorted(sp, j, side="right") - 1
    offset = j - sp[d]
    perm = tjds.perm.cpu().numpy()
    cols = perm[np.clip(offset, 0, max(tjds.ncols - 1, 0))]
    rows = tjds.row_ind[: tjds.nnz].cpu().numpy()
    return rows, cols, _host_vals(tjds.vals[: tjds.nnz]), tjds.shape


def _cached_op(matrix, triplets_fn=_triplets_from_csr_host) -> SellSpMV:
    """Per-matrix operator cache keyed weakly: a collected matrix drops
    its operator and the operator's device planes with it."""
    op = _CACHE.get(matrix)
    if op is None:
        r, c, v, shape = triplets_fn(matrix)
        # A bfloat16 matrix runs the kernels in bf16 value mode.
        vdt = (torch.bfloat16 if matrix.dtype == torch.bfloat16
               else torch.float32)
        op = SellSpMV(_auto_plan(r, c, v, shape), value_dtype=vdt,
                      device=matrix.device)
        _CACHE[matrix] = op
    return op


def spmv_csr_sell(csr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from CSR via the SELL kernels (operator cached per matrix)."""
    return _cached_op(csr)(x)


def sell_op_csr(csr) -> SellSpMV:
    """The cached SELL operator for a CSR matrix."""
    return _cached_op(csr)


def spmv_tjds_sell(tjds, x: torch.Tensor) -> torch.Tensor:
    """y = A·x from TJDS via the SELL kernels (operator cached per
    matrix): the TJDS triplets are replanned, so TJDS runs on whichever
    kernel its plan's route demands."""
    return _cached_op(tjds, _triplets_from_tjds_host)(x)


def sell_op_tjds(tjds) -> SellSpMV:
    """The cached SELL operator for a TJDS matrix."""
    return _cached_op(tjds, _triplets_from_tjds_host)
