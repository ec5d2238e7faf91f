"""Seeded fuzz sweep of the SELL operator's routes and kernels.

The JAX suite's sweep (``tests/test_fuzz_sell.py``: tall, wide,
ultra-sparse, dense-ish with duplicates, a single entry, bfloat16,
``SMVP_SELL_LIDX32``, k up to 17) is the first ten cases of ``CASES``,
verbatim; the rest force the routes the JAX sweep reaches only by plan
size: streamed y (merged word, and split planes on a window over 511
tiles), resident split planes, ``SMVP_SELL_RELSL=0``, ``SMVP_SELL_PACK=1``
(resident and streamed y), ``SMVP_SELL_COMPAT=1`` and
``SMVP_SELL_SUBWIN=1``.

Every case runs its rungs through the operator (``rungs``): ``__call__``,
``matmat`` at each width, ``bench_loop(x, 3)`` where the route has an
N-iteration kernel, ``bench_loop_mat(X, 3)`` at the widest k on resident
merged-word plans, ``vjp_vals_mat`` on resident plans (K7) and the
double-float operator on the case's float64 values (K8 and its
N-iteration kernel) where its plan is resident on the merged word. Each
result is held to a float64 oracle (``oracle``) at the JAX suite's
tolerances: 2e-5 of max |y| in float32, 3e-2 in bfloat16 against the
oracle's values and x rounded to bfloat16; K8's pair to 5e-14.

``check_on_card`` runs every case on a CUDA device and holds each kernel
against its plain version, an operator on the CPU over the same plan: 1e-6
of max |y| (the SpMM tolerance for k columns), K6 and K8 bit for bit
(K6 across two launches, K8 against its plain version), the N-iteration
kernels after 3 iterations against 3 plain iterations. The tests on the
CPU hold the plain versions to the oracle and to the JAX operator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.ops.sell_plan import build_streamed_sell_plan
from smvp_toolkit_tpu_torch.utils.tracing import kernel_counts, kernel_wrappers

__all__ = [
    "FuzzCase",
    "JAX_CASES",
    "CASES",
    "case_data",
    "case_env",
    "build_operator",
    "build_df64",
    "rungs",
    "oracle",
    "as_f64",
    "rel_err",
    "route_mismatch",
    "rung_kernel",
    "kernel_wrappers",
    "kernel_counts",
    "check_on_card",
]

TOL = {"f32": 2e-5, "bf16": 3e-2}  # against the oracle (the JAX sweep's)
TOL_KERNEL = 1e-6                   # kernel against its plain version
TOL_DF64 = 5e-14                    # tests/test_df64_pallas.py:37


@dataclasses.dataclass(frozen=True)
class FuzzCase:
    """One seeded matrix and its switches.

    ``k`` is the JAX sweep's SpMM width (``matmat`` runs at it when above
    1), ``ks`` further widths. ``y_block_rows`` > 0 plans a streamed y in
    blocks of that many rows at ``chunk``; else the operator is
    ``SellSpMV.from_coo``. ``route`` and ``bench_route`` are the routes
    ``__call__`` and ``bench_loop`` must take (``bench_route`` None: the
    operator refuses ``bench_loop``).
    """

    name: str
    seed: int
    n: int
    m: int
    nnz: int
    k: int
    dtype: str
    env: Dict[str, str]
    route: str = "relsl"
    bench_route: Optional[str] = "relsl"
    ks: Tuple[int, ...] = ()
    y_block_rows: int = 0
    chunk: int = 2048

    @property
    def value_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bf16" else torch.float32

    @property
    def widths(self) -> Tuple[int, ...]:
        """The ``matmat`` widths, in order."""
        return tuple(sorted({*self.ks, *((self.k,) if self.k > 1 else ())}))

    @property
    def lossy_jax(self) -> bool:
        """The JAX operator runs a lossy bf16 reduction under this case's
        switches (``SMVP_SELL_REDUCE2``), which the port does not follow:
        the port is held to the oracle only."""
        return self.env.get("SMVP_SELL_REDUCE2") == "1"


# (seed, nrows, ncols, nnz, k, value_dtype, env): tests/test_fuzz_sell.py
JAX_CASES = [
    (0, 513, 129, 3000, 1, "f32", {}),
    (1, 129, 513, 3000, 4, "f32", {}),
    (2, 1000, 1000, 50, 3, "f32", {}),           # ultra-sparse
    (3, 64, 64, 4000, 2, "f32", {}),             # dense-ish, duplicates
    (4, 2048, 100, 6000, 5, "bf16", {}),         # tall, bf16
    (5, 100, 2048, 6000, 7, "f32", {"SMVP_SELL_REDUCE2": "1"}),
    (6, 777, 333, 2000, 9, "f32", {"SMVP_SELL_NOWINDOW": "1"}),
    (7, 333, 777, 2000, 2, "bf16", {"SMVP_SELL_LIDX32": "1"}),
    (8, 300, 300, 1, 3, "f32", {}),              # single entry
    (9, 555, 444, 2500, 17, "f32", {}),          # k > group
]

_KS = (1, 8, 17)


def _route_cases() -> List[FuzzCase]:
    out = []
    for dt in ("f32", "bf16"):
        out += [
            # streamed y, merged word: K3-relsl, K2 streamed
            FuzzCase(f"streamed-relsl-{dt}", 10, 5000, 900, 9000, 1, dt, {},
                     "streamy_relsl", "streamy_relsl", _KS,
                     y_block_rows=2048, chunk=256),
            # streamed y, window of 560 tiles: K3-split, K2 streamed split
            FuzzCase(f"streamed-split-{dt}", 11, 5000, 70000, 9000, 1, dt,
                     {}, "streamy", "streamy", _KS, y_block_rows=4096),
            # resident y, window over 511 tiles: K4, K2 split, K4 with k
            FuzzCase(f"resident-split-{dt}", 12, 3000, 70000, 1800, 1, dt,
                     {}, "split", "split", _KS),
            # the merged word's plan on its split planes: K4, K2 split
            FuzzCase(f"relsl0-{dt}", 13, 2500, 2000, 15000, 1, dt,
                     {"SMVP_SELL_RELSL": "0"}, "split", "split", _KS),
            # K6 per call (matmat column by column); bench_loop keeps K2
            FuzzCase(f"compat-{dt}", 16, 1000, 800, 6000, 1, dt,
                     {"SMVP_SELL_COMPAT": "1"}, "onehot", "relsl", _KS),
            # K2-subwin: chunk 2048 in four sub-chains with windows
            FuzzCase(f"subwin-{dt}", 17, 8000, 8000, 60000, 1, dt,
                     {"SMVP_SELL_SUBWIN": "1"}, "relsl", "subwin", _KS),
        ]
    return out + [
        # bf16 only: K5, K5 with k columns, K2-packed
        FuzzCase("packed-bf16", 14, 2500, 2000, 15000, 1, "bf16",
                 {"SMVP_SELL_PACK": "1"}, "packed", "packed", _KS),
        # K5 on streamed y; bench_loop refused, as in the JAX operator
        FuzzCase("streamed-packed-bf16", 15, 5000, 900, 9000, 1, "bf16",
                 {"SMVP_SELL_PACK": "1"}, "streamy_packed", None, _KS,
                 y_block_rows=2048, chunk=256),
    ]


CASES: List[FuzzCase] = [
    FuzzCase(f"case{s}", s, n, m, nnz, k, vdt, env)
    for s, n, m, nnz, k, vdt, env in JAX_CASES
] + _route_cases()


def case_data(case: FuzzCase) -> dict:
    """The case's host inputs: triplets ``r``, ``c``, ``v`` (float32) and
    ``v64`` (the float64 draws ``v`` rounds), x, X per width, the K7 pair
    ``Xg``/``G``, and ``x64`` for K8. The JAX sweep's draws come first, in
    its order, so its ten cases see its numbers."""
    rng = np.random.RandomState(case.seed)
    r = rng.randint(0, case.n, case.nnz).astype(np.int32)
    c = rng.randint(0, case.m, case.nnz).astype(np.int32)
    v64 = rng.randn(case.nnz)
    x = rng.randn(case.m).astype(np.float32)
    X = {}
    if case.k > 1:
        X[case.k] = rng.randn(case.m, case.k).astype(np.float32)
    more = np.random.default_rng(case.seed + 1000)
    for k in case.widths:
        if k not in X:
            X[k] = more.standard_normal((case.m, k)).astype(np.float32)
    kg = max(case.widths, default=1)
    return dict(
        r=r, c=c, v=v64.astype(np.float32), v64=v64, x=x, X=X,
        Xg=more.standard_normal((case.m, kg)).astype(np.float32),
        G=more.standard_normal((case.n, kg)).astype(np.float32),
        x64=more.standard_normal(case.m),
    )


@contextlib.contextmanager
def case_env(case: FuzzCase, **extra: str):
    """The case's ``SMVP_SELL_*`` switches (and ``extra``) set in
    ``os.environ`` for the block, the previous values restored after."""
    env = {**case.env, **extra}
    old = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for key, val in old.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def build_operator(case: FuzzCase, data: dict, device):
    """The case's ``SellSpMV`` on ``device`` (call it under
    ``case_env``: ``SMVP_SELL_LIDX32`` is read at construction)."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV

    r, c, v = data["r"], data["c"], data["v"]
    shape = (case.n, case.m)
    if case.y_block_rows:
        plan = build_streamed_sell_plan(r, c, v, shape, chunk=case.chunk,
                                        y_block_rows=case.y_block_rows)
        return SellSpMV(plan, value_dtype=case.value_dtype, device=device,
                        triplets=(r, c, v))
    coo = COOMatrix.from_numpy(r, c, v, shape=shape, pad_to=64,
                               device=device)
    return SellSpMV.from_coo(coo, value_dtype=case.value_dtype)


def build_df64(case: FuzzCase, data: dict, device):
    """The double-float operator on the case's float64 values, or None
    where its plan is not resident on the merged word (streamed y, or a
    window over 511 tiles), which ``SellDf64SpMV`` refuses."""
    from smvp_toolkit_tpu_torch.ops.sell_plan import build_sell_plan
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import SellDf64SpMV

    if case.y_block_rows:
        return None
    shape = (case.n, case.m)
    probe = build_sell_plan(data["r"], data["c"], data["v"], shape,
                            chunk=2048)
    if not probe.merged_word:
        return None
    return SellDf64SpMV.from_coo_f64(data["r"], data["c"], data["v64"],
                                     shape, device=device)


Rung = Tuple[str, Callable]


def rungs(case: FuzzCase, data: dict, op, df=None) -> List[Rung]:
    """(label, fn) per rung the case reaches: ``fn(operator)`` runs it
    through an operator of this case (``op`` or one over the same plan
    on another device; for ``df64``, a double-float operator) and returns
    y, Y, the values cotangent or the (hi, lo) pair."""

    def to(a, o):
        return torch.from_numpy(a).to(o.device)

    out: List[Rung] = [("spmv", lambda o: o(to(data["x"], o)))]
    for k in case.widths:
        out.append((f"matmat k={k}",
                    lambda o, k=k: o.matmat(to(data["X"][k], o))))
    if op.bench_loop_refusal() is None:
        out.append(("bench_loop(3)",
                    lambda o: o.bench_loop(to(data["x"], o), 3)))
    kb = max(case.widths, default=1)
    if kb > 1 and op._merged_route() and not op.plan.y_block_slices:
        out.append((f"bench_loop_mat(3) k={kb}", lambda o: o.bench_loop_mat(
            to(data["X"][kb], o), 3)))
    if not op.plan.y_block_slices:
        out.append(("vjp_vals_mat", lambda o: o.vjp_vals_mat(
            to(data["Xg"], o), to(data["G"], o))))
    if df is not None:
        from smvp_toolkit_tpu_torch.ops.precision import df_split

        def pair(o, n):
            xh, xl = df_split(data["x64"], device=o.device)
            return o(xh, xl) if n == 1 else o.bench_loop(xh, xl, n)

        out.append(("df64", lambda o: pair(o, 1)))
        out.append(("df64 bench_loop(3)", lambda o: pair(o, 3)))
    return out


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float64)).to(
        torch.bfloat16).double().numpy()


def oracle(case: FuzzCase, data: dict,
           label: str) -> Tuple[np.ndarray, float]:
    """(float64 reference, tolerance) of a rung, the JAX sweep's: the
    float64 matrix (in bf16 mode its entries and x rounded to bfloat16).
    ``vjp_vals_mat``'s is per triplet, Σ_j G[r, j]·X[c, j], to be read at
    each triplet's slot of the plane (``as_f64``)."""
    import scipy.sparse

    r, c = data["r"], data["c"]
    if label.startswith("df64"):
        y = np.zeros(case.n)
        np.add.at(y, r, data["v64"] * data["x64"][c])
        return y, TOL_DF64
    bf16 = case.dtype == "bf16"
    cast = _bf16 if bf16 else (lambda a: np.asarray(a, np.float64))
    if label == "vjp_vals_mat":
        return (data["G"].astype(np.float64)[r]
                * cast(data["Xg"])[c]).sum(axis=1), TOL[case.dtype]
    # The matrix's entries, duplicates summed, as the JAX sweep's dense
    # oracle holds them (rounded to bfloat16 after the sum), stored sparse.
    a = scipy.sparse.csr_matrix((data["v"].astype(np.float64), (r, c)),
                                shape=(case.n, case.m))
    if bf16:
        a.data = _bf16(a.data)
    rhs = data["X"][_width(label)] if "k=" in label else data["x"]
    return a @ cast(rhs), TOL[case.dtype]


def _width(label: str) -> int:
    """k of a ``... k=K`` rung label."""
    return int(label.rsplit("=", 1)[1])


def as_f64(result, slot: Optional[np.ndarray] = None) -> np.ndarray:
    """A rung's result on the host in float64: a (hi, lo) pair summed, a
    values cotangent taken at ``slot``."""
    if isinstance(result, tuple):
        hi, lo = result
        return hi.double().cpu().numpy() + lo.double().cpu().numpy()
    a = result.detach().double().cpu().numpy()
    return a.reshape(-1)[slot] if slot is not None else a


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got − ref| / max |ref| (the JAX sweep's scale, at least
    1e-9)."""
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9))


def route_mismatch(case: FuzzCase, op) -> Optional[str]:
    """Why ``op`` does not take the case's routes now, or None. A case
    names ``csr`` where ``__call__`` must take K12 (``SellSpMV.csr_on``);
    ``bench_loop`` always keeps the planes."""
    bench = None if op.bench_loop_refusal() else op.bench_route
    if (op.route, bench) == (case.route, case.bench_route):
        return None
    return (f"{case.name}: routes {op.route}/{bench}, not "
            f"{case.route}/{case.bench_route}")


def rung_kernel(op, label: str) -> str:
    """The one kernel a rung must launch on ``op``'s routes now: K12 for
    a call on the csr route, the forward kernel of the plane route (per
    column where ``matmat`` runs column by column), the k-column kernel
    of a resident ``matmat``, the N-iteration kernel of
    ``op.bench_route``, K7, or K8 and its N-iteration kernel."""
    from smvp_toolkit_tpu_torch.ops.csr_merge import csr_merge_spmv
    from smvp_toolkit_tpu_torch.ops.spmv_sell import KERNEL_NAMES

    if label.startswith("df64"):
        return ("sell_bench_df64_kernel" if "bench" in label
                else "sell_df64_kernel")
    if label == "vjp_vals_mat":
        return "sell_vals_grad_kernel"
    if label.startswith("bench_loop_mat"):
        return "sell_bench_spmm_kernel"
    if label.startswith("bench"):
        route = op.bench_route
        return {"packed": "sell_bench_packed_kernel",
                "subwin": "sell_bench_subwin_kernel"}.get(
            route) or KERNEL_NAMES[(route, True)]
    if label == "spmv" and op.route == "csr":
        return csr_merge_spmv.kernel
    route = op._route()
    by_column = (label in ("spmv", "matmat k=1") or op.plan.y_block_slices
                 or route == "onehot"
                 or os.environ.get("SMVP_SELL_SPMM") == "0")
    if not by_column:
        return {"relsl": "sell_spmm_kernel",
                "split": "sell_split_spmm_kernel",
                "packed": "sell_packed_spmm_kernel"}[route]
    return {"packed": "sell_packed_kernel",
            "streamy_packed": "sell_packed_kernel",
            "onehot": "sell_onehot_kernel"}.get(
        route) or KERNEL_NAMES[(route, False)]


def _bits_equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_bits_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a.cpu(), b.cpu())


def check_on_card(case: FuzzCase, device) -> Tuple[List[dict], List[str]]:
    """Run the case on ``device`` (a CUDA device) and on the CPU over the
    same plans (the plain versions); each rung must launch its kernel
    (``rung_kernel``) and no other, and agree with its plain version and
    with the oracle. Returns one row per rung (its label, the kernels it
    launched, its errors against the plain version and the oracle, and
    the plain tolerance) and the failures, as messages."""
    from smvp_toolkit_tpu_torch.bench.bench_variants import spmm_tolerance
    from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV

    data = case_data(case)
    rows, fails = [], []
    with case_env(case):
        op = build_operator(case, data, device)
        plain = SellSpMV(op.plan, value_dtype=op.value_dtype, device="cpu",
                         triplets=op._triplets)
        df = build_df64(case, data, device)
        df_plain = build_df64(case, data, "cpu")
        fails += [m for m in (route_mismatch(case, op),) if m]
        slot = None if op.plan.y_block_slices else plain.slot_map()
        spmm_tol = spmm_tolerance(op.plan)[0]
        results = {}
        for label, fn in rungs(case, data, op, df):
            is_df = label.startswith("df64")
            before = kernel_counts()
            got = results[label] = fn(df if is_df else op)
            torch.cuda.synchronize(device)
            after = kernel_counts()
            launched = sorted(k for k in after if after[k] > before[k])
            ref = fn(df_plain if is_df else plain)
            at = slot if label == "vjp_vals_mat" else None
            g64 = as_f64(got, at)
            want, tol_o = oracle(case, data, label)
            e_plain = rel_err(g64, as_f64(ref, at))
            e_oracle = rel_err(g64, want)
            tol_p = (spmm_tol if "k=" in label and _width(label) > 1
                     else TOL_KERNEL)
            what = f"{case.name} {label}"
            want_k = rung_kernel(df if is_df else op, label)
            if launched != [want_k]:
                fails.append(f"{what}: launched {launched}, not {want_k}")
            if not np.isfinite(g64).all():
                fails.append(f"{what}: not finite")
            if is_df:
                tol_p = 0.0
                if not _bits_equal(got, ref):
                    fails.append(f"{what}: not bit for bit its plain version "
                                 f"({e_plain:.3e})")
                if label != "df64" and not _bits_equal(got, results["df64"]):
                    fails.append(f"{what}: not bit for bit one launch")
            elif e_plain > tol_p:
                fails.append(f"{what} vs plain: {e_plain} > {tol_p}")
            if op.route == "onehot" and label == "spmv" and not _bits_equal(
                    got, fn(op)):
                fails.append(f"{what}: two K6 launches differ")
            if e_oracle > tol_o:
                fails.append(f"{what} vs oracle: {e_oracle} > {tol_o}")
            rows.append(dict(rung=label, kernels=launched, plain=e_plain,
                             oracle=e_oracle, tol=tol_p))
    return rows, fails
