"""The N-iteration body's variant timer (``bench/bench_variants.py``) on the
CPU: what it can check without a card. Its variant ids and result buffers
match the CUDA source's, it hands each route's planes to the launcher in
``sell_bench_launch``'s order, it reads ptxas's register report, and with
no card it refuses to run (the timings themselves come only from a card).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu_torch.bench import bench_variants as BV
from smvp_toolkit_tpu_torch.ops import spmv_sell as S

import test_torch_streamy_contract as contract

SOURCE = BV._SRC.read_text()


def test_variant_ids_match_the_source():
    """Every id is a case of ``variant_of`` and is listed in the source's
    header under the same name."""
    cases = {int(m) for m in re.findall(
        r"case (\d):\s+(?:return on_route|if)", SOURCE)}
    assert cases == set(BV.VARIANTS.values())
    for name, vid in BV.VARIANTS.items():
        assert re.search(rf"^//\s+{vid} {name}\s", SOURCE, re.M), name


def test_one_buffer_variants_match_the_source():
    ids = sorted(BV.VARIANTS[v] for v in BV.ONE_BUFFER)
    assert (f"Variants {ids[0]} and {ids[1]} leave the result in y[0]"
            in SOURCE)
    assert "sublane_bench_sweeps<Stage, YAddr, 1>" in SOURCE
    assert "bench_sweeps<MergedWord, YAddr>" in SOURCE


@pytest.mark.parametrize("route", contract.ROUTES)
def test_plane_pointers_in_launch_order(route):
    plan = contract.contract_plan("dead-run-ends-chunk", route)
    op = S.SellSpMV(plan, device="cpu")
    ptr = BV.plane_pointers(op, route)
    merged = route in contract.MERGED
    want = [op.vals, op.lidx,
            op.relsl if merged else op.split_planes()[0],
            None if merged else op.split_planes()[1], op.tile_base,
            op.y_block_id if plan.y_block_slices else None]
    assert ptr == [None if t is None else t.data_ptr() for t in want]


def test_registers_from_a_ptxas_report():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114variant_kernelILi3EN4sell10MergedWordE' "
        "for 'sm_90a'",
        "ptxas info    : Used 32 registers, 512 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111slot_kernelIN4sell9ResidentYEfaEEv' for 'sm_90a'",
        "ptxas info    : Used 30 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111slot_kernelIN4sell9StreamedYEfaEEv' for 'sm_90a'",
        "ptxas info    : Used 31 registers",
    ])
    assert BV._registers(log) == {"variant 3": 32, "slot_kernel": 31}


def test_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would time the variants")
    assert BV.main(["--configs", "smoke"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


# -- the k-column variants (``--kcol``) --------------------------------------

KCOL_SOURCE = BV._KCOL_SRC.read_text()


def test_kcol_variant_ids_match_the_source():
    """Every k-column variant id is listed in the source's header under
    the same name, and ``variant_of`` (or, for the old walk, the launcher)
    dispatches it; every run cap timed is a case of variant 0."""
    for name, vid in BV.KCOL_VARIANTS.items():
        assert re.search(rf"^//\s+{vid} {name}\s", KCOL_SOURCE, re.M), name
    assert "if (variant == 2)" in KCOL_SOURCE  # slots: the old warp walk
    assert "if (variant == 1) return shaped<1, 1," in KCOL_SOURCE
    assert "if (variant == 3) return shaped<3, kMatRunCap," in KCOL_SOURCE
    caps = {int(m) for m in re.findall(r"case (\d+): return shaped<0, ",
                                       KCOL_SOURCE)}
    assert caps == set(BV.KCOL_CAPS) and BV.KCOL_CAP in caps
    common = (S.__file__.rsplit("/", 2)[0] + "/csrc/sell_common.cuh")
    assert (f"constexpr int kMatRunCap = {BV.KCOL_CAP};"
            in open(common).read())


def test_kcol_shapes_are_instantiated():
    """The kept shape of every timed k, each alternative and every swept
    shape is a shape the variants' source instantiates."""
    body = KCOL_SOURCE[KCOL_SOURCE.index("MKernel<V> shaped("):]
    body = body[:body.index("#undef SHAPE")]
    shapes = {(int(t), int(p)) for t, p in re.findall(
        r"SHAPE\((\d+), (\d+)\)", body)}
    for k in BV.KCOL_SHAPES:
        t, w, p = S.spmm_shape(k)
        assert w == 4 and (t, p) in shapes, k
        assert (t, p) in BV.KCOL_SWEEP[k] and (t, p) not in BV.KCOL_SHAPES[k]
        assert set(BV.KCOL_SHAPES[k]) | set(BV.KCOL_SWEEP[k]) <= shapes, k
    assert set(BV.KCOL_K) == {"smoke", "L2", "gcn_arxiv:A", "gcn_arxiv:At"}
    assert {k for ks in BV.KCOL_K.values() for k in ks} == set(BV.KCOL_SHAPES)


def test_kcol_tolerance_counts_the_longest_row():
    """``spmm_tolerance``'s n is the most products one row of Y sums over
    the plan's nonzero slots of live sublanes (the plain version's rows)."""
    import torch_kcol_plans as kcol

    plan = kcol.hub_row_plan("relsl")
    op = S.SellSpMV(plan, device="cpu")
    rel, sl = S._decode_word(op.relsl)
    _, _, row = S._live_slots(op.lidx, rel, sl, op.tile_base,
                              chunk=plan.chunk, vals=op.vals)
    tol, n = BV.spmm_tolerance(plan)
    assert n == int(torch.bincount(row).max()) >= kcol.HUB_ENTRIES
    assert tol == max(BV.TOL, 2 * 2.0 ** -24 * n ** 0.5)


# -- K7's variants (``--vgrad``) and K2-subwin's forms (``--subwin``) --------

VGRAD_SOURCE = BV._VGRAD_SRC.read_text()


def _c_params(source, fn):
    """The parameter count of the C function ``fn`` in ``source``."""
    head = source[source.index(f"int {fn}("):]
    return len(head[: head.index(")")].split(","))


def test_vgrad_variant_ids_match_the_source():
    """Every K7 variant id is listed in the source's header under the same
    name and dispatched by its launcher; the caps timed on the kept
    kernel lie below its unit size."""
    for name, vid in BV.VGRAD_VARIANTS.items():
        assert re.search(rf"^//\s+{vid} {name}\s", VGRAD_SOURCE, re.M), name
        assert f"variant == {vid}" in VGRAD_SOURCE, name
    assert all(1 <= c <= S.VG_RUN for c in BV.VGRAD_CAPS)
    assert set(BV.VGRAD_SCHEDULED) <= set(BV.VGRAD_VARIANTS)
    assert set(BV.VGRAD_K) == {256, 40}
    kept = (S.__file__.rsplit("/", 2)[0] + "/csrc/sell_vals_grad.cu")
    assert f"constexpr int kVgRun = {S.VG_RUN};" in open(kept).read()


def test_subwin_forms_match_the_source():
    assert re.search(r"K2-subwin's forms \(sell_bench_subwin_variant_launch",
                     SOURCE)
    for name, form in BV.SUBWIN_FORMS.items():
        assert f"if (form == {form}) kernel = " in SOURCE, name
    assert "(form 1) or two buffers and one barrier (form 2" in SOURCE
    assert "Forms 0 and 1 leave the result in y[0]" in SOURCE


def test_variant_signatures_match_the_sources():
    """ctypes gets as many arguments as each C launcher takes."""
    for src, sigs, fn in (
            (VGRAD_SOURCE, BV._VGRAD_SIGNATURES,
             "sell_vals_grad_variant_launch"),
            (SOURCE, BV._SIGNATURES, "sell_bench_subwin_variant_launch"),
            (SOURCE, BV._SIGNATURES, "sell_bench_variant_launch")):
        assert len(sigs[fn][1]) == _c_params(src, fn), fn
    kept = open(S.__file__.rsplit("/", 2)[0]
                + "/csrc/sell_vals_grad.cu").read()
    assert len(S._VALS_GRAD_SIGNATURES["sell_vals_grad_launch"][1]) == (
        _c_params(kept, "sell_vals_grad_launch"))
    assert (_c_params(VGRAD_SOURCE, "sell_vals_grad_variant_launch")
            == _c_params(kept, "sell_vals_grad_launch") + 1)


@pytest.mark.parametrize("route", ["relsl", "split"])
def test_vgrad_pointers_in_launch_order(route):
    import test_torch_autograd as autograd

    tp = autograd._plan_pair(route)[1]
    op = S.SellSpMV(tp, device="cpu")
    X = torch.zeros(tp.n_coltiles * 128, 4)
    G = torch.zeros(tp.n_slices * 128, 4)
    out = torch.empty(op.lidx.shape)
    sched = op.vals_grad_schedule()
    meta = (op.relsl, None) if route == "relsl" else op.split_planes()
    want = [op.lidx, *meta, op.tile_base, X, G, out, sched.order,
            sched.unit_start, sched.unit_slice]
    assert BV.vgrad_pointers(op, X, G, out, sched) == [
        None if t is None else t.data_ptr() for t in want]


@pytest.mark.parametrize("flag", ["--vgrad", "--subwin"])
def test_vgrad_and_subwin_refuse_without_a_card(flag, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would time the variants")
    assert BV.main([flag]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


# -- K5's variants (``--packed``) and K8's (``--df64``) ----------------------

PACKED_SOURCE = BV._PACKED_SRC.read_text()
DF64_SOURCE = BV._DF64_SRC.read_text()


def test_packed_variant_ids_match_the_source():
    """Every K5 variant id is listed in the source's header under the same
    name and is a case of its launcher; the kept body is the kept
    kernel's instantiation."""
    for name, vid in BV.PACKED_VARIANTS.items():
        assert re.search(rf"^//\s+{vid} {name}\s", PACKED_SOURCE, re.M), name
        assert f"case {vid}:" in PACKED_SOURCE, name
    assert "slot<PackedWord, YAddr>(a, i);" in PACKED_SOURCE
    assert "sell_packed_kernel<YAddr>" in PACKED_SOURCE
    assert set(BV.PACKED_CONFIGS) == {"smoke-packed", "L1-packed"}
    assert set(BV.PACKED_CONFIGS.values()) == {"smoke", "L1"}


def test_df64_variant_ids_and_forms_match_the_source():
    """The row walk and the staged body are the source's two variants;
    every (U, S) form timed is one the launcher instantiates, and the
    kept kernel's constants are among them."""
    for name, vid in BV.DF64_VARIANTS.items():
        assert re.search(rf"^//\s+{vid} {name}\s", DF64_SOURCE, re.M), name
    assert "if (variant == 1)" in DF64_SOURCE
    forms = {(int(u), int(sl)) for u, sl in re.findall(
        r"STAGED\((\d+), (\d+)\)\n", DF64_SOURCE)}
    assert set(BV.DF64_FORMS) == forms
    kept = open(S.__file__.rsplit("/", 2)[0] + "/csrc/sell_df64.cu").read()
    u = int(kept.split("constexpr int kDf64Unroll = ")[1].split(";")[0])
    sl = int(kept.split("constexpr int kDf64Slices = ")[1].split(";")[0])
    assert (u, sl) in forms
    assert set(BV.DF64_CONFIGS) == {"smoke-df64", "smoke-df64-f64"}


def test_packed_and_df64_signatures_match_the_sources():
    """ctypes gets as many arguments as each C launcher takes: one more
    than the kept launcher (the variant id) for K5, three more (the
    variant, U and S) for K8."""
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D

    csrc = S.__file__.rsplit("/", 2)[0] + "/csrc/"
    for src, sigs, fn, kept_src, kept_sigs, kept_fn, extra in (
            (PACKED_SOURCE, BV._PACKED_SIGNATURES,
             "sell_packed_variant_launch", "sell_packed.cu",
             S._PACKED_SIGNATURES, "sell_packed_launch", 1),
            (DF64_SOURCE, BV._DF64_SIGNATURES, "sell_df64_variant_launch",
             "sell_df64.cu", D._SIGNATURES, "sell_df64_launch", 3)):
        kept = open(csrc + kept_src).read()
        assert len(sigs[fn][1]) == _c_params(src, fn), fn
        assert len(kept_sigs[kept_fn][1]) == _c_params(kept, kept_fn)
        assert _c_params(src, fn) == _c_params(kept, kept_fn) + extra


@pytest.mark.parametrize("route", ["relsl", "streamy_relsl"])
def test_packed_pointers_in_launch_order(route):
    plan = contract.contract_plan("dead-run-ends-chunk", route)
    op = S.SellSpMV(plan, value_dtype=torch.bfloat16, device="cpu")
    y = torch.zeros(4)
    pk, sl = op.packed_planes()
    want = [pk, sl, op.tile_base,
            op.y_block_id if plan.y_block_slices else None, y]
    assert BV.packed_pointers(op, y) == [
        None if t is None else t.data_ptr() for t in want]


@pytest.mark.parametrize("lo_plane", [True, False])
def test_df64_pointers_in_launch_order(lo_plane):
    from smvp_toolkit_tpu_torch.ops import spmv_df64 as D

    rng = np.random.RandomState(3)
    r, c = rng.randint(0, 300, 2000), rng.randint(0, 300, 2000)
    v = rng.randn(2000)
    if not lo_plane:
        v = v.astype(np.float32).astype(np.float64)
    op = D.SellDf64SpMV.from_coo_f64(r, c, v, (300, 300), chunk=64,
                                     device="cpu")
    planes = op._planes(torch.ones(300), None)
    yh, yl = torch.zeros(4), torch.zeros(4)
    ptr = BV.df64_pointers(planes, yh, yl)
    assert len(ptr) == 11 and (ptr[1] is None) == (not lo_plane)
    assert ptr == [None if t is None else t.data_ptr()
                   for t in (*planes, yh, yl)]


@pytest.mark.parametrize("flag", ["--packed", "--df64"])
def test_packed_and_df64_refuse_without_a_card(flag, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would time the variants")
    assert BV.main([flag]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


# -- K10's and K11's variants (``--solver``), K2 with k columns' forms
# (``--kbench``) ---------------------------------------------------------------

SOLVER_SOURCE = BV._SOLVER_SRC.read_text()


def test_solver_variant_ids_match_the_source():
    """Every solver variant id is listed in the source's header under the
    same name and picks its phase for both K10 and K11, each solve the
    kept kernel's with only its SpMV phase changed."""
    phases = {"walk": "WalkPhase", "body": "SublanePhase",
              "ldcg": "LdcgPhase"}
    assert set(BV.SOLVER_VARIANTS) == set(phases)
    for name, vid in BV.SOLVER_VARIANTS.items():
        assert re.search(rf"^//\s+{vid} {name}\s", SOLVER_SOURCE, re.M), name
        assert (f"if (variant == {vid}) kernel = variant_kernel<"
                f"{phases[name]}, V, L>(solver);") in SOLVER_SOURCE, name
    assert "chebyshev_solve<Phase>(a);" in SOLVER_SOURCE
    assert "pcg_ic0_solve<Phase>(a);" in SOLVER_SOURCE
    for fn, solver in (("sell_chebyshev_variant_launch", "kChebyshev"),
                       ("sell_pcg_ic0_variant_launch", "kPcgIc0")):
        assert f"SOLVER_VARIANT_LAUNCH({fn}, {solver})" in SOLVER_SOURCE
    assert BV.IC0_STEPS == 100 and BV.IC0_SWEEPS == 4


def test_kbench_forms_match_the_source():
    """K2 with k columns' forms: each id is listed in the k-column
    variants' header and dispatched by its launcher; forms 0 and 1 leave
    the result in Y[0], form 2 in Y[(N - 1) % 2] (the kept kernel's two
    buffers)."""
    for name, form in BV.KBENCH_FORMS.items():
        assert re.search(rf"^//\s+{form} {name}\s", KCOL_SOURCE, re.M), name
    assert "form == 0   ? bench_spmm_walk_kernel<V>" in KCOL_SOURCE
    assert ": form == 1 ? bench_spmm_form_kernel<1," in KCOL_SOURCE
    assert ": bench_spmm_form_kernel<2," in KCOL_SOURCE
    assert ("Forms 0 and 1 leave the result in Y[0], form 2 in "
            "Y[(N - 1) % 2].") in KCOL_SOURCE
    assert "mat_bench_sweeps<MergedWord>(a);" in KCOL_SOURCE
    assert S.MAT_BENCH_Y_BUFFERS == 2
    assert (BV.KBENCH_K, BV.KBENCH_N) == (8, 200)


def test_solver_and_kbench_signatures_match_the_sources():
    """ctypes gets as many arguments as each C launcher takes: the solver
    variants the kept launcher's (the variant in place of the solver id),
    K2 with k columns' forms one more than the kept launcher's less its
    lane-index kind (int8 only); the kept blocks query takes k."""
    from smvp_toolkit_tpu_torch.ops import cg_fused as C

    csrc = S.__file__.rsplit("/", 2)[0] + "/csrc/"
    solvers = open(csrc + "sell_solvers.cu").read()
    n = _c_params(solvers, "sell_solver_launch")
    assert len(C._SIGNATURES["sell_solver_launch"][1]) == n
    assert _c_params(SOLVER_SOURCE, "name") == n  # the launchers' macro
    spmm = open(csrc + "sell_spmm.cu").read()
    fn = "sell_bench_spmm_variant_launch"
    assert len(BV._KCOL_SIGNATURES[fn][1]) == _c_params(KCOL_SOURCE, fn)
    assert _c_params(KCOL_SOURCE, fn) == _c_params(
        spmm, "sell_bench_spmm_launch")
    for kept in ("sell_bench_spmm_launch", "sell_bench_spmm_blocks"):
        assert len(S._SPMM_SIGNATURES[kept][1]) == _c_params(spmm, kept)


@pytest.mark.parametrize("flag", ["--solver", "--kbench"])
def test_solver_and_kbench_refuse_without_a_card(flag, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would time the variants")
    assert BV.main([flag]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
