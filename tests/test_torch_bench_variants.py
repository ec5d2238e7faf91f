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
