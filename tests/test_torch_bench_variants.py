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
