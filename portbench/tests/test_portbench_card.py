"""On the card (marker ``cuda``; skipped without one): each cell, resized,
comes out correct through the kernels, and its control, the port's own
bfloat16 path, comes out not correct. Run there with

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import pytest
import torch

from conftest import make_copy
from portbench.harness import Benchmark, run_cell

pytestmark = pytest.mark.cuda

CELLS = ["kron20.spmv", "hpcg104.cg-fused", "hpcg104.pcg-ic0-fused"]
SIZES = {"hpcg104": {"nx": 48, "ny": 48, "nz": 48}, "kron20": {"scale": 14}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.fixture
def small(tmp_path):
    return Benchmark(make_copy(tmp_path / "small", SIZES))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_the_card(card, small, cell):
    r = run_cell(small, cell, 2**31 + 21, 1.0, False, card)
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct_on_the_card(card, small, cell):
    for seed in (1, 2, 3):
        r = run_cell(small, cell, seed, 1.0, False, card,
                     value_dtype=torch.bfloat16)
        assert not r["correct"], (seed, r["checks"])


def test_traced_run_reads_the_kernels(card, small):
    r = run_cell(small, "kron20.spmv", 5, 1.0, True, card)
    assert r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["spmv_roofline"]["value"] <= 100
    assert r["breakdown"]["device_ops"]
