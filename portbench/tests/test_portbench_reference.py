"""The plain float64 reference, and the port judged by it on the CPU at a
tiny size: every cell of the benchmark comes out correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import run_cell
from portbench.reference.sparse64 import Csr64, max_rel_err, rel_residual


def test_csr64_against_dense():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, 5)) * (rng.random((7, 5)) < 0.5)
    r, c = np.nonzero(a)
    ref = Csr64(torch.from_numpy(r), torch.from_numpy(c),
                torch.from_numpy(a[r, c]), a.shape, "cpu")
    x = rng.standard_normal(5)
    assert np.allclose(ref.matvec(torch.from_numpy(x)).numpy(), a @ x,
                       rtol=0, atol=1e-14)
    with pytest.raises(ValueError):
        ref.matvec(torch.zeros(6))


def test_comparisons():
    y = torch.tensor([1.0, -4.0, 2.0], dtype=torch.float64)
    assert max_rel_err(y.float(), y) == 0
    assert max_rel_err(torch.tensor([1.0, -4.0, 2.5]), y) == 0.125
    assert max_rel_err(torch.tensor([1.0, float("nan"), 2.0]), y) == float(
        "inf")
    assert max_rel_err(torch.zeros(2), y) == float("inf")
    a = Csr64(torch.tensor([0, 1]), torch.tensor([0, 1]),
              torch.tensor([2.0, 4.0]), (2, 2), "cpu")
    b = torch.tensor([2.0, 4.0])
    assert rel_residual(a, torch.ones(2), b) == 0
    assert rel_residual(a, torch.zeros(2), b) == 1
    assert rel_residual(a, torch.ones(3), b) == float("inf")


@pytest.mark.parametrize("cell", ["kron20.spmv", "hpcg104.cg-fused",
                                  "hpcg104.pcg-ic0-fused"])
def test_port_is_correct_on_the_cpu(tiny, cell):
    r = run_cell(tiny, cell, 2**31 + 3, 0.2, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    for name, c in r["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
