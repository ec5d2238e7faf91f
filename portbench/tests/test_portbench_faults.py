"""The run, with the timed path broken underneath, comes out not correct.

Each fault a cell can have, planted where the port produces its answer:
the state returned unchanged (the output never written), half of the
answer left out, and one entry of the answer altered. (One chip: there is
no exchange between chips to leave out.) The harness's look for a chip
is skipped: these runs are on the CPU, on a resized copy."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import run_cell


def unchanged(out):
    return torch.zeros_like(out)


def half(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def altered(out):
    out = out.clone()
    out[out.shape[0] // 3] += 0.01 * out.abs().max()
    return out


FAULTS = [unchanged, half, altered]


def _break_spmv(monkeypatch, fault):
    from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV

    real = SellSpMV.__call__
    monkeypatch.setattr(SellSpMV, "__call__",
                        lambda self, x: fault(real(self, x)))


def _break_solver(monkeypatch, module, name, fault):
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: fault(real(*a, **k)))


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_spmv_fault_is_not_correct(tiny, monkeypatch, fault):
    _break_spmv(monkeypatch, fault)
    r = run_cell(tiny, "kron20.spmv", 17, 0.2, False, "cpu")
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_cg_fault_is_not_correct(tiny, monkeypatch, fault):
    from smvp_toolkit_tpu_torch.ops import cg_fused

    _break_solver(monkeypatch, cg_fused, "fused_cg", fault)
    r = run_cell(tiny, "hpcg104.cg-fused", 17, 0.2, False, "cpu")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_pcg_fault_is_not_correct(tiny, monkeypatch, fault):
    from smvp_toolkit_tpu_torch.ops import pcg_fused

    _break_solver(monkeypatch, pcg_fused, "fused_pcg_ic0", fault)
    r = run_cell(tiny, "hpcg104.pcg-ic0-fused", 17, 0.2, False, "cpu")
    assert not r["correct"], r["checks"]


def _spy(monkeypatch, module, name):
    calls = []
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("fraction, cg_steps, pcg_steps",
                         [("0.5", 150, 50), ("0.8", 240, 80)])
def test_control_cuts_the_solves_short(monkeypatch, fraction, cg_steps,
                                       pcg_steps):
    from portbench import control
    from smvp_toolkit_tpu_torch.ops import cg_fused, pcg_fused

    cg = _spy(monkeypatch, cg_fused, "fused_cg")
    pcg = _spy(monkeypatch, pcg_fused, "fused_pcg_ic0")
    control.steps(fraction)
    cg_fused.fused_cg("op", "b", 300)
    pcg_fused.fused_pcg_ic0("op", "f", "b", 100, sweeps=4)
    assert cg == [(("op", "b", cg_steps), {})]
    assert pcg == [(("op", "f", "b", pcg_steps), {"sweeps": 4})]


def test_control_sets_the_sweeps(monkeypatch):
    from portbench import control
    from smvp_toolkit_tpu_torch.ops import pcg_fused

    pcg = _spy(monkeypatch, pcg_fused, "fused_pcg_ic0")
    control.sweeps("2")
    pcg_fused.fused_pcg_ic0("op", "f", "b", 100, sweeps=4)
    assert pcg == [(("op", "f", "b", 100), {"sweeps": 2})]


@pytest.mark.parametrize("cell, fault", [
    ("hpcg104.cg-fused", "steps:0.5"),
    ("hpcg104.pcg-ic0-fused", "steps:0.5"),
    ("hpcg104.pcg-ic0-fused", "sweeps:2"),
    ("hpcg104.pcg-ic0-fused", "diagonal_factor")])
def test_control_fault_runs_through_the_port(tiny, monkeypatch, cell, fault):
    from portbench import control
    from smvp_toolkit_tpu_torch.ops import cg_fused, ilu, pcg_fused

    for module, name in ((cg_fused, "fused_cg"), (pcg_fused, "fused_pcg_ic0"),
                         (ilu, "ic0")):
        monkeypatch.setattr(module, name, getattr(module, name))
    name, _, arg = fault.partition(":")
    control.FAULTS[name](arg or None)
    r = run_cell(tiny, cell, 17, 0.2, False, "cpu")
    assert r["attempted"] >= 1 and r["checks"]["relres"]["value"] < 1, r
