"""The slice as a whole: every ``--solve`` method and ``--eigs`` through the
port's CLI, held to the JAX CLI on the same files.

Both CLIs run ``-c -n 1 --x random:1 --json-out`` on small ``.mtx`` files
(the JAX CLI on its XLA kernel, the default on the CPU; the port with
``--device cpu``, the SELL kernels' plain versions, and a few methods on
``--kernel torch`` as well): Poisson 20² stored as a symmetric lower
triangle (read with ``--expand-symmetry``) for all nineteen methods, and
the JAX AMG test's upwind convection matrix (nonsymmetric, 16²) for the
nonsymmetric ones. Each JSON record has the JAX record's fields. Where a
tolerance stops a solve, the counts differ by at most one step (GMRES:
one restart of 20); the relative residuals are within 10× of each other
or both at most 1e-5. BiCGSTAB, plain and with ILU(0), runs a fixed count
on the convection matrix: its residual there jumps by orders of magnitude
from step to step, and last-bit differences move its stop by several
steps (27 against 32 at 1e-4 with ILU(0); both packages' float64 stops
are held in ``tests/test_torch_krylov.py``). ``--eigs 4:60`` reaches the
analytic eigenvalues in both, AMG-preconditioned.

Refusals give the JAX CLI's exit codes: a non-square system and K above
the dimension (2), a stalled AMG hierarchy (``pcg-amg`` 2; ``--eigs``
declines the preconditioner and runs, 0), the ``--eigs`` spec checks (2),
and on a complex matrix the methods the JAX CLI refuses for complex
systems and ``--eigs`` (2; the port cannot read a complex matrix, so it
refuses them before its benchmark, where the JAX CLI refuses them after
its own).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

from smvp_toolkit_tpu import cli as jcli
from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch.io.mtx import write_mtx
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, poisson2d

from torch_systems import convection


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("solve")
    low = sp.tril(poisson2d(20)).tocoo()
    paths = {"spd": str(d / "spd.mtx"), "conv": str(d / "conv.mtx"),
             "rect": str(d / "rect.mtx"), "complex": str(d / "complex.mtx"),
             "stall": str(d / "hpcg17.mtx")}
    write_mtx(paths["spd"], low.row, low.col, low.data, (400, 400),
              symmetry="symmetric")
    c = convection()
    write_mtx(paths["conv"], c.row, c.col, c.data, c.shape)
    write_mtx(paths["rect"], np.array([0, 1, 2]), np.array([0, 2, 4]),
              np.array([1.0, 2.0, 3.0]), (3, 5))
    write_mtx(paths["complex"], np.array([0, 1]), np.array([0, 1]),
              np.array([1 + 2j, 3 - 1j]), (2, 2))
    h = sp.tril(hpcg_stencil(17)).tocoo()
    write_mtx(paths["stall"], h.row, h.col, h.data, h.shape,
              symmetry="symmetric")
    return d, paths


def _text(capsys) -> str:
    out = capsys.readouterr()
    return out.out + out.err


def _run(cli, tmp, tag, argv, path, device=True):
    out = os.path.join(tmp, f"{tag}.jsonl")
    if os.path.exists(out):
        os.remove(out)
    extra = ["--device", "cpu"] if device else []
    rc = cli.main(["-c", "-n", "1", "--no-report", "--x", "random:1",
                   "--json-out", out, *extra, *argv, path])
    recs = []
    if os.path.exists(out):
        with open(out) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
    return rc, [r for r in recs if r["alg"] not in ("CSR", "TJDS")]


def _both(files, argv, name, kernel=()):
    d, paths = files
    sym = ["--expand-symmetry"] if name in ("spd", "stall") else []
    t = _run(tcli, str(d), "port", [*sym, *kernel, *argv], paths[name])
    j = _run(jcli, str(d), "jax", [*sym, *argv], paths[name], device=False)
    return t, j


def _held(t, j, per=1, tol_given=True):
    (trc, trecs), (jrc, jrecs) = t, j
    assert trc == jrc == 0 and len(trecs) == len(jrecs) == 1
    tr, jr = trecs[0], jrecs[0]
    assert tr.keys() == jr.keys() and tr["alg"] == jr["alg"]
    if tol_given:
        assert abs(tr["iterations"] - jr["iterations"]) <= per
    else:
        assert tr["iterations"] == jr["iterations"]
    a, b = tr["relative_residual"], jr["relative_residual"]
    assert np.isfinite(a) and np.isfinite(b)
    assert max(a, b) <= 1e-5 or max(a, b) <= 10 * min(a, b)
    return tr, jr


SPD_SPECS = ["cg:300:1e-6", "cg-fused:100", "pcg:300:1e-6",
             "pcg-amg:60:1e-6", "pcg-cheb:60:1e-6", "pcg-neumann:150:1e-6",
             "pcg-ic0:100:1e-6", "pcg-ic0-fused:40", "pcg-ssor:100:1e-6",
             "pcg-bjac:200:1e-6", "bicgstab:200:1e-6", "bicgstab-ilu:100:1e-6",
             "bicgstab-amg:60:1e-6", "gmres:400:1e-6", "gmres-ilu:100:1e-6",
             "gmres-amg:60:1e-6", "minres:300:1e-6", "chebyshev:200",
             "chebyshev-fused:200"]


@pytest.mark.parametrize("spec", SPD_SPECS)
def test_every_method_on_poisson_matches_jax(files, spec):
    method = spec.split(":")[0]
    t, j = _both(files, ["--solve", spec], "spd")
    tr, jr = _held(t, j, per=20 if method.startswith("gmres") else 1,
                   tol_given=spec.count(":") == 2)
    assert tr["alg"] == f"SOLVE-{method.upper()}"
    assert tr["relative_residual"] <= 1e-4


def test_all_nineteen_methods_covered():
    assert sorted(s.split(":")[0] for s in SPD_SPECS) == sorted(
        tcli.SOLVE_METHODS) == sorted(jcli.SOLVE_METHODS)
    assert not hasattr(tcli, "PORTED_SOLVE_METHODS")


@pytest.mark.parametrize("spec,tol_given", [
    ("bicgstab:60", False), ("bicgstab-ilu:30", False),
    ("bicgstab-amg:40:1e-6", True), ("gmres:200:1e-6", True),
    ("gmres-ilu:100:1e-6", True), ("gmres-amg:60:1e-6", True)])
def test_nonsymmetric_methods_on_convection_match_jax(files, spec, tol_given):
    t, j = _both(files, ["--solve", spec], "conv")
    _held(t, j, per=20 if spec.startswith("gmres") else 1,
          tol_given=tol_given)


@pytest.mark.parametrize("spec,name", [
    ("pcg-amg:60:1e-6", "spd"), ("pcg-ssor:100:1e-6", "spd"),
    ("pcg-ic0:100:1e-6", "spd"), ("gmres-ilu:100:1e-6", "conv"),
    ("bicgstab-amg:40:1e-6", "conv")])
def test_plain_torch_kernel_matches_jax(files, spec, name):
    """``--kernel torch``: the factors and levels on the plain-PyTorch CSR
    SpMV (no SELL operator), as the JAX CLI runs them on XLA."""
    t, j = _both(files, ["--solve", spec], name,
                 kernel=("--kernel", "torch"))
    _held(t, j, per=20 if spec.startswith("gmres") else 1)


def _poisson_eigs(k):
    i = np.arange(1, 21)
    lam = (2 - 2 * np.cos(i * np.pi / 21))
    return np.sort(np.add.outer(lam, lam).ravel())[:k]


@pytest.mark.parametrize("kernel", [(), ("--kernel", "torch")])
def test_eigs_matches_jax(files, kernel):
    (trc, trecs), (jrc, jrecs) = _both(files, ["--eigs", "4:60"], "spd",
                                       kernel=kernel)
    assert trc == jrc == 0
    tr, jr = trecs[0], jrecs[0]
    assert tr.keys() == jr.keys() and tr["alg"] == "EIGS-LOBPCG"
    assert tr["preconditioner"] == jr["preconditioner"] == "amg"
    assert tr["k"] == 4 and tr["iterations"] == jr["iterations"] == 60
    lam = _poisson_eigs(4)
    for rec in (tr, jr):
        ev = np.asarray(rec["eigenvalues"])
        assert np.abs(ev - lam).max() <= 1e-4 * 8.0
        assert max(rec["residual_norms"]) <= 1e-3


def test_eigs_then_solve_in_one_run(files):
    """``--eigs`` runs before ``--solve``, as in the JAX CLI."""
    (trc, trecs), (jrc, jrecs) = _both(
        files, ["--eigs", "2:30", "--solve", "pcg-amg:60:1e-6"], "spd")
    assert trc == jrc == 0
    assert [r["alg"] for r in trecs] == [r["alg"] for r in jrecs] == [
        "EIGS-LOBPCG", "SOLVE-PCG-AMG"]


def test_stalled_amg_refused_and_declined_as_jax(files, capsys):
    t, j = _both(files, ["--solve", "pcg-amg:10"], "stall")
    assert t[0] == j[0] == 2
    assert "coarsening stalled" in _text(capsys)
    (trc, trecs), (jrc, jrecs) = _both(files, ["--eigs", "2:5"], "stall")
    assert trc == jrc == 0
    assert trecs[0]["preconditioner"] == jrecs[0]["preconditioner"] == "none"
    assert "AMG setup declined" in _text(capsys)


@pytest.mark.parametrize("argv", [["--solve", "gmres:10"],
                                  ["--solve", "pcg-amg"],
                                  ["--eigs", "2"]])
def test_non_square_refused_as_jax(files, argv, capsys):
    t, j = _both(files, argv, "rect")
    assert t[0] == j[0] == 2
    assert "square" in _text(capsys)


def test_eigs_k_above_dimension_refused_as_jax(files, capsys):
    t, j = _both(files, ["--eigs", "500"], "spd")
    assert t[0] == j[0] == 2
    assert "exceeds the matrix dimension 400" in _text(capsys)


@pytest.mark.parametrize("argv", [["--solve", "pcg-amg"],
                                  ["--solve", "chebyshev:10"],
                                  ["--solve", "bicgstab-ilu"],
                                  ["--solve", "cg-fused:5"],
                                  ["--eigs", "1"]])
def test_complex_refusals_match_jax(files, argv, capsys):
    t, j = _both(files, argv, "complex")
    assert t[0] == j[0] == 2
    out = _text(capsys)
    what = ("--eigs" if argv[0] == "--eigs"
            else f"--solve {argv[1].split(':')[0]}")
    assert out.count(what) >= 2  # both CLIs name the refused run


def test_nonconvergence_hint_matches_jax(files, capsys):
    """Chebyshev on the nonsymmetric matrix diverges: both CLIs log the
    same hint."""
    t, j = _both(files, ["--solve", "chebyshev:50"], "conv")
    assert t[0] == j[0] == 0
    hints = [ln.split("solve did not converge", 1)[1]
             for ln in _text(capsys).splitlines()
             if "solve did not converge" in ln]
    assert len(hints) == 2 and hints[0] == hints[1]
    assert "assumes an SPD system" in hints[0]


@pytest.mark.parametrize("argv", [["-c", "--eigs", "2:x"],
                                  ["-t", "--eigs", "2"],
                                  ["-c", "--eigs", "0"],
                                  ["-c", "--eigs", "2:3:4"]])
def test_eigs_validation_exit_2(files, argv):
    _, paths = files
    assert tcli.main([*argv, "--device", "cpu", "--no-report",
                      paths["spd"]]) == 2
    assert jcli.main([*argv, "--no-report", paths["spd"]]) == 2
