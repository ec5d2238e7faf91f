"""Complex matrices and solves against the JAX package.

A complex ``.mtx`` is read in complex64, encoded and decoded bit for bit
(CSR and TJDS), and its CSR and TJDS SpMVs run the plain PyTorch kernels
(the SELL kernels are real-valued), as the JAX CLI runs its XLA ones: the
CLI reports (``re+imj`` cells) agree with the JAX CLI's cell for cell
within 1e-6 of max |y| plus one unit of the sixth digit they print, with
the same layout.

The five complex solves (CG, Jacobi-PCG, BiCGSTAB, GMRES, MINRES) on a
small Hermitian positive definite system: the 2-D Poisson stencil with a
Peierls phase e^{iφ} on each off-diagonal pair (``synth.peierls_phase``),
b from a numpy seed. The residual histories of the library functions
agree with the JAX functions' within 1e-5 of |b| at every step, and with
``tol`` the stopping steps are equal; through the CLI the iteration counts
and final residuals are the JAX CLI's. The JAX MINRES cannot run a complex
system (its scan carry changes dtype: a TypeError), so the port's complex64
MINRES is held to its own complex128 run instead (1e-5 of |b|), and the
CLI runs it. A control shows that ``torch.dot`` (no conjugation) in place
of ``torch.vdot`` fails the CG check.
"""

from __future__ import annotations

import glob
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvp_toolkit_tpu import cli as jcli
from smvp_toolkit_tpu import models as jm
from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jenc
from smvp_toolkit_tpu.io.mtx import read_mtx as jread
from smvp_toolkit_tpu.ops.algebra import diagonal as jdiagonal
from smvp_toolkit_tpu_torch import cli as tcli
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_decode, csr_encode
from smvp_toolkit_tpu_torch.formats.tjds import tjds_decode, tjds_encode
from smvp_toolkit_tpu_torch.io.mtx import read_mtx, write_mtx
from smvp_toolkit_tpu_torch.models import solvers as tm
from smvp_toolkit_tpu_torch.ops import spmv_torch
from smvp_toolkit_tpu_torch.ops.algebra import diagonal
from smvp_toolkit_tpu_torch.utils.synth import peierls_phase, poisson2d

TOL_HIST = 1e-5  # of |b|, per residual-history entry
TOL_Y = 1e-6     # of max |y|, the reports' cells
NX = 12
SPMV = spmv_torch.spmv_csr


@pytest.fixture(scope="module")
def hpd(tmp_path_factory):
    a = peierls_phase(poisson2d(NX), seed=0).tocoo()
    path = str(tmp_path_factory.mktemp("hpd") / "hpd.mtx")
    write_mtx(path, a.row, a.col, a.data, a.shape)
    r, c = a.row.astype(np.int32), a.col.astype(np.int32)
    v = a.data.astype(np.complex64)
    jcoo = JCOO.from_numpy(r, c, v, shape=a.shape, dtype=jnp.complex64,
                           pad_to=128)
    tcoo = COOMatrix.from_numpy(r, c, v, shape=a.shape,
                                dtype=torch.complex64, pad_to=128,
                                device="cpu")
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(
        np.float32).astype(np.complex64)
    return dict(path=path, a=a, jcoo=jcoo, tcoo=tcoo, jcsr=jenc(jcoo),
                tcsr=csr_encode(tcoo), b=b)


def test_hermitian_positive_definite(hpd):
    dense = hpd["a"].toarray()
    assert np.array_equal(dense, dense.conj().T)
    lam = np.linalg.eigvalsh(dense)[0]
    # the diamagnetic inequality: at or above the real stencil's
    assert lam >= np.linalg.eigvalsh(poisson2d(NX).toarray())[0] - 1e-12


def test_read_encode_decode_round_trip(hpd):
    coo = read_mtx(hpd["path"], device="cpu")
    assert coo.dtype == torch.complex64 and coo.typecode.is_complex
    j = jread(hpd["path"], dtype=None)
    r, c, v = coo.to_numpy()
    jr, jc, jv = j.to_numpy()
    assert np.array_equal(r, jr) and np.array_equal(c, jc)
    assert v.tobytes() == np.asarray(jv).tobytes()
    for dec in (csr_decode(csr_encode(coo.pad(128))),
                tjds_decode(tjds_encode(coo.pad(128)))):
        assert dec.dtype == torch.complex64
        got = dec.canonical_order().to_numpy()
        want = coo.canonical_order().to_numpy()
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(Exception, match="complex"):
        read_mtx(hpd["path"], dtype=torch.float32, device="cpu")


def _report(tmp, alg):
    (path,) = glob.glob(os.path.join(tmp, f"smvp-toolbox_report_{alg}_*.txt"))
    with open(path) as f:
        return f.read().splitlines()


def _cells(lines):
    i = lines.index("Output vector (one cell per line):")
    return np.array([complex(s) for s in lines[i + 2: lines.index("]", i)]])


@pytest.fixture(scope="module")
def cli_runs(hpd, tmp_path_factory):
    """-c -t and a solve through both CLIs on the written HPD file."""
    jd = str(tmp_path_factory.mktemp("jc"))
    td = str(tmp_path_factory.mktemp("tc"))
    args = ["-c", "-t", "-n", "2", "--x", "random:3"]
    assert jcli.main([*args, "-d", jd, hpd["path"]]) == 0
    assert tcli.main([*args, "--device", "cpu", "-d", td, hpd["path"]]) == 0
    return jd, td


@pytest.mark.parametrize("alg", ["CSR", "TJDS"])
def test_cli_report_matches_jax(cli_runs, alg):
    jd, td = cli_runs
    j, t = _report(jd, alg), _report(td, alg)
    yj, yt = _cells(j), _cells(t)
    assert yt.shape == (NX * NX,) and np.abs(yt.imag).max() > 0
    # one unit in the sixth significant digit of each printed part
    ulp = 1e-5 * (np.abs(yj.real) + np.abs(yj.imag))
    assert np.all(np.abs(yt - yj) <= TOL_Y * np.abs(yj).max() + ulp)
    assert "Kernel: torch" in t
    skip = ("Execution results", "Total Time", "Average Time",
            "Fastest Time", "Slowest Time", "Time StDev", "Device",
            "Kernel", "nnz/s", "Effective GB/s", "Roofline")
    # the header's Unix time differs where the two runs straddle a second
    stamp = re.compile(r"^Generated on \d+ \(Unix time\)$")

    def header(rep):
        end = rep.index("Output vector (one cell per line):")
        return [stamp.sub("Generated on T (Unix time)", s) for s in rep[:end]
                if not s.startswith(skip)]

    assert header(t) == header(j)
    assert sum(bool(stamp.match(s)) for s in t) == 1


def _run(method, hpd, tol):
    b = hpd["b"]
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    if method == "cg":
        return (jm.conjugate_gradient(hpd["jcsr"], jb, num_iters=40, tol=tol),
                tm.conjugate_gradient(hpd["tcsr"], tb, num_iters=40,
                                      spmv=SPMV, tol=tol))
    if method == "pcg":
        return (jm.pcg(hpd["jcsr"], jb, jdiagonal(hpd["jcoo"]), num_iters=40,
                       tol=tol),
                tm.pcg(hpd["tcsr"], tb, diagonal(hpd["tcoo"]), num_iters=40,
                       spmv=SPMV, tol=tol))
    if method == "bicgstab":
        return (jm.bicgstab(hpd["jcsr"], jb, num_iters=30, tol=tol),
                tm.bicgstab(hpd["tcsr"], tb, num_iters=30, spmv=SPMV,
                            tol=tol))
    return (jm.gmres(hpd["jcsr"], jb, restart=5, num_restarts=8, tol=tol),
            tm.gmres(hpd["tcsr"], tb, restart=5, num_restarts=8, spmv=SPMV,
                     tol=tol))


def _stop(res, target):
    hit = np.nonzero(np.asarray(res) <= target * (1 + 1e-6))[0]
    return int(hit[0]) + 1 if hit.size else None


@pytest.mark.parametrize("method", ["cg", "pcg", "bicgstab", "gmres"])
def test_complex_solver_matches_jax(hpd, method):
    bn = float(np.linalg.norm(hpd["b"]))
    (xj, rj), (xt, rt) = _run(method, hpd, None)
    assert xt.dtype == torch.complex64
    assert np.abs(rt.numpy() - np.asarray(rj)).max() <= TOL_HIST * bn
    assert rt.numpy()[-1] <= 1e-5 * bn
    for tol in (1e-2, 1e-4):
        (_, rj), (_, rt) = _run(method, hpd, tol)
        sj, st = _stop(rj, tol * bn), _stop(rt.numpy(), tol * bn)
        assert sj is not None and st == sj


def test_complex_minres(hpd):
    b = hpd["b"]
    bn = float(np.linalg.norm(b))
    with pytest.raises(TypeError):  # the JAX function's carry dtype
        jm.minres(hpd["jcsr"], jnp.asarray(b), num_iters=5)
    a = hpd["a"]
    wide = csr_encode(COOMatrix.from_numpy(
        a.row, a.col, a.data, shape=a.shape, dtype=torch.complex128,
        pad_to=128, device="cpu"))
    x, r = tm.minres(hpd["tcsr"], torch.from_numpy(b), num_iters=40,
                     spmv=SPMV)
    x2, r2 = tm.minres(wide, torch.from_numpy(b.astype(np.complex128)),
                       num_iters=40, spmv=SPMV)
    assert np.abs(r.numpy() - r2.numpy()).max() <= TOL_HIST * bn
    true = np.linalg.norm(b - a @ x.numpy().astype(np.complex128)) / bn
    assert true <= 1e-5


def test_dot_without_conjugation_fails_cg(hpd, monkeypatch):
    """The control: CG with ``torch.dot`` in place of ``torch.vdot``."""
    bn = float(np.linalg.norm(hpd["b"]))
    monkeypatch.setattr(torch, "vdot", torch.dot)
    _, rt = tm.conjugate_gradient(hpd["tcsr"], torch.from_numpy(hpd["b"]),
                                  num_iters=40, spmv=SPMV)
    monkeypatch.undo()
    (_, rj), _ = _run("cg", hpd, None)
    rt = rt.numpy()
    assert not (np.abs(rt - np.asarray(rj)).max() <= TOL_HIST * bn
                and np.isfinite(rt).all() and rt[-1] <= 1e-5 * bn)


@pytest.mark.parametrize("method", ["cg:40:1e-4", "pcg:40:1e-4",
                                    "bicgstab:30:1e-4", "gmres:40:1e-4"])
def test_cli_complex_solve_matches_jax(hpd, tmp_path, method):
    jj, tj = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    args = ["-c", "-n", "1", "--no-report", "--x", "random:0", "--solve",
            method]
    assert jcli.main([*args, "--json-out", jj, hpd["path"]]) == 0
    assert tcli.main([*args, "--device", "cpu", "--json-out", tj,
                      hpd["path"]]) == 0

    def solve(path):
        with open(path) as f:
            return [json.loads(s) for s in f if "SOLVE" in s][0]

    j, t = solve(jj), solve(tj)
    assert t["iterations"] == j["iterations"]
    assert t["relative_residual"] <= 1e-4
    assert abs(t["relative_residual"] - j["relative_residual"]) <= 1e-5


def test_cli_complex_minres_runs(hpd, tmp_path):
    tj = str(tmp_path / "t.jsonl")
    assert tcli.main(["-c", "-n", "1", "--no-report", "--device", "cpu",
                      "--x", "random:0", "--solve", "minres:40:1e-4",
                      "--json-out", tj, hpd["path"]]) == 0
    with open(tj) as f:
        rec = [json.loads(s) for s in f if "SOLVE" in s][0]
    assert rec["relative_residual"] <= 1e-4
