"""The HPCG and Kronecker generators."""

from __future__ import annotations

import torch

from conftest import ROOT
from portbench.harness import Benchmark

B = Benchmark(ROOT)
HPCG = B.generator("hpcg")
KRON = B.generator("kronecker")


def _dense(rows, cols, vals, shape):
    a = torch.zeros(shape, dtype=torch.float64)
    a[rows.long(), cols.long()] = vals.double()
    return a


def test_hpcg_nx4():
    cfg = dict(B.config("hpcg104"), nx=4, ny=4, nz=4)
    r, c, v, shape = HPCG.generate(cfg, 0, "cpu")
    assert shape == (64, 64)
    assert r.numel() == (3 * 4 - 2) ** 3 == 1000
    key = r.long() * 64 + c.long()
    assert bool((key[1:] > key[:-1]).all())  # sorted, no duplicates
    a = _dense(r, c, v, shape)
    assert torch.equal(a, a.T)
    assert bool((a.diagonal() == 26).all())
    assert set(v.tolist()) == {26.0, -1.0}
    # an interior point has all 26 neighbours: its row sums to 0
    inner = 1 + 4 * 1 + 16 * 1
    assert a[inner].sum() == 0 and (a[inner] != 0).sum() == 27
    assert (a[0] != 0).sum() == 8  # a corner: 7 neighbours
    assert bool((torch.linalg.eigvalsh(a) > 0).all())
    assert torch.equal(r, HPCG.generate(cfg, 99, "cpu")[0])  # unseeded


def test_hpcg_counts_on_a_box():
    # (3·nx − 2)(3·ny − 2)(3·nz − 2) nonzeros, as at 104³: 310³ = 29,791,000
    cfg = dict(B.config("hpcg104"), nx=5, ny=4, nz=3)
    r, _c, _v, shape = HPCG.generate(cfg, 0, "cpu")
    assert shape == (60, 60) and r.numel() == 13 * 10 * 7
    cfg = B.config("hpcg104")
    assert cfg["rows"] == 104 ** 3 and cfg["nnz"] == (3 * 104 - 2) ** 3


def test_kronecker_edges_and_graph():
    cfg = dict(B.config("kron20"), scale=9)
    u, v = KRON.edges(cfg, 2**31 + 11, "cpu")
    assert u.numel() == v.numel() == 16 * 2 ** 9
    assert int(u.max()) < 2 ** 9 and int(v.min()) >= 0
    r, c, val, shape = KRON.generate(cfg, 2**31 + 11, "cpu")
    r2, c2, val2, _ = KRON.generate(cfg, 2**31 + 11, "cpu")
    assert torch.equal(r, r2) and torch.equal(c, c2) and torch.equal(val, val2)
    r3, c3, _, _ = KRON.generate(cfg, 12, "cpu")
    assert r3.numel() != r.numel() or not torch.equal(c3, c)
    assert shape == (512, 512)
    assert not bool((r == c).any())  # no self loops
    key = r.long() * 512 + c.long()
    assert bool((key[1:] > key[:-1]).all())  # sorted, no duplicates
    a = _dense(r, c, torch.ones_like(val), shape)
    assert torch.equal(a, a.T)  # undirected
    col = _dense(r, c, val, shape).sum(dim=0)
    live = a.sum(dim=0) > 0
    assert torch.allclose(col[live], torch.ones_like(col[live]), atol=1e-6)
    assert r.numel() <= 2 * u.numel()
