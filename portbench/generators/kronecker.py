"""The Graph500 Kronecker graph, as the GAP suite's ``kron`` builds it.

Edges: the Graph500 reference generator (``kronecker_generator.m``):
``edge_factor · 2^scale`` edges, each placed bit by bit into a quadrant of
the initiator (A, B, C, D), then the vertex ids permuted at random. The
graph is made undirected as GAP's builder does: each edge also reversed,
self loops and duplicates dropped. The values are 1/degree of the column:
the column-stochastic matrix of PageRank's SpMV step. Everything is drawn
from the seed on the given device, in a few large calls.
"""

from __future__ import annotations

import torch


def edges(cfg: dict, seed: int, device):
    """(u, v): the directed edges before any edge is dropped, int64."""
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c, _d = (float(p) for p in cfg["initiator"])
    n, m = 1 << scale, ef << scale
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=g, device=device) > ab
        jj = torch.rand(m, generator=g, device=device) > torch.where(
            ii, c_norm, a_norm)
        u += ii.long() << bit
        v += jj.long() << bit
    perm = torch.randperm(n, generator=g, device=device)
    return perm[u], perm[v]


def generate(cfg: dict, seed: int, device):
    n = 1 << int(cfg["scale"])
    u, v = edges(cfg, seed, device)
    keep = u != v
    u, v = u[keep], v[keep]
    keys = torch.unique(torch.cat([u * n + v, v * n + u]))  # sorted
    rows, cols = keys // n, keys % n
    deg = torch.bincount(rows, minlength=n)
    vals = (1.0 / deg[cols].double()).to(torch.float32)
    return rows.to(torch.int32), cols.to(torch.int32), vals, (n, n)
