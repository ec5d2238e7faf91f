"""The HPCG benchmark's matrix (``GenerateProblem_ref.cpp``).

A 27-point stencil on an nx × ny × nz grid: 26 on the diagonal and −1 for
each of the up to 26 neighbours in the 3×3×3 box. Row and column of grid
point (ix, iy, iz) are ix + nx·iy + nx·ny·iz, as HPCG numbers them. The
triplets come out sorted by row, then column. The matrix does not depend
on the seed.
"""

from __future__ import annotations

import torch


def generate(cfg: dict, seed: int, device):
    nx, ny, nz = (int(cfg[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    rows, cols = [], []
    # Offsets in increasing linear order, so each row's columns ascend.
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                      & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
                rows.append(torch.where(ok, idx, -1))
                cols.append(idx + dx + nx * dy + nx * ny * dz)
    r = torch.stack(rows, dim=1).reshape(-1)
    c = torch.stack(cols, dim=1).reshape(-1)
    keep = r >= 0
    r, c = r[keep], c[keep]
    v = torch.where(r == c, float(cfg["diagonal"]),
                    float(cfg["off_diagonal"])).to(torch.float32)
    return r.to(torch.int32), c.to(torch.int32), v, (n, n)
