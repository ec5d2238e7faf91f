"""Synthetic sparse-matrix generators (benchmark and test inputs).

Copies of the JAX package's banded, uniform and power-law generators: the
same numpy ``RandomState`` streams, so the same seed gives the same matrix
bit for bit. BASELINE.json's "synthetic 10M-nnz matrix" is
``parse_synth_spec("synth:1000000:10000000")``; the ``synth:N:NNZ``
grammar is banded only, as in the JAX package.

Two SPD stencils for the solvers, as host scipy CSR matrices (float64):
the 2-D Poisson 5-point Laplacian and the HPCG benchmark's 27-point
stencil.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

__all__ = ["synth_banded", "synth_uniform", "synth_powerlaw",
           "parse_synth_spec", "poisson2d", "hpcg_stencil"]


def synth_banded(
    n: int, nnz_per_row: int = 9, bandwidth: int = 64, seed: int = 0,
    dtype=None, device=None,
) -> COOMatrix:
    """Banded SPD-ish pattern: entries within ±bandwidth of the diagonal."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    offs = rng.randint(-bandwidth, bandwidth + 1, size=len(rows))
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.randn(len(rows))
    return _dedup(rows, cols, vals, (n, n), dtype, device)


def synth_uniform(
    nrows: int, ncols: int, nnz: int, seed: int = 0, dtype=None,
    device=None,
) -> COOMatrix:
    """Uniformly scattered pattern (worst-case locality)."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, nrows, size=nnz).astype(np.int64)
    cols = rng.randint(0, ncols, size=nnz).astype(np.int64)
    vals = rng.randn(nnz)
    return _dedup(rows, cols, vals, (nrows, ncols), dtype, device)


def synth_powerlaw(
    n: int, nnz: int, alpha: float = 1.5, seed: int = 0, dtype=None,
    device=None,
) -> COOMatrix:
    """Power-law column popularity (hub columns, as in circuit and web
    graphs): column j is drawn with probability ∝ (j + 1)^-alpha."""
    rng = np.random.RandomState(seed)
    popularity = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    popularity /= popularity.sum()
    rows = rng.randint(0, n, size=nnz).astype(np.int64)
    cols = rng.choice(n, size=nnz, p=popularity).astype(np.int64)
    vals = rng.randn(nnz)
    return _dedup(rows, cols, vals, (n, n), dtype, device)


def _dedup(rows, cols, vals, shape: Tuple[int, int], dtype,
           device) -> COOMatrix:
    """Drop duplicate (row, col) pairs (keep first) and sort row-major."""
    key = rows * shape[1] + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    keep = np.ones(len(key_s), dtype=bool)
    keep[1:] = key_s[1:] != key_s[:-1]
    sel = order[keep]
    return COOMatrix.from_numpy(
        rows[sel].astype(np.int32),
        cols[sel].astype(np.int32),
        vals[sel],
        shape=shape,
        dtype=dtype,
        device=device,
    )


def parse_synth_spec(spec: str, *, dtype=None, device=None) -> COOMatrix:
    """Parse ``synth:N:NNZ`` into a banded COO matrix.

    Raises ValueError with a user-readable message on a malformed spec.
    """
    parts = spec.split(":")
    if len(parts) != 3 or parts[0] != "synth":
        raise ValueError(f"bad synth spec (want synth:N:NNZ): {spec!r}")
    try:
        n, nnz = int(parts[1]), int(parts[2])
    except ValueError:
        raise ValueError(
            f"bad synth spec (want synth:N:NNZ): {spec!r}"
        ) from None
    if n < 1 or nnz < 0:
        raise ValueError(f"bad synth spec (non-positive sizes): {spec!r}")
    return synth_banded(n, nnz_per_row=max(nnz // n, 1), dtype=dtype,
                        device=device)


def poisson2d(nx: int):
    """The 2-D Dirichlet Poisson matrix on an nx² grid (4 on the
    diagonal, -1 for each of the 4 neighbours) as a scipy CSR."""
    import scipy.sparse as sp

    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx))
    return (sp.kron(sp.eye(nx), t) + sp.kron(t, sp.eye(nx))).tocsr()


def hpcg_stencil(nx: int):
    """The HPCG benchmark's matrix on an nx³ grid (its
    ``GenerateProblem_ref.cpp``): 26 on the diagonal, -1 for each of the up
    to 26 neighbours in the 3×3×3 box, as a scipy CSR. At hpcg.dat's
    default 104³: 1,124,864 rows and (3·104 − 2)³ = 29,791,000 nnz."""
    import scipy.sparse as sp

    b1 = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (nx, nx))
    return (27.0 * sp.eye(nx ** 3) - sp.kron(b1, sp.kron(b1, b1))).tocsr()


def peierls_phase(a, seed: int = 0):
    """A real symmetric scipy matrix made Hermitian by a Peierls phase:
    each off-diagonal pair (i, j), i < j, is multiplied by e^{iφ} and
    (j, i) by e^{−iφ}, φ uniform in [−π, π) from ``seed``, the diagonal
    kept. Where the off-diagonal entries are ≤ 0 (Poisson, HPCG), the
    diamagnetic inequality keeps the smallest eigenvalue at or above the
    real matrix's, so an SPD stencil stays Hermitian positive definite.
    Returns a complex128 scipy CSR."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    up = sp.triu(a, k=1).tocoo()
    phi = np.random.default_rng(seed).uniform(-np.pi, np.pi, up.nnz)
    u = sp.csr_matrix((up.data * np.exp(1j * phi), (up.row, up.col)),
                      shape=a.shape)
    return (sp.diags(a.diagonal().astype(np.complex128)) + u
            + u.conj().T).tocsr()
