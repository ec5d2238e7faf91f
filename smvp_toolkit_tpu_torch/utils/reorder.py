"""Matrix reordering: the RCM permutation and the symmetric permute.

Counterpart of the JAX package's ``utils/reorder.py`` on the port's
``COOMatrix``. Host-side, encode-time tools (like SELL planning):
reordering changes the sparsity pattern. Reverse Cuthill-McKee (scipy's,
as in JAX) shrinks bandwidth, which helps ILU/IC fill and locality; the
JAX package measured it as no throughput gain for the SELL kernels
(its round-2 notes), so these helpers serve numerics and analysis.
"""

from __future__ import annotations

import numpy as np

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

__all__ = ["rcm_permutation", "permute_symmetric", "bandwidth"]


def bandwidth(coo: COOMatrix) -> int:
    """max |i − j| over stored entries (0 for an empty matrix)."""
    r, c, _ = coo.to_numpy()
    if r.size == 0:
        return 0
    return int(np.abs(r.astype(np.int64) - c.astype(np.int64)).max())


def rcm_permutation(coo: COOMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a square matrix's graph.

    Returns ``perm`` such that row/col ``perm[k]`` of A becomes row/col
    ``k`` of the reordered matrix (scipy's convention). The graph is
    symmetrized first (RCM is defined on undirected graphs).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n, m = coo.shape
    if n != m:
        raise ValueError(f"rcm needs a square matrix, got {coo.shape}")
    r, c, _ = coo.to_numpy()
    s = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n),
                      dtype=np.float64)
    return np.asarray(reverse_cuthill_mckee(s + s.T, symmetric_mode=True),
                      np.int64)


def permute_symmetric(coo: COOMatrix, perm: np.ndarray) -> COOMatrix:
    """P·A·Pᵀ: one permutation applied to rows and columns.

    ``perm`` follows :func:`rcm_permutation`'s convention (the old index
    of the entry that lands at each new position). Values keep their bits,
    dtype and device; symmetric, skew and Hermitian storage is expanded
    first and returned as general (a permutation does not keep an entry in
    its triangle).
    """
    n, m = coo.shape
    if n != m:
        raise ValueError(
            f"symmetric permute needs a square matrix, got {coo.shape}")
    perm = np.asarray(perm)
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError("perm must be a permutation of range(nrows)")
    from smvp_toolkit_tpu_torch.ops.algebra import _as_general

    g = _as_general(coo)
    r, c, v = g.to_numpy()
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return COOMatrix.from_numpy(
        inv[r].astype(r.dtype), inv[c].astype(c.dtype), v, shape=(n, n),
        dtype=g.dtype, pad_to=128, device=g.device)
