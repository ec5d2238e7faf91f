"""y = A·x in float64 from the generator's triplets, and the comparisons.

The SpMV is a gather, a multiply and an ``index_add_`` over blocks of
nonzeros, in float64 on the given device.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 23  # nonzeros per block of the SpMV


class Csr64:
    """A in float64 on ``device``, from (rows, cols, vals, shape)."""

    def __init__(self, rows, cols, vals, shape, device):
        self.shape = (int(shape[0]), int(shape[1]))
        self.device = torch.device(device)
        self.rows = rows.to(self.device, torch.int64)
        self.cols = cols.to(self.device, torch.int64)
        self.vals = vals.to(self.device, torch.float64)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, torch.float64).reshape(-1)
        if x.shape[0] != self.shape[1]:
            raise ValueError(f"x has {x.shape[0]} entries, A {self.shape[1]} "
                             "columns")
        y = torch.zeros(self.shape[0], dtype=torch.float64, device=self.device)
        for a in range(0, self.rows.shape[0], BLOCK):
            b = a + BLOCK
            y.index_add_(0, self.rows[a:b], self.vals[a:b] * x[self.cols[a:b]])
        return y


def max_rel_err(y: torch.Tensor, y_ref: torch.Tensor) -> float:
    """max |y − y_ref| over max |y_ref|; a y of another length, or with a
    NaN, reads infinite."""
    y = y.reshape(-1).to(y_ref.device, torch.float64)
    if y.shape != y_ref.shape:
        return float("inf")
    gap = float((y - y_ref).abs().max())
    if gap != gap:
        return float("inf")
    return gap / max(float(y_ref.abs().max()), 1e-300)


def rel_residual(a: Csr64, x: torch.Tensor, b: torch.Tensor) -> float:
    """‖b − A·x‖₂ / ‖b‖₂ in float64; a wrong length or a NaN reads
    infinite."""
    x = x.reshape(-1)
    if x.shape[0] != a.shape[1]:
        return float("inf")
    b64 = b.to(a.device, torch.float64).reshape(-1)
    res = float(torch.linalg.vector_norm(b64 - a.matvec(x)))
    if res != res:
        return float("inf")
    return res / max(float(torch.linalg.vector_norm(b64)), 1e-300)
