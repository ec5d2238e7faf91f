"""Autograd over the SELL operator: forward and backward on the kernels.

Counterpart of the ``jax.custom_vjp`` closures of the JAX package's
``SellSpMV`` (``differentiable``, ``differentiable_mat``,
``differentiable_edges``, ``differentiable_edges_mat``). SpMM is bilinear
in (values, X), so both cotangents are sparse products again:

* d/dX of Y = A·X is Aᵀ·G: the transpose operator's ``matmat`` (K1 or K4
  with k columns; the k = 1 kernels for a vector), with the live values
  scattered into the transpose's plane on the edge path;
* d/dv is K7's (S, 128) plane gathered at ``slot_map()``.

Each callable wraps a ``torch.autograd.Function`` whose forward calls the
operator's kernel. A cotangent may arrive in any layout (the gradient of
``.sum()`` is an expanded, stride-0 tensor): the operator copies it into a
contiguous, padded block before any launch. The vector callables are the
k-column ones on one column, which ``matmat`` runs as an SpMV.
"""

from __future__ import annotations

import torch

__all__ = [
    "differentiable",
    "differentiable_mat",
    "differentiable_edges",
    "differentiable_edges_mat",
]


class _Mat(torch.autograd.Function):
    """Y = A·X; X's cotangent Aᵀ·G."""

    @staticmethod
    def forward(ctx, X, op):
        ctx.op, ctx.rows, ctx.dtype = op, X.shape[0], X.dtype
        return op.matmat(X)

    @staticmethod
    def backward(ctx, G):
        gX = ctx.op.transpose().matmat(G)[: ctx.rows].to(ctx.dtype)
        return gX, None


class _EdgesMat(torch.autograd.Function):
    """Y = A(v)·X with v the nnz values in triplet order; both cotangents."""

    @staticmethod
    def forward(ctx, v, X, op):
        ctx.op = op
        ctx.save_for_backward(v, X)
        return op.matmat(X, vals=op.scatter_values(v))

    @staticmethod
    def backward(ctx, G):
        v, X = ctx.saved_tensors
        op = ctx.op
        gv = gX = None
        if ctx.needs_input_grad[0]:
            gv = op.vjp_vals_mat(X, G).reshape(-1)[op.slot_index()]
            gv = gv.to(v.dtype)
        if ctx.needs_input_grad[1]:
            op_t = op.transpose()
            gX = op_t.matmat(G, vals=op_t.scatter_values(v))
            gX = gX[: X.shape[0]].to(X.dtype)
        return gv, gX, None


def differentiable_mat(op):
    """``f(X) = A·X`` (X of shape (ncols, k)), differentiable in X."""
    op.transpose()  # plan Aᵀ now, not inside the first backward pass

    def f(X: torch.Tensor) -> torch.Tensor:
        return _Mat.apply(X, op)

    return f


def differentiable(op):
    """``f(x) = A·x`` (x of shape (ncols,)), differentiable in x."""
    f_mat = differentiable_mat(op)

    def f(x: torch.Tensor) -> torch.Tensor:
        return f_mat(x.reshape(-1, 1))[:, 0]

    return f


def differentiable_edges_mat(op):
    """``f(v, X) = A(v)·X``, differentiable in the nnz values ``v`` (in
    the operator's triplet order) and in X."""
    op.slot_index()
    op.transpose().slot_index()

    def f(v: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        return _EdgesMat.apply(v, X, op)

    return f


def differentiable_edges(op):
    """``f(v, x) = A(v)·x``, differentiable in ``v`` and in x."""
    f_mat = differentiable_edges_mat(op)

    def f(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return f_mat(v, x.reshape(-1, 1))[:, 0]

    return f
