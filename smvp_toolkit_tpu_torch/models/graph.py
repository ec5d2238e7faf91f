"""Graph convolution (GCN) on the port's sparse kernels.

Counterpart of the JAX package's ``models/graph.py``: the GCN of Kipf &
Welling, each layer ``act(S·(H·W) + b)`` with S the symmetrically
normalised adjacency. The dense H·W is a ``torch.matmul``; the
aggregation S·(HW) runs, by default, on the cached SELL operator of S
(``SellSpMV.differentiable_mat``): the k-column kernels forward, Aᵀ·G
through the transpose operator backward. On CPU tensors those are the
kernels' plain versions. The ``spmm=`` seam takes any ``(s, z) -> S·z``
instead, e.g. ``ops.spmv_torch.spmm_csr`` (the oracle).

``gcn_train_step_edges`` trains the edge weights as well; its default
aggregator is ``differentiable_edges_mat`` of the same operator, so the
values gradient runs on K7.

The parameters live in a :class:`GCN` module. The JAX package's steps
return new parameter pytrees; these steps update the module's tensors in
place (plain SGD) and return it, which keeps one copy of the weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix, csr_encode
from smvp_toolkit_tpu_torch.ops.spmv_sell import sell_op_csr
from smvp_toolkit_tpu_torch.utils.device import resolve_device

__all__ = [
    "GCN",
    "gcn_norm",
    "gcn_layer",
    "gcn_init",
    "gcn_forward",
    "gcn_train_step",
    "gcn_train_step_edges",
]

Spmm = Callable[[CSRMatrix, torch.Tensor], torch.Tensor]


class GCN(torch.nn.Module):
    """The (W, b) pairs of a GCN as parameters: ``weights[i]`` is (d_in,
    d_out), ``biases[i]`` (d_out,)."""

    def __init__(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.weights = torch.nn.ParameterList(
            [torch.nn.Parameter(w) for w, _ in pairs])
        self.biases = torch.nn.ParameterList(
            [torch.nn.Parameter(b) for _, b in pairs])

    def layers(self):
        return list(zip(self.weights, self.biases))

    def forward(self, s: CSRMatrix, h: torch.Tensor, *,
                spmm: Optional[Spmm] = None) -> torch.Tensor:
        return gcn_forward(s, self, h, spmm=spmm)


def gcn_norm(coo: COOMatrix, *, add_self_loops: bool = True) -> CSRMatrix:
    """Symmetrically normalised adjacency D^-1/2 (A + I) D^-1/2 as CSR.

    Host numpy with float64 degrees, as the JAX package computes it, so
    every array of the result equals the JAX one. Edge weights are
    rectified (``abs``) first: the degrees under the square root must be
    non-negative.
    """
    if coo.shape[0] != coo.shape[1]:
        raise ValueError("gcn_norm needs a square adjacency")
    n = coo.shape[0]
    r, c, v = coo.to_numpy()
    v = np.abs(np.asarray(v, dtype=np.float64))
    if add_self_loops:
        r = np.concatenate([r, np.arange(n, dtype=r.dtype)])
        c = np.concatenate([c, np.arange(n, dtype=c.dtype)])
        v = np.concatenate([v, np.ones(n)])
    deg = np.zeros(n)
    np.add.at(deg, r, v)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    vn = dinv[r] * v * dinv[c]
    return csr_encode(COOMatrix.from_numpy(
        r.astype(np.int32), c.astype(np.int32), vn, shape=coo.shape,
        pad_to=128, device=coo.device,
    ))


def _sell_spmm(s: CSRMatrix, z: torch.Tensor) -> torch.Tensor:
    """S·z on the cached SELL operator of ``s``, differentiable in z."""
    return sell_op_csr(s).differentiable_mat()(z)


def gcn_layer(s: CSRMatrix, h: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None,
              act: Callable[[torch.Tensor], torch.Tensor] = torch.relu, *,
              spmm: Optional[Spmm] = None) -> torch.Tensor:
    """One GCN layer: act(S · (H W) + b), transform before aggregate so
    the SpMM runs at the (usually narrower) output width."""
    out = (spmm or _sell_spmm)(s, h @ w)
    if b is not None:
        out = out + b
    return act(out)


def gcn_init(generator: torch.Generator, dims: Sequence[int], *,
             device=None) -> GCN:
    """Glorot-normal weights and zero biases for ``len(dims) - 1`` layers,
    drawn from ``generator`` (a CPU ``torch.Generator``) and moved to
    ``device``. The numbers differ from ``jax.random``'s for the same seed;
    ``interop.gcn_params_from_arrays`` carries given weights across."""
    dev = resolve_device(device)
    pairs = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn(din, dout, generator=generator) * math.sqrt(
            2.0 / (din + dout))
        pairs.append((w.to(dev), torch.zeros(dout, device=dev)))
    return GCN(pairs)


def gcn_forward(s: CSRMatrix, model: GCN, h: torch.Tensor, *,
                spmm: Optional[Spmm] = None) -> torch.Tensor:
    """Multi-layer GCN; the last layer is linear (logits)."""
    layers = model.layers()
    for i, (w, b) in enumerate(layers):
        last = i == len(layers) - 1
        h = gcn_layer(s, h, w, b, act=(lambda z: z) if last else torch.relu,
                      spmm=spmm)
    return h


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the nodes where ``mask`` is set."""
    logp = torch.log_softmax(logits, dim=1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    m = mask.to(logp.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _sgd(model: GCN, lr: float) -> None:
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * p.grad


def gcn_train_step(s: CSRMatrix, model: GCN, h: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   lr: float = 1e-2, *, spmm: Optional[Spmm] = None):
    """One SGD step on the masked softmax cross-entropy; updates ``model``
    in place and returns ``(model, loss)``."""
    model.zero_grad(set_to_none=True)
    loss = _masked_nll(gcn_forward(s, model, h, spmm=spmm), labels, mask)
    loss.backward()
    _sgd(model, lr)
    return model, loss.detach()


def gcn_train_step_edges(s: CSRMatrix, model: GCN, edge_vals: torch.Tensor,
                         h: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, lr: float = 1e-2,
                         edge_lr: Optional[float] = None, *,
                         spmm: Optional[Spmm] = None):
    """One SGD step on the layer weights AND the edge weights.

    ``edge_vals`` holds the aggregation's values in ``s.vals`` layout (CSR
    entry order, padded; pass ``s.vals`` to start). ``spmm`` receives the
    live-valued matrix ``dataclasses.replace(s, vals=...)``; by default it
    is ``differentiable_edges_mat`` of ``s``'s cached SELL operator fed
    with the first ``s.nnz`` values. Entries past ``s.nnz`` aggregate into
    no row, so their gradient is 0 and they stay put.

    Returns ``(model, edge_vals, loss)``; ``model`` is updated in place.
    """
    edge_lr = lr if edge_lr is None else edge_lr
    if spmm is None:
        f = sell_op_csr(s).differentiable_edges_mat()

        def spmm(m, z):
            return f(m.vals[: m.nnz], z)

    ev = edge_vals.detach().requires_grad_(True)
    live = dataclasses.replace(s, vals=ev)
    model.zero_grad(set_to_none=True)
    loss = _masked_nll(gcn_forward(live, model, h, spmm=spmm), labels, mask)
    loss.backward()
    _sgd(model, lr)
    ge = ev.grad if ev.grad is not None else torch.zeros_like(ev)
    return model, (edge_vals - edge_lr * ge).detach(), loss.detach()
