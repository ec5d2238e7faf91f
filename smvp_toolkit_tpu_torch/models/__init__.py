"""Models on the port's sparse kernels: the GCN (``models.graph``)."""

from smvp_toolkit_tpu_torch.models.graph import (
    GCN,
    gcn_forward,
    gcn_init,
    gcn_layer,
    gcn_norm,
    gcn_train_step,
    gcn_train_step_edges,
)

__all__ = [
    "GCN",
    "gcn_norm",
    "gcn_layer",
    "gcn_init",
    "gcn_forward",
    "gcn_train_step",
    "gcn_train_step_edges",
]
