"""Models on the port's sparse kernels: the GCN (``models.graph``) and
the SPD solvers with mixed-precision refinement (``models.solvers``)."""

from smvp_toolkit_tpu_torch.models.graph import (
    GCN,
    gcn_forward,
    gcn_init,
    gcn_layer,
    gcn_norm,
    gcn_train_step,
    gcn_train_step_edges,
)
from smvp_toolkit_tpu_torch.models.solvers import (
    chebyshev,
    conjugate_gradient,
    ic0_preconditioner,
    lanczos,
    lanczos_eigsh,
    pcg,
    pcg_precond,
    refine_solve,
)

__all__ = [
    "GCN",
    "gcn_norm",
    "gcn_layer",
    "gcn_init",
    "gcn_forward",
    "gcn_train_step",
    "gcn_train_step_edges",
    "conjugate_gradient",
    "lanczos",
    "lanczos_eigsh",
    "chebyshev",
    "pcg",
    "pcg_precond",
    "ic0_preconditioner",
    "refine_solve",
]
