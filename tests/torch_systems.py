"""Shared systems of the solver-family parity tests: one matrix in both
packages (JAX COO and CSR, the port's COO and CSR on the CPU) and the
comparison helpers.

The matrices are the JAX package's own test systems: the 2-D Poisson
matrix (tests/test_amg.py) and its upwind convection-diffusion variant
(tests/test_amg.py: 70% of the superdiagonal entries lowered by 0.35, a
nonsymmetric system).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from smvp_toolkit_tpu.formats.coo import COOMatrix as JCOO
from smvp_toolkit_tpu.formats.csr import csr_encode as jcsr_encode
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.interop import coo_from_triplets
from smvp_toolkit_tpu_torch.utils.synth import poisson2d

# x after a fixed count: within 1e-4 of max |x|, the JAX package's
# tolerance for its fused solvers against their scan loops (float32
# recurrences whose SpMVs and dot products sum in other orders).
TOL_X = 1e-4


def convection(nx: int = 16, seed: int = 9) -> sp.coo_matrix:
    """The JAX AMG test's upwind convection-diffusion matrix."""
    a = poisson2d(nx).toarray()
    rng = np.random.RandomState(seed)
    for kk in range(a.shape[0] - 1):
        if rng.rand() < 0.7 and a[kk, kk + 1] != 0:
            a[kk, kk + 1] -= 0.35
    return sp.coo_matrix(a)


def pair(a):
    """(JAX COO, JAX CSR, port COO, port CSR) of one scipy matrix."""
    a = sp.coo_matrix(a)
    r, c, v = a.row.astype(np.int32), a.col.astype(np.int32), a.data
    jcoo = JCOO.from_numpy(r, c, v, shape=a.shape, pad_to=128)
    tcoo = coo_from_triplets(r, c, v, a.shape, device="cpu").pad(128)
    return jcoo, jcsr_encode(jcoo), tcoo, csr_encode(tcoo)


def rel(got, want) -> float:
    """max |got − want| / max |want|, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def stop_step(res, b, tol) -> int:
    """The step at which a history first reaches ``tol·|b|`` (1-based),
    or its length (the JAX CLI's count recovery)."""
    rn = np.asarray(res, np.float64)
    tgt = tol * max(float(np.linalg.norm(np.asarray(b))), 1e-30)
    hit = np.nonzero(rn <= tgt * (1.0 + 1e-6))[0]
    return int(hit[0]) + 1 if hit.size else rn.shape[0]


def same_bits(t, j) -> bool:
    t, j = np.asarray(t), np.asarray(j)
    return t.dtype == j.dtype and t.shape == j.shape and \
        t.tobytes() == j.tobytes()
