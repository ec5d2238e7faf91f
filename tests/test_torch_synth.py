"""Synthetic generators: bit-identical to the JAX package's.

The same ``RandomState`` streams and the same dedup, so the same seed gives
the same triplets, in the same order, bit for bit. Also the ``synth:N:NNZ``
grammar, which stays banded as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smvp_toolkit_tpu.utils import synth as jsynth
from smvp_toolkit_tpu_torch.utils import synth as tsynth


def _same(t, j):
    tr, tc, tv = t.to_numpy()
    jr, jc, jv = j.to_numpy()
    assert t.shape == j.shape and t.nnz == j.nnz
    assert tr.tobytes() == np.asarray(jr).tobytes()
    assert tc.tobytes() == np.asarray(jc).tobytes()
    assert tv.dtype == np.float32
    assert tv.tobytes() == np.asarray(jv, np.float32).tobytes()


@pytest.mark.parametrize("args", [(300, 500, 4000, 0), (1000, 64, 9000, 3)])
def test_synth_uniform_bit_identical(args):
    nrows, ncols, nnz, seed = args
    _same(tsynth.synth_uniform(nrows, ncols, nnz, seed=seed, device="cpu"),
          jsynth.synth_uniform(nrows, ncols, nnz, seed=seed))


@pytest.mark.parametrize("args", [(2000, 20000, 1.5, 0), (700, 5000, 1.2, 4)])
def test_synth_powerlaw_bit_identical(args):
    n, nnz, alpha, seed = args
    _same(tsynth.synth_powerlaw(n, nnz, alpha=alpha, seed=seed,
                                device="cpu"),
          jsynth.synth_powerlaw(n, nnz, alpha=alpha, seed=seed))


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_banded_bit_identical(seed):
    _same(tsynth.synth_banded(3000, nnz_per_row=6, seed=seed, device="cpu"),
          jsynth.synth_banded(3000, nnz_per_row=6, seed=seed))


def test_synth_spec_stays_banded():
    _same(tsynth.parse_synth_spec("synth:4096:40960", device="cpu"),
          jsynth.parse_synth_spec("synth:4096:40960"))


def test_powerlaw_has_hub_columns():
    coo = tsynth.synth_powerlaw(5000, 50000, seed=1, device="cpu",
                                dtype=torch.bfloat16)
    assert coo.dtype == torch.bfloat16
    counts = np.bincount(coo.to_numpy()[1], minlength=5000)
    assert counts[0] > 100 * max(np.median(counts), 1)
