"""Every example of the port (``examples/torch/*.py``) runs end to end on
the CPU: ``--device cpu`` (the kernels' plain versions), small sizes, and
``SMVP_DEMO_MTX`` pointing at a small ``.mtx`` written from
``utils/synth.py`` where the example reads a matrix. Each must exit 0 and
print something. They run in this process (``runpy``), not in a fresh
interpreter each, to keep the suite's time down.
"""

from __future__ import annotations

import contextlib
import glob
import io
import os
import runpy
import sys

import pytest
import torch

from smvp_toolkit_tpu_torch.io.mtx import write_mtx
from smvp_toolkit_tpu_torch.utils.synth import synth_banded

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEMOS = sorted(glob.glob(os.path.join(_REPO, "examples", "torch", "*.py")))
# Small sizes for the examples that build their own matrix.
_SMALL = {
    "edge_train_demo.py": ["--steps", "20", "--n", "300"],
    "eigs_demo.py": ["--nx", "16"],
    "precond_demo.py": ["--nx", "16"],
    "solve_demo.py": ["--n", "400"],
    "scaling_demo.py": ["--n", "800"],
}


def test_ten_examples():
    assert len(_DEMOS) == 10


@pytest.fixture(scope="module")
def demo_mtx(tmp_path_factory):
    coo = synth_banded(512, nnz_per_row=8, bandwidth=32, seed=0,
                       device="cpu")
    path = str(tmp_path_factory.mktemp("demo") / "demo.mtx")
    write_mtx(path, *coo.to_numpy(), coo.shape)
    return path


@pytest.fixture
def one_thread():
    """One intra-op thread while an example runs: its tensors are small,
    and the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("demo", _DEMOS, ids=[os.path.basename(d)
                                              for d in _DEMOS])
def test_example_runs(demo, demo_mtx, monkeypatch, one_thread):
    name = os.path.basename(demo)
    monkeypatch.setenv("SMVP_DEMO_MTX", demo_mtx)
    monkeypatch.setattr(sys, "argv", [demo, "--device", "cpu",
                                      *_SMALL.get(name, [])])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_path(demo, run_name="__main__")
        except SystemExit as e:  # an example may end with sys.exit
            assert e.code in (0, None), f"{name} exited {e.code}"
    assert out.getvalue().strip(), f"{name} printed nothing"
    text = open(demo).read()
    assert "smvp_toolkit_tpu." not in text and "import jax" not in text
