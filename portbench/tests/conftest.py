"""Fixtures of the benchmark's own tests: a copy of the benchmark with the
configurations cut to a size the CPU runs in a second."""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"hpcg104": {"nx": 8, "ny": 8, "nz": 8}, "kron20": {"scale": 10}}


def make_copy(dest: Path, sizes=TINY) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` under ``dest``, each named
    configuration resized; the port and its build directory linked."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, upd in sizes.items():
        path = dest / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(upd)
        path.write_text(json.dumps(cfg))
    os.symlink(ROOT / "smvp_toolkit_tpu_torch", dest / "smvp_toolkit_tpu_torch")
    return dest


@pytest.fixture
def tiny(tmp_path):
    """A resized copy of the benchmark, as a ``harness.Benchmark``."""
    from portbench.harness import Benchmark

    return Benchmark(make_copy(tmp_path / "tiny"))
