"""The harness finds configurations, mixes, limits and metrics by name,
and a cell is added by adding files alone."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT
from portbench.harness import (Benchmark, Reservoir, forbidden_modules,
                               run_cell)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_lists_every_kind_by_name():
    b = Benchmark(ROOT)
    assert b.names("configs") == ["hpcg104", "kron20"]
    assert b.names("mixes") == ["cg-fused", "pcg-ic0-fused", "spmv"]
    assert b.names("generators") == ["hpcg", "kronecker"]
    assert b.names("entries") == ["cg_fused", "pcg_ic0_fused", "spmv"]
    metrics = [m["name"] for m in b.spec["end_to_end"] + b.spec["per_layer"]]
    assert sorted(metrics) == b.names("metrics")
    assert b.names("limits") == sorted(w["name"] for w in b.spec["workloads"])


def test_every_cell_resolves():
    b = Benchmark(ROOT)
    for w in b.spec["workloads"]:
        cfg, mix = b.config(w["config"]), b.mix(w["traffic"])
        assert (b.dir / "generators" / f"{cfg['generator']}.py").exists()
        assert (b.dir / "entries" / f"{mix['entry']}.py").exists()
        assert b.limits(w["name"])
        for m in b.metrics_for(w["name"], False) + b.metrics_for(
                w["name"], True):
            assert callable(b.reader(m["name"]))


def test_benchmark_json_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reported = [e["name"] for e in spec["end_to_end"]
                        if cell in e.get("workloads", cells)]
            assert m["moves"] in reported


def test_forbidden_modules_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "smvp_toolkit_tpu", "smvp_toolkit_tpu.ops.spmv",
             "smvp_toolkit_tpu_torch", "smvp_toolkit_tpu_torch.ops",
             "jaxtyping", "jax_cpu", "numpy", "torch"]
    assert forbidden_modules(names) == ["flax", "jax", "jaxlib",
                                        "smvp_toolkit_tpu"]
    assert forbidden_modules(["smvp_toolkit_tpu_torch.cli", "jaxtyping",
                              "jaxlibx"]) == []


def test_reservoir_is_a_seeded_sample():
    def sample(seed, n, k=5):
        r = Reservoir(k, seed)
        for i in range(n):
            r.offer(i)
        return r.items

    assert sample(3, 3) == [0, 1, 2]
    a = sample(2**31 + 5, 10_000)
    assert len(a) == 5 and len(set(a)) == 5
    assert a == sample(2**31 + 5, 10_000) and a != sample(7, 10_000)
    # every item is as likely: the mean of the sampled items is near n/2
    means = [sum(sample(s, 1000)) / 5 for s in range(200)]
    assert abs(sum(means) / len(means) - 499.5) < 40


def test_a_cell_added_by_files_alone(tmp_path):
    from conftest import make_copy

    root = make_copy(tmp_path / "copy")
    d = root / "portbench"
    cfg = json.loads((d / "configs" / "hpcg104.json").read_text())
    cfg.update(name="hpcg6", nx=6, ny=6, nz=6)
    (d / "configs" / "hpcg6.json").write_text(json.dumps(cfg))
    mix = json.loads((d / "mixes" / "spmv.json").read_text())
    mix.update(sync_every=8)
    (d / "mixes" / "spmv-sync8.json").write_text(json.dumps(mix))
    (d / "limits" / "hpcg6.spmv-sync8.json").write_text('{"y_err": 1e-4}')
    (d / "metrics" / "calls_per_sync.py").write_text(
        "def read(run):\n    return float(run.mix['sync_every'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "hpcg6", "source": cfg["source"],
                            "file": "portbench/configs/hpcg6.json",
                            "reduced": [], "why": "a 6x6x6 grid"})
    spec["workloads"].append({"name": "hpcg6.spmv-sync8", "config": "hpcg6",
                              "traffic": "spmv-sync8", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "spmv_gnnz_s":
            m["workloads"].append("hpcg6.spmv-sync8")
    for m in spec["per_layer"]:
        if m["name"] == "plan_occupancy_pct":
            m["workloads"].append("hpcg6.spmv-sync8")
    spec["per_layer"].append({
        "name": "calls_per_sync", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "operator",
        "moves": "spmv_gnnz_s", "workloads": ["hpcg6.spmv-sync8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    b = Benchmark(root)
    assert "hpcg6" in b.names("configs")
    assert "spmv-sync8" in b.names("mixes")
    assert "calls_per_sync" in b.names("metrics")
    r = run_cell(b, "hpcg6.spmv-sync8", 5, 0.2, True, "cpu")
    assert r["metrics"]["plan_occupancy_pct"]["value"] > 0
    assert r["correct"] and r["metrics"]["calls_per_sync"]["value"] == 8.0
    assert r["attempted"] % 8 == 0
    r = run_cell(b, "hpcg6.spmv-sync8", 5, 0.2, False, "cpu")
    assert set(r["metrics"]) == {"spmv_gnnz_s", "setup_s"}
    assert list(r)[-1] == "checks"


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "kron20.spmv", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
    assert harness.main(["--workload", "nope", "--seed", "1",
                         "--seconds", "1"]) != 0
