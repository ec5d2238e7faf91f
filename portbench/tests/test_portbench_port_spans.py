"""The port's spans in a traced run (``port_spans.py``): each reader of
``metrics/tracer/`` is None without spans and right on synthetic ones,
and its entry is one ``BENCHMARK.json`` takes; ``run.py``'s harness
leaves the port's tracer off; the traced runner reads the port's spans
on the CPU at a tiny size, and runs a port that has no tracer."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import port_spans as P
from portbench.devtrace import Summary
from portbench.harness import ROOT, run_cell
from smvp_toolkit_tpu_torch.utils import tracing

Span = tracing.Span
MS = 1_000_000  # ns
BENCH = P.TracedBenchmark(ROOT, tracing)
NAMES = sorted(m["name"] for m in BENCH.tracer_metrics)


def _read(name, run):
    return BENCH.reader(name)(run)


def _run(kind="spmv", setup=True, window=True):
    """A run of two requests on a 10 ms window: the device busy [0, 4]
    and [6, 9] ms, idle [4, 6] and [9, 10]."""
    setup_spans = [Span(1, 0, 1, "plan", 0, 10 * MS, {}),
                   Span(2, 1, 1, "plan.sort", 1 * MS, 3 * MS, {}),
                   Span(3, 1, 1, "plan.tune", 3 * MS, 4 * MS, {}),
                   Span(4, 1, 1, "plan.upload", 4 * MS, 9 * MS, {}),
                   Span(5, 0, 2, "factor.ic0", 10 * MS, 20 * MS, {}),
                   Span(6, 5, 2, "factor.ic0.pass", 11 * MS, 14 * MS, {}),
                   Span(7, 5, 2, "factor.ic0.pass", 14 * MS, 19 * MS, {})]
    root, a, b = (("spmv.call", "spmv.x_tiles", "spmv.launch")
                  if kind == "spmv" else
                  ("solve.call", "solve.prep", "solve.launch"))
    # request 3 runs [3.5, 5] ms, request 4 [5.5, 8] ms; request 4 has
    # two launch spans
    window_spans = [Span(10, 0, 3, root, 3_500_000, 5 * MS, {}),
                    Span(11, 10, 3, a, 3_600_000, 4 * MS, {}),
                    Span(12, 10, 3, b, 4 * MS, 4_900_000, {}),
                    Span(13, 0, 4, root, 5_500_000, 8 * MS, {}),
                    Span(14, 13, 4, a, 5_500_000, 5_700_000, {}),
                    Span(15, 13, 4, b, 5_700_000, 6 * MS, {}),
                    Span(16, 13, 4, b, 6 * MS, 6_100_000, {})]
    run = SimpleNamespace(kind=kind, requests=2, spans={}, call_host_s=[],
                          kernels=("k",))
    run.device_trace = Summary([("k", 0.0, 4000.0), ("k", 6000.0, 9000.0)],
                               [], window_s=10e-3)
    if setup:
        run.program_setup = {"spans": setup_spans, "counters": {}}
    if window:
        run.program_window = {"spans": window_spans, "counters": {}}
    return run


@pytest.mark.parametrize("name", NAMES)
def test_reading_is_none_without_spans(name):
    for kind in ("spmv", "solve"):
        assert _read(name, _run(kind, setup=False, window=False)) is None


@pytest.mark.parametrize("name, kind, want", [
    ("plan_sort_s", "spmv", 2e-3), ("plan_tune_s", "solve", 1e-3),
    ("plan_upload_s", "spmv", 5e-3), ("ic0_pass_s", "solve", 8e-3),
    # medians per request: x_tiles 0.4 and 0.2 ms; launches 0.9 and 0.4
    ("x_tiles_us", "spmv", 300.0), ("launch_host_us", "spmv", 650.0),
    ("solve_prep_us", "solve", 300.0), ("solve_launch_us", "solve", 650.0),
    # idle [4, 6] ms meets the spans' union [3.5, 5] + [5.5, 8]: 1.5 ms
    ("port_idle_us.spmv", "spmv", 750.0),
    ("port_idle_us.solve", "solve", 750.0),
])
def test_reading_on_synthetic_spans(name, kind, want):
    got = _read(name, _run(kind))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name, kind", [
    ("x_tiles_us", "solve"), ("launch_host_us", "solve"),
    ("solve_prep_us", "spmv"), ("solve_launch_us", "spmv"),
    ("port_idle_us.spmv", "solve"), ("port_idle_us.solve", "spmv")])
def test_reading_only_in_its_cells(name, kind):
    assert _read(name, _run(kind)) is None


def test_entries_are_what_benchmark_json_takes():
    """Each entry has the keys of an entry of ``per_layer``, a layer that
    ``BENCHMARK.json`` names, and cells that report what it moves; no
    name is one of the benchmark's metrics yet."""
    spec = BENCH.spec
    cells = {w["name"] for w in spec["workloads"]}
    layers = {m["layer"] for m in spec["per_layer"]}
    e2e = {m["name"]: m.get("workloads", cells) for m in spec["end_to_end"]}
    taken = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    assert len(NAMES) == 10 and not set(NAMES) & taken
    for m in BENCH.tracer_metrics:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["better"] == "lower" and m["unit"] in ("s", "us")
        assert m["source"] in ("program_span", "device_trace")
        assert m["layer"] in layers
        assert m["workloads"] and set(m["workloads"]) <= set(e2e[m["moves"]])
        assert (BENCH.tracer_dir / f"{m['name']}.py").exists()


def test_agreement_of_inside_and_outside():
    run = _run("spmv")
    run.spans = {"plan_s": 0.0105}
    run.call_host_s = [3e-3, 1e-3]
    run.program_setup["counters"] = {"plan.slots": 512,
                                      "plan.live_slots": 128}
    run.program_window["counters"] = {"k": 2, "tracing.dropped": 1}
    # launch calls: two in the first launch span (the last is its
    # kernel's), one in the second, one in no span, one not a launch
    run.device_trace.host = [("cudaLaunchKernel", 4100.0, 4150.0),
                             ("cudaLaunchKernel", 4200.0, 4300.0),
                             ("cudaMemsetAsync", 5710.0, 5720.0),
                             ("cudaLaunchKernel", 5750.0, 5800.0),
                             ("cudaLaunchKernel", 7000.0, 7010.0)]
    got = P.agreement(run)
    assert got["plan_root_s"] == pytest.approx(0.01)
    assert got["plan_phases_share"] == pytest.approx(0.8)
    assert got["plan_live_slots_pct"] == pytest.approx(25.0)
    assert (got["spans_dropped"], got["kernel_launches_counted"]) == (1, 2)
    assert got["spmv_call_us"] == pytest.approx(2000.0)
    assert got["call_host_us"] == pytest.approx(2000.0)
    assert P.launch_margins(
        [(a, b) for _, a, b in run.device_trace.host],
        run.program_window["spans"]) == [[200.0, 600.0], [50.0, 200.0],
                                         None]
    assert (got["kernel_launches"], got["launch_spans"],
            got["launch_spans_holding_a_call"]) == (2, 3, 2)
    assert got["launch_margin_us"]["end"] == [200.0, 200.0, 400.0]
    assert got["idle_us_per_request"] == pytest.approx(1500.0)


@pytest.mark.parametrize("trace", [False, True])
def test_run_py_leaves_the_tracer_off(tiny, trace):
    tracing.drain()
    r = run_cell(tiny, "kron20.spmv", 3, 0.2, trace, "cpu")
    assert r["correct"]
    assert not tracing.enabled()
    assert tracing.drain()["spans"] == []
    assert not set(NAMES) & set(r["metrics"])


@pytest.mark.parametrize("cell, want", [
    ("kron20.spmv", {"plan_sort_s", "plan_tune_s", "plan_upload_s",
                     "x_tiles_us", "launch_host_us"}),
    ("hpcg104.pcg-ic0-fused", {"plan_sort_s", "plan_tune_s",
                               "plan_upload_s", "ic0_pass_s",
                               "solve_prep_us", "solve_launch_us"})])
def test_traced_runner_reads_the_ports_spans(tiny, cell, want):
    bench = P.TracedBenchmark(tiny.root, tracing)
    r = P.run_traced(bench, cell, 2**31 + 9, 0.2, "cpu")
    assert r["correct"] and not tracing.enabled()
    assert set(NAMES) & set(r["metrics"]) == want
    assert all(r["metrics"][m]["value"] > 0 for m in want)
    agree = r["port_spans"]
    assert 0 < agree["plan_root_s"] <= agree["plan_s"]
    assert 0 < agree["plan_phases_share"] <= 1
    if cell == "kron20.spmv":
        assert 0 < agree["spmv_call_us"]
    assert agree["spans_per_request"] >= 3


def test_traced_runner_on_a_port_without_a_tracer(tiny):
    bench = P.TracedBenchmark(tiny.root, None)
    r = P.run_traced(bench, "hpcg104.cg-fused", 4, 0.2, "cpu")
    assert r["correct"] and "port_spans" not in r
    assert not set(NAMES) & set(r["metrics"])
    assert "solve_host_ms" not in r["metrics"]  # no device on the CPU
