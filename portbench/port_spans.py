"""A traced run of one cell with the port's own tracer on.

``python3 portbench/port_spans.py --workload <cell> --seed <n> --seconds
<s>`` runs the cell as ``run.py --trace 1`` does (the same harness,
entries and profiler around the window) with the port's tracer
(``smvp_toolkit_tpu_torch.utils.tracing``) on from before set-up. The
tracer is drained once after set-up and once after the window, into
``run.program_setup`` and ``run.program_window`` (each ``{"spans": [...],
"counters": {...}}``). The result line carries, beside the traced run's
own metrics, the metrics of ``metrics/tracer/entries.json`` (each read by
``metrics/tracer/<name>.py``) and ``port_spans``: the inside spans and
counters against the benchmark's outside readings, and the kernels'
launch calls in the port's launch spans. Against a port without
``utils/tracing`` it gives the traced run alone.

``run.py`` never turns the tracer on: the benchmark's lines are what they
were. The entries and their readers become the benchmark's once
``harness.py`` itself drains the tracer under ``--trace 1``: they are then
appended to ``BENCHMARK.json``'s ``per_layer`` and the readers moved up
into ``metrics/``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from typing import Dict, List

if __name__ == "__main__":
    T0 = time.perf_counter()
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import ROOT, Benchmark, load_module, run_cell  # noqa: E402
from portbench.metrics._spans import per_request_us, spans_of  # noqa: E402

LAUNCH_SPANS = ("spmv.launch", "solve.launch")
PLAN_PHASES = ("plan.to_host", "plan.sort", "plan.tune", "plan.upload")


def port_tracing():
    """The port's tracer module, or None where the port has none."""
    try:
        from smvp_toolkit_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


# -- the inside against the outside ------------------------------------------


def launch_margins(calls, spans) -> List[List[float]]:
    """For each launch span, in time order, the last kernel-launch call
    (``calls``: start, end µs) that lies inside it, as its margins
    ``[call start − span start, span end − call end]`` in µs; None for a
    span that holds no launch call."""
    calls = sorted(calls)
    starts = [a for a, _ in calls]
    out = []
    for s in sorted((s for s in spans if s.name in LAUNCH_SPANS),
                    key=lambda s: s.start_ns):
        lo, hi = s.start_ns / 1e3, s.end_ns / 1e3
        i = bisect.bisect_left(starts, lo)
        inside = [c for c in calls[i: bisect.bisect_right(starts, hi)]
                  if c[1] <= hi]
        out.append([inside[-1][0] - lo, hi - inside[-1][1]]
                   if inside else None)
    return out


def _low(values) -> List[float]:
    """The least, the 1st percentile and the median of ``values``."""
    v = sorted(values)
    return [v[0], v[len(v) // 100], statistics.median(v)]


def agreement(run) -> dict:
    """The inside spans and counters against the benchmark's outside
    readings."""
    out: dict = {}
    by_name: Dict[str, float] = {}
    for s in spans_of(run, "setup") or ():
        by_name[s.name] = (by_name.get(s.name, 0.0)
                           + (s.end_ns - s.start_ns) / 1e9)
    out["setup_spans_s"] = by_name
    plan = by_name.get("plan")
    if plan:
        out.update(plan_root_s=plan, plan_s=run.spans.get("plan_s"),
                   plan_phases_share=sum(by_name.get(p, 0.0)
                                         for p in PLAN_PHASES) / plan)
    setup = getattr(run, "program_setup", None) or {"counters": {}}
    c = setup["counters"]
    if c.get("plan.slots"):
        # the twin of plan_occupancy_pct, from the port's own counters
        out["plan_live_slots_pct"] = 100.0 * c["plan.live_slots"] \
            / c["plan.slots"]
    window = getattr(run, "program_window", None)
    if window is not None:
        out["spans_dropped"] = (c.get("tracing.dropped", 0)
                                + window["counters"].get("tracing.dropped",
                                                         0))
        out["kernel_launches_counted"] = sum(
            window["counters"].get(k, 0) for k in run.kernels)
    if run.call_host_s:
        out.update(spmv_call_us=per_request_us(run, "spmv.call"),
                   call_host_us=statistics.median(run.call_host_s) * 1e6)
    tr, spans = run.device_trace, spans_of(run, "window")
    if tr is not None and spans is not None:
        calls = [(a, b) for n, a, b in tr.host if n.startswith("cudaLaunch")]
        m = launch_margins(calls, spans)
        held = [x for x in m if x is not None]
        out.update(kernel_launches=tr.kernel_stats(run.kernels)[0],
                   launch_spans=len(m), launch_spans_holding_a_call=len(held))
        if held:
            tenth = max(len(held) // 10, 1)
            out.update(
                launch_margin_us={k: _low(v) for k, v in (
                    ("start", [a for a, _ in held]),
                    ("end", [b for _, b in held]))},
                launch_end_margin_first_last_tenth_us=[
                    statistics.median(b for _, b in held[:tenth]),
                    statistics.median(b for _, b in held[-tenth:])])
    if tr is not None and run.requests:
        out["idle_us_per_request"] = ((tr.window_s - tr.busy_s) * 1e6
                                      / run.requests)
    if spans is not None and run.requests:
        out["spans_per_request"] = len(spans) / run.requests
    return out


# -- the traced benchmark ----------------------------------------------------


class _TracedEntry:
    """An entry whose set-up runs with the port's tracer on; its spans
    are drained after set-up and after the window."""

    def __init__(self, entry, bench: "TracedBenchmark"):
        self._entry, self._bench = entry, bench

    def setup(self, ctx):
        tracing = self._bench.tracing
        self._bench.run = ctx.run
        tracing.enable()
        tracing.drain()
        return self._entry.setup(ctx)

    def window(self, ctx, state, seconds, cap):
        tracing = self._bench.tracing
        ctx.run.program_setup = tracing.drain()
        try:
            self._entry.window(ctx, state, seconds, cap)
        finally:
            ctx.run.program_window = tracing.drain()
            tracing.disable()

    def __getattr__(self, name):
        return getattr(self._entry, name)


class TracedBenchmark(Benchmark):
    """``Benchmark`` with the port's tracer on and the metrics of
    ``metrics/tracer/`` among the per-layer ones; the plain traced run
    where the port has no tracer (``tracing`` None)."""

    def __init__(self, root=ROOT, tracing=None):
        super().__init__(root)
        self.tracing = tracing
        self.run = None  # the harness.Run of the last set-up
        self.tracer_dir = self.dir / "metrics" / "tracer"
        self.tracer_metrics = json.loads(
            (self.tracer_dir / "entries.json").read_text())

    def entry(self, name: str):
        entry = super().entry(name)
        return entry if self.tracing is None else _TracedEntry(entry, self)

    def metrics_for(self, workload: str, trace: bool) -> List[dict]:
        base = super().metrics_for(workload, trace)
        if not trace or self.tracing is None:
            return base
        return base + [m for m in self.tracer_metrics
                       if workload in m["workloads"]]

    def reader(self, metric: str):
        if any(m["name"] == metric for m in self.tracer_metrics):
            return load_module(self.tracer_dir / f"{metric}.py",
                               f"portbench_tracer_metric_{metric}").read
        return super().reader(metric)


def run_traced(bench: TracedBenchmark, workload: str, seed: int,
               seconds: float, device, t0=None, log=sys.stderr) -> dict:
    """One traced run of ``workload`` (``harness.run_cell``) with the
    port's tracer on, ``port_spans`` (``agreement``) added to its
    result."""
    result = run_cell(bench, workload, seed, seconds, True, device, t0=t0,
                      log=log)
    if bench.tracing is None:
        return result
    run = bench.run
    result["port_spans"] = agreement(run)
    builds = [s.attrs.get("names", "") for s in run.program_setup["spans"]
              if s.name == "build"]
    print(f"[portbench] builds in set-up: "
          f"{run.program_setup['counters'].get('build.compiles', 0)} "
          f"({', '.join(builds) or 'none'})", file=log)
    return result


def main(argv=None, t0=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[portbench] a traced run needs a CUDA device",
              file=sys.stderr)
        return 3
    bench = TracedBenchmark(tracing=port_tracing())
    result = run_traced(bench, args.workload, args.seed, args.seconds,
                        "cuda:0", t0=t0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(t0=T0))
