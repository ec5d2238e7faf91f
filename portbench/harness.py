"""Run one cell of ``BENCHMARK.json`` and print its result line.

A run: make the matrix from the seed (``generators/``), set up the port's
operator through its public entry and warm up every shape the cell uses
(``entries/``; all of it counts as ``setup_s``), drive the traffic for
``--seconds`` (with ``--trace 1`` under ``torch.profiler``), read the
device's peak memory, free the port's state, and judge a seeded sample of
the window's answers against the plain float64 reference
(``reference/``). The metrics come from one reader each (``metrics/``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "smvp_toolkit_tpu")


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level packages among module names, each compared
    whole: ``smvp_toolkit_tpu_torch`` is not ``smvp_toolkit_tpu``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, by path (names may hold
    dots or dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_data(path: Path) -> dict:
    return json.loads(path.read_text())


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    # -- what exists, by name ---------------------------------------------

    def names(self, kind: str) -> List[str]:
        """Names of the files of one kind: ``configs``, ``mixes``,
        ``metrics``, ``limits``, ``generators`` or ``entries``."""
        suffix = ".py" if kind in ("metrics", "generators",
                                   "entries") else ".json"
        return sorted(p.name[: -len(suffix)] for p in (self.dir / kind).iterdir()
                      if p.suffix == suffix and not p.name.startswith("_"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _read_data(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return _read_data(self.dir / "mixes" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _read_data(self.dir / "limits" / f"{workload}.json")

    def generator(self, name: str):
        return load_module(self.dir / "generators" / f"{name}.py",
                           f"portbench_generator_{name}")

    def entry(self, name: str):
        return load_module(self.dir / "entries" / f"{name}.py",
                           f"portbench_entry_{name}")

    def reader(self, metric: str) -> Callable:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}").read

    def metrics_for(self, workload: str, trace: bool) -> List[dict]:
        """The cell's metrics: end-to-end ones without a trace, per-layer
        ones with it; a metric with ``workloads`` only in those cells."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or workload in m["workloads"]]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from the seed (Li's algorithm L: one comparison per item)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self._rng = random.Random(seed)
        self._w = 1.0
        self._next = k - 1
        self._advance()

    def _advance(self) -> None:
        self._w *= math.exp(math.log(self._rng.random()) / self.k)
        self._next += int(math.log(self._rng.random())
                          / math.log1p(-self._w)) + 1

    def offer(self, item) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(item)
        elif i == self._next:
            self.items[self._rng.randrange(self.k)] = item
            self._advance()


class Run:
    """What one run measured: the readers' input."""

    def __init__(self, workload: str, config: dict, mix: dict, seed: int,
                 seconds: float, trace: bool):
        self.workload, self.config, self.mix = workload, config, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.kind = ""              # "spmv" or "solve", set by the entry
        self.nnz = self.nrows = self.ncols = 0
        self.value_bytes = 4
        self.needed_bytes = 0       # per request, needed_bytes.py
        self.kernels: tuple = ()    # name parts of the timed kernel
        self.spans: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self.setup_s = 0.0
        self.window_s = 0.0
        self.requests = 0
        self.failed = 0
        self.call_host_s: List[float] = []   # host span of each call
        self.latency_s: List[float] = []     # call to synchronise, solves
        self.event_call_s: List[float] = []  # CUDA-event time per call
        self.device_trace = None             # devtrace.Summary
        self.device_name = ""
        self.peak_bytes_per_s = None

    @contextmanager
    def span(self, name: str, sync: Callable = lambda: None):
        t = time.perf_counter()
        yield
        sync()
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t

    def kernel_s_per_request(self) -> Optional[float]:
        """Mean device seconds of the cell's kernel per request: from the
        profiler where it recorded one launch per request, else from the
        CUDA events around each call (the whole call), else None."""
        tr = self.device_trace
        if tr is not None:
            count, total = tr.kernel_stats(self.kernels)
            if count and count == self.requests:
                return total / count
        if self.event_call_s:
            return sum(self.event_call_s) / len(self.event_call_s)
        return None


class Context:
    """What an entry gets: the cell's data, device and generators."""

    def __init__(self, run: Run, matrix, device, value_dtype):
        self.run, self.matrix = run, matrix
        self.device, self.value_dtype = device, value_dtype

    def generator(self, stream: int):
        """A generator on the device for one stream of inputs, seeded from
        the run's seed and the stream number."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed((int(self.run.seed) * 1000003 + stream) % (1 << 63))
        return g

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


def run_cell(bench: Benchmark, workload: str, seed: int, seconds: float,
             trace: bool, device, value_dtype=None, t0: Optional[float] = None,
             log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result (without printing).

    ``value_dtype`` other than the configuration's own is the control
    (``control.py``)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    w = bench.workload(workload)
    cfg, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    limits = bench.limits(workload)
    dev = torch.device(device)
    run = Run(workload, cfg, mix, seed, seconds, trace)
    dtype = value_dtype or getattr(torch, cfg["dtype"])
    gen = bench.generator(cfg["generator"])
    entry = bench.entry(mix["entry"])

    matrix = gen.generate(cfg, seed, dev)
    ctx = Context(run, matrix, dev, dtype)
    state = entry.setup(ctx)
    ctx.sync()
    # The reference takes the triplets from the host after the window, so
    # the device holds only the port's state while it runs.
    host_matrix = tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                        for t in matrix)
    ctx.matrix = matrix = None

    gc.collect()
    run.setup_s = time.perf_counter() - t0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA
                                   if dev.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
    gc.disable()
    try:
        entry.window(ctx, state, seconds,
                     int(mix["trace_requests"]) if trace else None)
    finally:
        gc.enable()
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if prof is not None:
        from portbench import devtrace

        run.device_trace = devtrace.summarize(prof, run.window_s)
        del prof

    # The port's state goes before the reference runs.
    samples = entry.release(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = entry.check(ctx, samples, host_matrix)
    del samples
    ref_s = time.perf_counter() - t_ref

    judged = {name: (value, float(limits[name]))
              for name, value in checks.items()}
    run.failed += sum(1 for v, lim in judged.values() if not v <= lim)
    correct = run.failed == 0 and set(judged) == set(limits)

    if dev.type == "cuda":
        run.device_name = torch.cuda.get_device_name(dev)
        peaks = json.loads((bench.dir / "peaks.json").read_text())
        run.peak_bytes_per_s = peaks.get(run.device_name, {}).get(
            "hbm_bytes_per_s")
    metrics = {}
    for m in bench.metrics_for(workload, trace):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": run.device_name or dev.type, "count": 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.requests,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if trace and run.device_trace is not None:
        device_info["busy_s"] = run.device_trace.busy_s
        device_info["window_s"] = run.device_trace.window_s
        result["breakdown"] = run.device_trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in judged.items()}
    print(f"[portbench] {workload} seed {seed}: setup {run.setup_s:.3f} s, "
          f"spans {run.spans}, window {run.window_s:.3f} s, "
          f"{run.requests} requests, reference {ref_s:.3f} s, peak "
          f"{peak} B", file=log)
    host = sorted(run.call_host_s or run.latency_s)
    if host:
        q = [host[int(f * (len(host) - 1))] * 1e6 for f in (0.1, 0.5, 0.9)]
        print(f"[portbench] host per request p10/p50/p90 {q[0]:.1f} / "
              f"{q[1]:.1f} / {q[2]:.1f} us", file=log)
    if trace and run.device_trace is not None:
        tr = run.device_trace
        count, total = tr.kernel_stats(run.kernels)
        how = ("profiler" if count == run.requests else
               "CUDA events around each call (the profiler recorded "
               f"{count} launches for {run.requests} requests)")
        print(f"[portbench] trace: {len(tr.device)} device ops, busy "
              f"{tr.busy_s:.6f} of {tr.window_s:.6f} s; kernel time from "
              f"{how}; card {_power_limit()}", file=log)
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = Benchmark()
    try:
        w = bench.workload(args.workload)
    except KeyError as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(w["chips"])):
        print(f"[portbench] {args.workload} needs {w['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", t0=t0)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"[portbench] the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
