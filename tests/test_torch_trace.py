"""The port's tracer (``utils/tracing.py``): off by default, the span tree
of the planner, the operator, the factorization and the fused solvers on
the CPU (where each takes its plain version), self time, the counters
beside the kernel wrappers' ``.launches``, the bounded buffer, the
profiler's clock, and ``--profile``'s trace. The card test holds K1's and
K9's launch runtime events inside their launch spans:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading

import pytest
import torch

from smvp_toolkit_tpu_torch.bench import profile
from smvp_toolkit_tpu_torch.formats.coo import COOMatrix
from smvp_toolkit_tpu_torch.formats.csr import csr_encode
from smvp_toolkit_tpu_torch.ops.cg_fused import fused_cg
from smvp_toolkit_tpu_torch.ops.ilu import ic0
from smvp_toolkit_tpu_torch.ops.pcg_fused import fused_pcg_ic0
from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV, sell_spmv
from smvp_toolkit_tpu_torch.utils import tracing
from smvp_toolkit_tpu_torch.utils.synth import hpcg_stencil, synth_banded


def _spd(device="cpu"):
    """HPCG's 27-point stencil on a 6³ grid: 216 rows, SPD."""
    return COOMatrix.from_scipy(hpcg_stencil(6).tocoo(), device=device)


@pytest.fixture
def tracer():
    """The tracer on for one test, drained clean first; off after."""
    tracing.enable()
    tracing.drain()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _check_tree(spans):
    """Every parent is a recorded span that encloses its child and shares
    its request; top-level spans each have a request of their own."""
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent == 0]
    assert len({s.request for s in roots}) == len(roots)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.request == p.request
    return roots


def test_off_by_default_records_nothing():
    out = subprocess.run(
        [sys.executable, "-c", "from smvp_toolkit_tpu_torch.utils import "
         "tracing; print(tracing.enabled())"], capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    assert not tracing.enabled()
    assert tracing.span("spmv.call") is tracing.NO_SPAN
    assert tracing.span("solve.call", {"solver": "cg"}) is tracing.NO_SPAN
    tracing.drain()
    op = SellSpMV.from_coo(synth_banded(300, nnz_per_row=4, seed=1,
                                        device="cpu"), device="cpu")
    op(torch.ones(300))
    tracing.count("plan.slots")
    got = tracing.drain()
    assert got["spans"] == [] and "plan.slots" not in got["counters"]


def test_plan_and_call_tree(tracer):
    coo = synth_banded(600, nnz_per_row=5, seed=3, device="cpu")
    op = SellSpMV.from_coo(coo, device="cpu")
    setup = tracer.drain()
    names = _by_name(setup["spans"])
    (root,) = _check_tree(setup["spans"])
    assert root.name == "plan"
    for name in ("plan.to_host", "plan.sort", "plan.tune", "plan.upload"):
        assert [s.parent for s in names[name]] == [root.id], name
    c = setup["counters"]
    assert c["plan.slots"] == op.plan.n_sublanes * 128
    assert c["plan.live_slots"] == op.plan.nnz == coo.nnz

    x = torch.randn(600)
    for _ in range(3):
        op(x)
    calls = tracer.drain()["spans"]
    roots = _check_tree(calls)
    assert [s.name for s in roots] == ["spmv.call"] * 3
    for r in roots:
        kids = sorted((s for s in calls if s.parent == r.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["spmv.x_tiles", "spmv.launch"]


def test_factor_and_solve_trees(tracer):
    coo = _spd()
    op = SellSpMV.from_coo(coo, device="cpu")
    factors = ic0(csr_encode(coo))
    tracer.drain()  # the plan's spans (above)
    b = torch.randn(coo.shape[0], generator=torch.Generator().manual_seed(0))
    fused_cg(op, b, 20)
    fused_pcg_ic0(op, factors, b, 10, sweeps=3)
    fused_pcg_ic0(op, factors, b, 10, sweeps=3)
    got = tracer.drain()
    spans = got["spans"]
    roots = _check_tree(spans)
    assert [(s.name, s.attrs) for s in roots] == [
        ("solve.call", {"solver": "cg"})] + [
        ("solve.call", {"solver": "pcg_ic0"})] * 2
    kids = [[s.name for s in sorted((k for k in spans if k.parent == r.id),
                                    key=lambda k: k.start_ns)]
            for r in roots]
    # the first IC(0) solve plans the factor planes, the second reuses them
    assert kids == [["solve.prep", "solve.launch"],
                    ["factor.planes", "solve.prep", "solve.launch"],
                    ["solve.prep", "solve.launch"]]

    csr = csr_encode(coo)
    ic0(csr)
    got = tracer.drain()
    roots = _check_tree(got["spans"])
    assert [s.name for s in roots] == ["encode.csr", "factor.ic0"]
    names = _by_name(got["spans"])
    passes = names["factor.ic0.pass"]
    assert len(passes) >= 1
    assert all(s.parent == roots[1].id for s in
               passes + names["factor.ic0.upload"])


def test_self_time():
    S = tracing.Span
    spans = [S(1, 0, 1, "a", 0, 100, {}), S(2, 1, 1, "b", 10, 30, {}),
             S(3, 1, 1, "c", 20, 50, {}), S(4, 3, 1, "d", 25, 45, {}),
             S(5, 1, 1, "e", 90, 120, {})]
    # a: 100 less the union of its children [10, 50] and [90, 100]
    assert tracing.self_times(spans) == {1: 50, 2: 20, 3: 10, 4: 20, 5: 30}


def test_self_time_of_the_plan(tracer):
    SellSpMV.from_coo(synth_banded(400, nnz_per_row=3, seed=4,
                                   device="cpu"), device="cpu")
    spans = tracer.drain()["spans"]
    own = tracing.self_times(spans)
    (root,) = [s for s in spans if s.parent == 0]
    kids = [s for s in spans if s.parent == root.id]
    assert own[root.id] == (root.end_ns - root.start_ns
                            - sum(s.end_ns - s.start_ns for s in kids))
    assert all(own[s.id] >= 0 for s in spans)


def test_counters_are_the_wrappers_launches(tracer):
    wrappers = tracing.kernel_wrappers()
    before = tracing.counters()
    assert {k: before[k] for k in wrappers} == tracing.kernel_counts()
    sell_spmv.launches += 3  # as three K1 launches would
    try:
        after = tracing.counters()
        moved = {k: after[k] - before[k] for k in wrappers
                 if after[k] != before[k]}
        assert moved == {"sell_spmv_kernel": 3}
        assert tracer.drain()["counters"] == {"sell_spmv_kernel": 3}
        assert tracer.drain()["counters"] == {}
    finally:
        sell_spmv.launches -= 3


def test_bounded_buffer_counts_what_it_drops(monkeypatch):
    tracing.disable()
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    tracing.enable()
    try:
        for i in range(6):
            with tracing.span(f"s{i}"):
                pass
        got = tracing.drain()
        assert [s.name for s in got["spans"]] == ["s0", "s1", "s2", "s3"]
        assert got["counters"] == {"tracing.dropped": 2}
        with tracing.span("s6"):
            pass
        got = tracing.drain()
        assert [s.name for s in got["spans"]] == ["s6"]
        assert got["counters"] == {}
    finally:
        tracing.disable()
        tracing.drain()


def test_threads_lose_no_span_and_nest_apart(tracer):
    """Eight threads record nested spans and count while the main thread
    drains: no span or count is lost, and each thread's spans nest under
    that thread's own."""
    n_threads, per = 8, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for _ in range(per):
            attrs = {"k": k}
            with tracing.span("outer", attrs):
                with tracing.span("inner", attrs):
                    tracing.count("stress")

    got = []
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            got += tracer.drain()["spans"]
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        last = tracer.drain()
    finally:
        sys.setswitchinterval(old)
    got += last["spans"]
    assert len(got) == 2 * n_threads * per
    assert tracer.counters()["stress"] == n_threads * per
    # drained at once, the same work nests by thread
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    spans = tracer.drain()["spans"]
    by_id = {s.id: s for s in spans}
    _check_tree(spans)
    for s in spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer"
            assert by_id[s.parent].attrs == s.attrs
        else:
            assert s.parent == 0 and s.request == s.id


def test_spans_lie_on_the_profilers_clock(tracer):
    """The zeros that pad x run inside ``spmv.x_tiles`` and the zeros of
    y inside ``spmv.launch``, on the profiler's own timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    op = SellSpMV.from_coo(synth_banded(500, nnz_per_row=4, seed=5,
                                        device="cpu"), device="cpu")
    x = torch.randn(500)
    op(x)
    tracer.drain()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        op(x)
    names = _by_name(tracer.drain()["spans"])
    (xt,), (ln,) = names["spmv.x_tiles"], names["spmv.launch"]
    zeros = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "aten::zeros"
                   and e.device_type() == DeviceType.CPU)
    assert len(zeros) >= 2
    assert xt.start_ns <= zeros[0][0] and zeros[0][1] <= xt.end_ns
    assert ln.start_ns <= zeros[1][0] and zeros[1][1] <= ln.end_ns


def test_profile_writes_the_spans_on_a_track_of_their_own(tmp_path):
    op = SellSpMV.from_coo(synth_banded(300, nnz_per_row=4, seed=6,
                                        device="cpu"), device="cpu")
    x = torch.ones(300)
    profile.profile_fn(op, x, log_dir=str(tmp_path), iterations=2)
    assert not tracing.enabled()
    with open(tmp_path / profile.TRACE_FILE) as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    ours = [e for e in ev if e.get("pid") == tracing.TRACK_PID
            and e.get("ph") == "X"]
    assert sorted(e["name"] for e in ours) == sorted(
        ["spmv.call", "spmv.x_tiles", "spmv.launch"] * 2)
    # on the profiler's timeline: inside the span of its own operators
    ops = [e for e in ev if e.get("ph") == "X"
           and str(e.get("name", "")).startswith("aten::")]
    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e["dur"] for e in ops)
    calls = [e for e in ours if e["name"] == "spmv.call"]
    assert all(lo - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e3
               for e in calls)
    assert all(e["args"]["self_us"] >= 0 for e in ours)


def test_profile_leaves_a_running_tracer_to_its_caller(tmp_path, tracer):
    """With the tracer on before the block, ``trace`` leaves it on, takes
    none of its spans and writes none: they stay for the caller."""
    op = SellSpMV.from_coo(synth_banded(300, nnz_per_row=4, seed=7,
                                        device="cpu"), device="cpu")
    x = torch.ones(300)
    tracer.drain()
    op(x)  # recorded before the block
    with profile.trace(str(tmp_path)):
        op(x)
    assert tracing.enabled()
    got = tracer.drain()["spans"]
    assert [s.name for s in got if s.parent == 0] == ["spmv.call"] * 2
    with open(tmp_path / profile.TRACE_FILE) as f:
        ev = json.load(f)["traceEvents"]
    assert not [e for e in ev if e.get("pid") == tracing.TRACK_PID]


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launch_events(prof, kernel):
    """(start, end) ns of the runtime call that launched each ``kernel``,
    paired by correlation id."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    ids = {e.correlation_id() for e in events
           if e.device_type() == DeviceType.CUDA and kernel in e.name()}
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() != DeviceType.CUDA
            and e.name().startswith("cudaLaunch")
            and e.correlation_id() in ids]


@pytest.mark.cuda
def test_launch_runtime_events_lie_in_their_spans(card, tracer):
    from torch.profiler import ProfilerActivity

    coo = _spd(card)
    op = SellSpMV.from_coo(coo, device=card)
    x = torch.randn(coo.shape[0], device=card)
    b = torch.randn(coo.shape[0], device=card)
    op(x)
    fused_cg(op, b, 10)
    torch.cuda.synchronize()
    tracer.drain()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            op(x)
        fused_cg(op, b, 10)
        torch.cuda.synchronize()
    names = _by_name(tracer.drain()["spans"])
    for kernel, span in (("sell_spmv_kernel", "spmv.launch"),
                         ("sell_cg_kernel", "solve.launch")):
        launches = _launch_events(prof, kernel)
        spans = names[span]
        assert len(launches) == len(spans) >= 1, kernel
        for (a, z), s in zip(sorted(launches), spans):
            assert s.start_ns <= a and z <= s.end_ns, (kernel, a - s.start_ns,
                                                       s.end_ns - z)
