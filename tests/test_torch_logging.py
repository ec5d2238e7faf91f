"""``utils.logging.log`` keeps lines whole when processes share one pipe.

The ranks of a ``torchrun`` job (``parallel/launch.py``) write to one
pipe. ``log`` writes each line, newline included, in one ``write`` and
flushes it, so a line shorter than ``PIPE_BUF`` reaches the pipe whole.
Two child processes start logging at the same instant into the same
pipe, each a few thousand lines of more than 100 characters; every line
the parent reads must be one of theirs, whole, and each child's lines
must all arrive, in its own order. A ``print`` on Python's block-buffered
stdout flushes at whatever byte its buffer fills up at, and fails this.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

import pytest

from smvp_toolkit_tpu_torch.utils import logging as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = 4000
PAD = "x" * 110
CHILD = """
import sys, time
from smvp_toolkit_tpu_torch.utils.logging import log
start, who = float(sys.argv[1]), sys.argv[2]
while time.time() < start:
    pass
for i in range({lines}):
    log("DATA", f"{{who}} {{i:05d}} {pad}")
""".format(lines=LINES, pad=PAD)
LINE = re.compile(r"\[DATA\]\t(p[01]) (\d{5}) " + PAD)


def test_two_processes_on_one_pipe_keep_lines_whole():
    env = dict(os.environ, PYTHONPATH=ROOT, NO_COLOR="1")
    start = time.time() + 1.5
    read, write = os.pipe()
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, repr(start), who], stdout=write,
            env=env, cwd=ROOT) for who in ("p0", "p1")]
    finally:
        os.close(write)
    with os.fdopen(read, "r") as pipe:
        text = pipe.read()
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    seen = {"p0": [], "p1": []}
    bad = []
    for line in text.splitlines():
        m = LINE.fullmatch(line)
        if m is None:
            bad.append(line)
        else:
            seen[m.group(1)].append(int(m.group(2)))
    assert not bad, f"{len(bad)} broken line(s), e.g. {bad[0][:200]!r}"
    assert all(v == list(range(LINES)) for v in seen.values())


@pytest.mark.parametrize("tag, stream", [("DATA", "stdout"),
                                         ("ERROR", "stderr")])
def test_log_writes_one_line_and_flushes(tag, stream, monkeypatch):
    """One ``write`` of the whole line, then a flush, to stdout (stderr
    for ERROR); colours only when forced or on a TTY."""
    calls = []

    class Sink:
        def write(self, s):
            calls.append(("write", s))

        def flush(self):
            calls.append(("flush",))

        def isatty(self):
            return False

    sink = Sink()
    monkeypatch.setattr(sys, stream, sink)
    monkeypatch.setattr(L, "_forced_color", None)
    L.log(tag, "a message")
    assert calls == [("write", f"[{tag}]\ta message\n"), ("flush",)]
    calls.clear()
    monkeypatch.setattr(L, "_forced_color", True)
    L.log(tag, "a message")
    assert calls == [("write", f"{L._COLORS[tag]}[{tag}]\ta message"
                               f"{L._RESET}\n"), ("flush",)]
