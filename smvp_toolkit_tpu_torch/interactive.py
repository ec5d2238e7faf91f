"""Interactive front end: the working analog of the reference GUI.

Counterpart of the JAX package's ``interactive.py``. The reference ships
a GTK3 window whose callbacks are empty stubs and whose build target is
commented out (main-gui.c:31-50, CMakeLists.txt:25,31). Its intended use,
pick a matrix file, choose CSR and/or TJDS, set the iteration count, run,
is a terminal dialog here that drives the port's CLI:
``python -m smvp_toolkit_tpu_torch.interactive``. The run is on the card
unless the last question (device) is answered ``cpu``.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from smvp_toolkit_tpu_torch.utils.logging import log

__all__ = ["main"]


def _ask(prompt: str, default: str, stdin, stdout) -> Optional[str]:
    """Prompt once; None on end of input (the caller aborts, not loops)."""
    stdout.write(f"{prompt} [{default}]: ")
    stdout.flush()
    line = stdin.readline()
    if not line:  # end of input, not a blank line ("\n")
        return None
    return line.strip() or default


def main(argv: Optional[List[str]] = None, stdin=None, stdout=None) -> int:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    stdout.write("smvp-toolkit-tpu-torch interactive benchmark\n")
    stdout.write("--------------------------------------------\n")

    path = _ask("Matrix (.mtx) file", "", stdin, stdout)
    while path is not None and (not path or not os.path.exists(path)):
        if path:
            stdout.write(f"file not found: {path}\n")
        path = _ask("Matrix (.mtx) file", "", stdin, stdout)
    if path is None:
        log("ERROR", "no input file provided (EOF)")
        return 2

    answers = [
        _ask("Run CSR? (y/n)", "y", stdin, stdout),
        _ask("Run TJDS? (y/n)", "y", stdin, stdout),
        _ask("Iterations", "1000", stdin, stdout),
        _ask("Report directory", ".", stdin, stdout),
        _ask("Device (cuda/cpu)", "cuda", stdin, stdout),
    ]
    if any(a is None for a in answers):
        log("ERROR", "aborted (EOF)")
        return 2
    run_csr = answers[0].lower().startswith("y")
    run_tjds = answers[1].lower().startswith("y")
    try:
        iters_n = max(int(answers[2]), 1)
    except ValueError:
        iters_n = 1000
    report_dir = answers[3]
    device = "cpu" if answers[4].lower() == "cpu" else "cuda"

    if not (run_csr or run_tjds):
        log("ERROR", "nothing selected")
        return 2

    from smvp_toolkit_tpu_torch.cli import main as cli_main

    args = []
    if run_csr:
        args.append("-c")
    if run_tjds:
        args.append("-t")
    args += ["-n", str(iters_n), "--device", device]
    if report_dir and report_dir != ".":
        args += ["-d", report_dir]
    args.append(path)
    return cli_main(args)


if __name__ == "__main__":
    sys.exit(main())
