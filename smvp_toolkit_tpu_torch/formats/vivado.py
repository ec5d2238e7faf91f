"""Vivado hardware-image emitters (parameterized, opt-in).

Counterpart of the JAX package's ``formats/vivado.py``. The reference
unconditionally prints about 730k lines of Verilog LUT assignments for a
hardcoded 10x36520 grid after every TJDS run (main-cli.c:1031-1064,
SURVEY.md §B5 — dead FPGA-debug code that segfaults on small inputs).
The capability worth keeping is "export a packed hardware image": here
``write_tjds_lut`` emits the same LUT assignment format for the grid of
the actual matrix, and the CISR ``.coe`` emitter lives in
``formats/cisr.py``.
"""

from __future__ import annotations

import io as _io
from typing import Optional, Union

from smvp_toolkit_tpu_torch.formats.tjds import TJDSMatrix

__all__ = ["write_tjds_lut"]


def write_tjds_lut(
    tjds: TJDSMatrix,
    dest: Union[str, "_io.TextIOBase", None] = None,
    *,
    max_diags: Optional[int] = None,
    signal: str = "tjds_lut",
) -> str:
    """Emit Verilog LUT assignments for the TJDS row-index grid.

    One assignment per (diagonal, position) cell, bounded by the true
    diagonal count (the reference hardcodes a 10x36520 grid and reads out
    of bounds on smaller matrices — here the grid is the matrix's own).
    The text is byte for byte the JAX emitter's.
    """
    nd = int(tjds.num_diags)
    if max_diags is not None:
        nd = min(nd, max_diags)
    sp = tjds.start_pos[: nd + 1].cpu().tolist()
    row_ind = tjds.row_ind.cpu().numpy()
    lines = []
    for d in range(nd):
        lo, hi = sp[d], sp[d + 1]
        lines.extend(f"assign {signal}[{d}][{pos}] = {r};"
                     for pos, r in enumerate(row_ind[lo:hi].tolist()))
    text = "\n".join(lines) + ("\n" if lines else "")
    if dest is None:
        return text
    if hasattr(dest, "write"):
        dest.write(text)
    else:
        with open(dest, "w") as f:
            f.write(text)
    return text
