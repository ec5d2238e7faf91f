"""mtx read round-trip test program (reference mmio-readtest.c:29-101).

Counterpart of the JAX package's ``io/readtest.py``: reads a MatrixMarket
file and writes it back to stdout, the reference's manual I/O check, as a
console entry point: ``smvp-mtx-readtest-torch f.mtx``. Host only.
"""

from __future__ import annotations

import sys

from smvp_toolkit_tpu_torch.io.mtx import read_mtx_raw, write_mtx


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: smvp-mtx-readtest-torch <file.mtx>", file=sys.stderr)
        return 2
    typecode, nrows, ncols, r, c, v = read_mtx_raw(argv[0])
    write_mtx(
        sys.stdout,
        r,
        c,
        None if typecode.is_pattern else v,
        shape=(nrows, ncols),
        field=typecode.field,
        symmetry=typecode.symmetry,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
