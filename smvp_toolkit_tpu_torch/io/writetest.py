"""mtx writer test program (reference mmio-writetest.c:19-42).

Counterpart of the JAX package's ``io/writetest.py``: writes a fixed
4-nnz 10x10 real matrix to stdout, the reference's manual writer check:
``smvp-mtx-writetest-torch``. Host only.
"""

from __future__ import annotations

import sys

import numpy as np

from smvp_toolkit_tpu_torch.io.mtx import write_mtx


def main(argv=None) -> int:
    rows = np.array([0, 3, 6, 9])
    cols = np.array([0, 3, 6, 9])
    vals = np.array([1.0, 2.5, 3.5, 4.0])
    write_mtx(sys.stdout, rows, cols, vals, shape=(10, 10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
