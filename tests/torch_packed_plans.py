"""The packed word plane with lanes that disagree with lane 0, numpy only,
shared by the CPU tests (tests/test_torch_packed_staging.py,
tests/test_torch_packed_bench_staging.py) and the card tests
(tests/test_torch_cuda.py).

The planner writes one rel into all 128 words of a sublane, and the packed
kernels' function reads a sublane's rel from its lane-0 word only (the JAX
``_unpack_plane``, the port's ``_unpack_word``, K5's and K2-packed's
staging, ``PackedStage``, and K5-with-k-columns' decode,
``PackedLaneZero``). ``disagreeing_lanes`` (``bench/bench_variants.py``,
which ``chip_smoke.py`` uses too) rewrites the rel field of lanes 1..127
of every live sublane: odd lanes to 511 (dead), even lanes to another tile
of the chunk's window (0, or 1 where lane 0's rel is 0 and the column
tiles reach that far; else 511). Values and lane indices stay as they
were, so a kernel that reads rel from lane 0 gives the plane's own y, and
one that decodes rel per slot does not.
"""

from __future__ import annotations

import numpy as np

from smvp_toolkit_tpu_torch.bench.bench_variants import disagreeing_lanes

__all__ = ["LANES", "REL_SHIFT", "REL_DEAD", "word_rel", "disagreeing_lanes"]

LANES = 128
REL_SHIFT, REL_DEAD = 7, 511


def word_rel(packed):
    """The rel field of every word, int64."""
    return (packed.astype(np.int64) & 0xFFFFFFFF) >> REL_SHIFT & REL_DEAD
