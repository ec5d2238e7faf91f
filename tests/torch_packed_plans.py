"""The packed word plane with lanes that disagree with lane 0, numpy only,
shared by the CPU tests (tests/test_torch_packed_staging.py) and the card
tests (tests/test_torch_cuda.py).

The planner writes one rel into all 128 words of a sublane, and K5's
function reads a sublane's rel from its lane-0 word only (the JAX
``_unpack_plane``, the port's ``_unpack_word``, and K5's staging,
``PackedStage``). ``disagreeing_lanes`` rewrites the rel field of lanes
1..127 of every live sublane: odd lanes to 511 (dead), even lanes to
another tile of the chunk's window (0, or 1 where lane 0's rel is 0 and
the column tiles reach that far; else 511). Values and lane indices stay
as they were, so a kernel that reads rel from lane 0 gives the plane's
own y, and one that decodes rel per slot does not.
"""

from __future__ import annotations

import numpy as np

LANES = 128
REL_SHIFT, REL_DEAD = 7, 511


def word_rel(packed):
    """The rel field of every word, int64."""
    return (packed.astype(np.int64) & 0xFFFFFFFF) >> REL_SHIFT & REL_DEAD


def disagreeing_lanes(packed, slice_of, tile_base, *, chunk: int,
                      n_coltiles: int):
    """A copy of the (S, 128) int32 ``packed`` plane whose live sublanes'
    lanes 1..127 carry a rel other than lane 0's."""
    w = packed.reshape(-1, LANES).astype(np.int64) & 0xFFFFFFFF
    rel0 = word_rel(packed.reshape(-1, LANES))[:, 0]
    live = (rel0 != REL_DEAD) & (slice_of.reshape(-1) >= 0)
    s = np.arange(w.shape[0])
    room = tile_base.astype(np.int64)[s // chunk] + 1 < n_coltiles
    other = np.where(rel0 != 0, 0, np.where(room, 1, REL_DEAD))
    lane = np.arange(LANES)
    rel = np.where(lane % 2 == 1, REL_DEAD, other[:, None])
    rel[:, 0] = rel0
    rel = np.where(live[:, None], rel, word_rel(packed.reshape(-1, LANES)))
    out = (w & ~(REL_DEAD << REL_SHIFT)) | (rel << REL_SHIFT)
    return out.astype(np.uint32).view(np.int32).reshape(packed.shape)
