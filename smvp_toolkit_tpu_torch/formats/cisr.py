"""CISR (Compressed Interleaved Sparse Row) codec + Vivado ``.coe`` emitter.

Counterpart of the JAX package's ``formats/cisr.py``, the reference's
``smvp_cisr_coegen`` (main-cli.c:473-729): rows are scheduled round-robin
onto ``slot_count`` parallel channels (the FPGA consumer's lanes); each
slot streams its row's nonzeros one per "slot group" (a clock beat across
all channels), picking up the next unassigned row when its row is
exhausted; exhausted slots emit zero padding. The packed ``.coe`` memory
image interleaves value words with row-length words (packing spec per the
reference comment main-cli.c:673-688).

As in the JAX package:

* The scheduler is the C++ pass ``csrc/cisr.cpp`` (built by
  ``ops/_build.py`` on first use; a failed build raises). The per-beat
  Python loop runs where the caller asks (``use_native=False``) or for
  complex values, and equals the native pass element for element.
* Empty rows consume a row-length record of 0 and no slot beats (the
  reference mis-emits the next row's first entry for empty rows).
* Packing masks fields to their widths (value 12 bits, col 12 bits, slot
  8 bits); the truncation of values into 12 bits is the reference
  format's.

The schedule is host data (numpy arrays), as in the JAX package: it is a
wire format, and its SpMVs run from it on a device (``ops/spmv_cisr.py``,
``ops/spmv_sell.spmv_cisr_sell``). ``write_coe`` builds the text with
numpy (a 10M-entry schedule gives about 10M lines), byte for byte the JAX
emitter's per-word loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import io as _io
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from smvp_toolkit_tpu_torch.formats.coo import COOMatrix, host_array
from smvp_toolkit_tpu_torch.formats.csr import CSRMatrix

__all__ = ["CISRMatrix", "cisr_encode", "cisr_decode", "pack_value_word",
           "pack_rowlen_word", "write_coe"]

_START_WORD = 0xAAAAAAAA
_END_WORD = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True, eq=False)
class CISRMatrix:
    """CISR interleaved-channel schedule (host-side numpy arrays).

    ``vals``/``col_ind`` have shape (num_groups, slot_count): element
    [g, s] is what channel ``s`` consumes at beat ``g`` (0/0 padding when
    idle). ``row_of`` carries the matrix row feeding [g, s] (-1 when idle)
    — derived scratch for decode/SpMV, not part of the wire format.
    ``row_lengths`` is the per-row nnz stream in row-pickup order.
    ``eq=False`` keeps identity hashing, so a schedule can key the
    operator caches weakly.
    """

    vals: np.ndarray  # float64[num_groups, slot_count]
    col_ind: np.ndarray  # int32[num_groups, slot_count]
    row_of: np.ndarray  # int32[num_groups, slot_count], -1 = idle
    row_lengths: np.ndarray  # int32[nrows]
    slot_count: int
    shape: Tuple[int, int]
    nnz: int

    @property
    def num_groups(self) -> int:
        return int(self.vals.shape[0])

    def __repr__(self) -> str:
        return (
            f"CISRMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"slots={self.slot_count}, groups={self.num_groups})"
        )


def _csr_host(matrix: Union[COOMatrix, CSRMatrix]):
    """Row-major CSR arrays on host from either a COO or CSR input."""
    if isinstance(matrix, CSRMatrix):
        row_ptr = matrix.row_ptr.cpu().numpy().astype(np.int64)
        col = matrix.col_ind[: matrix.nnz].cpu().numpy()
        val = host_array(matrix.vals[: matrix.nnz])
        return row_ptr, col, val, matrix.shape, matrix.nnz
    r, c, v = matrix.to_numpy()
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    row_ptr = np.searchsorted(r, np.arange(matrix.shape[0] + 1)).astype(
        np.int64)
    return row_ptr, c, v, matrix.shape, matrix.nnz


_LL = ctypes.c_longlong
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "cisr_num_groups": (_LL, [_I64P, _LL, ctypes.c_int]),
    "cisr_schedule": (ctypes.c_int, [_I64P, _I32P, _F64P, _LL, ctypes.c_int,
                                     _LL, _F64P, _I32P, _I32P, _I32P]),
}


def _cisr_encode_native(row_ptr, col, val, shape, nnz, slot_count):
    """The C++ scheduler (the same schedule as the Python loop)."""
    from smvp_toolkit_tpu_torch.ops import _build

    lib = _build.load("cisr", _SIGNATURES)
    nrows = shape[0]
    rp = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cc = np.ascontiguousarray(col, dtype=np.int32)
    vv = np.ascontiguousarray(val, dtype=np.float64)
    beats = int(lib.cisr_num_groups(rp, nrows, slot_count))
    out_val = np.zeros((beats, slot_count), dtype=np.float64)
    out_col = np.zeros((beats, slot_count), dtype=np.int32)
    out_row = np.full((beats, slot_count), -1, dtype=np.int32)
    row_lengths = np.zeros(max(nrows, 1), dtype=np.int32)
    rc = lib.cisr_schedule(
        rp, cc, vv, nrows, slot_count, beats,
        out_val.reshape(-1), out_col.reshape(-1), out_row.reshape(-1),
        row_lengths,
    )
    if rc != 0:
        raise RuntimeError(f"cisr_schedule failed with code {rc}")
    return CISRMatrix(
        vals=out_val,
        col_ind=out_col,
        row_of=out_row,
        row_lengths=row_lengths[:nrows],
        slot_count=slot_count,
        shape=shape,
        nnz=nnz,
    )


def cisr_encode(
    matrix: Union[COOMatrix, CSRMatrix],
    slot_count: int = 16,
    *,
    use_native: bool = True,
) -> CISRMatrix:
    """Schedule CSR rows onto ``slot_count`` interleaved channels.

    Greedy row pickup in row order, matching the reference scheduler
    (main-cli.c:542-612): slot s takes the next unassigned row whenever its
    current row is exhausted; beats where a slot has no work emit (0, 0).

    ``use_native=True`` runs the C++ scheduler (``csrc/cisr.cpp``); the
    per-beat Python loop below runs for ``use_native=False`` and for
    complex values (the C++ pass is float64 only).
    """
    if slot_count < 1:
        raise ValueError("slot_count must be >= 1")
    row_ptr, col, val, shape, nnz = _csr_host(matrix)
    if use_native and not np.iscomplexobj(np.asarray(val)):
        return _cisr_encode_native(row_ptr, col, val, shape, nnz, slot_count)
    nrows = shape[0]
    row_len = np.diff(row_ptr).astype(np.int64)

    # Assign rows to slots by greedy pickup, tracking per-slot cursors.
    vals_out: List[list] = [[] for _ in range(slot_count)]
    cols_out: List[List[int]] = [[] for _ in range(slot_count)]
    rows_out: List[List[int]] = [[] for _ in range(slot_count)]
    row_lengths: List[int] = []

    next_row = 0
    cursor = np.zeros(slot_count, dtype=np.int64)  # nnz index per slot
    remaining = np.zeros(slot_count, dtype=np.int64)  # left in its row

    def _pickup(s: int) -> bool:
        """Give slot s its next non-empty row; record empty rows' lengths."""
        nonlocal next_row
        while next_row < nrows:
            r = next_row
            next_row += 1
            row_lengths.append(int(row_len[r]))
            if row_len[r] > 0:
                cursor[s] = row_ptr[r]
                remaining[s] = row_len[r]
                rows_out[s].extend([r] * int(row_len[r]))
                return True
        return False

    active = np.zeros(slot_count, dtype=bool)
    for s in range(slot_count):
        active[s] = _pickup(s)

    cplx = np.iscomplexobj(val)
    while active.any():
        for s in range(slot_count):
            if active[s]:
                j = cursor[s]
                vals_out[s].append(complex(val[j]) if cplx else float(val[j]))
                cols_out[s].append(int(col[j]))
                cursor[s] += 1
                remaining[s] -= 1
                if remaining[s] == 0:
                    active[s] = _pickup(s)
            else:
                vals_out[s].append(0.0)
                cols_out[s].append(0)
                rows_out[s].append(-1)

    num_groups = max((len(v) for v in vals_out), default=0)
    vals_arr = np.zeros((num_groups, slot_count),
                        dtype=np.complex128 if cplx else np.float64)
    cols_arr = np.zeros((num_groups, slot_count), dtype=np.int32)
    rowof_arr = np.full((num_groups, slot_count), -1, dtype=np.int32)
    for s in range(slot_count):
        n = len(vals_out[s])
        vals_arr[:n, s] = vals_out[s]
        cols_arr[:n, s] = cols_out[s]
        rowof_arr[: len(rows_out[s]), s] = rows_out[s]

    # Rows never picked up (trailing empty rows after the last pickup).
    while len(row_lengths) < nrows:
        row_lengths.append(0)

    return CISRMatrix(
        vals=vals_arr,
        col_ind=cols_arr,
        row_of=rowof_arr,
        row_lengths=np.asarray(row_lengths, dtype=np.int32),
        slot_count=slot_count,
        shape=shape,
        nnz=nnz,
    )


def cisr_decode(cisr: CISRMatrix, *, device=None) -> COOMatrix:
    """Reconstruct COO triplets from the CISR schedule (round-trip
    check), in canonical row-major order, on ``device`` (default: the
    card). The values keep the schedule's float64 (complex128) values."""
    mask = cisr.row_of >= 0
    r = cisr.row_of[mask].astype(np.int32)
    c = cisr.col_ind[mask].astype(np.int32)
    v = cisr.vals[mask]
    order = np.lexsort((c, r))
    dtype = torch.complex128 if np.iscomplexobj(v) else torch.float64
    return COOMatrix.from_numpy(r[order], c[order], v[order],
                                shape=cisr.shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# .coe emission (packing spec per reference comment main-cli.c:673-688)
# ---------------------------------------------------------------------------


def pack_value_word(val: float, col: int, slot: int) -> int:
    """Control code 1 payload: VVV III NN (12b value, 12b col, 8b slot).

    The reference packs ``(int)val << 20 | col << 8 | slot``
    (main-cli.c:703); each field is masked to its documented width
    instead of relying on shift overflow (SURVEY.md §B8). ``int(val)``
    truncates toward zero, so a negative value packs as its wrapped low
    bits.
    """
    return ((int(val) & 0xFFF) << 20) | ((int(col) & 0xFFF) << 8) | (
        int(slot) & 0xFF)


def pack_rowlen_word(len_a: int, len_b: Optional[int]) -> int:
    """Control code 2 payload: VAAA VBBB (valid bit + 12b length, twice)."""
    word = (1 << 28) | ((int(len_a) & 0xFFF) << 16)
    if len_b is not None:
        word |= (1 << 12) | (int(len_b) & 0xFFF)
    return word


_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def _word_lines(code: bytes, words: np.ndarray) -> np.ndarray:
    """(n, 12) uint8: ``<code><8 hex digits>,\\n`` per 32-bit word."""
    words = words.astype(np.uint64)
    out = np.empty((words.shape[0], 12), dtype=np.uint8)
    out[:, 0], out[:, 1] = code[0], code[1]
    for k in range(8):
        out[:, 2 + k] = _HEX[(words >> np.uint64(28 - 4 * k)) & np.uint64(15)]
    out[:, 10], out[:, 11] = ord(","), ord("\n")
    return out


def _value_words(cisr: CISRMatrix) -> np.ndarray:
    """``pack_value_word`` of every cell, vectorized: the value's integer
    part (truncated toward zero) mod 4096 is exact in float64 (``fmod``),
    the same low 12 bits as Python's ``int(val) & 0xFFF``."""
    v = cisr.vals.reshape(-1)
    if not np.isfinite(v).all():
        raise ValueError("the COE packed format holds finite values only; "
                         "cannot pack NaN or Inf")
    low = np.mod(np.trunc(v), 4096.0).astype(np.int64)
    col = cisr.col_ind.reshape(-1).astype(np.int64) & 0xFFF
    slot = np.tile(np.arange(cisr.slot_count, dtype=np.int64) & 0xFF,
                   cisr.num_groups)
    return (low << 20) | (col << 8) | slot


def _rowlen_words(rl: np.ndarray) -> np.ndarray:
    """``pack_rowlen_word`` of each pair of row lengths (a last odd one
    alone)."""
    rl = rl.astype(np.int64)
    a = rl[0::2]
    b = rl[1::2]
    words = (1 << 28) | ((a & 0xFFF) << 16)
    words[: b.shape[0]] |= (1 << 12) | (b & 0xFFF)
    return words


def write_coe(
    cisr: CISRMatrix,
    dest: Union[str, "_io.TextIOBase", None] = None,
) -> str:
    """Emit the Vivado single-port-BRAM ``.coe`` image for a CISR schedule.

    Stream layout matches the reference emitter (main-cli.c:690-728): a
    start word, then per beat×slot one value word, each followed by a
    row-length word (two lengths per word) while lengths remain, the
    row-length words beyond the value words after them, then an end word.
    Returns the text; optionally writes to ``dest``.
    """
    if np.iscomplexobj(cisr.vals):
        raise ValueError(
            "the COE packed format is real-valued (12-bit integer value "
            "field, main-cli.c:673-688); cannot pack a complex matrix"
        )
    head = "\n".join([
        ";*********************************************",
        ";* CISR COE File for Vivado Single-Port BRAM *",
        ";*********************************************",
        "",
        f";Generated with a slot/channel count of: {cisr.slot_count}",
        "",
        "memory_initialization_radix=16;",
        "memory_initialization_vector=",
        f"00{_START_WORD:08x},",
    ]) + "\n"
    vw = _word_lines(b"01", _value_words(cisr))
    rw = _word_lines(b"02", _rowlen_words(cisr.row_lengths[: cisr.shape[0]]))
    # Value word i is followed by row-length word i while both last; then
    # the longer stream's rest (row-length words beyond 2x the value words
    # arise when many rows are empty).
    m = min(vw.shape[0], rw.shape[0])
    body = np.concatenate([
        np.stack([vw[:m], rw[:m]], axis=1).reshape(-1),
        vw[m:].reshape(-1), rw[m:].reshape(-1),
    ])
    text = head + body.tobytes().decode("ascii") + f"03{_END_WORD:08x};\n"
    if dest is None:
        return text
    if hasattr(dest, "write"):
        dest.write(text)
    else:
        with open(dest, "w") as f:
            f.write(text)
    return text
