"""MatrixMarket (.mtx) parser and writer.

Covers the capability surface of the reference's NIST mmio library
(reference mmio/mmio.c — ``mm_read_banner`` mmio.c:96-170,
``mm_read_mtx_crd_size`` mmio.c:180-208, typecode model mmio.h:31-73,
writers mmio.c:172-178,372-425) plus the CLI-side staging loop
(reference main-cli.c:1405-1441: sparse-only gate, pattern→1.0 values,
1-based→0-based index shift).

The port keeps its own copy of the JAX package's parser (numpy only) so
that it never imports that package, and its own native parser
(``io/native.py`` over ``csrc/mtxio.cpp``), which ``read_mtx`` takes by
default for uncompressed coordinate real, integer and pattern files, as
the JAX reader takes its own. Its triplets are bit-identical to the JAX
reader's, native or Python path.

Design differences from the reference (intentional):

* Parsing is vectorized host-side with numpy (``np.frombuffer`` on the
  whitespace-split payload) instead of a per-line ``fscanf`` loop.
* Symmetric / skew-symmetric / hermitian inputs can be *expanded* to full
  general form (``expand_symmetry=True``). The reference never expands
  (SURVEY.md §B7) — the default ``False`` reproduces its literal
  stored-entries-only behavior for golden compatibility.
* Errors are typed exceptions mirroring the mmio error codes
  (``MM_PREMATURE_EOF`` etc., mmio.h:76-83) rather than ``exit(1)``
  (reference main-cli.c:144-166).
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Optional, TextIO, Tuple, Union

import numpy as np

__all__ = [
    "MMTypeCode",
    "MTXError",
    "MTXPrematureEOF",
    "MTXNoHeader",
    "MTXNotMatrix",
    "MTXUnsupportedType",
    "read_banner",
    "read_mtx",
    "read_mtx_raw",
    "write_mtx",
]

MM_BANNER = "%%MatrixMarket"

# ---------------------------------------------------------------------------
# Errors (named after the mmio error codes, mmio.h:76-83)
# ---------------------------------------------------------------------------


class MTXError(Exception):
    """Base class for MatrixMarket I/O failures."""


class MTXPrematureEOF(MTXError):
    """File ended before the expected banner/size/data (MM_PREMATURE_EOF)."""


class MTXNoHeader(MTXError):
    """First line is not a %%MatrixMarket banner (MM_NO_HEADER)."""


class MTXNotMatrix(MTXError):
    """Banner object is not 'matrix' (MM_NOT_MTX)."""


class MTXUnsupportedType(MTXError):
    """Banner names an unsupported format/field combo (MM_UNSUPPORTED_TYPE)."""


# ---------------------------------------------------------------------------
# Typecode model (mmio.h:31-73 query/set macros)
# ---------------------------------------------------------------------------

_OBJECTS = ("matrix",)
_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "pattern", "complex")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclasses.dataclass(frozen=True)
class MMTypeCode:
    """Parsed banner type information.

    Python analog of the mmio 4-char ``MM_typecode`` (mmio.h:27) with the
    ``mm_is_*`` predicates (mmio.h:36-56) as properties and
    ``mm_typecode_to_str`` (mmio.c:428-483) as ``__str__``.
    """

    object: str = "matrix"
    format: str = "coordinate"
    field: str = "real"
    symmetry: str = "general"

    # --- mm_is_* predicates -------------------------------------------------
    @property
    def is_matrix(self) -> bool:
        return self.object == "matrix"

    @property
    def is_sparse(self) -> bool:  # mm_is_sparse == coordinate (mmio.h:38)
        return self.format == "coordinate"

    @property
    def is_coordinate(self) -> bool:
        return self.format == "coordinate"

    @property
    def is_dense(self) -> bool:
        return self.format == "array"

    @property
    def is_array(self) -> bool:
        return self.format == "array"

    @property
    def is_complex(self) -> bool:
        return self.field == "complex"

    @property
    def is_real(self) -> bool:
        return self.field == "real"

    @property
    def is_pattern(self) -> bool:
        return self.field == "pattern"

    @property
    def is_integer(self) -> bool:
        return self.field == "integer"

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"

    @property
    def is_general(self) -> bool:
        return self.symmetry == "general"

    @property
    def is_skew(self) -> bool:
        return self.symmetry == "skew-symmetric"

    @property
    def is_hermitian(self) -> bool:
        return self.symmetry == "hermitian"

    def __str__(self) -> str:
        return f"{self.object} {self.format} {self.field} {self.symmetry}"

    @staticmethod
    def parse(banner_line: str) -> "MMTypeCode":
        """Parse a ``%%MatrixMarket`` banner line (mm_read_banner, mmio.c:96-170)."""
        parts = banner_line.strip().split()
        if not parts or parts[0] != MM_BANNER:
            raise MTXNoHeader(
                f"first line is not a {MM_BANNER} banner: {banner_line!r}"
            )
        if len(parts) != 5:
            raise MTXPrematureEOF(f"banner has {len(parts) - 1} fields, expected 4")
        obj, fmt, field, symm = (p.lower() for p in parts[1:5])
        if obj not in _OBJECTS:
            raise MTXNotMatrix(f"unsupported MatrixMarket object {obj!r}")
        if fmt not in _FORMATS:
            raise MTXUnsupportedType(f"unsupported MatrixMarket format {fmt!r}")
        if field not in _FIELDS:
            raise MTXUnsupportedType(f"unsupported MatrixMarket field {field!r}")
        if symm not in _SYMMETRIES:
            raise MTXUnsupportedType(f"unsupported MatrixMarket symmetry {symm!r}")
        return MMTypeCode(obj, fmt, field, symm)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _open_text(source: Union[str, os.PathLike, TextIO]):
    if hasattr(source, "read"):
        return source, False
    path = os.fspath(source)
    if path.endswith(".gz"):
        # SuiteSparse ships .mtx.gz; stream-decompress transparently.
        import gzip

        return gzip.open(path, "rt"), True
    return open(path, "r"), True


def _open_text_write(dest: Union[str, os.PathLike]):
    """Writer counterpart of ``_open_text``: .gz paths gzip-compress so
    ``write_mtx`` output round-trips through ``read_mtx``."""
    path = os.fspath(dest)
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "wt")
    return open(path, "w")


def read_banner(source: Union[str, os.PathLike, TextIO]) -> MMTypeCode:
    """Read only the banner line of a ``.mtx`` file (mm_read_banner, mmio.c:96)."""
    f, close = _open_text(source)
    try:
        line = f.readline()
        if not line:
            raise MTXPrematureEOF("empty file: no MatrixMarket banner")
        return MMTypeCode.parse(line)
    finally:
        if close:
            f.close()


def _read_size_line(f: TextIO, typecode: MMTypeCode) -> Tuple[int, int, int]:
    """Skip comments and read the size line.

    Coordinate: ``M N nnz`` (mm_read_mtx_crd_size, mmio.c:180-208).
    Array: ``M N`` (mm_read_mtx_array_size, mmio.c:211-238); nnz = M*N.
    """
    for line in f:
        stripped = line.strip()
        if not stripped or stripped.startswith("%"):
            continue
        parts = stripped.split()
        try:
            if typecode.is_coordinate:
                if len(parts) != 3:
                    raise MTXError(f"bad coordinate size line: {stripped!r}")
                m, n, nnz = (int(p) for p in parts)
            else:
                if len(parts) != 2:
                    raise MTXError(f"bad array size line: {stripped!r}")
                m, n = (int(p) for p in parts)
                if typecode.is_general:
                    nnz = m * n
                elif typecode.is_skew:
                    # Strictly-lower triangle stored (MatrixMarket spec).
                    nnz = m * (m - 1) // 2
                else:  # symmetric / hermitian: lower triangle + diagonal
                    nnz = m * (m + 1) // 2
        except ValueError as e:
            raise MTXError(f"bad size line: {stripped!r}") from e
        if m < 0 or n < 0 or nnz < 0:
            raise MTXError(f"negative dimension in size line: {stripped!r}")
        if not typecode.is_general and m != n:
            # MatrixMarket symmetric/skew/hermitian matrices must be
            # square; a malformed rectangular declaration would otherwise
            # surface as a raw numpy error in the triangle enumeration.
            raise MTXError(
                f"{typecode.symmetry} matrix must be square, "
                f"got {m}x{n} in size line {stripped!r}"
            )
        return m, n, nnz
    raise MTXPrematureEOF("file ended before the size line")


def read_mtx_raw(
    source: Union[str, os.PathLike, TextIO],
) -> Tuple[MMTypeCode, int, int, np.ndarray, np.ndarray, np.ndarray]:
    """Read a ``.mtx`` file into raw (typecode, rows, cols, r, c, v) arrays.

    Stored entries only — no symmetry expansion, matching the reference's
    staging loop (main-cli.c:1426-1441): pattern entries get value 1.0 and
    indices are shifted 1-based → 0-based.

    Returns int32 index arrays and float64 (or complex128) values; value
    precision is kept at full f64 host-side so decode bit-exactness is
    defined on what the file stored (SURVEY.md §7 hard part (e)).
    """
    f, close = _open_text(source)
    try:
        line = f.readline()
        if not line:
            raise MTXPrematureEOF("empty file: no MatrixMarket banner")
        typecode = MMTypeCode.parse(line)
        if not typecode.is_matrix:
            raise MTXNotMatrix("only 'matrix' objects are supported")
        nrows, ncols, nnz = _read_size_line(f, typecode)
        payload = f.read()
    finally:
        if close:
            f.close()

    # Strip any trailing comment lines (rare but legal mid-file in practice
    # only before the size line; be permissive and drop % lines anywhere).
    if "%" in payload:
        payload = "\n".join(
            ln for ln in payload.splitlines() if not ln.lstrip().startswith("%")
        )

    tokens = payload.split()

    if typecode.is_array:
        # Dense array: column-major list of values (mmio spec). For
        # symmetric/skew/hermitian, only the (strictly-)lower triangle is
        # stored — mirror with expand_symmetric() if full form is wanted.
        want = nnz if not typecode.is_complex else 2 * nnz
        if typecode.is_pattern:
            raise MTXUnsupportedType("array + pattern is invalid MatrixMarket")
        if len(tokens) < want:
            raise MTXPrematureEOF(
                f"expected {want} array values, found {len(tokens)}"
            )
        try:
            flat = np.array(tokens[:want], dtype=np.float64)
        except ValueError as e:
            raise MTXError(f"malformed array value: {e}") from e
        if typecode.is_complex:
            vals = flat[0::2] + 1j * flat[1::2]
        else:
            vals = flat
        if typecode.is_general:
            # Column-major order → (row, col) indices.
            cc, rr = np.meshgrid(np.arange(ncols), np.arange(nrows))
            r = rr.T.reshape(-1).astype(np.int32)  # col-major enumeration
            c = cc.T.reshape(-1).astype(np.int32)
        else:
            # Column-major lower triangle (diagonal excluded for skew).
            off = 1 if typecode.is_skew else 0
            cols_list = [
                np.full(nrows - j - off, j, dtype=np.int32)
                for j in range(ncols)
            ]
            rows_list = [
                np.arange(j + off, nrows, dtype=np.int32)
                for j in range(ncols)
            ]
            c = np.concatenate(cols_list) if cols_list else np.empty(0, np.int32)
            r = np.concatenate(rows_list) if rows_list else np.empty(0, np.int32)
        return typecode, nrows, ncols, r, c, vals

    # Coordinate format.
    if typecode.is_pattern:
        per = 2
    elif typecode.is_complex:
        per = 4
    else:
        per = 3
    want = per * nnz
    if len(tokens) < want:
        raise MTXPrematureEOF(
            f"expected {nnz} coordinate entries ({want} tokens), "
            f"found {len(tokens)} tokens"
        )
    try:
        flat = np.array(tokens[:want], dtype=np.float64).reshape(nnz, per)
    except ValueError as e:
        raise MTXError(f"malformed coordinate entry: {e}") from e
    r = flat[:, 0].astype(np.int32) - 1  # 1-based → 0-based (main-cli.c:1437-1438)
    c = flat[:, 1].astype(np.int32) - 1
    if typecode.is_pattern:
        v = np.ones(nnz, dtype=np.float64)  # pattern → 1.0 (main-cli.c:1430-1431)
    elif typecode.is_complex:
        v = flat[:, 2] + 1j * flat[:, 3]
    else:
        v = flat[:, 2]
    if nnz and (r.min() < 0 or r.max() >= nrows or c.min() < 0 or c.max() >= ncols):
        raise MTXError("coordinate index out of declared bounds")
    return typecode, nrows, ncols, r, c, v


def expand_symmetric(
    typecode: MMTypeCode,
    r: np.ndarray,
    c: np.ndarray,
    v: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand stored lower-triangle entries to the full matrix.

    New capability — the reference never expands (SURVEY.md §B7).
    symmetric: A[j,i] = A[i,j]; skew: A[j,i] = -A[i,j] (diagonal must be
    absent/zero per spec); hermitian: A[j,i] = conj(A[i,j]).
    """
    if typecode.is_general:
        return r, c, v
    off = r != c
    ro, co, vo = r[off], c[off], v[off]
    if typecode.is_skew:
        vm = -vo
    elif typecode.is_hermitian:
        vm = np.conj(vo)
    else:
        vm = vo
    return (
        np.concatenate([r, co]),
        np.concatenate([c, ro]),
        np.concatenate([v, vm]),
    )


def read_mtx(
    source: Union[str, os.PathLike, TextIO],
    *,
    expand_symmetry: bool = False,
    dtype=None,
    device=None,
    use_native: bool = True,
):
    """Read a ``.mtx`` file into a
    :class:`~smvp_toolkit_tpu_torch.formats.coo.COOMatrix` on ``device``.

    ``use_native=True`` reads a path that does not end in ``.gz`` with the
    native parser (``io/native.py``); files it does not take (array,
    complex) go to the Python parser, as in the JAX reader. An empty file
    then reads as the JAX native reader words it, "truncated header".

    ``expand_symmetry=False`` reproduces the reference's literal behavior of
    multiplying only stored entries (SURVEY.md §B7); ``True`` performs
    mathematically-correct symmetric expansion.

    ``dtype`` is a torch dtype (default ``torch.float32``; complex files
    default to ``torch.complex64`` and refuse a real dtype). ``device``
    follows the port's rule: ``cuda`` unless ``"cpu"`` is passed.
    """
    import torch

    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    result = None
    if (use_native and isinstance(source, (str, os.PathLike))
            and not os.fspath(source).endswith(".gz")):
        from smvp_toolkit_tpu_torch.io import native

        try:
            result = native.read_mtx_raw_native(os.fspath(source))
        except native.NativeUnavailable:
            result = None
    if result is None:
        result = read_mtx_raw(source)
    typecode, nrows, ncols, r, c, v = result
    if not typecode.is_general and nrows != ncols:
        # The Python parser refuses this at the size line; the native one
        # does not, so the gate is repeated here, as in the JAX reader.
        raise MTXError(
            f"{typecode.symmetry} matrix must be square, "
            f"got {nrows}x{ncols}"
        )
    if expand_symmetry:
        r, c, v = expand_symmetric(typecode, r, c, v)
        # The triplets now hold the FULL matrix: retype as general, or
        # every typecode-aware consumer would mirror the off-diagonals a
        # second time.
        typecode = dataclasses.replace(typecode, symmetry="general")
    if np.iscomplexobj(v):
        if dtype is None:
            dtype = torch.complex64
        elif not dtype.is_complex:
            # Refuse to silently drop imaginary parts.
            raise MTXUnsupportedType(
                "complex matrix requires a complex dtype "
                "(e.g. dtype=torch.complex64)"
            )
    return COOMatrix.from_numpy(
        r, c, v, shape=(nrows, ncols), typecode=typecode, dtype=dtype,
        device=device,
    )


# ---------------------------------------------------------------------------
# Writing (mm_write_banner mmio.c:372-383, mm_write_mtx_crd mmio.c:248-300)
# ---------------------------------------------------------------------------


def write_mtx(
    dest: Union[str, os.PathLike, TextIO],
    rows: np.ndarray,
    cols: np.ndarray,
    vals: Optional[np.ndarray],
    shape: Tuple[int, int],
    *,
    field: Optional[str] = None,
    symmetry: str = "general",
    comment: Optional[str] = None,
) -> None:
    """Write a coordinate ``.mtx`` file (0-based inputs, 1-based on disk)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if field is None:
        if vals is None:
            field = "pattern"
        elif np.iscomplexobj(vals):
            field = "complex"
        elif np.asarray(vals).dtype.kind in "iu":
            field = "integer"
        else:
            field = "real"
    typecode = MMTypeCode("matrix", "coordinate", field, symmetry)

    buf = _io.StringIO()
    buf.write(f"{MM_BANNER} {typecode}\n")
    if comment:
        for line in comment.splitlines():
            buf.write(f"%{line}\n")
    buf.write(f"{shape[0]} {shape[1]} {len(rows)}\n")
    if field == "pattern":
        for r, c in zip(rows, cols):
            buf.write(f"{int(r) + 1} {int(c) + 1}\n")
    elif field == "complex":
        for r, c, v in zip(rows, cols, vals):
            buf.write(f"{int(r) + 1} {int(c) + 1} {v.real:.17g} {v.imag:.17g}\n")
    elif field == "integer":
        for r, c, v in zip(rows, cols, vals):
            buf.write(f"{int(r) + 1} {int(c) + 1} {int(v)}\n")
    else:
        for r, c, v in zip(rows, cols, vals):
            buf.write(f"{int(r) + 1} {int(c) + 1} {float(v):.17g}\n")

    text = buf.getvalue()
    if hasattr(dest, "write"):
        dest.write(text)
    else:
        with _open_text_write(dest) as f:
            f.write(text)
