"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout,
keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once. Several sources build in parallel:
one ``nvcc`` each, all started together. A failed build raises with
nvcc's output; there is no fallback.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "KernelBuildError",
    "NVCC_FLAGS",
    "build",
    "build_dir",
    "load",
    "sources",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills into the log
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def build_dir() -> Path:
    """``build/kernels`` beside the package (listed in .gitignore)."""
    return _CSRC.parent.parent / "build" / "kernels"


def sources() -> Tuple[str, ...]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return tuple(sorted(p.stem for p in _CSRC.glob("*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels build only on a machine with the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every named source that is not built yet, in parallel.

    Returns ``{name: nvcc output}`` for the sources built by this call
    (ptxas's register and spill report among it).
    """
    names = sources() if names is None else tuple(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, out, tmp, cmd, proc in procs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
            out.with_suffix(".log").write_text(text)
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str,
         signatures: Dict[str, Tuple[object, Sequence[object]]]
         ) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C function to ``(restype, argtypes)``; they
    are declared once, when the library is first loaded.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _LIBS[name] = lib
        return lib

