"""MatrixMarket (.mtx) reading and writing (``io.mtx``), and the
reference's read and write test programs (``io.readtest``,
``io.writetest``).

The JAX package's ``io`` exports, loaded lazily, as the top-level
package's are.
"""

from __future__ import annotations

import importlib

_EXPORTS = {name: "mtx" for name in (
    "MMTypeCode", "MTXError", "MTXPrematureEOF", "MTXNoHeader",
    "MTXNotMatrix", "MTXUnsupportedType", "read_banner", "read_mtx",
    "read_mtx_raw", "write_mtx", "write_mtx_array")}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
