"""Tagged, ANSI-colored console logging.

Same UX as the reference's color-macro printf tags
(``[START]/[FILE]/[INFO]/[DATA]/[DEBUG]/[ERROR]/[STOP]``, main-cli.c:25-32
and usage e.g. main-cli.c:1402,1417,1449).
"""

from __future__ import annotations

import os
import sys

__all__ = ["log", "set_color"]

_COLORS = {
    "START": "\x1b[32m",  # green
    "FILE": "\x1b[35m",  # magenta
    "INFO": "\x1b[33m",  # yellow
    "DATA": "\x1b[36m",  # cyan
    "DEBUG": "\x1b[34m",  # blue
    "ERROR": "\x1b[31m",  # red
    "STOP": "\x1b[32m",  # green
}
_RESET = "\x1b[0m"

_forced_color = None  # None = auto (per destination stream)


def set_color(enabled: bool) -> None:
    global _forced_color
    _forced_color = enabled


def _colorize(stream) -> bool:
    if _forced_color is not None:
        return _forced_color
    if os.environ.get("NO_COLOR") is not None:
        return False
    # Decide per destination: ERROR goes to stderr, which may be a tty
    # while stdout is piped (or vice versa).
    isatty = getattr(stream, "isatty", lambda: False)
    try:
        return bool(isatty())
    except (ValueError, OSError):  # closed stream
        return False


def log(tag: str, message: str, *, file=None) -> None:
    """Print a tagged line, colored when the destination is a TTY."""
    file = file or (sys.stderr if tag == "ERROR" else sys.stdout)
    color = _COLORS.get(tag, "")
    if color and _colorize(file):
        print(f"{color}[{tag}]\t{message}{_RESET}", file=file)
    else:
        print(f"[{tag}]\t{message}", file=file)
