"""Progress logging in the reference's observable format.

The reference's stderr lines ("[echelonize] round 0", "[pivots]
Faugère-Lachartre: N pivots found [0.0s]", README.md:19-41) double as its
algorithm's observable spec; we keep the same shape so logs are comparable.
A swappable callback mirrors libspasm's ``logcallback``
(src/SpaSM.jl:18-46)."""

from __future__ import annotations

import sys
import time

_callback = None
_enabled = False


def set_log(cb=None):
    """cb=None: silent; cb=True: stderr; cb=False: silent; else callable."""
    global _callback, _enabled
    if cb is True:
        _callback = None
        _enabled = True
    elif cb in (None, False):
        _callback = None
        _enabled = False
    else:
        _callback = cb
        _enabled = True


class push_verbose:
    """Context manager scoping verbosity (echelonize's `verbose` kwarg)."""

    def __init__(self, verbose):
        self.verbose = bool(verbose)

    def __enter__(self):
        global _enabled
        self.saved = _enabled
        _enabled = self.verbose
        return self

    def __exit__(self, *exc):
        global _enabled
        _enabled = self.saved
        return False


def is_verbose() -> bool:
    return _enabled


def log(msg: str):
    if not _enabled:
        return
    if _callback is not None:
        _callback(msg)
    else:
        print(msg, file=sys.stderr)


def wtime() -> float:
    """spasm_wtime (src/SpaSM.jl:430)."""
    return time.time()


def human_format(n: int) -> str:
    """Pretty big-number printing (``spasm_human_format``,
    src/SpaSM.jl:466-468)."""
    n = float(n)
    for unit in ("", "k", "M", "G", "T"):
        if abs(n) < 1000:
            s = f"{n:.1f}".rstrip("0").rstrip(".")
            return f"{s}{unit}"
        n /= 1000.0
    return f"{n:.1f}P"
