"""Scoped wall-clock timers — Q_TIMER_START/Q_TIMER_ELAPSED parity
(source/util/util.h:24-31) plus the ms->string formatter (util.h:143-177).

A copy of ``gamer_tpu.utils.timers``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

import time
from typing import Optional

from .log import Messages


def format_ms(ms: float) -> str:
    """Human-readable elapsed time like the reference's MilisecondToString."""
    ms = max(0.0, float(ms))
    h, rem = divmod(int(ms), 3600_000)
    m, rem = divmod(rem, 60_000)
    s, rem = divmod(rem, 1000)
    ds = rem // 100
    out = ""
    if h:
        out += f"{h}h "
    if m:
        out += f"{m}m "
    return out + f"{s}.{ds}s"


class ScopedTimer:
    """`with ScopedTimer("Rendering"):` logs '<name> took <t>' on exit."""

    def __init__(self, name: str, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.elapsed_ms: Optional[float] = None

    def __enter__(self) -> "ScopedTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
        if not self.quiet:
            Messages.message(f"{self.name} took {format_ms(self.elapsed_ms)}")
