"""What more than one per-layer metric reader needs from the traced run's
record ``rec`` (see ``run.py``). Each metric's own arithmetic is in its
``metrics/<name>.py``."""

from __future__ import annotations

import re

# the names of the march kernels' device records, whatever launch form
MARCH = re.compile(r"march\w*_kernel")


def march_us(rec) -> list:
    """Per card, the device time (us) of the march kernels' records,
    clipped to the window."""
    t0, t1 = rec["trace"]["window_us"]
    return [sum(min(e, t1) - max(s, t0) for name, _, s, e, _ in evs
                if MARCH.search(name))
            for evs in rec["trace"]["device"].values()]
