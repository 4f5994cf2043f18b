"""Device milliseconds per frame of the copies that place each card's
share into the frame on the first card: the device records of the
launches and copies the host enqueued inside the benchmark's span around
``cuda_render._gather``."""

from harness.trace import launched_in


def read(rec):
    corr = launched_in(rec["trace"], "assembly")
    if not corr or rec["units"] <= 0:
        return None
    t0, t1 = rec["trace"]["window_us"]
    us = sum(min(e, t1) - max(s, t0)
             for evs in rec["trace"]["device"].values()
             for _, _, s, e, c in evs if c in corr)
    return us * 1e-3 / rec["units"]
