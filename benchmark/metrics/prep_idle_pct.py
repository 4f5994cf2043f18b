"""What host prep costs the card, in %: the share of the window in which
a card ran no kernel, copy or set while the host was inside one of the
program's ``gamer.prep`` spans, averaged over the cell's cards (as
``device_idle_pct``). Prep that overlaps a running kernel costs the host
(``host_prep_ms``) but not the card, and is not counted here."""

from harness.trace import busy_us, gaps


def read(rec):
    tr = rec["trace"]
    preps = tr["annotations"].get("gamer.prep")
    t0, t1 = tr["window_us"]
    if not preps or not tr["device"] or t1 <= t0:
        return None
    idle = [sum(busy_us(preps, s, e)
                for s, e in gaps([(s, e) for _, _, s, e, _ in evs], t0, t1))
            / (t1 - t0) for evs in tr["device"].values()]
    return 100.0 * sum(idle) / len(idle)
