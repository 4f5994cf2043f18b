"""The share of the window in which no kernel, copy or set ran on a card,
averaged over the cell's cards, in %: 1 - (union of the card's device
records) / window."""

from harness.trace import busy_us


def read(rec):
    t0, t1 = rec["trace"]["window_us"]
    evs = rec["trace"]["device"]
    if not evs or t1 <= t0:
        return None
    idle = [1.0 - busy_us([(s, e) for _, _, s, e, _ in v], t0, t1)
            / (t1 - t0) for v in evs.values()]
    return 100.0 * sum(idle) / len(idle)
