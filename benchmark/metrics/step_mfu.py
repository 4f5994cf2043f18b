"""The whole window's share of the cards' peak, in %: the least time the
window's rays need on one H100 (the frozen bound, ``harness/work.py``)
over the cards times the window's length on the host's clock. It reads no
kernel record, so a kernel taken off the path leaves
``march_roofline_pct`` silent and this still bounds it from below."""


def read(rec):
    if rec.get("bound_s") is None or rec["elapsed_s"] <= 0:
        return None
    return 100.0 * rec["bound_s"] / (rec["cards"] * rec["elapsed_s"])
