"""The march kernel's share of its roofline over the window, in %: the
least time one H100 needs for the window's rays (the frozen bound,
``harness/work.py``, over the reference's work counts of the checked rays
scaled to every ray) over the summed device time of the march kernels'
records on all cards."""

from harness.readers import march_us


def read(rec):
    total_us = sum(march_us(rec))
    if total_us <= 0 or rec.get("bound_s") is None:
        return None
    return 100.0 * rec["bound_s"] / (total_us * 1e-6)
