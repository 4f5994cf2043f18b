"""Device milliseconds per frame or skybox of the program's epilogue
(pooling, star overlay, post chain, the batch's stack): the device
records of the launches and copies the host enqueued inside the
program's ``gamer.epilogue`` spans, summed over the cards, over the
window's frames or skyboxes."""

from harness.trace import launched_in


def read(rec):
    corr = launched_in(rec["trace"], "gamer.epilogue")
    if not corr or rec["units"] <= 0:
        return None
    t0, t1 = rec["trace"]["window_us"]
    us = sum(min(e, t1) - max(s, t0)
             for evs in rec["trace"]["device"].values()
             for _, _, s, e, c in evs if c in corr)
    return us * 1e-3 / rec["units"]
