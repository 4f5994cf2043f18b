"""Milliseconds per frame or skybox in which the program's readback ran:
the length of the union, over the cards, of the device copy records that
the host enqueued inside the program's ``gamer.readback`` spans (the
uint8 frame's ``.cpu()``), over the window's frames or skyboxes."""

from harness.trace import busy_us, launched_in


def read(rec):
    corr = launched_in(rec["trace"], "gamer.readback")
    if not corr or rec["units"] <= 0:
        return None
    t0, t1 = rec["trace"]["window_us"]
    copies = [(s, e) for evs in rec["trace"]["device"].values()
              for _, cat, s, e, c in evs
              if c in corr and cat == "gpu_memcpy"]
    if not copies:
        return None
    return busy_us(copies, t0, t1) * 1e-3 / rec["units"]
