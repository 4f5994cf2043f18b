"""The check of a generator whose answers are pixels of frames.

A generator hands over ``groups``: (scene, views, got), where ``scene`` is
a dict of the configuration's ``instances`` and ``config`` as the frames of
that group were rendered, ``views`` a list of (camera dict, size, flat
pixel indices) as each frame was asked for, and ``got`` the program's
uint8 (N, 3) of those pixels in the same order (None before a run). The
plain reference recomputes every view's pixels from the scene; nothing of
the program is read but ``got``."""

from __future__ import annotations

import numpy as np

from . import oracle
from .cell import rng


def sampled(config: dict, frames, max_rays: int, seed: int) -> list:
    """One (scene, views, got) group of the configuration's ``frames``:
    (camera, size, kept flat pixel indices, their uint8 values or None),
    each thinned to a sample drawn from the seed, so that about
    ``max_rays`` rays are checked in all and some of every frame."""
    total = sum(len(px) for _, _, px, _ in frames)
    keep = min(1.0, max_rays / max(total, 1))
    r = rng(seed, "check")
    views, got = [], []
    for cam, size, px, g in frames:
        m = max(1, int(round(len(px) * keep)))
        sel = np.sort(r.choice(len(px), m, replace=False))
        views.append((cam, size, px[sel]))
        got.append(None if g is None else g[sel])
    scene = {"instances": config["instances"], "config": config["config"]}
    planned = not got or any(g is None for g in got)
    return [(scene, views, None if planned else np.concatenate(got))]


def reference(groups, lower: bool = False, stats=None) -> np.ndarray:
    """uint8 (N, 3): the reference's pixels of every group's views, in
    order. ``lower``: the precision control. ``stats`` (a dict) receives
    the reference's work counts of those rays."""
    out = [oracle.render_pixels(scene, views, lower=lower, stats=stats)
           for scene, views, _ in groups if views]
    return np.concatenate(out) if out else np.zeros((0, 3), np.uint8)


def program(groups) -> np.ndarray:
    """uint8 (N, 3): the program's pixels of every group, in order."""
    out = [got for _, views, got in groups if views]
    return np.concatenate(out) if out else np.zeros((0, 3), np.uint8)


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """The numbers that decide ``correct``: the largest channel difference
    in LSB over the checked pixels, and the share of checked pixels that
    differ at all."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    return {"max_lsb": int(d.max()) if d.size else 0,
            "share_off": float((d > 0).mean()) if d.size else 0.0}


def check(groups) -> dict:
    """What ``Run.check`` returns for pixels: the compared numbers, the
    number of rays the reference marched and its work counts of them."""
    stats = {}
    want = reference(groups, stats=stats)
    return {"compared": compare(program(groups), want), "rays": len(want),
            "stats": stats}
