"""Each mix is a function of its seed: the same seed gives the same
cameras and checked pixels, another seed gives others."""

import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.cell import generator, load_cell  # noqa: E402

SEEDS = (2 ** 31 + 77, 5)


def _drawn(cell, seed, units=4):
    """The cameras and checked pixels of ``units`` units as a window draws
    them, and the views the check takes from them."""
    run = generator(cell).Run(cell, seed, ["cpu"] * cell.chips)
    run.plan(units)
    views = [(cam, size, px.tolist())
             for _, vs, _ in run.groups(64) for cam, size, px in vs]
    px = [np.asarray(p).tolist() for _, p, _ in run.taken]
    return [c for c, _, _ in run.taken], px, views


@pytest.mark.parametrize("name", [
    "spiral-galaxy.still4096", "spiral-skybox.faces1024",
    "spiral-galaxy.still4096-4card"])
def test_same_seed_same_traffic(name):
    cell = load_cell(name)
    a, b = _drawn(cell, SEEDS[0]), _drawn(cell, SEEDS[0])
    assert a == b
    assert _drawn(cell, SEEDS[1]) != a


def test_orbit_keeps_the_radius():
    still = load_cell("spiral-galaxy.still4096")
    cams, _, _ = _drawn(still, 3)
    r = [np.linalg.norm(c["camera"]) for c in cams]
    assert np.allclose(r, 0.5)
    step = np.degrees(np.arccos(np.clip(np.dot(cams[0]["camera"],
                                               cams[1]["camera"]) / 0.25,
                                        -1, 1)))
    assert step == pytest.approx(still.mix["orbit_deg_per_frame"], abs=1e-6)


def test_check_spreads_its_rays_over_every_unit():
    """The check takes about ``max_rays`` rays (each view's share rounded,
    at least one), some of every frame or face, and never a pixel twice in
    one view."""
    for name, views_per_unit in (("spiral-galaxy.still4096", 1),
                                 ("spiral-skybox.faces1024", 6)):
        cell = load_cell(name)
        _, _, views = _drawn(cell, 9, units=8)
        assert len(views) == 8 * views_per_unit
        rays = sum(len(px) for _, _, px in views)
        assert max(len(views), 64 - len(views)) <= rays
        assert rays <= 64 + len(views)
        assert all(len(set(px)) == len(px) > 0 for _, _, px in views)
