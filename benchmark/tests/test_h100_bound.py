"""The frozen roofline arithmetic: it gives the bound the port's smoke
gave on one recorded set of work counts, and the reference counts the
work in the same units as the port's plain march."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import oracle, work  # noqa: E402
from harness.cell import scene_dict  # noqa: E402

# march_plain's counts of the spiral at 16^2 from the singleGalaxy camera,
# and chip_smoke.march_bound(STATS, 0, 16 * 16 * 12) of them (simplex):
# 0.0020209715074626863 ms, bound by operations
STATS = {"samples": 58229, "bulge": 58229, "triggers": 232916,
         "triggered": 106811, "gated": 106811, "arm_gated": 106811,
         "emitting": 106811, "raw_noise": 1044544}
SMOKE_BOUND_MS = 0.0020209715074626863
CONFIG = json.loads((BENCH / "configs" / "spiral-galaxy.json").read_text())


def test_bound_equals_the_smoke_bound():
    got = work.bound_seconds(STATS, 0, 16 * 16 * 12) * 1e3
    assert got == pytest.approx(SMOKE_BOUND_MS, rel=1e-12)


def test_bound_scales_with_rays():
    one = work.bound_for_rays(STATS, 256, 256)
    assert work.bound_for_rays(STATS, 256, 4096 * 4096) == pytest.approx(
        one * 4096 * 4096 / 256, rel=1e-9)


def test_reference_counts_equal_the_plain_march():
    from gamer_tpu_torch.engine import cuda_render
    from gamer_tpu_torch.scene.schema import scene_from_dict

    scene = scene_from_dict(scene_dict(CONFIG, CONFIG["camera"], 16))
    page, table, size, _ = cuda_render.prepare(scene, "cpu")
    plain = {}
    cuda_render.march_plain(page, table, size, stats=plain)
    ref = {}
    oracle.render_pixels({"instances": CONFIG["instances"],
                          "config": CONFIG["config"]},
                         [(CONFIG["camera"], 16, np.arange(256))], stats=ref)
    assert ref == plain == STATS
