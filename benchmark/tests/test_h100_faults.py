"""The comparison that decides ``correct`` fails what it must fail.

The control: the plain reference computed with its state in bfloat16 (the
precision below the configuration's float32) put in the program's place
fails the limits on every cell's views. The faults: a whole run (set-up,
window, the generator's check against the reference) is driven on CPU
entries at a small size with the timed path broken underneath, and
``correct`` comes out false: a frame's answer altered where it is made,
half of a frame's rows or half of a skybox's faces left out, the exchange
between cards left out. Each run is a few seconds to a minute of the plain
march."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from harness import pixels  # noqa: E402
from harness.cell import generator, load_cell  # noqa: E402

SMALL = {
    "spiral-galaxy.still4096": dict(size=8, check_pixels_per_frame=24,
                                    check_rays=48),
    "spiral-galaxy.still4096-4card": dict(size=8, check_pixels_per_frame=24,
                                          check_rays=48),
    "spiral-skybox.faces1024": dict(size=8, check_pixels_per_face=8,
                                    check_rays=48),
}


def small(name):
    cell = load_cell(name)
    return dataclasses.replace(cell, mix=dict(cell.mix, **SMALL[name]))


def within(cell, compared) -> bool:
    return all(compared[k] <= v for k, v in cell.config["limits"].items())


@pytest.mark.parametrize("name", ["spiral-galaxy.still4096",
                                  "spiral-skybox.faces1024"])
def test_control_fails_the_limits(name):
    """At the cells' own frame sizes, on the views the cell's generator
    draws from a seed (its cameras and checked pixels), thinned to 96
    rays."""
    cell = load_cell(name)
    run = generator(cell).Run(cell, 11, ["cpu"] * cell.chips)
    run.plan(2)
    groups = run.groups(96)
    want = pixels.reference(groups)
    low = pixels.reference(groups, lower=True)
    assert within(cell, pixels.compare(want, want))
    assert not within(cell, pixels.compare(low, want))


def _measure(name, seconds=0.05):
    cell = small(name)
    return run.measure(cell, 2 ** 31 + 5, seconds, False,
                       ["cpu"] * cell.chips)


def test_sound_small_run_is_correct():
    res = _measure("spiral-galaxy.still4096")
    assert res["correct"] and res["compared"]["max_lsb"]["value"] == 0


def _altered(img):
    return np.minimum(img.astype(np.int16) + 8, 255).astype(np.uint8)


def test_altered_frame(monkeypatch):
    from gamer_tpu_torch.engine import cuda_render

    real = cuda_render.render_scene
    monkeypatch.setattr(cuda_render, "render_scene",
                        lambda *a, **k: _altered(real(*a, **k)))
    assert not _measure("spiral-galaxy.still4096")["correct"]


def test_half_the_rows_left_out(monkeypatch):
    from gamer_tpu_torch.engine import cuda_render

    real = cuda_render.render_scene

    def half(*a, **k):
        img = real(*a, **k).copy()
        img[img.shape[0] // 2:] = 0
        return img

    monkeypatch.setattr(cuda_render, "render_scene", half)
    assert not _measure("spiral-galaxy.still4096")["correct"]


def test_exchange_between_cards_left_out(monkeypatch):
    from gamer_tpu_torch.engine import cuda_render

    real = cuda_render._gather

    def first_card_only(dst, src, mesh, i):
        if i == 0:
            real(dst, src, mesh, i)
        else:
            dst.zero_()

    monkeypatch.setattr(cuda_render, "_gather", first_card_only)
    assert not _measure("spiral-galaxy.still4096-4card")["correct"]


def test_half_the_faces_left_out(monkeypatch):
    from gamer_tpu_torch.engine import batch

    real = batch.render_batch

    def three_faces(scenes, *a, **k):
        out = real(scenes[:3], *a, **k)
        return np.concatenate([out, np.zeros_like(out)])

    monkeypatch.setattr(batch, "render_batch", three_faces)
    assert not _measure("spiral-skybox.faces1024")["correct"]
