"""The spec oracle's 512x512 frames stored in the port
(gamer_tpu_torch/data/oracle_<preset>_512.npz), which chip_smoke.py holds
the CUDA kernel against, one per preset of ``presets.GALLERY``.

Each file must describe its preset's scene as it is now (a preset edit
without a rewrite fails here), and the port's plain march must meet the
oracle gate on a band of its rows. The drift test (marked slow, ~10-25 min
a preset on one core) renders each frame again with the JAX package's
oracle and asserts equality. Rewrite the files with

    python -m gamer_tpu_torch.golden [PRESET ...]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gamer_tpu_torch.golden import (  # noqa: E402
    ORACLE_SIZE,
    PRESETS,
    load_oracle_frame,
    oracle_scene,
)
from gamer_tpu_torch.scene.schema import scene_to_dict  # noqa: E402

# the rows of the band the plain march is held to: the 2 rows at the middle
# of the frame, through the disk plane (1,024 rays; the plain march's cost
# is set by its trips more than by its rays, and 4 rows took ~70 s for the
# seven presets)
BAND_ROWS = 2
BAND_ROW0 = ORACLE_SIZE // 2 - BAND_ROWS // 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain march runs thousands of small torch ops. Under the
    parallel test run, each op's thread-pool region waits on threads that
    the other workers' load has descheduled. One intra-op thread keeps
    each worker at its own pace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_there_is_a_frame_for_every_preset():
    assert PRESETS == ("spiral", "barred_spiral", "elliptical", "irregular",
                       "dusty_disk", "ring", "flocculent")


@pytest.mark.parametrize("preset", PRESETS)
def test_stored_frame_is_the_presets_scene(preset):
    gold = load_oracle_frame(preset)
    img = gold["image"]
    assert img.shape == (ORACLE_SIZE, ORACLE_SIZE, 3) and img.dtype == np.uint8
    assert gold["pixels"] == ORACLE_SIZE * ORACLE_SIZE
    assert gold["samples"] > 0 and int(img.sum()) > 0
    scene = oracle_scene(preset, ORACLE_SIZE)
    assert gold["scene"] == json.loads(json.dumps(scene_to_dict(scene)))
    c = scene.config
    assert (c.no_stars, c.supersample, c.noise_kind) == (0, 1, "simplex")


@pytest.mark.parametrize("preset", PRESETS)
def test_plain_march_meets_the_oracle_gate_on_the_middle_band(preset):
    """The plain march on the band's rows, through the progressive frame's
    epilogue, against the stored rows: <= 3 LSB, the gate chip_smoke.py
    applies to the kernel's whole frame."""
    from gamer_tpu_torch.engine import cuda_render as cr

    plan = cr._Bands(oracle_scene(preset, ORACLE_SIZE), 16,
                     torch.device("cpu"))
    lin = cr.march_band_plain(plan.page, plan.table, plan.S, BAND_ROWS,
                              BAND_ROW0)
    ours = plan.finish(plan.epilogue(0, 1, lin))
    gold = load_oracle_frame(preset)["image"][BAND_ROW0:BAND_ROW0 + BAND_ROWS]
    assert ours.shape == gold.shape
    d = np.abs(ours.astype(np.int16) - gold.astype(np.int16))
    assert int(gold.sum()) > 0
    assert int(d.max()) <= 3, (int(d.max()), float((d.max(-1) > 0).mean()))


# Pixels (row, col) where the kernel's 512^2 frame was 3-7 LSB from the
# oracle's on an NVIDIA H100, in three rounds: while the kernel and its
# plain version took the TPU kernel's accumulated path length for the step
# and the loop's exit (the first eight of each preset), the reference's
# recurrence in float32 alone (the next ones, to (32, 254)), and the
# reference's doubles with the ray steps rounded to float32 (the last). In
# each, the ray took one sample more or fewer by the camera than the
# oracle's.
ORACLE_MISSES = {
    "irregular": [(127, 165), (139, 150), (150, 139), (150, 201), (150, 230),
                  (150, 282), (150, 311), (375, 266), (120, 78), (392, 78),
                  (51, 457), (78, 120), (368, 62), (434, 120), (434, 392),
                  (32, 254), (389, 88), (123, 88), (424, 123), (88, 123),
                  (88, 389), (424, 389)],
    "dusty_disk": [(214, 332), (106, 409), (112, 453), (120, 496),
                   (121, 397), (121, 484), (128, 488), (142, 426), (197, 452),
                   (51, 457), (78, 392), (120, 434), (144, 450), (201, 279),
                   (32, 258), (32, 254), (88, 389), (123, 424), (424, 123)],
}


@pytest.mark.parametrize("preset", sorted(ORACLE_MISSES))
def test_plain_march_takes_the_references_steps(preset):
    """The plain march of those pixels' rays, as one ray list, is within
    1 LSB of the oracle's pixels (equal sample counts; the components'
    float32 arithmetic against the oracle's float64 leaves up to 1)."""
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine.render import post_process
    from gamer_tpu_torch.ops.camera import ray_grid

    scene = oracle_scene(preset, ORACLE_SIZE)
    page, table, size, _ = cr.prepare(scene, "cpu")
    inv_vp = page[cr.G_INV_VP:cr.G_INV_VP + 16].numpy()
    pix = ORACLE_MISSES[preset]
    dirs = torch.stack([ray_grid(size, inv_vp, float(r), rows=1)[0, c]
                        for r, c in pix])
    lin = cr.march_rays_plain(page, table, dirs)
    c = scene.config
    ours = post_process(lin, np.float32(c.exposure), np.float32(c.gamma),
                        np.float32(c.saturation)).numpy()
    gold = load_oracle_frame(preset)["image"]
    want = np.stack([gold[r, col] for r, col in pix])
    d = np.abs(ours.astype(np.int16) - want.astype(np.int16)).max(-1)
    assert int(d.max()) <= 1, dict(zip(pix, d.tolist()))


@pytest.mark.slow
@pytest.mark.parametrize("preset", PRESETS)
def test_stored_frame_is_the_oracle_frame(preset):
    """A fresh run of the JAX package's spec oracle on the preset's scene
    gives the stored frame and sample count."""
    import gamer_tpu
    from gamer_tpu.oracle.reference import render_oracle

    d = scene_to_dict(oracle_scene(preset, ORACLE_SIZE))
    img, tim = render_oracle(gamer_tpu.scene_from_dict(d))
    gold = load_oracle_frame(preset)
    np.testing.assert_array_equal(gold["image"], img)
    assert (gold["samples"], gold["pixels"]) == (tim.samples, tim.pixels)


# HEALPix RING pixels of the nside-512 sky (chip_smoke.allsky_scene) where
# the XLA-form march was 1.1-1.6e-3 of the map's largest value from the
# kernel's (the kernel equals the oracle there within 4e-5) while the
# XLA-form took its chord and steps in float32: a sample more or fewer by
# the camera.
SKY_MISSES = [2528237, 1758308, 2526226, 1676326, 1657963, 1705187]


def test_xla_march_takes_the_references_steps():
    """The XLA-form march of those sky rays is within 1e-4 of their
    largest value of the plain march's (the kernel's function)."""
    import chip_smoke
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine import render as xr
    from gamer_tpu_torch.post.healpix import pix2vec_ring

    d = pix2vec_ring(512, np.asarray(SKY_MISSES))
    dirs = torch.as_tensor(np.stack([d[:, 0], -d[:, 2], d[:, 1]],
                                    axis=-1).astype(np.float32))
    sky = chip_smoke.allsky_scene()
    page, table, _, _ = cr.prepare(sky, "cpu")
    plain = cr.march_rays_plain(page, table, dirs)
    static, params, camera, _, rs, ms, *_ = xr.scene_args(sky, "cpu")
    with torch.no_grad():
        xla = xr.render_rays(static, params, dirs, camera, rs, ms)
    lum_p, lum_x = plain.mean(-1), xla.mean(-1)
    assert float(lum_p.min()) > 0
    rel = float((lum_x - lum_p).abs().max() / lum_p.abs().max())
    assert rel <= 1e-4, rel
