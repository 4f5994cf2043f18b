"""gamer_tpu_torch camera chain against the JAX package and the oracle."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gamer_tpu.ops import camera as jcam  # noqa: E402
from gamer_tpu.oracle import qtmath as qm  # noqa: E402

from gamer_tpu_torch.ops import camera as tcam  # noqa: E402

POSES = [
    ((0.5, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 90.0),
    ((2.5, 0.3, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 70.0),
    ((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 70.0),
    ((1.3, -0.7, 2.1), (0.2, 0.1, -0.3), (0.1, 0.9, 0.2), 45.0),
    ((-3.0, 2.0, 1.0), (0.5, -0.5, 0.0), (0.0, 0.0, 1.0), 120.0),
]


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_inv_view_projection_matches_jax(pose):
    """Host float32 closed form within 2 ulp of the JAX package's matrix
    (the same expressions; the 4x4 product may round in another order)."""
    camera, target, up, fov = POSES[pose]
    ours = tcam.inv_view_projection(camera, target, up, fov)
    ref = jcam.inv_view_projection_host(np.asarray(camera, np.float32),
                                        target, up, fov)
    assert ours.dtype == np.float32 and ours.shape == (4, 4)
    # entries that are zero by construction may carry rounding noise on
    # either side; hold them to an absolute bound two ulps of the matrix
    tiny = np.abs(ref) < 1e-6
    np.testing.assert_array_max_ulp(ours[~tiny], ref[~tiny], maxulp=2)
    assert np.abs(ours[tiny] - ref[tiny]).max(initial=0.0) <= 2 * np.spacing(
        np.float32(np.abs(ref).max()))


@pytest.mark.parametrize("pose", range(len(POSES)))
@pytest.mark.parametrize("size", [16, 23])
def test_ray_grid_matches_jax(pose, size):
    camera, target, up, fov = POSES[pose]
    inv_vp = jcam.inv_view_projection_host(np.asarray(camera, np.float32),
                                           target, up, fov)
    ours = tcam.ray_grid(size, inv_vp).numpy()
    ref = np.asarray(jcam.ray_grid(size, jnp.asarray(inv_vp)))
    assert ours.shape == (size, size, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_rays_match_qtmath_oracle():
    camera, target, up, fov = POSES[0]
    size = 24
    inv_vp = qm.inv_view_projection(camera, target, up, fov)
    idx = np.arange(size * size)
    ref = qm.coord2ray((idx % size).astype(np.float64),
                       (idx // size).astype(np.float64), float(size), inv_vp)
    ours = tcam.ray_grid(size, inv_vp).numpy().reshape(-1, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_row0_shifts_rows():
    inv_vp = tcam.inv_view_projection(*POSES[1])
    full = tcam.ray_grid(16, inv_vp)
    band = tcam.ray_grid(16, inv_vp, row0=8.0)
    torch.testing.assert_close(band[:8], full[8:], rtol=0, atol=0)
