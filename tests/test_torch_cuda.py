"""The CUDA march kernel against its plain torch version. These run only
where a CUDA card and nvcc are present (``pytest -m cuda`` on the card);
elsewhere they skip."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine.render import post_process  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(galaxy, size, **cfg):
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy)],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg))


@pytest.mark.parametrize("name", ["spiral", "dusty_disk", "flocculent",
                                  "ring", "irregular"])
def test_kernel_matches_plain(cuda, name):
    """<= 2 uint8 LSB between the kernel and march_plain on one page."""
    scene = _scene(getattr(presets, name)(), 48)
    page, table, size, _ = cr.prepare(scene, "cpu")
    before = cr.march.launch_count
    lin_k = cr.march(page.to(cuda), table.to(cuda), size)
    torch.cuda.synchronize()
    assert cr.march.launch_count == before + 1
    lin_p = cr.march_plain(page, table, size)
    assert bool(torch.isfinite(lin_k).all())
    post = (np.float32(1.0),) * 3
    a = post_process(lin_k.cpu(), *post).numpy().astype(np.int16)
    b = post_process(lin_p, *post).numpy().astype(np.int16)
    assert int(np.abs(a - b).max()) <= 2


def test_render_scene_device_out_stays_on_card(cuda):
    scene = _scene(presets.spiral(), 32)
    img = gt.render_scene(scene, device="cuda", device_out=True)
    assert img.device.type == "cuda" and img.dtype == torch.uint8
    np.testing.assert_array_equal(img.cpu().numpy(),
                                  gt.render_scene(scene, device="cuda"))


def test_noise_probe_matches_plain(cuda):
    """noise.cuh's device functions against the plain torch ops on the CPU:
    the same float32 operations in the same order."""
    from gamer_tpu_torch.ops import noise as tnoise

    rng = np.random.default_rng(4)
    pts = rng.uniform(-20.0, 20.0, (4096, 3)).astype(np.float32)
    pts[:32] = np.round(pts[:32])
    args = (10, 0.6, 0.1, tnoise.ridged_weights(1.5, 9), 2.5, 1.0, 1.2)
    before = tnoise.noise_probe.launch_count
    got = tnoise.noise_probe(torch.as_tensor(pts, device=cuda), *args).cpu()
    assert tnoise.noise_probe.launch_count == before + 1
    want = tnoise.noise_probe(torch.as_tensor(pts), *args)
    assert float((got - want).abs().max()) <= 1e-6
