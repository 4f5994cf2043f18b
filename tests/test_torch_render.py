"""gamer_tpu_torch.render_scene(device="cpu") — the march kernel's plain
torch version plus the torch epilogue — against the JAX package's engines
and the spec oracle, at small frames.

Tolerance ladder (docs/ARCHITECTURE.md): the port runs the TPU kernel's
arithmetic, so it is held to <= 2 uint8 LSB of the Pallas kernel
(interpreted) and of the lockstep XLA march, and to <= 3 LSB of the oracle
(1 LSB oracle->XLA plus 2 LSB XLA->kernel).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain march runs thousands of small torch ops. Under the
    parallel test run, each op's thread-pool region waits on threads that
    the other workers' load has descheduled: a 40^2 frame took ~40x as
    long. One intra-op thread keeps each worker at its own pace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy, size=16, **cfg):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy)],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))


def _diff(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d.max(-1) > 0).mean())


def test_matches_pallas_interpret_spiral():
    from gamer_tpu.engine.pallas_render import render_scene_pallas

    scene = _scene(presets.spiral())
    ours = gt.render_scene(scene, device="cpu")
    ref = render_scene_pallas(scene)
    assert ours.shape == (16, 16, 3) and ours.dtype == np.uint8
    assert ours.sum() > 0
    mx, _ = _diff(ours, ref)
    assert mx <= 2, f"port vs pallas: {mx} LSB"


# dusty_disk at 20^2: at 16^2 the TPU kernel itself (interpreted) is 3 LSB
# from the XLA march on one pixel
@pytest.mark.parametrize("name,size", [("spiral", 16), ("dusty_disk", 20),
                                       ("flocculent", 16), ("ring", 24)])
def test_matches_xla_engine(name, size):
    from gamer_tpu.engine.render import render_scene

    scene = _scene(getattr(presets, name)(), size)
    ours = gt.render_scene(scene, device="cpu")
    ref = render_scene(scene)
    assert ours.sum() > 0
    mx, frac = _diff(ours, ref)
    assert mx <= 2, f"{name}: port vs xla {mx} LSB"
    assert frac < 0.05, f"{name}: {frac:.3f} of pixels differ"


def test_matches_oracle_spiral():
    from gamer_tpu.oracle.reference import render_oracle

    scene = _scene(presets.spiral())
    ours = gt.render_scene(scene, device="cpu")
    ref, _ = render_oracle(scene)
    mx, frac = _diff(ours, ref)
    assert mx <= 3, f"port vs oracle: {mx} LSB"
    assert frac < 0.05


def test_render_linear_matches_xla_radiance():
    """The linear buffer itself, before the post chain."""
    from gamer_tpu.engine.render import render_scene

    scene = _scene(presets.ring(), 12)
    lin = gt.render_linear(scene, device="cpu")
    assert isinstance(lin, torch.Tensor) and lin.dtype == torch.float32
    assert lin.shape == (12, 12, 3)
    _, ref = render_scene(scene, return_linear=True)
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(lin.numpy() - ref).max()) / scale < 0.02
