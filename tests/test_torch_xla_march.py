"""The port's XLA march (``gamer_tpu_torch.engine.render``) and its
fixed-trip differentiable form (``engine.diff``) against the JAX package,
on the CPU.

Tolerances: the XLA march is held to <= 2 uint8 LSB of
``gamer_tpu.engine.render.render_scene`` (the same arithmetic in another
library: XLA:CPU fuses and contracts some float32 ops, torch on the CPU
does not), with the linear radiance within 1e-3 of its largest value. The
fixed-trip march is bit-equal to the port's own XLA march: it runs the
same trip body, and trips after a ray is done leave it as it is.
``safe_pow``'s value equals torch.pow's bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import diff as jdiff  # noqa: E402
from gamer_tpu.engine import render as jrender  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402
from gamer_tpu.scene.schema import default_galaxy  # noqa: E402

from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine import diff as tdiff  # noqa: E402
from gamer_tpu_torch.engine import render as trender  # noqa: E402
from gamer_tpu_torch.ops.camera import ray_grid_xla  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under the parallel test run the default pool
    waits on descheduled threads for each of the march's small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy, size, **cfg):
    cfg.setdefault("ray_step", 0.025)
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy)],
        config=gamer_tpu.RenderConfig(size=size, **cfg))


# dusty_disk at 20^2 (at 16^2 the per-step norm leaves one pixel 3 LSB
# from XLA in both the TPU kernel and the port, ROADMAP.md §3), a dithered
# frame, a supersampled one and a star overlay
CASES = {
    "dusty_disk_20": lambda: _scene(presets.dusty_disk(), 20),
    "spiral_dither_16": lambda: _scene(presets.spiral(), 16, dither=True),
    "spiral_ss2_12": lambda: _scene(presets.spiral(), 12, supersample=2),
    "default_stars_16": lambda: _scene(default_galaxy(), 16, no_stars=40,
                                       star_size=2.0, star_seed=3),
}


@pytest.fixture(scope="module")
def jax_frames():
    """Each case's JAX frame and linear radiance, rendered once."""
    return {name: jrender.render_scene(make(), return_linear=True)
            for name, make in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_xla_march_matches_jax(name, jax_frames):
    img_j, lin_j = jax_frames[name]
    img_t, lin_t = trender.render_scene(CASES[name](), device="cpu",
                                        return_linear=True)
    assert img_t.shape == img_j.shape and img_t.dtype == np.uint8
    d = np.abs(img_t.astype(np.int16) - img_j.astype(np.int16))
    assert int(d.max()) <= 2, f"{name}: {int(d.max())} LSB"
    assert np.abs(lin_t - lin_j).max() <= 1e-3 * np.abs(lin_j).max()
    assert int(img_t.sum()) > 0


def _args(scene):
    return trender.scene_args(scene, "cpu")


@pytest.mark.parametrize("name,make", [
    ("default_16", lambda: _scene(default_galaxy(), 16, is_preview=True)),
    ("spiral_dither_12", lambda: _scene(presets.spiral(), 12,
                                        is_preview=True, dither=True)),
])
def test_fixed_trip_march_bit_equal_to_xla_march(name, make):
    """The analog of tests/test_fit.py:59: for a trip bound at or above the
    realized trip count the scan march's radiance equals the while-loop
    march's bit for bit, and the float post truncates to the same uint8."""
    scene = make()
    static, params, camera, inv_vp, rs, ms, ex, ga, sa = _args(scene)
    size = scene.config.size
    with torch.no_grad():
        img_ref, lin_ref = trender.render_frame(static, size, params, camera,
                                                inv_vp, rs, ms, ex, ga, sa)
        bound = tdiff.step_bound_for_scene(scene)
        img_d, lin_d = tdiff.render_frame_diff(static, size, bound, params,
                                               camera, inv_vp, rs, ms, ex,
                                               ga, sa)
    assert torch.equal(lin_d, lin_ref)
    assert torch.equal(img_d.to(torch.int32).to(torch.uint8), img_ref)
    assert int(img_ref.sum()) > 0


def test_fixed_trip_march_under_checkpoint_keeps_values():
    """With gradients recorded each trip runs under torch.utils.checkpoint;
    the radiance is the same as without."""
    scene = _scene(default_galaxy(), 8, is_preview=True)
    static, params, camera, inv_vp, rs, ms, *_ = _args(scene)
    dirs = ray_grid_xla(8, inv_vp)
    bound = tdiff.step_bound_for_scene(scene)
    strength = params[0]["comps"][0]["strength"].requires_grad_(True)
    lin = tdiff.render_rays_diff(static, params, dirs, camera, rs, ms, bound)
    with torch.no_grad():
        ref = trender.render_rays(static, params, dirs, camera, rs, ms)
    assert torch.equal(lin.detach(), ref)
    (g,) = torch.autograd.grad(lin.sum(), [strength])
    assert bool(torch.isfinite(g)) and float(g) != 0.0


def test_safe_pow_value_and_partials():
    """safe_pow's value is torch.pow's (NaN for a negative base with a
    fractional exponent included); its partials are e*x^(e-1) and
    x^e*log(x) where those are finite and 0 elsewhere (x <= 0)."""
    x = torch.tensor([2.0, 0.5, 0.0, -1.5, 3.0], requires_grad=True)
    e = torch.tensor(1.7, requires_grad=True)
    y = tdiff.safe_pow(x, e)
    with torch.no_grad():
        ref = torch.pow(x, e)
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    assert torch.equal(y[~torch.isnan(y)].detach(), ref[~torch.isnan(ref)])
    gx, ge = torch.autograd.grad(y.sum(), [x, e])
    xv = x.detach()
    want_x = torch.where(xv > 0, e.detach() * xv ** (e.detach() - 1.0),
                         torch.zeros(()))
    want_e = torch.where(xv > 0, xv ** e.detach() * torch.log(xv),
                         torch.zeros(())).sum()
    assert torch.isfinite(gx).all() and bool(torch.isfinite(ge))
    torch.testing.assert_close(gx, want_x, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(ge, want_e, rtol=1e-6, atol=0.0)
    # a Python exponent: the base alone gets a partial
    (g2,) = torch.autograd.grad(tdiff.safe_pow(x, 2.0).sum(), [x])
    torch.testing.assert_close(g2, 2.0 * xv, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("args", [(0.025, 0.01), (0.001, 0.001),
                                  (0.025, 0.001, 1.0), (0.05, 0.002, 2.5),
                                  (0.025, 0.001, 400.0)])
def test_step_bound_matches_jax(args):
    """One copy of conservative_step_bound (engine/diff.py, imported by
    engine/cuda_render.py), equal to the JAX package's."""
    assert cr.conservative_step_bound is tdiff.conservative_step_bound
    assert tdiff.conservative_step_bound(*args) == \
        jdiff.conservative_step_bound(*args)


def test_step_bound_for_scene_matches_jax():
    scene = _scene(presets.spiral(), 8)
    assert tdiff.step_bound_for_scene(scene) == \
        jdiff.step_bound_for_scene(scene)
    assert tdiff.conservative_step_bound(0.025, 0.01) < \
        tdiff.conservative_step_bound(0.001, 0.001)


def test_xla_render_scene_needs_a_card_for_cuda():
    """device='cuda' (the default) raises without a card; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path is the card's test")
    with pytest.raises(RuntimeError, match="cuda"):
        trender.render_scene(_scene(default_galaxy(), 8))


def test_ray_grid_matches_jax_camera():
    """The XLA march's ray grid: the JAX package's expression (index-order
    dot with inv_vp's rows, then v / |v|), within float32 rounding of
    jnp's matmul form."""
    import jax.numpy as jnp
    from gamer_tpu.ops import camera as jcam

    scene = _scene(default_galaxy(), 9)
    inv_vp = trender.scene_args(scene, "cpu")[3]
    got = ray_grid_xla(9, inv_vp).numpy()
    want = np.asarray(jcam.ray_grid(9, jnp.asarray(inv_vp.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
