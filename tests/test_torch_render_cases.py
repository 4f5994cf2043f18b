"""gamer_tpu_torch edge cases against the JAX package: NaN discipline,
negative/zero inner cutoff, several instances, dithering, supersampling,
the star overlay, empty and grey frames, and unported options."""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402
from gamer_tpu.scene.schema import (  # noqa: E402
    CameraParams,
    ComponentParams,
    GalaxyData,
    GalaxyParams,
)

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402


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


def _scene_of(components, winding_b=0.5, winding_n=4.0, size=16, **cfg):
    g = GalaxyData(display_name="t",
                   params=GalaxyParams(winding_b=winding_b,
                                       winding_n=winding_n),
                   components=components)
    return gamer_tpu.Scene(
        camera=CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                            up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=g)],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))


def _preset_scene(galaxy, size=16, **cfg):
    return gamer_tpu.Scene(
        camera=CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                            up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy)],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))


def _xla(scene):
    from gamer_tpu.engine.render import render_scene

    return render_scene(scene)


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.mark.parametrize("arm", [2.5, 2.0])
def test_nan_arm_bases_do_not_poison(arm):
    """tests/test_pallas.py's wound-arm scene: pow(negative, arm*15) is NaN
    for non-integral arm*15 and must be dropped by the emission select; for
    integral arm*15 it is finite and may win the literal pow ladder."""
    g = GalaxyData(
        display_name="wound",
        params=GalaxyParams(winding_b=0.15, winding_n=11.0, no_arms=2.0),
        components=[
            ComponentParams(class_name="bulge", strength=10.0, r0=4.0,
                            spectrum="Yellow"),
            ComponentParams(class_name="disk", strength=600.0, r0=0.4,
                            arm=arm, noise_tilt=0.4, spectrum="Blue"),
        ],
    )
    scene = _preset_scene(g)
    ours = gt.render_scene(scene, device="cpu")
    assert ours.sum() > 0
    assert _max_diff(ours, _xla(scene)) <= 2


def test_nan_emission_floored_like_xla():
    """stars with star_extra and fractional tilt emit pow(negative, 0.5) =
    NaN; the in-march floor must zero it like RasterPixel::Floor."""
    scene = _scene_of([
        ComponentParams(class_name="stars", strength=50.0, r0=0.6, z0=0.2,
                        scale=2.0, noise_offset=-4.0, noise_tilt=0.5,
                        spectrum="White"),
    ])
    ours = gt.render_scene(scene, device="cpu")
    assert _max_diff(ours, _xla(scene)) <= 2


@pytest.mark.parametrize("inner", [-0.1, 0.0, 0.3])
def test_inner_cutoff_uses_the_raw_division(inner):
    """smoothstep(0, inner, r): inner < 0 cuts the component, inner == 0
    emits fully (NaN/inf clamp path)."""
    scene = _scene_of([
        ComponentParams(class_name="disk", strength=600.0, r0=0.4, arm=0.3,
                        noise_tilt=0.3, inner=inner, spectrum="Blue"),
    ])
    ours = gt.render_scene(scene, device="cpu")
    assert _max_diff(ours, _xla(scene)) <= 2
    if inner < 0:
        assert int(ours.sum()) == 0
    else:
        assert int(ours.sum()) > 0


def test_multi_instance_matches_xla():
    """Two instances, sorted far->near, I carried across their marches
    (the geometry of tests/test_pallas.py::test_pallas_multi_instance)."""
    g = presets.spiral()
    scene = gamer_tpu.Scene(
        camera=CameraParams(camera=(2.5, 0.3, 0), target=(0, 0, 0),
                            up=(0, 1, 0), fov=70.0),
        instances=[
            gamer_tpu.GalaxyInstance(galaxy=g, position=(0, 0, 0)),
            gamer_tpu.GalaxyInstance(galaxy=g, position=(0.5, 0.2, -0.8),
                                     orientation=(0.3, 0.8, 0.1),
                                     intensity_scale=0.7),
        ],
        config=gamer_tpu.RenderConfig(size=16, ray_step=0.025),
    )
    ours = gt.render_scene(scene, device="cpu")
    assert ours.sum() > 0
    assert _max_diff(ours, _xla(scene)) <= 2


def test_dither_statistically_matches_xla():
    """Dither hashes direction bits, so single pixels may differ; the
    images agree statistically (tests/test_dither.py's gate)."""
    base = _preset_scene(presets.spiral())
    scene = _preset_scene(presets.spiral(), dither=True)
    ours = gt.render_scene(scene, device="cpu").astype(np.int64)
    ref = _xla(scene).astype(np.int64)
    assert ours.sum() > 0
    assert abs(float(ours.sum()) / float(ref.sum()) - 1.0) < 0.1
    assert float(np.abs(ours - ref).mean()) < 10.0
    assert not np.array_equal(ours, gt.render_scene(base, device="cpu"))


def test_stars_small_statistically_matches_xla():
    g = presets.spiral()
    g.components.append(ComponentParams(
        class_name="stars small", spectrum="White", strength=150.0, r0=0.5,
        z0=0.05, arm=0.1, winding=1.0, scale=40.0, noise_tilt=1.0))
    scene = _preset_scene(g, deterministic=False)
    ours = gt.render_scene(scene, device="cpu").astype(np.int64)
    ref = _xla(scene).astype(np.int64)
    assert abs(float(ours.sum()) / float(ref.sum()) - 1.0) < 0.1
    assert float(np.abs(ours - ref).mean()) < 10.0


def test_supersample_matches_xla():
    scene = _preset_scene(presets.spiral(), size=8, supersample=2)
    ours = gt.render_scene(scene, device="cpu")
    assert ours.shape == (8, 8, 3)
    assert _max_diff(ours, _xla(scene)) <= 2


def test_star_field_matches_jax_device_overlay():
    import jax.numpy as jnp

    from gamer_tpu.post.stars import pad_star_rows, star_field_device, star_params

    from gamer_tpu_torch.post.stars import star_field_device as tstars

    for size, n, sz, seed in ((32, 40, 20.0, 7), (48, 300, 12.0, 3), (8, 0, 1.0, 0)):
        p = pad_star_rows(star_params(size, n, sz, 1.0, 1.0, seed))
        ours = tstars(p, size).numpy()
        ref = np.asarray(star_field_device(jnp.asarray(p), size))
        assert ours.shape == (size, size, 3)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
        if n:
            assert ours.max() > 0


def test_stars_render_matches_xla():
    # star_size 40 at 16^2 draws splats of width 2 (w = int(sz*size)/245)
    scene = _preset_scene(presets.spiral(), size=16, no_stars=40,
                          star_size=40.0, star_seed=7)
    ours = gt.render_scene(scene, device="cpu")
    plain = gt.render_scene(_preset_scene(presets.spiral(), size=16),
                            device="cpu")
    assert not np.array_equal(ours, plain)
    assert _max_diff(ours, _xla(scene)) <= 2


def test_empty_scene_is_black():
    scene = gamer_tpu.Scene(config=gamer_tpu.RenderConfig(size=8))
    img = gt.render_scene(scene, device="cpu")
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8
    assert int(img.sum()) == 0


def test_zero_saturation_is_grey():
    scene = _preset_scene(presets.spiral(), size=8, saturation=0.0)
    img = gt.render_scene(scene, device="cpu")
    assert img.sum() > 0
    np.testing.assert_array_equal(img[..., 0], img[..., 1])
    np.testing.assert_array_equal(img[..., 1], img[..., 2])


def test_march_cap_warning():
    ok = _preset_scene(presets.spiral())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cr._check_march_cap(ok)
    big = dataclasses.replace(ok, config=dataclasses.replace(
        ok.config, ray_step=0.001))
    big.instances[0].galaxy.params.axis = (1000.0, 1000.0, 1000.0)
    with pytest.warns(RuntimeWarning, match="MAX_ITERS"):
        cr._check_march_cap(big)
    assert cr.conservative_step_bound(0.025, 0.001, 400.0) < cr.MAX_ITERS


def test_octave_cap_matches_xla():
    scene = _preset_scene(presets.dusty_disk(), size=12, noise_octaves=3)
    ours = gt.render_scene(scene, device="cpu")
    assert _max_diff(ours, _xla(scene)) <= 2


def test_exposure_gamma_match_xla():
    scene = _preset_scene(presets.flocculent(), size=8)
    scene = dataclasses.replace(scene, config=dataclasses.replace(
        scene.config, exposure=0.7, gamma=0.8, saturation=1.4))
    ours = gt.render_scene(scene, device="cpu")
    assert _max_diff(ours, _xla(scene)) <= 2
