"""The all-sky path (K6, the ray-list launch) on the CPU:
``gamer_tpu_torch.render_dirs`` / ``render_allsky_map`` /
``render_allsky_image`` and the CLI's ``allsky`` and ``renderhpx`` against
the JAX package's Pallas ray-list kernel (interpreted) and XLA ray march.

The camera sits inside the galaxy's ellipsoid, as the all-sky benchmark's
does, so every ray hits and marches from the far side to the camera: the
near end of the march (``tacc`` against ``dist0``) is exercised here and by
no frame test. Tolerances: the map gate of tests/test_pallas.py
(max |d| / max |m| < 1e-3, map not empty); <= 2 uint8 LSB for the
Mollweide image; the JAX reference for each ray count is built once.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import allsky as jallsky  # noqa: E402
from gamer_tpu.engine.pallas_render import render_dirs_pallas  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch import cli  # noqa: E402
from gamer_tpu_torch.engine import allsky as tallsky  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.io.fits import write_fits_image  # noqa: E402
from gamer_tpu_torch.scene import gax  # noqa: E402

MAP_GATE = 1e-3
NSIDES = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain march runs thousands of small torch ops. Under the
    parallel test run, each op's thread-pool region waits on threads that
    the other workers' load has descheduled. One intra-op thread keeps each
    worker at its own pace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(camera=(0.3, 0.05, 0.0), size=16, **cfg):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=camera, target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))


@pytest.fixture(scope="module")
def port_maps():
    return {n: gt.render_allsky_map(_scene(), n, device="cpu") for n in NSIDES}


def _pallas_map_in_a_longer_list(scene, nside, n_rays):
    """render_allsky_map(scene, nside, kernel="pallas") with the map's rays
    marched in a list of ``n_rays`` (the rest repeat the last ray): each ray
    is marched alone, so the map is the same, and a list of one length
    reuses one compiled ray-list kernel. The directions and the luminance
    are jallsky.render_allsky_map's."""
    from gamer_tpu.post.healpix import npix, pix2vec_ring

    n = npix(nside)
    d = pix2vec_ring(nside, np.arange(n))
    dirs = np.stack([d[:, 0], -d[:, 2], d[:, 1]], axis=-1)
    dirs = np.concatenate([dirs, np.repeat(dirs[-1:], n_rays - n, axis=0)])
    linear = np.asarray(render_dirs_pallas(scene, dirs))[:n]
    return (linear.sum(axis=-1) / 3.0).astype(np.float64)


@pytest.fixture(scope="module")
def jax_maps():
    """(nside, kernel) -> the JAX package's map, each built once; the
    Pallas maps of the smaller nsides go through the largest one's compiled
    ray-list kernel."""
    top = max(NSIDES)
    maps = {(n, "xla"): jallsky.render_allsky_map(_scene(), n, kernel="xla")
            for n in NSIDES}
    maps[top, "pallas"] = jallsky.render_allsky_map(_scene(), top,
                                                    kernel="pallas")
    for n in NSIDES:
        if n != top:
            maps[n, "pallas"] = _pallas_map_in_a_longer_list(
                _scene(), n, 12 * top * top)
    return maps


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
@pytest.mark.parametrize("nside", NSIDES)
def test_allsky_map_matches_jax(port_maps, jax_maps, nside, kernel):
    ours, ref = port_maps[nside], jax_maps[nside, kernel]
    assert ours.shape == (12 * nside * nside,) and ours.dtype == np.float64
    # the camera is inside the ellipsoid: every ray hits
    assert (ours > 0).all(), "all-sky map has empty pixels"
    scale = np.abs(ref).max() + 1e-12
    assert np.abs(ours - ref).max() / scale < MAP_GATE


def test_allsky_dirs_are_the_turned_ring_centres():
    from gamer_tpu.post.healpix import npix, pix2vec_ring

    d = pix2vec_ring(4, np.arange(npix(4)))
    ref = np.stack([d[:, 0], -d[:, 2], d[:, 1]], axis=-1)
    ours = tallsky.allsky_dirs(4)
    assert ours.dtype == np.float32 and ours.shape == (192, 3)
    np.testing.assert_array_equal(ours, ref.astype(np.float32))


@pytest.fixture(scope="module")
def random_dirs():
    """191 random unit directions and one zero vector: the ray count of
    nside 4, so the JAX ray-list kernel compiled for the map is reused."""
    rng = np.random.default_rng(5)
    d = rng.normal(size=(192, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[77] = 0.0
    return d.astype(np.float32)


def test_render_dirs_matches_pallas_on_random_directions(random_dirs, jax_maps):
    scene = _scene()
    ours = gt.render_dirs(scene, random_dirs, device="cpu")
    ref = render_dirs_pallas(scene, random_dirs)
    assert ours.shape == (192, 3) and ours.dtype == np.float32
    assert np.isfinite(ours).all()
    # the zero direction never hits: radiance 0 on both sides, no hang
    assert not ours[77].any() and not np.asarray(ref)[77].any()
    assert (np.delete(ours, 77, axis=0).sum(axis=1) > 0).all()
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() / scale < MAP_GATE


def test_render_dirs_outside_camera_misses_and_hits(random_dirs):
    """From outside the ellipsoid some rays miss (radiance 0) and some hit;
    the directions are used as given: a direction that is not a unit vector
    marches the same chord on another step schedule, finite and non-zero."""
    scene = _scene(camera=(2.0, 0.3, 0.0))
    lin = gt.render_dirs(scene, random_dirs, device="cpu")
    lum = lin.sum(axis=1)
    assert (lum == 0).any() and (lum > 0).any()
    # the march runs along -d (the intersection keeps t <= 0), so the
    # direction that reaches the galaxy points from its centre to the camera
    d = np.asarray(scene.camera.camera, np.float32)
    both = np.stack([d / np.linalg.norm(d), d])
    out = gt.render_dirs(scene, both, device="cpu")
    assert np.isfinite(out).all() and (out.sum(axis=1) > 0).all()


def test_march_rays_wrapper_checks_its_inputs(random_dirs):
    page, table, _, _ = cr.prepare(_scene(), "cpu")
    dirs = torch.as_tensor(random_dirs[:4])
    before = cr.march_rays.launch_count
    out = cr.march_rays(page, table, dirs)
    assert out.shape == (4, 3) and cr.march_rays.launch_count == before
    torch.testing.assert_close(out, cr.march_rays_plain(page, table, dirs),
                               rtol=0, atol=0)
    stats = {}
    cr.march_rays_plain(page, table, dirs, stats=stats)
    assert stats["samples"] > 0 and stats["raw_noise"] > 0
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        cr.march_rays(page, table, dirs.double())
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        cr.march_rays(page, table, dirs.reshape(-1))
    with pytest.raises(ValueError, match="device"):
        cr.march_rays(page, table, dirs.to("meta"))
    with pytest.raises(ValueError, match="1-D mesh"):  # rays shard over 1-D
        gt.render_dirs(_scene(), random_dirs, mesh=gt.Mesh(
            ["cpu"] * 4, ("batch", "rows"), (2, 2)))
    with pytest.raises(RuntimeError, match="cuda"):
        gt.render_allsky_map(_scene(), 1)  # the default device is the card


def test_allsky_image_matches_jax(jax_maps):
    scene = _scene(exposure=0.8, gamma=0.9)
    ours = gt.render_allsky_image(scene, 4, 32, device="cpu")
    ref = np.asarray(jallsky.render_allsky_image(scene, 4, 32))
    assert ours.shape == (32, 32, 3) and ours.dtype == np.uint8
    assert ours.sum() > 0
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 2, f"all-sky image: {d.max()} LSB"
    # gray inside the projection ellipse, black outside
    np.testing.assert_array_equal(ours[..., 0], ours[..., 1])
    assert not ours[0, 0].any()


def test_cli_allsky_and_renderhpx(tmp_path, monkeypatch, port_maps):
    monkeypatch.chdir(tmp_path)
    gax.save(presets.spiral(), "spiral.gax")
    assert cli.main(["allsky", "spiral.gax", "2", "24", "sky.png",
                     "--device", "cpu"]) == 0
    scene = gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
        config=gt.RenderConfig(size=24, ray_step=0.025))
    np.testing.assert_array_equal(
        np.asarray(Image.open("sky.png").convert("RGB")),
        gt.render_allsky_image(scene, 2, 24, device="cpu"))

    # renderhpx: a stored map through Mollweide and the post chain, against
    # the JAX package's same steps
    import jax.numpy as jnp
    from gamer_tpu.engine.queue import _post_jitted
    from gamer_tpu.post.mollweide import mollweide_image

    hpx = port_maps[4]
    write_fits_image("map.fits", hpx[None, :])
    assert cli.main(["renderhpx", "map.fits", "32", "hpx", "0.7", "0.9",
                     "1.0", "--device", "cpu"]) == 0
    ref = np.asarray(_post_jitted()(
        jnp.asarray(mollweide_image(hpx, 4, 32)), jnp.float32(0.7),
        jnp.float32(0.9), jnp.float32(1.0)))
    got = np.asarray(Image.open("hpx.png").convert("RGB"))
    assert got.sum() > 0
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    write_fits_image("bad.fits", np.zeros((1, 13)))
    assert cli.main(["renderhpx", "bad.fits", "8", "x", "1", "1", "1",
                     "--device", "cpu"]) == 1
    assert cli.main(["allsky", "spiral.gax"]) == 1
