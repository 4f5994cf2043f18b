"""The band path (K5): ``gamer_tpu_torch.render_progressive`` against the
JAX package's ``render_progressive_pallas`` (interpreted Pallas), against
the port's own fused frame, and the ``march_band`` wrapper against its
plain version, on the CPU (the progressive launch's own CPU tests are in
tests/test_torch_progressive.py).

Below 1024 rows the band quantum is 32 march rows, so a frame needs more
than 32 rows to have a second band: the spiral at 40^2 gives two bands,
the second of them ragged (as tests/test_pallas.py's band tests, with a
preset in place of the fixtures). Tolerances: <= 2 uint8 LSB against the
Pallas kernel; <= 1 LSB band against fused within the port on the CPU,
where torch's vector and scalar code paths may round a few elements
differently (on the card the two are bit-equal, tests/test_torch_cuda.py).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import pallas_render as pr  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402

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


def _scene(size, galaxy=None, **cfg):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy or presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.fixture(scope="module")
def spiral40():
    return _scene(40)


@pytest.fixture(scope="module")
def port_bands(spiral40):
    ticks = []
    img = gt.render_progressive(spiral40, bands=2, device="cpu",
                                on_progress=lambda f, _: ticks.append(f))
    return img, ticks


@pytest.fixture(scope="module")
def jax_bands(spiral40):
    ticks = []
    img = pr.render_progressive_pallas(
        spiral40, bands=2, on_progress=lambda f, _: ticks.append(f))
    return img, ticks


def test_bands_match_jax_band_path(port_bands, jax_bands):
    ours, ref = port_bands[0], jax_bands[0]
    assert ours.shape == (40, 40, 3) and ours.dtype == np.uint8
    assert int(ours[32:].sum()) > 0  # the ragged second band is rendered
    assert _max_diff(ours, ref) <= 2


def test_ticks_equal_jax(port_bands, jax_bands):
    assert port_bands[1] == jax_bands[1] == [0.5, 1.0]


def test_abort_after_first_band(spiral40, port_bands, jax_bands):
    """Abort at the first tick: rows 0-31 rendered, rows 32-39 black, as
    the JAX band path's aborted frame."""
    partials = []

    def stop(frac, partial):
        partials.append(partial)
        return False

    aborted = gt.render_progressive(spiral40, bands=2, on_progress=stop,
                                    device="cpu")
    assert aborted.shape == (40, 40, 3) and len(partials) == 1
    np.testing.assert_array_equal(aborted, partials[0])
    np.testing.assert_array_equal(aborted[:32], port_bands[0][:32])
    assert int(aborted[32:].sum()) == 0
    assert _max_diff(aborted[:32], jax_bands[0][:32]) <= 2


def test_bands_match_fused_frame(spiral40, port_bands):
    fused = gt.render_scene(spiral40, device="cpu")
    assert _max_diff(port_bands[0], fused) <= 1


def test_bands_supersample_and_stars_match_fused():
    """Supersampling and the star overlay on the band path: pooling stays
    aligned to band edges and the overlay's band slices reassemble. 20^2 at
    supersample 2 marches 40 rows, so the second band is ragged."""
    # star_size 40 at 20^2 draws splats of width 3 (w = int(sz*size)/245)
    scene = _scene(20, supersample=2, no_stars=40, star_size=40.0,
                   star_seed=7)
    assert cr.band_geometry(20, 2, 2) == (32, 2)
    assert float(cr._star_overlay(scene.config, "cpu").max()) > 0
    prog = gt.render_progressive(scene, bands=2, device="cpu")
    fused = gt.render_scene(scene, device="cpu")
    assert prog.shape == (20, 20, 3)
    assert _max_diff(prog, fused) <= 1


@pytest.mark.parametrize("size,ss,bands,want", [
    (40, 1, 2, (32, 2)), (40, 1, 16, (32, 2)), (512, 1, 16, (32, 16)),
    (1024, 1, 16, (64, 16)), (1000, 1, 16, (64, 16)), (20, 2, 2, (32, 2)),
    (100, 3, 4, (96, 4)), (16, 1, 16, (32, 1)), (600, 1, 7, (96, 7))])
def test_band_geometry(size, ss, bands, want):
    """render_progressive_pallas's band cut (pallas_render.py:1552-1558)."""
    import math

    S = size * ss
    tr = pr._tile_rows(S)
    assert cr._tile_rows(S) == tr
    granule = tr * ss // math.gcd(tr, ss)
    rows = -(-S // granule) * granule
    n = max(1, min(bands, rows // granule))
    band_rows = -(-(rows // granule) // n) * granule
    assert cr.band_geometry(size, ss, bands) == (band_rows, -(-S // band_rows))
    assert cr.band_geometry(size, ss, bands) == want


def _quick_page(size):
    """A page whose march takes few steps (ray step 0.1), for the wrapper
    checks."""
    scene = _scene(size)
    scene.config.ray_step = 0.1
    return cr.prepare(scene, "cpu")


def test_march_band_wrapper_equals_plain():
    page, table, size, _ = _quick_page(8)
    full = cr.march_plain(page, table, size)
    band = cr.march_band(page, table, size, 4, 4)
    torch.testing.assert_close(band, cr.march_band_plain(page, table, size,
                                                         4, 4),
                               rtol=0, atol=0)
    torch.testing.assert_close(band, full[4:], rtol=0, atol=1e-6)
    # a band reaching past the frame's last row: those rows are 0
    over = cr.march_band(page, table, size, 8, 4)
    assert over.shape == (8, 8, 3)
    torch.testing.assert_close(over[:4], band, rtol=0, atol=0)
    assert float(over[4:].abs().max()) == 0.0
    assert float(page[cr.G_ROW0]) == 0.0  # the caller's page is untouched


def test_band_wrapper_rejects_bad_inputs():
    page, table, size, _ = _quick_page(4)
    with pytest.raises(TypeError):
        cr.march_band(page.double(), table, size, 4, 0)
    with pytest.raises(TypeError):
        cr.march_band(page, table.long(), size, 4, 0)
    with pytest.raises(ValueError):
        cr.march_band(page, table.to("meta"), size, 4, 0)
    with pytest.raises(ValueError, match="row0"):
        cr.march_band(page, table, size, 4, 1.5)
    with pytest.raises(ValueError, match="row0"):
        cr.march_band(page, table, size, 4, -4)


def test_band_path_launches_nothing_on_cpu():
    def counts():
        return (cr.march.launch_count, cr.march_band.launch_count,
                cr.march_progressive.launch_count)

    before = counts()
    scene = _scene(6)
    scene.config.ray_step = 0.1
    img = gt.render_progressive(scene, bands=4, device="cpu")
    assert img.shape == (6, 6, 3)
    assert counts() == before


def test_band_path_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        gt.render_progressive(_scene(8))  # cuda is the default device
