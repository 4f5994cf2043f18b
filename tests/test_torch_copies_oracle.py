"""The port's copy of the spec oracle (``gamer_tpu_torch/oracle``, numpy
only) held equal to ``gamer_tpu.oracle``, and ``GRAD3`` to
``gamer_tpu.ops.tables``'s; and the CLI's ``galaxy`` methods that the copy
and the XLA-form surfaces brought (``xla``, ``sharded``, ``oracle``), each
PNG equal to its library call on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

import gamer_tpu  # noqa: E402
from gamer_tpu.models import presets as jpresets  # noqa: E402
from gamer_tpu.ops import tables as jtables  # noqa: E402
from gamer_tpu.oracle import altnoise as jaltnoise  # noqa: E402
from gamer_tpu.oracle import noise as jnoise  # noqa: E402
from gamer_tpu.oracle.reference import render_oracle as jrender_oracle  # noqa: E402,E501

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch import cli  # noqa: E402
from gamer_tpu_torch.engine import queue as tqueue  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.ops import tables  # noqa: E402
from gamer_tpu_torch.oracle import altnoise as taltnoise  # noqa: E402
from gamer_tpu_torch.oracle import noise as tnoise  # noqa: E402
from gamer_tpu_torch.oracle import render_oracle  # noqa: E402
from gamer_tpu_torch.parallel import Mesh, render_scene_sharded  # noqa: E402
from gamer_tpu_torch.scene import gax  # noqa: E402

GALAXY_ARGS = ["0.5", "0", "0", "0", "0", "0", "0", "1", "0", "90", "1.1",
               "0.9", "1.2", "0.025"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_grad3_and_perm_equal_the_originals():
    np.testing.assert_array_equal(tables.GRAD3, jtables.GRAD3)
    assert tables.GRAD3.dtype == jtables.GRAD3.dtype
    np.testing.assert_array_equal(tables.PERM, jtables.PERM)


def test_oracle_noise_equals_the_original():
    rng = np.random.default_rng(7)
    x, y, z = rng.uniform(-20.0, 20.0, (3, 4096))
    np.testing.assert_array_equal(tnoise.raw_noise_3d(x, y, z),
                                  jnoise.raw_noise_3d(x, y, z))
    np.testing.assert_array_equal(
        tnoise.octave_noise_3d(7, 0.6, 0.3, x, y, z),
        jnoise.octave_noise_3d(7, 0.6, 0.3, x, y, z))
    np.testing.assert_array_equal(
        tnoise.ridged_mf(x, y, z, 0.5, 6, 2.1, 1.0, 1.5),
        jnoise.ridged_mf(x, y, z, 0.5, 6, 2.1, 1.0, 1.5))
    np.testing.assert_array_equal(taltnoise.iq_noise(x, y, z),
                                  jaltnoise.iq_noise(x, y, z))
    half = rng.permutation(1024)
    perm = np.concatenate([half, half, half[:2]])
    g3 = rng.normal(size=(len(perm), 3))
    np.testing.assert_array_equal(taltnoise.perlin_raw_3d(perm, g3, x, y, z),
                                  jaltnoise.perlin_raw_3d(perm, g3, x, y, z))


def _scenes(mod, presets_mod, size):
    return [
        mod.Scene(camera=mod.CameraParams(camera=cam, target=(0, 0, 0),
                                          up=(0, 1, 0), fov=fov),
                  instances=[mod.GalaxyInstance(galaxy=g)],
                  config=mod.RenderConfig(size=size, ray_step=0.025,
                                          exposure=1.1, gamma=0.9))
        for cam, fov, g in (((0.5, 0, 0), 90.0, presets_mod.spiral()),
                            ((1.3, -0.7, 2.1), 60.0,
                             presets_mod.dusty_disk()))]


def test_render_oracle_equals_the_original():
    """A 12^2 frame of two presets and two cameras, bit for bit, and the
    same sample counts."""
    for ours, ref in zip(_scenes(gt, presets, 12),
                         _scenes(gamer_tpu, jpresets, 12)):
        img, t = render_oracle(ours)
        want, jt = jrender_oracle(ref)
        np.testing.assert_array_equal(img, want)
        assert (t.samples, t.pixels) == (jt.samples, jt.pixels)
        assert int(img.sum()) > 0


@pytest.fixture
def bulge(tmp_path, monkeypatch):
    """The spiral's bulge alone as a .gax in the working directory: the
    XLA-form march of a 12-chunk CLI frame stays a few seconds."""
    monkeypatch.chdir(tmp_path)
    g = presets.spiral()
    g.components = [c for c in g.components if c.cid == 0]
    gax.save(g, "bulge.gax")
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=g)],
        config=gt.RenderConfig(size=12, ray_step=0.025, exposure=1.1,
                               gamma=0.9, saturation=1.2))


@pytest.mark.parametrize("method", ["xla", "sharded", "oracle"])
def test_cli_galaxy_method_equals_its_library_call(bulge, capsys, method):
    argv = ["galaxy", method, *GALAXY_ARGS, "bulge.gax", "12", "g.png"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Image saved to file g.png" in out
    if method == "xla":
        assert "[ 100.0% ]" in out
        want = tqueue.render_progressive(bulge, chunks=16, device="cpu")
    elif method == "sharded":
        want = render_scene_sharded(bulge, Mesh(["cpu"]))
    else:
        want, _ = render_oracle(bulge)
    got = np.asarray(Image.open("g.png").convert("RGB"))
    np.testing.assert_array_equal(got, want)
