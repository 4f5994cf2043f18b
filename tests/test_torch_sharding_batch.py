"""The batch and ray-list shards on the CPU: ``render_batch(mesh=)`` on a
1-D and on a ('batch', 'rows') mesh (S2) and ``render_allsky_map(mesh=)``
(S3), against the port's unsharded results and against the JAX package's
``shard_map`` forms (the Pallas kernel, interpreted, on the virtual
devices).

Tolerances: <= 1 uint8 LSB between the port's sharded and unsharded frames
on the CPU, <= 2 LSB against the interpreted Pallas kernel. The JAX batch
comparison uses on-axis dataset frames (galaxy variations at the canonical
camera): on off-axis orbit frames the JAX engines themselves drift from the
spec oracle at the centre pixel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import batch as jbatch  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402
from gamer_tpu.scene import generate as jgen  # noqa: E402
from gamer_tpu.scene.cameracontrols import orbit_path  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import batch as tbatch  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.parallel import Mesh, pixel_tile_mesh_2d  # noqa: E402


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


# The sharding is the subject here, not the galaxy: the ring preset has
# each component class of the spiral with one disk where the spiral has
# two, so each interpreted JAX kernel traces one component less.
def _scene(size, camera=(0.5, 0, 0), galaxy=None, **cfg):
    cfg.setdefault("ray_step", 0.025)
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=camera, target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy or presets.ring())],
        config=gamer_tpu.RenderConfig(size=size, **cfg))


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.fixture(scope="module")
def dataset_scenes():
    # ray step 0.1: the plain march's lockstep loop (once per mesh entry)
    # runs a quarter of the steps of 0.025
    base = _scene(16, ray_step=0.1)
    return [dataclasses.replace(base,
                                instances=[gamer_tpu.GalaxyInstance(galaxy=g)])
            for g in jgen.generate_galaxy_variations(presets.ring(), 2,
                                                     seed=3)]


@pytest.fixture(scope="module")
def dataset_frames(dataset_scenes):
    return gt.render_batch(dataset_scenes, device="cpu")


def test_batch_shard_1d_matches_jax(dataset_scenes, dataset_frames):
    """Two dataset frames over a 2-entry batch mesh, both packages."""
    ref = jbatch.render_batch(
        dataset_scenes, mesh=jbatch.make_batch_mesh(jax.devices()[:2]))
    ours = gt.render_batch(dataset_scenes,
                           mesh=tbatch.make_batch_mesh(["cpu"] * 2))
    assert ours.shape == (2, 16, 16, 3) and (ours[0] != ours[1]).any()
    for i in range(2):
        assert _max_diff(ours[i], ref[i]) <= 2, f"frame {i}"
        assert _max_diff(ours[i], dataset_frames[i]) <= 1, f"frame {i}"


def test_batch_shard_2d_matches_jax(dataset_scenes, dataset_frames):
    """The same frames on a (2 batch x 2 rows) mesh, both packages."""
    from jax.sharding import Mesh as JMesh

    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                  ("batch", "rows"))
    ref = jbatch.render_batch(dataset_scenes, mesh=jmesh)
    ours = gt.render_batch(dataset_scenes,
                           mesh=pixel_tile_mesh_2d(2, ["cpu"] * 4))
    for i in range(2):
        assert _max_diff(ours[i], ref[i]) <= 2, f"frame {i}"
        assert _max_diff(ours[i], dataset_frames[i]) <= 1, f"frame {i}"


@pytest.fixture(scope="module")
def orbit():
    scene = _scene(40, ray_step=0.3)
    cams = orbit_path(scene.camera, 3, horizontal_deg=60.0)
    return scene, cams, gt.render_flythrough(scene, cams, device="cpu")


@pytest.mark.parametrize("mesh", [
    Mesh(["cpu"] * 2, ("batch",)),               # 3 frames on 2 entries
    Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2)),
    Mesh(["cpu"] * 6, ("rows", "batch"), (2, 3)),  # axis order is by name
], ids=["1d-2", "2d-2x2", "2d-rows-first"])
def test_flythrough_shards_match_unsharded(mesh, orbit):
    """A 3-frame orbit at size 40 (10 tile rows of each frame dealt over
    the entries, each entry a card of its own): every entry marches its
    rows of all three frames, with no pad frame, on a 1-D mesh and on a
    ('batch', 'rows') mesh in either axis order."""
    scene, cams, want = orbit
    got = gt.render_flythrough(scene, cams, mesh=mesh)
    assert got.shape == (3, 40, 40, 3) and (got[0] != got[2]).any()
    assert _max_diff(got, want) <= 1
    assert cr.march_batch_rowshard.launch_count == 0  # no kernel on the CPU


def test_batch_mesh_axis_names_and_tiling():
    scene = _scene(8, ray_step=0.2)
    with pytest.raises(ValueError, match=r"\('batch', 'rows'\)"):
        gt.render_batch([scene], mesh=Mesh(["cpu"] * 4, ("a", "b"), (2, 2)))
    with pytest.raises(ValueError, match="1- or 2-D mesh"):
        gt.render_batch([scene], mesh=Mesh(["cpu"] * 8, ("a", "b", "c"),
                                           (2, 2, 2)))
    # 3 pages on 2 entries need no pad frame (at 4^2, one tile row: the
    # second entry owns none); an empty galaxy marches in no time and
    # every element of the uninitialised output must come back 0 (the
    # values of 3 frames on 2 entries are held in
    # test_flythrough_shards_match_unsharded); an empty stack raises
    page, table, _, _ = cr.prepare(_scene(4, galaxy=presets.GalaxyData()),
                                   "cpu")
    pages = page[None].repeat(3, 1)
    got = cr.march_batch_rowshard(pages, table, 4,
                                  Mesh(["cpu"] * 2, ("batch",)))
    assert got.shape == (3, 4, 4, 3) and not got.any()
    with pytest.raises(ValueError, match="1 to 65535 frames"):
        cr.march_batch_rowshard(pages[:0], table, 4,
                                Mesh(["cpu"] * 2, ("batch",)))
    assert tbatch.make_batch_mesh(["cpu"] * 3).axis_names == ("batch",)


def test_mixed_structure_batch_on_a_mesh():
    """Two structure groups (spiral x2, dusty_disk x1) on a 2-entry mesh:
    each group is dealt on its own, the lone dusty_disk frame's two tile
    rows one an entry, with no pad frame."""
    a = _scene(8, ray_step=0.2)
    b = dataclasses.replace(a, instances=[gamer_tpu.GalaxyInstance(
        galaxy=presets.dusty_disk())])
    got = gt.render_batch([a, b, a], mesh=Mesh(["cpu"] * 2, ("batch",)))
    want = gt.render_batch([a, b, a], device="cpu")
    assert _max_diff(got, want) <= 1
    np.testing.assert_array_equal(got[0], got[2])


@pytest.fixture(scope="module")
def sky_scene():
    # ray step 0.1: the plain march's lockstep loop (once per mesh entry)
    # runs a quarter of the steps of 0.025
    return _scene(16, camera=(0.3, 0.05, 0), ray_step=0.1)


def test_allsky_shard_matches_jax(sky_scene):
    """The nside-4 map (192 rays) over 8 entries, both packages: the
    analog of tests/test_sharding.py::test_allsky_rowshard_matches_single.
    <= 2 LSB after the post chain, and close as radiance."""
    from gamer_tpu.engine.allsky import render_allsky_map as jmap
    from gamer_tpu.parallel import make_pixel_mesh

    ref = jmap(sky_scene, nside=4, mesh=make_pixel_mesh())
    ours = gt.render_allsky_map(sky_scene, 4, mesh=Mesh(["cpu"] * 8))
    single = gt.render_allsky_map(sky_scene, 4, device="cpu")
    assert ours.shape == ref.shape == (192,) and float(ours.min()) > 0
    np.testing.assert_allclose(ours, single, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(ours, ref, rtol=2e-2, atol=1e-4)
    to_u8 = lambda m: np.clip(m * 10.0, 0, 255).astype(np.uint8)  # noqa: E731
    assert _max_diff(to_u8(ours), to_u8(ref)) <= 2


@pytest.fixture(scope="module")
def ray_list():
    scene = _scene(16, camera=(0.3, 0.05, 0), ray_step=0.3)
    dirs = np.random.default_rng(7).normal(size=(11, 3)).astype(np.float32)
    dirs[4] = 0.0
    return scene, dirs, gt.render_dirs(scene, dirs, device="cpu")


@pytest.mark.parametrize("n", [1, 3, 16])
def test_ray_blocks_cover_the_list(n, ray_list):
    """11 rays over n entries: blocks of ceil(11 / n), the tail short,
    entries past the list idle; a zero direction gives 0."""
    scene, dirs, want = ray_list
    got = gt.render_dirs(scene, dirs, mesh=Mesh(["cpu"] * n))
    assert got.shape == (11, 3) and not got[4].any() and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


def test_allsky_image_on_a_mesh(ray_list):
    scene = ray_list[0]
    with pytest.raises(ValueError, match="1-D mesh"):
        gt.render_allsky_map(scene, 2, mesh=Mesh(["cpu"] * 4,
                                                 ("batch", "rows"), (2, 2)))
    img = gt.render_allsky_image(scene, 2, 24, mesh=Mesh(["cpu"] * 3))
    want = gt.render_allsky_image(scene, 2, 24, device="cpu")
    assert img.shape == (24, 24, 3) and _max_diff(img, want) <= 1
