"""The batch path (K4): ``gamer_tpu_torch.render_batch`` and its callers
against the JAX package's ``engine.batch`` (interpreted Pallas), the spec
oracle and the port's own single frames, the JAX page contract, the
``march_batch`` wrapper, and resumable dataset jobs, on the CPU.

Tolerances: <= 2 uint8 LSB against the Pallas kernel, <= 3 LSB against the
oracle. A batch frame equals its single ``render_scene`` exactly: both run
the same plain march on the same page, then the same per-frame epilogue.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import batch as jbatch  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402
from gamer_tpu.scene import generate as jgen  # noqa: E402
from gamer_tpu.scene.cameracontrols import orbit_path  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import batch as tbatch  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine.render import post_process  # noqa: E402
from gamer_tpu_torch.engine.scene_prep import from_jax_pages  # noqa: E402
from gamer_tpu_torch.models import presets as tpresets  # noqa: E402
from gamer_tpu_torch.scene.generate import generate_galaxy_variations  # noqa: E402


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
    cfg.setdefault("ray_step", 0.025)
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy or presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, **cfg))


def _crossing_orbit(size, ray_step=0.025):
    """Two instances of different structure on an orbit that crosses their
    depth order (tests/test_batch.py:112-139, presets for the fixtures)."""
    scene = gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(1.2, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[
            gamer_tpu.GalaxyInstance(galaxy=presets.dusty_disk(),
                                     position=(0.0, 0.0, 0.45)),
            gamer_tpu.GalaxyInstance(galaxy=presets.spiral(),
                                     position=(0.0, 0.0, -0.45)),
        ],
        config=gamer_tpu.RenderConfig(size=size, ray_step=ray_step),
    )
    cams = orbit_path(scene.camera, 4, horizontal_deg=270.0)
    return [dataclasses.replace(scene, camera=c) for c in cams]


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_dataset_batch_matches_jax_batch():
    """Two spiral variations at 16^2 (a dataset batch): one interpreted
    Pallas batch launch against the port's batch."""
    base = _scene(16)
    scenes = [dataclasses.replace(base,
                                  instances=[gamer_tpu.GalaxyInstance(galaxy=g)])
              for g in jgen.generate_galaxy_variations(presets.spiral(), 2,
                                                      seed=3)]
    ref = jbatch.render_batch(scenes)
    ours = gt.render_batch(scenes, device="cpu")
    assert ours.shape == (2, 16, 16, 3) and ours.dtype == np.uint8
    assert all(int(f.sum()) > 0 for f in ours)
    assert (ours[0] != ours[1]).any()
    for i in range(2):
        assert _max_diff(ours[i], ref[i]) <= 2, f"frame {i}"


def test_flythrough_frames_match_oracle():
    """Two orbit frames of the spiral at 16^2 against the spec oracle.
    (On the off-axis frames the JAX engines themselves sit 5 LSB from the
    oracle on the centre pixel, whose ray runs through the galaxy's centre
    in the disk plane; the port agrees with the oracle there.)"""
    from gamer_tpu.oracle.reference import render_oracle

    scene = _scene(16)
    cams = orbit_path(scene.camera, 2, horizontal_deg=30.0)
    frames = gt.render_flythrough(scene, cams, device="cpu")
    assert frames.shape == (2, 16, 16, 3) and (frames[0] != frames[1]).any()
    for i, cam in enumerate(cams):
        want, _ = render_oracle(dataclasses.replace(scene, camera=cam))
        assert _max_diff(frames[i], want) <= 3, f"frame {i}"


def test_mixed_structure_batch_equals_singles():
    """spiral, dusty_disk, spiral: two structure groups; frames 0 and 2
    equal, each frame equal to its single render."""
    a = _scene(8, ray_step=0.1)
    b = _scene(8, presets.dusty_disk(), ray_step=0.1)
    groups = tbatch._scene_groups([a, b, a])
    assert [g[2].tolist() for g in groups] == [[0, 2], [1]]
    frames = gt.render_batch([a, b, a], device="cpu")
    np.testing.assert_array_equal(frames[0], frames[2])
    for i, s in enumerate((a, b)):
        np.testing.assert_array_equal(frames[i],
                                      gt.render_scene(s, device="cpu"))


def test_depth_crossing_groups_match_jax():
    scenes = _crossing_orbit(12)
    ours = tbatch._scene_groups(scenes)
    ref = jbatch._scene_groups(scenes)
    assert len(ours) > 1, "the orbit must cross the depth order"
    assert [g[2].tolist() for g in ours] == [g[2].tolist() for g in ref]


def test_depth_crossing_frames_match_oracle():
    """Every frame composites far to near from its own camera: one frame of
    each structure group, rendered in one batch, against the spec oracle."""
    from gamer_tpu.oracle.reference import render_oracle

    scenes = _crossing_orbit(12)
    picks = [int(g[2][0]) for g in tbatch._scene_groups(scenes)]
    frames = gt.render_batch([scenes[i] for i in picks], device="cpu")
    for frame, i in zip(frames, picks):
        want, _ = render_oracle(scenes[i])
        assert _max_diff(frame, want) <= 3, f"frame {i}"


def test_starred_batch_matches_starred_single():
    """Overlays made once per unique star configuration; star_size 80 at
    8^2 draws splats of width 2."""
    base = _scene(8, no_stars=60, star_size=80.0, star_seed=3, ray_step=0.1)
    other = dataclasses.replace(
        base, config=dataclasses.replace(base.config, star_seed=9))
    frames = gt.render_batch([base, base, other], device="cpu")
    np.testing.assert_array_equal(frames[0], frames[1])
    assert not np.array_equal(frames[0], frames[2])
    np.testing.assert_array_equal(frames[0], gt.render_scene(base,
                                                             device="cpu"))


def test_pages_equal_jax_scene_groups():
    """The page contract: the JAX ``_scene_groups`` rows, cut to the port's
    page length, are the port's pages but for the steps' low words (the
    last entries: 0 from JAX, whose steps are float32; the port's carry the
    scenes' double steps), and the port's batched plain march gives the
    same radiance from either."""
    scenes = _crossing_orbit(4, ray_step=0.1)
    ours = tbatch._scene_groups(scenes)
    ref = jbatch._scene_groups(scenes)
    assert len(ours) == len(ref) > 1
    k = len(cr.STEP_LO)
    for (_, pages, _), (_, rows, _) in zip(ours, ref):
        carried = from_jax_pages(rows, pages.shape[1])
        np.testing.assert_array_equal(carried[:, :-k], pages[:, :-k])
        assert not carried[:, -k:].any()
        np.testing.assert_array_equal(
            pages[:, -k:], [[cr._low_word(0.1), cr._low_word(0.001)]]
            * len(pages))
    # the JAX rows through the port's batched plain march
    st, pages, _ = ours[0]
    table = torch.as_tensor(cr._build_table(st, cr._build_layout(st)))
    jax_pages = torch.as_tensor(from_jax_pages(ref[0][1][:1], pages.shape[1]))
    lin = cr.march_batch_plain(jax_pages, table, 4)
    assert lin.shape == (1, 4, 4, 3)
    assert bool(torch.isfinite(lin).all()) and float(lin.max()) > 0


def test_batch_linear_and_device_out():
    scenes = [_scene(6, ray_step=0.1),
              _scene(6, ray_step=0.1, exposure=0.7, gamma=0.8, saturation=1.3)]
    lin = gt.render_batch_linear(scenes, device="cpu")
    assert isinstance(lin, torch.Tensor) and lin.shape == (2, 6, 6, 3)
    torch.testing.assert_close(lin[0], lin[1], rtol=0, atol=0)
    img = gt.render_batch(scenes, device="cpu", device_out=True)
    assert isinstance(img, torch.Tensor) and img.dtype == torch.uint8
    # per-frame post chain: same radiance, other exposure/gamma/saturation
    assert not torch.equal(img[0], img[1])
    for k, s in enumerate(scenes):
        c = s.config
        torch.testing.assert_close(img[k], post_process(
            lin[k], np.float32(c.exposure), np.float32(c.gamma),
            np.float32(c.saturation)), rtol=0, atol=0)


def test_batch_rejects_what_it_does_not_take():
    a = _scene(6)
    with pytest.raises(ValueError, match="mesh must have axes"):
        gt.render_batch([a], mesh=gt.Mesh(["cpu"] * 4, ("px", "py"), (2, 2)))
    with pytest.raises(ValueError, match="size"):
        gt.render_batch([a, _scene(8)], device="cpu")
    with pytest.raises(ValueError, match="supersample"):
        gt.render_batch([a, _scene(6, supersample=2)], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        gt.render_batch([], device="cpu")
    page, table, size, _ = cr.prepare(a, "cpu")
    with pytest.raises(ValueError):
        cr.march_batch(page, table, size)  # a 1-D page is not a stack
    with pytest.raises(TypeError):
        cr.march_batch(page[None].double(), table, size)
    with pytest.raises(ValueError):
        cr.march_batch(page[None], table.to("meta"), size)
    before = cr.march_batch.launch_count
    cr.march_batch(page[None], table, 2)
    assert cr.march_batch.launch_count == before


def _dataset_scenes(n):
    base = gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        config=gt.RenderConfig(size=6, ray_step=0.1))
    return [dataclasses.replace(base, instances=[gt.GalaxyInstance(galaxy=g)])
            for g in generate_galaxy_variations(tpresets.spiral(), n, seed=5)]


def test_dataset_job_resume_is_bitwise_equal(tmp_path):
    scenes = _dataset_scenes(2)
    full = gt.DatasetJob(scenes, tmp_path / "full", chunk_size=1,
                         device="cpu")
    assert full.n_chunks == 2 and full.run() == 2

    count = {"n": 0}

    def interrupt(c, dt):
        count["n"] += 1
        if count["n"] == 1:
            raise KeyboardInterrupt

    job = gt.DatasetJob(scenes, tmp_path / "part", chunk_size=1, device="cpu")
    with pytest.raises(KeyboardInterrupt):
        job.run(on_chunk=interrupt)
    manifest = json.loads((tmp_path / "part" / "manifest.json").read_text())
    assert manifest["done"] == [0]
    with pytest.raises(RuntimeError, match="incomplete"):
        job.load_all()
    resumed = gt.DatasetJob(scenes, tmp_path / "part", chunk_size=1,
                            device="cpu")
    assert resumed.remaining == [1] and resumed.run() == 1
    for c in range(2):
        name = f"chunk_{c:05d}.npy"
        assert ((tmp_path / "part" / name).read_bytes()
                == (tmp_path / "full" / name).read_bytes())
    out = resumed.load_all()
    assert out.shape == (2, 6, 6, 3) and int(out.sum()) > 0
    assert (out[0] != out[1]).any()
    with pytest.raises(ValueError, match="manifest"):
        gt.DatasetJob(scenes, tmp_path / "part", chunk_size=2, device="cpu")
    with pytest.raises(ValueError, match="manifest"):
        gt.DatasetJob(scenes[:1], tmp_path / "part", chunk_size=1,
                      device="cpu")
