"""gamer_tpu_torch's positional CLI commands on the CPU (``--device cpu``):
``galaxy`` (the reference's 19-token form, through the band path),
``skybox``, ``flythrough``, ``morph``, ``scene``, ``dataset`` and ``info``,
each output decoded and held to the library's frames; and the render queue
against the JAX package's. The ``.gax`` and RenderParams.dat inputs are
written by the port's own codecs from the presets."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from gamer_tpu.engine import queue as jqueue  # noqa: E402
from gamer_tpu.scene import gax as jgax  # noqa: E402
from gamer_tpu.scene.schema import galaxy_to_dict  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch import cli  # noqa: E402
from gamer_tpu_torch.engine import queue as tqueue  # noqa: E402
from gamer_tpu_torch.io.renderparams import RenderParamsFile  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.scene import gax  # noqa: E402
from gamer_tpu_torch.scene.cameracontrols import orbit_path  # noqa: E402
from gamer_tpu_torch.scene.generate import generate_scene  # noqa: E402
from gamer_tpu_torch.scene.morph import morph_scenes  # noqa: E402


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


@pytest.fixture
def work(tmp_path, monkeypatch):
    """A working directory with spiral.gax, wound.gax (a morph-compatible
    spiral), ring.gax and a RenderParams.dat."""
    monkeypatch.chdir(tmp_path)
    gax.save(presets.spiral(), "spiral.gax")
    gax.save(presets.spiral(winding_n=6.0, winding_b=0.8), "wound.gax")
    gax.save(presets.ring(), "ring.gax")
    RenderParamsFile(camera=gt.CameraParams(camera=(0.5, 0, 0)),
                     ray_step=0.1, exposure=1.2,
                     spectra={"Custom": (0.2, 0.4, 0.9)}).save("rp.dat")
    return tmp_path


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _canonical(galaxy, size, **cfg):
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy)],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg))


GALAXY_ARGS = ["0.5", "0", "0", "0", "0", "0", "0", "1", "0", "90", "1.1",
               "0.9", "1.2", "0.025"]


def test_galaxy_19_tokens_through_the_band_path(work, capsys):
    argv = ["galaxy", "omp", *GALAXY_ARGS, "spiral.gax", "12", "g.png"]
    assert len(argv) == 19
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[ 100.0% ]" in out and "Image saved to file g.png" in out
    want = gt.render_progressive(
        _canonical(presets.spiral(), 12, exposure=1.1, gamma=0.9,
                   saturation=1.2), device="cpu")
    np.testing.assert_array_equal(_png("g.png"), want)


@pytest.mark.parametrize("method", ["xla", "oracle", "sharded", "vulkan"])
def test_galaxy_refuses_unported_methods(work, capsys, method):
    """Every method of gamer_tpu.cli is ported; an unknown one is refused
    and writes nothing (the frames are held to their library calls in
    tests/test_torch_copies_oracle.py)."""
    argv = ["galaxy", method, *GALAXY_ARGS, "ring.gax", "4", "g.png"]
    rc = cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "not ported" not in out
    assert rc == (1 if method == "vulkan" else 0)
    assert ("Cannot recognize" in out) == (method == "vulkan")
    assert (work / "g.png").exists() == (method != "vulkan")


def test_bad_usage_exits_one(work):
    assert cli.main(["galaxy", "omp", "1", "2", "--device", "cpu"]) == 1
    assert cli.main(["skybox", "omp", "rp.dat", "--device", "cpu"]) == 1
    assert cli.main(["nope"]) == 1
    assert cli.main(["info", "spiral.gax", "--device", "tpu"]) == 1
    assert cli.main([]) == 0


def test_skybox_writes_six_faces(work):
    assert cli.main(["skybox", "pallas", "rp.dat", "spiral.gax", "8",
                     "--device", "cpu"]) == 0
    rp = RenderParamsFile.load("rp.dat")
    scene = gt.Scene(camera=rp.camera,
                     instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
                     config=rp.to_render_config(size=8), spectra=rp.spectra)
    jobs = tqueue.skybox_jobs(scene)
    assert [j.filename for j in jobs] == [f"Skybox{n}" for n, _, _ in
                                          tqueue.SKYBOX_FACES]
    for job in jobs:
        assert _png(f"{job.filename}.png").shape == (8, 8, 3)
    # a batch frame equals its single frame
    np.testing.assert_array_equal(_png(f"{jobs[5].filename}.png"),
                                  gt.render_scene(jobs[5].scene, device="cpu"))


def test_flythrough_writes_frames(work, capsys):
    assert cli.main(["flythrough", "spiral.gax", "2", "8", "fly",
                     "--device", "cpu"]) == 0
    assert "Saved 2 frames" in capsys.readouterr().out
    scene = _canonical(presets.spiral(), 8)
    want = gt.render_flythrough(scene, orbit_path(scene.camera, 2),
                                device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(_png(f"fly_{i:03d}.png"), want[i])


def test_morph_writes_frames(work):
    assert cli.main(["morph", "spiral.gax", "wound.gax", "2", "8", "mo",
                     "--device", "cpu"]) == 0
    scenes = morph_scenes(_canonical(presets.spiral(), 8),
                          presets.spiral(winding_n=6.0, winding_b=0.8), 2)
    want = gt.render_batch(scenes, device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(_png(f"mo_{i:03d}.png"), want[i])
    # incompatible structures: refused, nothing written
    assert cli.main(["morph", "spiral.gax", "ring.gax", "2", "8", "bad",
                     "--device", "cpu"]) == 1
    assert not (work / "bad_000.png").exists()


def test_scene_mode(work):
    assert cli.main(["scene", "spiral.gax,ring.gax", "2", "1.5", "4", "8",
                     "sc.png", "--device", "cpu"]) == 0
    base = gt.Scene(
        camera=gt.CameraParams(camera=(2.5, 0.4, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=70.0),
        config=gt.RenderConfig(size=8, ray_step=0.025))
    scene = generate_scene([presets.spiral(), presets.ring()], 2, 1.5, seed=4,
                           base_scene=base)
    np.testing.assert_array_equal(_png("sc.png"),
                                  gt.render_scene(scene, device="cpu"))


def test_dataset_runs_and_resumes(work, capsys):
    args = ["dataset", "spiral.gax", "2", "1", "6", "1", "ds", "--device",
            "cpu"]
    assert cli.main(args) == 0
    assert "2/2 chunks this run" in capsys.readouterr().out
    assert cli.main(args) == 0  # everything is done: nothing renders
    assert "0/2 chunks this run" in capsys.readouterr().out
    manifest = json.loads((work / "ds" / "manifest.json").read_text())
    assert sorted(manifest["done"]) == [0, 1]
    got = np.concatenate([np.load(work / "ds" / f"chunk_{c:05d}.npy")
                          for c in range(2)])
    want = gt.render_batch(cli.dataset_scenes(["spiral.gax"], 2, 1, 6),
                           device="cpu")
    np.testing.assert_array_equal(got, want)


def test_info_prints_the_galaxy(work, capsys):
    assert cli.main(["info", "spiral.gax"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out) == json.loads(json.dumps(
        galaxy_to_dict(jgax.load(work / "spiral.gax"))))


def test_render_queue_matches_jax_queue(work):
    """The queue renders through the band path here and through the XLA
    march in the JAX package: <= 2 LSB, the ladder's XLA rung."""
    import gamer_tpu

    from gamer_tpu.models import presets as jpresets

    jscene = gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0)),
        instances=[gamer_tpu.GalaxyInstance(galaxy=jpresets.spiral())],
        config=gamer_tpu.RenderConfig(size=12, ray_step=0.025))
    (work / "j").mkdir()
    (work / "t").mkdir()
    jq = jqueue.RenderQueue(chunks=4)
    jq.add(jqueue.RenderJob(scene=jscene, filename="a"))
    ref = [img for _, img, _ in jq.render_all(str(work / "j"))]
    ticks = []
    tq = tqueue.RenderQueue(chunks=4, device="cpu")
    tq.add(tqueue.RenderJob(scene=jscene, filename="a"))
    ours = [img for _, img, _ in tq.render_all(
        str(work / "t"), on_progress=lambda name, f: ticks.append((name, f)))]
    assert ticks and ticks[-1] == ("a", 1.0) and tq.jobs == []
    d = np.abs(ours[0].astype(np.int16) - ref[0].astype(np.int16))
    assert int(d.max()) <= 2
    np.testing.assert_array_equal(_png(work / "t" / "a.png"), ours[0])


def test_png_module_is_the_cli_writer(tmp_path):
    from gamer_tpu_torch.io import png

    assert cli.write_png is png.write_png
    img = np.random.default_rng(7).integers(0, 256, (5, 9, 3), dtype=np.uint8)
    png.write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(_png(tmp_path / "x.png"), img)
    with pytest.raises(ValueError):
        png.write_png(tmp_path / "y.png", img[..., :2])


def test_skybox_jobs_match_jax():
    import gamer_tpu

    from gamer_tpu.models import presets as jpresets

    cam = dict(camera=(0.3, -0.2, 0.7), target=(0, 0, 0), up=(0, 1, 0))
    ours = tqueue.skybox_jobs(gt.Scene(camera=gt.CameraParams(**cam),
                                       instances=[gt.GalaxyInstance(
                                           galaxy=presets.ring())]), "S")
    ref = jqueue.skybox_jobs(gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(**cam),
        instances=[gamer_tpu.GalaxyInstance(galaxy=jpresets.ring())]), "S")
    assert tqueue.SKYBOX_FACES == jqueue.SKYBOX_FACES
    assert [j.filename for j in ours] == [j.filename for j in ref]
    for a, b in zip(ours, ref):
        assert (dataclasses.astuple(a.scene.camera)
                == dataclasses.astuple(b.scene.camera))
