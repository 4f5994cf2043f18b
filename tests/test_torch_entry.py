"""gamer_tpu_torch's entry points: the CLI, the device argument, the launch
count, and the rule that the package never imports jax."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402
from gamer_tpu.scene.schema import scene_to_dict  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch import cli  # noqa: E402
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


REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "gamer_tpu_torch"


def _scene(size=8, galaxy=None, **cfg):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy or presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))


def _clean_env():
    """The environment without the JAX settings that keep ``gamer_tpu``
    from importing jax: a port that reached into gamer_tpu would load jax
    here."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env["PYTHONPATH"] = str(REPO)
    return env


def _run_cli(args, tmp_path):
    env = _clean_env()
    return subprocess.run([sys.executable, "-m", "gamer_tpu_torch.cli", *args],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_render_png_matches_library(tmp_path):
    from PIL import Image

    scene = _scene(8)
    sj = tmp_path / "scene.json"
    sj.write_text(json.dumps(scene_to_dict(scene)))
    r = _run_cli(["render", str(sj), str(tmp_path / "out.png"), "--device",
                  "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "Image saved to file" in r.stdout
    decoded = np.asarray(Image.open(tmp_path / "out.png").convert("RGB"))
    np.testing.assert_array_equal(decoded, gt.render_scene(scene, device="cpu"))


def test_cli_render_fits_matches_linear(tmp_path):
    from gamer_tpu.io.fits import read_fits_image

    scene = _scene(6)
    sj = tmp_path / "scene.json"
    sj.write_text(json.dumps(scene_to_dict(scene)))
    assert cli.main(["render", str(sj), str(tmp_path / "lin.fits"),
                     "--device", "cpu"]) == 0
    lin = gt.render_linear(scene, device="cpu").numpy()
    assert len(list(tmp_path.glob("lin*.fits"))) == 3
    for k, ch in enumerate("rgb"):
        img = read_fits_image(tmp_path / f"lin_{ch}.fits")
        # the FITS export stores rows bottom-up (buffer2d.cpp:175-185)
        np.testing.assert_allclose(img[::-1], lin[..., k], rtol=1e-6)


def test_png_writer_roundtrips_through_pil(tmp_path):
    from PIL import Image

    img = np.random.default_rng(5).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    cli.write_png(tmp_path / "r.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "r.png")),
                                  img)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        gt.render_scene(_scene(8), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        gt.render_linear(_scene(8))  # cuda is the default device


def test_launch_count_stays_zero_on_cpu():
    before = cr.march.launch_count
    lin = gt.render_linear(_scene(6), device="cpu")
    img = gt.render_scene(_scene(6), device="cpu", device_out=True)
    assert lin.device.type == "cpu" and img.device.type == "cpu"
    assert isinstance(img, torch.Tensor) and img.dtype == torch.uint8
    assert cr.march.launch_count == before


def test_march_wrapper_rejects_mixed_devices():
    page, table, size, _ = cr.prepare(_scene(4), "cpu")
    with pytest.raises(ValueError):
        cr.march(page, table.to("meta"), size)


def test_package_never_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 5
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax"


def test_package_never_imports_gamer_tpu():
    pat = re.compile(r"^\s*(import|from)\s+gamer_tpu(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports gamer_tpu"


def test_cpu_render_loads_no_jax():
    """Import the port (its viewer, dry run and profiling hooks too),
    render with stars on the CPU, write a PNG and serve one request over a
    mesh, in a process where nothing keeps gamer_tpu from loading jax:
    neither jax nor gamer_tpu may be in sys.modules afterwards."""
    code = (
        "import sys, tempfile\n"
        "import gamer_tpu_torch as gt\n"
        "import gamer_tpu_torch.dryrun, gamer_tpu_torch.utils.profiling\n"
        "import gamer_tpu_torch.viewer\n"
        "from gamer_tpu_torch.cli import write_png\n"
        "from gamer_tpu_torch.models import presets\n"
        "s = gt.Scene(camera=gt.CameraParams(camera=(0.5, 0, 0)),\n"
        "             instances=[gt.GalaxyInstance(galaxy=presets.spiral())],\n"
        "             config=gt.RenderConfig(size=8, ray_step=0.025,\n"
        "                                    no_stars=5, star_size=40.0))\n"
        "img = gt.render_scene(s, device='cpu')\n"
        "assert img.shape == (8, 8, 3)\n"
        "write_png(tempfile.mkdtemp() + '/x.png', img)\n"
        "svc = gt.RenderService(device='cpu', mesh=gt.Mesh(['cpu'] * 2))\n"
        "job = svc.wait(svc.submit(gt.scene_to_dict(s)), timeout=120)\n"
        "svc.stop()\n"
        "assert job.state == 'done' and job.image.shape == (8, 8, 3)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'gamer_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
