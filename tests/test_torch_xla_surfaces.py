"""The XLA-form surfaces of ``gamer_tpu_torch`` on the CPU: the sharded
XLA-form frame (``parallel.render_scene_sharded(method="xla")``), the
all-sky map through the XLA-form march (``render_allsky_map(
kernel="xla")``) and the queue's progressive frame
(``engine.queue.render_progressive``), against the port's unsharded
XLA-form frame (``engine.render.render_scene``) and against the JAX
package's same calls.

Tolerances: a row slab of the XLA-form march is the same rows of the whole
frame (every ray marches element-wise, and a done ray's state no longer
changes), so the sharded and the progressive frames are held bit for bit
to the unsharded one; against JAX's XLA march <= 2 uint8 LSB (the ladder's
XLA step, tests/test_torch_xla_march.py); the all-sky map to the map gate
of tests/test_pallas.py (max |d| / max |m| < 1e-3).

The JAX references run in a fresh process started with the module's first
test (4 of conftest's 8 virtual devices for the sharded frames).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import queue as tqueue  # noqa: E402
from gamer_tpu_torch.engine import render as trender  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.parallel import Mesh, render_scene_sharded  # noqa: E402

SIZES = (16, 20)
NSIDE = 8
MAP_GATE = 1e-3
LSB = 2
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size, camera=(0.5, 0.0, 0.0), **cfg):
    cfg = {"is_preview": True, "noise_octaves": 3, **cfg}
    return gt.Scene(
        camera=gt.CameraParams(camera=camera, target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg))


_JAX_WORKER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import gamer_tpu
from gamer_tpu.engine import queue as jqueue
from gamer_tpu.engine.allsky import render_allsky_map
from gamer_tpu.models import presets
from gamer_tpu.parallel.sharding import make_pixel_mesh, render_scene_sharded

sizes, nside = eval(sys.argv[2]), int(sys.argv[3])
def scene(size, camera=(0.5, 0.0, 0.0), **cfg):
    cfg = {"is_preview": True, "noise_octaves": 3, **cfg}
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=camera, target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))
out = {}
mesh = make_pixel_mesh(jax.devices()[:4])
for size in sizes:
    out[f"sharded{size}"] = render_scene_sharded(scene(size), mesh,
                                                 method="xla")
for ss in (1, 2):
    out[f"progressive{ss}"] = jqueue.render_progressive(
        scene(sizes[0], supersample=ss), chunks=16)
out["allsky"] = render_allsky_map(scene(16, camera=(0.3, 0.05, 0.0)), nside,
                                  kernel="xla")
np.savez(sys.argv[1], **out)
print("JAX-XLA-OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_worker(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_xla_surfaces")
    worker = tmp / "worker.py"
    worker.write_text(_JAX_WORKER)
    out = tmp / "frames.npz"
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count"
                            "=8").strip()
    env["PYTHONPATH"] = str(repo) + (
        (":" + env["PYTHONPATH"]) if env.get("PYTHONPATH") else "")
    log = tmp / "worker.log"
    with open(log, "w") as fh:
        # output to a file: a full pipe would stall the worker
        proc = subprocess.Popen([sys.executable, str(worker), str(out),
                                 repr(SIZES), str(NSIDE)], stdout=fh,
                                stderr=subprocess.STDOUT, env=env)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def jax_ref(_jax_worker):
    proc, out, log = _jax_worker
    proc.wait(timeout=600)
    text = log.read_text()
    assert proc.returncode == 0 and "JAX-XLA-OK" in text, text[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def unsharded():
    return {size: trender.render_scene(_scene(size), **CPU) for size in SIZES}


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("size", SIZES)
def test_sharded_xla_frame_is_the_unsharded_frame(unsharded, jax_ref, size):
    """Row slabs of the XLA-form march on 4 CPU entries: bit-equal to the
    unsharded frame, and within 2 LSB of JAX's sharded XLA frame (4
    devices)."""
    got = render_scene_sharded(_scene(size), Mesh(["cpu"] * 4), method="xla")
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    assert int(got.sum()) > 0
    np.testing.assert_array_equal(got, unsharded[size])
    assert _lsb(got, jax_ref[f"sharded{size}"]) <= LSB


def test_sharded_xla_arguments():
    """The size must tile the mesh (JAX's message); the pallas method is
    float32 only; float64 marches and stays bit-equal across the mesh."""
    scene = _scene(18)
    with pytest.raises(ValueError) as e:
        render_scene_sharded(scene, Mesh(["cpu"] * 4), method="xla")
    assert str(e.value) == ("size 18 not divisible by mesh size 4; choose a "
                            "size that tiles over the mesh")
    with pytest.raises(ValueError, match="float32 only"):
        render_scene_sharded(scene, Mesh(["cpu"] * 2), dtype=torch.float64)
    small = _scene(8, noise_octaves=2)
    f64 = render_scene_sharded(small, Mesh(["cpu"] * 2), dtype=torch.float64,
                               method="xla")
    np.testing.assert_array_equal(
        f64, trender.render_scene(small, dtype=torch.float64, **CPU))
    assert _lsb(f64, trender.render_scene(small, **CPU)) <= LSB


def test_allsky_xla_map_matches_jax(jax_ref):
    """The ray list through the XLA-form march against JAX's kernel="xla"
    map; a mesh needs the kernel."""
    scene = _scene(16, camera=(0.3, 0.05, 0.0))
    ours = gt.render_allsky_map(scene, NSIDE, kernel="xla", **CPU)
    ref = jax_ref["allsky"]
    assert ours.shape == (12 * NSIDE ** 2,) and ours.dtype == np.float64
    assert (ours > 0).all()
    assert np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-12) < MAP_GATE
    with pytest.raises(ValueError, match="mesh sharding needs the pallas"):
        gt.render_allsky_map(scene, NSIDE, kernel="xla",
                             mesh=Mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="unknown all-sky kernel"):
        gt.render_allsky_map(scene, NSIDE, kernel="oracle", **CPU)


@pytest.mark.parametrize("ss", [1, 2])
def test_progressive_xla_ticks_abort_and_frame(unsharded, jax_ref, ss):
    """8 chunks of two rows: ticks in order, each partial frame black below
    the rows rendered so far; an abort after chunk 4 returns that partial
    frame; the finished frame is the unsharded XLA-form frame bit for bit
    and within 2 LSB of JAX's queue (16 chunks there)."""
    size = SIZES[0]
    scene = _scene(size, supersample=ss)
    want = (unsharded[size] if ss == 1
            else trender.render_scene(scene, **CPU))
    ticks = []

    def record(frac, partial):
        ticks.append((frac, partial))

    got = tqueue.render_progressive(scene, chunks=8, on_progress=record,
                                    **CPU)
    assert [f for f, _ in ticks] == [(c + 1) / 8 for c in range(8)]
    for c, (_, partial) in enumerate(ticks):
        rows = 2 * (c + 1)
        np.testing.assert_array_equal(partial[:rows], want[:rows])
        assert not partial[rows:].any()
    np.testing.assert_array_equal(got, want)
    assert _lsb(got, jax_ref[f"progressive{ss}"]) <= LSB

    seen = []

    def stop_after_4(frac, partial):
        seen.append(frac)
        return len(seen) < 4

    aborted = tqueue.render_progressive(scene, chunks=8,
                                        on_progress=stop_after_4, **CPU)
    assert seen == [0.125, 0.25, 0.375, 0.5]
    np.testing.assert_array_equal(aborted, ticks[3][1])
