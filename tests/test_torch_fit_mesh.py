"""Data parallelism of the autograd fits of ``gamer_tpu_torch.engine.fit``
(``mesh=``) on the CPU, on meshes of CPU entries: pixel rows (fit_scene,
fit_pose), the batch axis (fit_scene_batch) and the view axis
(fit_scene_multiview), against the port's unsharded fits and against
``gamer_tpu.engine.fit.fit_scene(mesh=make_pixel_mesh())`` on conftest's 8
virtual devices; the divisibility errors; and the service's fit mesh
(``RenderService._fit_mesh``).

Tolerances (``gamer_tpu``'s own for its sharded fits, tests/test_fit.py:
582, 615, 1091): a sharded mean reassociates the loss and the gradient
sums, so fit_scene is held to relative 2e-3 on the losses and fitted
values, fit_pose to 5e-3, fit_scene_multiview to 5e-5; fit_scene_batch
runs each scene's own graph on its entry and is held bit for bit, its
checkpointed resume too. Adam moves each element by about lr x sign(m), so
those trajectories cannot see a gradient part that the mesh drops, doubles
or scales; the summed gradient of every step is therefore also held to the
unsharded one, under plain SGD, at 1e-5 of each leaf's largest element
(the CPU reaches 2.2e-7 on fit_scene and multi-view, 2.2e-6 on fit_pose).

JAX's sharded fit runs in a fresh process started with the module's first
test, so its compiling overlaps the port's fits.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.scene.cameracontrols import orbit_path  # noqa: E402
from gamer_tpu_torch.serve import RenderService  # noqa: E402
from gamer_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

SIZE = 16
SCENE_RTOL = 2e-3
POSE_RTOL = 5e-3
MVIEW_RTOL = 5e-5
GRAD_RTOL = 1e-5
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size, cam=(0.5, 0, 0), galaxy=None):
    return gt.Scene(
        camera=gt.CameraParams(camera=cam, target=(0, 0, 0), up=(0, 1, 0),
                               fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy or presets.spiral())],
        config=gt.RenderConfig(size=size, ray_step=0.025, is_preview=True,
                               noise_octaves=2))


def _scaled(scene, factor):
    s = copy.deepcopy(scene)
    for c in s.instances[0].galaxy.components:
        c.strength *= factor
    return s


def _close(a, b, rtol):
    a, b = (np.asarray(v, np.float64) for v in (a, b))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def _same_fit(got, want, rtol):
    _close(got.losses, want.losses, rtol)
    for x, y in zip(tree_leaves(got.params), tree_leaves(want.params)):
        _close(x, y, rtol)


# ---------------------------------------------------------------------------
# JAX's sharded fit_scene in a fresh process (8 virtual CPU devices)
# ---------------------------------------------------------------------------

_JAX_WORKER = """
import copy
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import gamer_tpu
from gamer_tpu.engine import fit as jfit
from gamer_tpu.engine.render import render_scene
from gamer_tpu.models import presets
from gamer_tpu.parallel.sharding import make_pixel_mesh

size = int(sys.argv[2])
def scene(size):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025,
                                      is_preview=True, noise_octaves=2))
truth = scene(size)
target = render_scene(truth)
start = copy.deepcopy(truth)
for c in start.instances[0].galaxy.components:
    c.strength *= 1.5
mesh = make_pixel_mesh()
assert mesh.devices.size == 8, mesh
res = jfit.fit_scene(start, target, ("strength",), steps=2, lr=5e-2,
                     march="tensor", mesh=mesh)
out = {"target": np.asarray(target),
       "losses": np.asarray(res.losses, np.float64)}
for k, leaf in enumerate(jax.tree_util.tree_leaves(res.params)):
    out[f"p{k}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
print("JAX-FIT-OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_worker(tmp_path_factory):
    """Start JAX's sharded fit with the module's first test; the test that
    compares with it waits for it."""
    tmp = tmp_path_factory.mktemp("jax_fit_mesh")
    worker = tmp / "worker.py"
    worker.write_text(_JAX_WORKER)
    out = tmp / "fit.npz"
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
                                 str(SIZE)], stdout=fh,
                                stderr=subprocess.STDOUT, env=env)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def problem():
    truth = _scene(SIZE)
    target = gt.render_scene(truth, device="cpu")
    return truth, target, _scaled(truth, 1.5)


@pytest.mark.parametrize("march", ["tensor", "frozen"])
def test_fit_scene_mesh_matches_unsharded(problem, march):
    """Pixel rows over 4 entries against the unsharded fit, 3 steps."""
    _, target, start = problem
    kw = dict(fit_fields=("strength", "r0"), steps=3, lr=5e-2, march=march)
    want = tfit.fit_scene(start, target, **kw, **CPU)
    got = tfit.fit_scene(start, target, mesh=Mesh(["cpu"] * 4), **kw)
    _same_fit(got, want, SCENE_RTOL)
    assert got.losses[-1] < got.losses[0]


def test_fit_scene_mesh_matches_jax_sharded_fit(problem, _jax_worker):
    """8 port entries against JAX's fit_scene on an 8-device pixel mesh
    (GSPMD's all-reduce of the replicated parameters' gradients)."""
    _, _, start = problem
    proc, out, log = _jax_worker
    proc.wait(timeout=600)
    text = log.read_text()
    assert proc.returncode == 0 and "JAX-FIT-OK" in text, text[-4000:]
    with np.load(out) as z:
        ref = dict(z)
    # the port's fit against JAX's own target, so only the fits differ
    got = tfit.fit_scene(start, ref["target"], ("strength",), steps=2,
                         lr=5e-2, march="tensor", mesh=Mesh(["cpu"] * 8))
    _close(got.losses, ref["losses"], SCENE_RTOL)
    for k, leaf in enumerate(tree_leaves(got.params)):
        _close(leaf, ref[f"p{k}"], SCENE_RTOL)


def test_fit_pose_mesh_matches_unsharded(problem):
    """fit_pose's rows over 4 entries, pool 2 (normalize on: the loss runs
    on the gathered frame), against the unsharded fit."""
    truth, target, _ = problem
    moved = dataclasses.replace(truth, camera=dataclasses.replace(
        truth.camera, camera=(0.52, 0.01, 0.0)))
    kw = dict(fit_fields=("camera",), steps=2, lr=1e-2, pool=2)
    want = tfit.fit_pose(moved, target, **kw, **CPU)
    got = tfit.fit_pose(moved, target, mesh=Mesh(["cpu"] * 4), **kw)
    _same_fit(got, want, POSE_RTOL)
    assert got.scene.camera.camera != moved.camera.camera


@pytest.fixture(scope="module")
def batch_problem():
    truth = _scene(12)
    factors = (0.7, 0.9, 1.1, 1.3)
    targets = np.stack([gt.render_scene(_scaled(truth, f), device="cpu")
                        for f in factors])
    starts = [_scaled(truth, 1.4 * f) for f in factors]
    return starts, targets


class _SGDProbe:
    """Plain SGD (params += -lr * g) in ``Adam``'s init/update interface
    that keeps each step's gradient as the fit's loop passes it: summed
    over the mesh's entries, made finite and masked."""

    def __init__(self, lr):
        self.lr, self.grads = lr, []

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        self.grads.append([g.detach().numpy().copy()
                           for g in tree_leaves(grads)])
        return tree_map(lambda g: g * -self.lr, grads), state


def _grad_case(name, problem):
    """run(mesh, optimizer) of one gradient case."""
    truth, target, start = problem
    if name.startswith("fit_scene "):
        march = name.split()[1]
        return (lambda m, opt: tfit.fit_scene(
            start, target, ("strength", "r0"), steps=2, lr=5e-2,
            march=march, optimizer=opt, mesh=m, **CPU))
    if name == "fit_pose":
        moved = dataclasses.replace(truth, camera=dataclasses.replace(
            truth.camera, camera=(0.52, 0.01, 0.0)))
        return (lambda m, opt: tfit.fit_pose(
            moved, target, ("camera",), steps=2, lr=1e-3, pool=2,
            optimizer=opt, mesh=m, **CPU))
    small = _scene(12)
    cams = orbit_path(small.camera, 4, 120.0)
    views = np.stack([gt.render_scene(dataclasses.replace(small, camera=c),
                                      device="cpu") for c in cams])
    return (lambda m, opt: tfit.fit_scene_multiview(
        _scaled(small, 1.5), views, cams, ("strength",), steps=2, lr=5e-2,
        march="frozen", optimizer=opt, mesh=m, **CPU))


@pytest.mark.parametrize("name", ["fit_scene tensor", "fit_scene frozen",
                                  "fit_pose", "fit_scene_multiview"])
def test_mesh_gradient_matches_unsharded(problem, name):
    """Each step's summed gradient on 4 entries against the unsharded
    fit's, under plain SGD, whose steps are proportional to the gradient:
    a part dropped, doubled or scaled by 1/n would be >= 25 % off."""
    run = _grad_case(name, problem)
    want, got = _SGDProbe(5e-2), _SGDProbe(5e-2)
    run(None, want)
    run(Mesh(["cpu"] * 4), got)
    assert len(got.grads) == len(want.grads) == 2
    for step_got, step_want in zip(got.grads, want.grads):
        fitted = 0
        for g, w in zip(step_got, step_want):
            scale = float(np.abs(w).max())
            if scale == 0.0:
                # an unfitted leaf: masked to zero on both
                np.testing.assert_array_equal(g, w)
                continue
            fitted += 1
            assert float(np.abs(g - w).max()) <= GRAD_RTOL * scale, (
                name, float(np.abs(g - w).max()) / scale)
        assert fitted


def test_fit_scene_batch_mesh_is_bit_equal(batch_problem, tmp_path):
    """The batch axis over 4 entries: each scene's graph is its unsharded
    one, so the fit is bit-equal; a checkpointed mesh run stopped after a
    step and resumed replays the uninterrupted one exactly."""
    starts, targets = batch_problem
    mesh = Mesh(["cpu"] * 4)
    kw = dict(fit_fields=("strength",), steps=2, lr=5e-2, march="frozen")
    want = tfit.fit_scene_batch(starts, targets, **kw, **CPU)
    got = tfit.fit_scene_batch(starts, targets, mesh=mesh, **kw)
    np.testing.assert_array_equal(got.losses, want.losses)
    for x, y in zip(tree_leaves(got.params), tree_leaves(want.params)):
        np.testing.assert_array_equal(x, y)
    ckpt = str(tmp_path / "batch.ckpt")
    tfit.fit_scene_batch(starts, targets, mesh=mesh, checkpoint_path=ckpt,
                         checkpoint_every=1,
                         on_step=lambda i, _l: i < 0, **kw)
    resumed = tfit.fit_scene_batch(starts, targets, mesh=mesh,
                                   checkpoint_path=ckpt, checkpoint_every=1,
                                   **kw)
    np.testing.assert_array_equal(resumed.losses, want.losses)
    for x, y in zip(tree_leaves(resumed.params), tree_leaves(want.params)):
        np.testing.assert_array_equal(x, y)


def test_fit_scene_multiview_mesh_matches_unsharded():
    """K=4 views over 4 entries (frozen fields per view on its entry)."""
    truth = _scene(12)
    cams = orbit_path(truth.camera, 4, 120.0)
    targets = np.stack([gt.render_scene(dataclasses.replace(truth, camera=c),
                                        device="cpu") for c in cams])
    start = _scaled(truth, 1.5)
    kw = dict(fit_fields=("strength",), steps=2, lr=5e-2, march="frozen")
    want = tfit.fit_scene_multiview(start, targets, cams, **kw, **CPU)
    got = tfit.fit_scene_multiview(start, targets, cams,
                                   mesh=Mesh(["cpu"] * 4), **kw)
    _same_fit(got, want, MVIEW_RTOL)


def test_mesh_divisibility_errors(problem, batch_problem):
    """gamer_tpu's messages: pooled rows, the batch and the view axis."""
    _, target, start = problem
    starts, targets = batch_problem
    with pytest.raises(ValueError, match=r"fit_scene: pooled frame rows 16 "
                       r"must divide the mesh \(3 devices\)"):
        tfit.fit_scene(start, target, steps=1, mesh=Mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match=r"fit_pose: pooled frame rows 4 "
                       r"must divide the mesh \(8 devices\)"):
        tfit.fit_pose(start, target, steps=1, pool=4,
                      mesh=Mesh(["cpu"] * 8))
    with pytest.raises(ValueError, match=r"batch size 4 must divide the "
                       r"mesh \(3 devices\)"):
        tfit.fit_scene_batch(starts, targets, steps=1,
                             mesh=Mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match=r"4 views must divide the mesh "
                       r"\(3 devices\)"):
        tfit.fit_scene_multiview(start, np.stack([target] * 4),
                                 [start.camera] * 4, steps=1,
                                 mesh=Mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="1-D mesh"):
        tfit.fit_scene(start, target, steps=1,
                       mesh=Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2)))


def test_service_fit_mesh(problem):
    """The service shards a fit over its mesh when every rung tiles it
    (16^2 on 8 entries), else runs it on its first device (20^2); a fit
    job's result is the library call's on that mesh."""
    truth, target, start = problem
    mesh = Mesh(["cpu"] * 8)
    svc = RenderService(mesh=mesh, device="cpu")
    try:
        at20 = dataclasses.replace(truth, config=dataclasses.replace(
            truth.config, size=20))
        assert svc._fit_mesh(truth, False) is mesh
        assert svc._fit_mesh(at20, False) is None
        # the scene ladder's quarter rung (4 rows) does not tile 8 entries
        assert svc._fit_mesh(truth, True) is None
        # pose ladder pools of 4 and 2: 4 and 8 pooled rows
        assert svc._fit_mesh(truth, True, pose=True) is None
        assert svc._fit_mesh(truth, False, pose=True) is mesh
        jid = svc.submit_fit(start, target, ("strength",), steps=2, lr=5e-2,
                             march="frozen")
        job = svc.wait(jid, timeout=300)
        assert job.state == "done", job.error
        lib = tfit.fit_scene(start, target, ("strength",), steps=2, lr=5e-2,
                             march="frozen", mesh=mesh)
        assert job.result["losses"] == [float(v) for v in lib.losses]
    finally:
        svc.stop(timeout=60)
