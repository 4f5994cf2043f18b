"""The pose fits of ``gamer_tpu_torch.engine.fit`` on the CPU against
``gamer_tpu.engine.fit``: the differentiable camera chain
(``ops.camera.inv_view_projection_tensor``), ``fit_pose`` (tensor march,
gradients through the ray grid into camera, target and fov) and
``fit_pose_fd`` (probe batches on ``march_batch``'s plain version here, K4
on the card), with their contracts: checkpoint resume, the fingerprints,
the field and march checks, ``mesh=`` and the card default
(tests/test_fit.py:204-300, 709-730).

Tolerances (as tests/test_torch_fit_fd.py's header):
- the tensor camera matrix: bit-equal to the host form; its gradient
  within relative 1e-4 (L2, per input) of ``jax.grad`` of
  ``gamer_tpu.ops.camera.inv_view_projection`` (the same float32
  expressions in two libraries);
- the pose gradient of fit_pose's loss: within relative 1e-3 (L2) of
  ``jax.grad`` of the same loss (the march's gradients agree to ~1e-4 per
  leaf, test_torch_grad.py, and the camera sums every ray's);
- 2-step trajectories at 12^2 with noise_octaves=2 (full-octave noise
  decorrelates under sub-pixel moves, tests/test_fit.py:204-230): losses
  within relative 1e-4 of JAX's, and fit_pose_fd's probe losses too;
- checkpoint resume: bit-equal to the uninterrupted run.

The JAX gradients run in a fresh subprocess, as in test_torch_grad.py.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import batch as jbatch  # noqa: E402
from gamer_tpu.engine import fit as jfit  # noqa: E402
from gamer_tpu.engine.render import render_scene as jrender_scene  # noqa: E402
from gamer_tpu.scene.schema import default_galaxy  # noqa: E402

from gamer_tpu_torch.engine import batch as tbatch  # noqa: E402
from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.engine.diff import post_process_float  # noqa: E402
from gamer_tpu_torch.ops import camera as tcam  # noqa: E402
from gamer_tpu_torch.utils.tree import tree_map  # noqa: E402

SIZE = 12
GRAD_SIZE = 8
RTOL = 1e-4
CAM_GRAD_RTOL = 1e-4
POSE_GRAD_RTOL = 1e-3
START_CAM = (0.52, 0.01, 0.0)
POSES = [
    ((0.5, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 90.0),
    ((2.5, 0.3, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 70.0),
    ((1.3, -0.7, 2.1), (0.2, 0.1, -0.3), (0.1, 0.9, 0.2), 45.0),
    ((-3.0, 2.0, 1.0), (0.5, -0.5, 0.0), (0.0, 0.0, 1.0), 120.0),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy, size, cam=(0.5, 0, 0), **cfg):
    cfg = {"noise_octaves": 2, **cfg}
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=cam, target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy)],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025,
                                      is_preview=True, **cfg))


def _moved(scene, cam=START_CAM):
    return dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, camera=cam))


def _weights(seed=3):
    return np.random.default_rng(seed).normal(size=(4, 4)).astype(np.float32)


# ---------------------------------------------------------------------------
# jax.grad in a fresh process: the camera chain, and fit_pose's loss
# ---------------------------------------------------------------------------

_JAX_WORKER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import gamer_tpu
from gamer_tpu.engine import diff as gdiff
from gamer_tpu.engine.render import render_scene
from gamer_tpu.engine.scene_prep import flatten_scene
from gamer_tpu.engine.tensor_march import render_rays_tensor
from gamer_tpu.ops import camera as cam_ops
from gamer_tpu.scene.schema import default_galaxy

poses = eval(sys.argv[2])
size = int(sys.argv[3])
w = jnp.asarray(np.random.default_rng(3).normal(size=(4, 4)).astype(
    np.float32))
out = {}
for n, (c, t, u, fov) in enumerate(poses):
    def chain(c, t, fov, u=jnp.asarray(u, jnp.float32)):
        return jnp.sum(w * cam_ops.inv_view_projection(c, t, u, fov))
    g = jax.grad(chain, argnums=(0, 1, 2))(
        jnp.asarray(c, jnp.float32), jnp.asarray(t, jnp.float32),
        jnp.asarray(fov, jnp.float32))
    for k, name in enumerate(("camera", "target", "fov")):
        out[f"chain{n}_{name}"] = np.asarray(g[k])

# fit_pose's loss (gamer_tpu/engine/fit.py:1122-1165) at the start pose
def scene_at(cam):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=cam, target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=default_galaxy())],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025,
                                      is_preview=True, noise_octaves=2))
target = jnp.asarray(np.asarray(render_scene(scene_at((0.5, 0, 0))),
                                np.float32) / 255.0)
scene = scene_at((0.52, 0.01, 0.0))
static, gal = flatten_scene(scene)
gal = jax.tree_util.tree_map(jnp.asarray, gal)
up = jnp.asarray(scene.camera.up, jnp.float32)
bound = gdiff.step_bound_for_scene(scene)
f = jnp.float32

def prep(img):
    return img / (jnp.mean(img) + 1e-6)

def loss(p):
    inv_vp = cam_ops.inv_view_projection(p["camera"], p["target"], up,
                                         p["fov"])
    dirs = cam_ops.ray_grid(size, inv_vp)
    lin = render_rays_tensor(static, gal, dirs, p["camera"], f(0.025),
                             f(scene.config.min_ray_step), bound)
    img = gdiff.post_process_float(lin, f(1.0), f(1.0), f(1.0)) / 255.0
    return jnp.mean((prep(img) - prep(target)) ** 2)

pose = {"camera": jnp.asarray(scene.camera.camera, jnp.float32),
        "target": jnp.asarray(scene.camera.target, jnp.float32),
        "fov": jnp.asarray(scene.camera.fov, jnp.float32)}
value, grads = jax.value_and_grad(loss)(pose)
out["pose_loss"] = np.asarray(value)
for k in pose:
    out["pose_" + k] = np.asarray(grads[k])
np.savez(sys.argv[1], **out)
print("GRADS-OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_worker(tmp_path_factory):
    """Start the JAX gradients' process with the module's first test, so
    its ~30 s of compiling overlap the trajectory tests; the gradient
    tests come last and wait for it."""
    tmp = tmp_path_factory.mktemp("jax_pose_grads")
    worker = tmp / "worker.py"
    worker.write_text(_JAX_WORKER)
    out = tmp / "grads.npz"
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(repo) + (
        (":" + env["PYTHONPATH"]) if env.get("PYTHONPATH") else "")
    log = tmp / "worker.log"
    with open(log, "w") as fh:
        # output to a file: a full pipe would stall the worker
        proc = subprocess.Popen([sys.executable, str(worker), str(out),
                                 repr(POSES), str(GRAD_SIZE)], stdout=fh,
                                stderr=subprocess.STDOUT, env=env)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def jax_grads(_jax_worker):
    proc, out, log = _jax_worker
    proc.wait(timeout=600)
    text = log.read_text()
    assert proc.returncode == 0 and "GRADS-OK" in text, text[-4000:]
    with np.load(out) as z:
        return dict(z)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# trajectories against the JAX package
# ---------------------------------------------------------------------------


def _captured(monkeypatch, module, run):
    """run()'s result and the fingerprint strings it computed."""
    real = module._fit_fingerprint
    seen = []

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(module, "_fit_fingerprint", spy)
    try:
        return run(), seen
    finally:
        monkeypatch.setattr(module, "_fit_fingerprint", real)


@pytest.fixture(scope="module")
def pose_problem():
    truth = _scene(default_galaxy(), SIZE)
    return _moved(truth), jrender_scene(truth)


@pytest.fixture(scope="module")
def pose_fits(pose_problem):
    start, target = pose_problem
    kw = dict(fit_fields=("camera",), steps=2, lr=1e-2)
    mp = pytest.MonkeyPatch()
    try:
        ref = _captured(mp, jfit, lambda: jfit.fit_pose(start, target, **kw))
        ours = _captured(mp, tfit, lambda: tfit.fit_pose(
            start, target, device="cpu", **kw))
    finally:
        mp.undo()
    return ref, ours


def test_fit_pose_matches_jax(pose_fits):
    (ref, ref_fp), (ours, our_fp) = pose_fits
    assert len(ours.losses) == len(ref.losses) == 3
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ours.params["camera"],
                               np.asarray(ref.params["camera"]), rtol=1e-5)
    assert min(ours.losses) < ours.losses[0]
    assert ours.scene.camera.camera == tuple(
        float(v) for v in ours.params["camera"])
    # the unfitted target and fov stay exactly where they were
    assert ours.scene.camera.target == (0.0, 0.0, 0.0)
    assert ours.scene.camera.fov == 90.0
    assert our_fp == ref_fp


def test_fit_pose_starts_at_the_fit_scene_loss(pose_problem):
    """The tensor camera chain is the host form, so a pose fit's first
    loss (normalize off) is fit_scene's loss at the same pose, bit for
    bit."""
    start, target = pose_problem
    a = tfit.fit_pose(start, target, ("camera",), steps=0, normalize=False,
                      device="cpu")
    b = tfit.fit_scene(start, target, ("strength",), steps=0, march="tensor",
                       device="cpu")
    assert a.losses == b.losses


def _spied_batches(monkeypatch, module, run):
    real = module.render_batch_linear
    seen = []

    def spy(scenes, *a, **k):
        out = real(scenes, *a, **k)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "render_batch_linear", spy)
    try:
        return run(), seen
    finally:
        monkeypatch.setattr(module, "render_batch_linear", real)


@pytest.fixture(scope="module")
def fd_problem():
    truth = _scene(default_galaxy(2), SIZE)
    return _moved(truth), jrender_scene(truth)


@pytest.fixture(scope="module")
def fd_fits(fd_problem):
    start, target = fd_problem
    kw = dict(fit_fields=("camera",), steps=2, lr=1e-2)
    mp = pytest.MonkeyPatch()
    try:
        ref = _captured(mp, jfit, lambda: _spied_batches(
            mp, jbatch, lambda: jfit.fit_pose_fd(start, target, **kw)))
        ours = _captured(mp, tfit, lambda: _spied_batches(
            mp, tbatch, lambda: tfit.fit_pose_fd(start, target,
                                                 device="cpu", **kw)))
    finally:
        mp.undo()
    return ref, ours


def _norm_losses(lin, target):
    """fit_pose_fd's device loss of each probe frame (normalize on)."""
    one = torch.tensor(1.0)
    img = post_process_float(torch.tensor(np.array(lin)), one, one,
                             one) / 255.0
    img = img / (torch.mean(img, dim=(1, 2, 3), keepdim=True) + 1e-6)
    t = np.asarray(target, np.float32) / 255.0
    t = torch.as_tensor(t / (t.mean() + 1e-6))
    return torch.mean((img - t) ** 2, dim=(1, 2, 3)).numpy()


def test_fit_pose_fd_probe_losses_match_jax(fd_fits, fd_problem):
    """Each step's 7 frames (the pose, then +eps and -eps per camera
    coordinate) are one render_batch_linear call in both packages; the
    first set's losses agree."""
    ((_, ref_lin), _), ((_, our_lin), _) = fd_fits
    assert len(ref_lin) == len(our_lin) == 3
    assert our_lin[0].shape == (7, SIZE, SIZE, 3)
    a = _norm_losses(ref_lin[0], fd_problem[1])
    b = _norm_losses(our_lin[0], fd_problem[1])
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)
    assert len(set(a.tolist())) == 7  # every probe moves the image


def test_fit_pose_fd_matches_jax(fd_fits):
    ((ref, _), ref_fp), ((ours, _), our_fp) = fd_fits
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ours.params["camera"], ref.params["camera"],
                               rtol=1e-5)
    assert min(ours.losses) < ours.losses[0]
    assert our_fp == ref_fp


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------


def test_fit_pose_checkpoint_resume(pose_problem, tmp_path):
    """Interrupted after 1 step and resumed, a 3-step pose fit replays the
    uninterrupted one bit for bit (tests/test_fit.py:709-730)."""
    start, target = pose_problem
    kw = dict(fit_fields=("camera", "fov"), lr=1e-2, device="cpu")
    straight = tfit.fit_pose(start, target, steps=3, **kw)
    ckpt = str(tmp_path / "pose.ckpt")
    tfit.fit_pose(start, target, steps=1, checkpoint_path=ckpt,
                  checkpoint_every=1, **kw)
    resumed = tfit.fit_pose(start, target, steps=3, checkpoint_path=ckpt,
                            checkpoint_every=1, **kw)
    assert resumed.losses == straight.losses
    for k in ("camera", "target", "fov"):
        np.testing.assert_array_equal(resumed.params[k], straight.params[k])
    assert straight.params["fov"] != 90.0  # fov was fitted (and clipped)
    with pytest.raises(ValueError, match="different fit"):
        tfit.fit_pose(start, target, steps=3, checkpoint_path=ckpt,
                      fit_fields=("camera",), lr=1e-2, device="cpu")


def test_fit_pose_fd_checkpoint_resume(tmp_path):
    """The host Adam moments live in the checkpoint: interrupted after 1
    step and resumed, the fit replays the uninterrupted one bit for bit
    (tests/test_fit.py:274-298; a bulge at 8^2 keeps the plain batches
    short)."""
    truth = _scene(default_galaxy(1), 8)
    target = jrender_scene(truth)
    start = _moved(truth)
    kw = dict(fit_fields=("fov",), lr=1e-2, device="cpu")
    straight = tfit.fit_pose_fd(start, target, steps=2, **kw)
    ckpt = str(tmp_path / "posefd.ckpt")
    tfit.fit_pose_fd(start, target, steps=1, checkpoint_path=ckpt,
                     checkpoint_every=1, **kw)
    resumed = tfit.fit_pose_fd(start, target, steps=2, checkpoint_path=ckpt,
                               checkpoint_every=1, **kw)
    assert resumed.losses == straight.losses
    np.testing.assert_array_equal(resumed.params["fov"],
                                  straight.params["fov"])
    assert straight.params["fov"] != np.float32(90.0)


def test_pose_fits_reject_fields_march_and_mesh(pose_problem):
    start, target = pose_problem
    for fn in (tfit.fit_pose, tfit.fit_pose_fd):
        with pytest.raises(ValueError, match="unknown pose fields"):
            fn(start, target, fit_fields=("up",), steps=1, device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        tfit.fit_pose(start, target, steps=1, march="frozen", device="cpu")
    with pytest.raises(ValueError, match="must divide the mesh"):
        tfit.fit_pose(start, target, steps=1, mesh=Mesh(["cpu"] * 7),
                      device="cpu")
    with pytest.raises(ValueError, match="target must be"):
        tfit.fit_pose(start, target[:8, :8], steps=1, device="cpu")


def test_pose_fits_need_a_card_for_cuda(pose_problem):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path is the card's test")
    start, target = pose_problem
    for fn in (tfit.fit_pose, tfit.fit_pose_fd):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(start, target, steps=1)


# ---------------------------------------------------------------------------
# the camera chain and fit_pose's gradient against jax.grad (last: they wait
# for the JAX process)
# ---------------------------------------------------------------------------


def _elementwise_host_form(camera, target, up, fov_deg, near=1.0,
                           far=100.0):
    """The host matrix as the port first computed it, kept here frozen: V^-1
    and P^-1 written element by element into zeroed float32 tensors, the
    fov halved in numpy float32 and every constant divided as a Python
    float. The tensor form must give these bits, so the march kernels are
    fed the same matrix as before it existed."""
    from gamer_tpu_torch.ops.math3d import dot3

    f = torch.float32
    camera = torch.as_tensor(np.asarray(camera, np.float32), dtype=f)
    target = torch.as_tensor(np.asarray(target, np.float32), dtype=f)
    up = torch.as_tensor(np.asarray(up, np.float32), dtype=f)
    eye, center = target, camera
    fwd = center - eye
    fwd = fwd / torch.sqrt(dot3(fwd, fwd))
    side = torch.linalg.cross(fwd, up)
    side = side / torch.sqrt(dot3(side, side))
    upv = torch.linalg.cross(side, fwd)
    vinv = torch.zeros(4, 4, dtype=f)
    vinv[:3, 0] = side
    vinv[:3, 1] = upv
    vinv[:3, 2] = -fwd
    vinv[:3, 3] = eye
    vinv[3, 3] = 1.0
    radians = torch.tensor(np.float32(fov_deg) / np.float32(2.0), dtype=f) \
        * (np.pi / 180.0)
    cotan = torch.cos(radians) / torch.sin(radians)
    clip = far - near
    m22 = -(near + far) / clip
    m23 = -(2.0 * near * far) / clip
    pinv = torch.zeros(4, 4, dtype=f)
    pinv[0, 0] = 1.0 / cotan
    pinv[1, 1] = 1.0 / cotan
    pinv[2, 3] = -1.0
    pinv[3, 2] = 1.0 / m23
    pinv[3, 3] = m22 / m23
    return (vinv @ pinv).numpy()


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_tensor_camera_is_the_host_form(pose):
    """Forward bit-equal to the frozen element-by-element host form, on the
    listed pose and 200 random poses around it, both through the tensor
    form and through the host entry the march kernels are fed."""
    rng = np.random.default_rng(pose)
    c0, t0, u0, fov0 = POSES[pose]
    poses = [POSES[pose]] + [
        (tuple(np.asarray(c0) + rng.normal(0.0, 0.5, 3)),
         tuple(np.asarray(t0) + rng.normal(0.0, 0.2, 3)),
         tuple(np.asarray(u0) + rng.normal(0.0, 0.1, 3)),
         float(rng.uniform(10.0, 150.0)))
        for _ in range(200)]
    f = torch.float32
    for c, t, u, fov in poses:
        want = _elementwise_host_form(c, t, u, fov)
        tensor = tcam.inv_view_projection_tensor(
            *(torch.as_tensor(np.asarray(v, np.float32), dtype=f)
              for v in (c, t, u, fov)))
        np.testing.assert_array_equal(tensor.numpy(), want)
        np.testing.assert_array_equal(tcam.inv_view_projection(c, t, u, fov),
                                      want)


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_tensor_camera_gradient_matches_jax(pose, jax_grads):
    c, t, u, fov = POSES[pose]
    f = torch.float32
    ins = [torch.tensor(v, dtype=f, requires_grad=True) for v in (c, t, fov)]
    m = tcam.inv_view_projection_tensor(ins[0], ins[1],
                                        torch.tensor(u, dtype=f), ins[2])
    grads = torch.autograd.grad(torch.sum(torch.as_tensor(_weights()) * m),
                                ins)
    for g, name in zip(grads, ("camera", "target", "fov")):
        want = jax_grads[f"chain{pose}_{name}"]
        assert _rel_l2(g.numpy(), want) <= CAM_GRAD_RTOL, (name, g, want)


class _Recorder:
    """An optimizer (Adam's init/update interface) that records the masked
    gradients it is given and moves nothing."""

    def __init__(self):
        self.grads = []

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        self.grads.append(tree_map(lambda g: g.detach().clone(), grads))
        return tree_map(torch.zeros_like, grads), state


def test_fit_pose_gradient_matches_jax(jax_grads):
    """fit_pose's own loss and pose gradient (camera, target and fov all
    fitted) against jax.grad of the JAX package's fit_pose loss."""
    truth = _scene(default_galaxy(), GRAD_SIZE)
    target = jrender_scene(truth)
    rec = _Recorder()
    res = tfit.fit_pose(_moved(truth), target, ("camera", "target", "fov"),
                        steps=1, optimizer=rec, device="cpu")
    assert res.losses[0] == pytest.approx(float(jax_grads["pose_loss"]),
                                          rel=RTOL)
    (got,) = rec.grads
    for k in ("camera", "target", "fov"):
        assert _rel_l2(got[k].numpy(), jax_grads["pose_" + k]) \
            <= POSE_GRAD_RTOL, (k, got[k], jax_grads["pose_" + k])
    assert float(torch.linalg.norm(got["camera"])) > 0.0
