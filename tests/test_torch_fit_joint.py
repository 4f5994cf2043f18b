"""The composed fits of ``gamer_tpu_torch.engine.fit`` on the CPU:
``fit_pose_multiscale`` (a ladder of fit_pose rungs), ``fit_joint`` (pose
blocks, multiscale or fd, alternating with fit_scene blocks) and
``fit_joint_multiview`` (per-view fit_pose_fd blocks, then a shared
fit_scene_multiview block). Each is held bit for bit against the port's
own blocks run in turn, with its global step index, its cooperative abort
and its per-block checkpoints, and once against a small run of the same
function in ``gamer_tpu.engine.fit`` (tests/test_fit.py:551-580,
871-986, 414-452).

The scenes are the default galaxy's bulge at 8^2 with preview sampling:
every fd pose step renders 7 probe frames through ``march_batch``'s plain
version, which costs ~0.1 s a frame for a bulge and ~1 s for the whole
default galaxy. The JAX runs use on-axis views (ROADMAP.md §3: the JAX
marches drift at the centre ray of off-axis orbit views).

Tolerances (as tests/test_torch_fit_fd.py's header): the port against its
own blocks bit-equal; against the JAX package losses within relative 1e-4.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import fit as jfit  # noqa: E402
from gamer_tpu.engine.render import render_scene as jrender_scene  # noqa: E402
from gamer_tpu.scene.schema import default_galaxy  # noqa: E402

from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.utils.tree import tree_leaves  # noqa: E402

SIZE = 8
RTOL = 1e-4
SCHEDULE = ((2, 2), (0, 1))
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy, cam=(0.5, 0.0, 0.0), **cfg):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=cam, target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy)],
        config=gamer_tpu.RenderConfig(size=SIZE, ray_step=0.025,
                                      is_preview=True, **cfg))


def _bulge(strength_factor=1.0):
    g = default_galaxy(1)
    g.components[0].strength *= strength_factor
    return g


@pytest.fixture(scope="module")
def problem():
    """(start, target): the bulge seen from (0.5, 0, 0); the start's camera
    moved and its strength at 0.6 x."""
    target = jrender_scene(_scene(_bulge()))
    return _scene(_bulge(0.6), cam=(0.52, 0.01, 0.0)), target


def _same(a, b):
    assert a.losses == b.losses
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _recorder(stop_at=None):
    seen = []

    def on_step(i, loss):
        seen.append(i)
        return stop_at is None or i < stop_at
    return on_step, seen


# ---------------------------------------------------------------------------
# fit_pose_multiscale
# ---------------------------------------------------------------------------


def test_pose_multiscale_is_its_rungs(problem):
    """The ladder is fit_pose per rung (LOD 2 pooled by 2, then the exact
    rung), each from the last rung's pose; the global step index runs over
    every rung and the caller's noise_octaves comes back."""
    start, target = problem
    start = dataclasses.replace(start, config=dataclasses.replace(
        start.config, noise_octaves=4))
    on_step, seen = _recorder()
    ladder = tfit.fit_pose_multiscale(start, target, steps=2,
                                      schedule=SCHEDULE, on_step=on_step,
                                      **CPU)
    assert seen == [0, 1, 2, 3]
    assert ladder.scene.config.noise_octaves == 4
    current, losses = start, []
    for lod, pool in SCHEDULE:
        rung = dataclasses.replace(current, config=dataclasses.replace(
            current.config, noise_octaves=lod or None))
        res = tfit.fit_pose(rung, target, ("camera",), steps=2, lr=1e-2,
                            pool=pool, **CPU)
        current, losses = res.scene, losses + res.losses
    assert ladder.losses == losses and len(losses) == 6
    _same(ladder, dataclasses.replace(res, losses=losses))
    assert ladder.scene.camera == current.camera


def test_pose_multiscale_abort_and_rung_checkpoints(problem, tmp_path):
    """An abort inside the first rung stops the ladder; each rung writes
    its own checkpoint file, and a rerun resumes the ladder bit for bit."""
    start, target = problem
    on_step, seen = _recorder(stop_at=0)
    res = tfit.fit_pose_multiscale(start, target, steps=2,
                                   schedule=SCHEDULE, on_step=on_step, **CPU)
    assert seen == [0] and len(res.losses) == 2
    straight = tfit.fit_pose_multiscale(start, target, steps=2,
                                        schedule=SCHEDULE, **CPU)
    ckpt = str(tmp_path / "ladder.ckpt")
    kw = dict(steps=2, schedule=SCHEDULE, checkpoint_path=ckpt,
              checkpoint_every=1, **CPU)
    tfit.fit_pose_multiscale(start, target, on_step=_recorder(stop_at=2)[0],
                             **kw)
    assert (tmp_path / "ladder.ckpt.rung0").exists()
    assert (tmp_path / "ladder.ckpt.rung1").exists()
    _same(tfit.fit_pose_multiscale(start, target, **kw), straight)
    with pytest.raises(ValueError, match="rung"):
        tfit.fit_pose_multiscale(start, target, schedule=(), **CPU)
    with pytest.raises(ValueError, match="must divide the mesh"):
        tfit.fit_pose_multiscale(start, target, mesh=Mesh(["cpu"] * 7),
                                 **CPU)


def test_pose_multiscale_matches_jax(problem):
    start, target = problem
    kw = dict(steps=1, schedule=SCHEDULE)
    ref = jfit.fit_pose_multiscale(start, target, **kw)
    ours = tfit.fit_pose_multiscale(start, target, **kw, **CPU)
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# fit_joint
# ---------------------------------------------------------------------------

JOINT = dict(rounds=2, pose_steps=1, scene_steps=2, march="frozen")


@pytest.fixture(scope="module")
def joint_fd(problem):
    start, target = problem
    on_step, seen = _recorder()
    res = tfit.fit_joint(start, target, ("strength",), pose_method="fd",
                         on_step=on_step, **JOINT, **CPU)
    return res, seen


def test_fit_joint_fd_is_its_blocks(problem, joint_fd):
    """Each round: fit_pose_fd of the camera (one K4 launch a step on the
    card), then fit_scene at the fitted pose; the global index runs over
    rounds * (pose_steps + scene_steps)."""
    start, target = problem
    res, seen = joint_fd
    assert seen == list(range(2 * (1 + 2)))
    current, losses = start, []
    for _ in range(2):
        pres = tfit.fit_pose_fd(current, target, ("camera",), steps=1,
                                lr=1e-2, **CPU)
        sres = tfit.fit_scene(pres.scene, target, ("strength",), steps=2,
                              lr=2e-2, march="frozen", **CPU)
        current, losses = sres.scene, losses + pres.losses + sres.losses
    assert res.losses == losses
    assert res.scene.camera == current.camera
    for k in ("camera", "target", "fov"):
        np.testing.assert_array_equal(res.params["pose"][k], pres.params[k])
    for a, b in zip(tree_leaves(res.params["scene"]),
                    tree_leaves(sres.params)):
        np.testing.assert_array_equal(a, b)
    assert res.fit_fields == ("camera", "strength")
    assert res.scene.camera.camera != start.camera.camera


def test_fit_joint_multiscale_is_its_blocks(problem):
    start, target = problem
    kw = dict(rounds=1, pose_steps=1, scene_steps=1, march="tensor",
              pose_schedule=SCHEDULE)
    on_step, seen = _recorder()
    res = tfit.fit_joint(start, target, ("strength",), on_step=on_step,
                         **kw, **CPU)
    assert seen == [0, 1, 2]
    pres = tfit.fit_pose_multiscale(start, target, ("camera",), steps=1,
                                    lr=1e-2, schedule=SCHEDULE, **CPU)
    sres = tfit.fit_scene(pres.scene, target, ("strength",), steps=1,
                          lr=2e-2, march="tensor", **CPU)
    assert res.losses == pres.losses + sres.losses
    assert res.scene.camera == sres.scene.camera


def test_fit_joint_abort_and_resume(problem, joint_fd, tmp_path):
    """A False from on_step stops every later block (tests/test_fit.py
    :962-986); with per-block checkpoints (.r<k>.pose, .r<k>.scene) an
    interrupted joint fit resumes mid-round bit for bit."""
    start, target = problem
    on_step, seen = _recorder(stop_at=1)
    res = tfit.fit_joint(start, target, ("strength",), rounds=2,
                         pose_steps=3, scene_steps=3, pose_schedule=((2, 2),),
                         march="tensor", on_step=on_step, **CPU)
    assert seen == [0, 1] and len(res.losses) == 3
    assert res.params["scene"] is None

    ckpt = str(tmp_path / "joint.ckpt")
    kw = dict(pose_method="fd", checkpoint_path=ckpt, checkpoint_every=1,
              **JOINT, **CPU)
    # stopped in round 0's scene block, after its first step
    cut = tfit.fit_joint(start, target, ("strength",),
                         on_step=_recorder(stop_at=1)[0], **kw)
    assert cut.params["scene"] is not None and len(cut.losses) == 2 + 2
    assert (tmp_path / "joint.ckpt.r0.pose").exists()
    assert (tmp_path / "joint.ckpt.r0.scene").exists()
    _same(tfit.fit_joint(start, target, ("strength",), **kw), joint_fd[0])


def test_fit_joint_validation(problem):
    start, target = problem
    with pytest.raises(ValueError, match="rounds"):
        tfit.fit_joint(start, target, rounds=0, **CPU)
    with pytest.raises(ValueError, match="pose_method"):
        tfit.fit_joint(start, target, pose_method="lbfgs", **CPU)
    with pytest.raises(ValueError, match="must divide the mesh"):
        tfit.fit_joint(start, target, mesh=Mesh(["cpu"] * 7), **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tfit.fit_joint(start, target, rounds=1, pose_steps=1,
                           scene_steps=1, pose_method="fd")


def test_fit_joint_matches_jax(problem, joint_fd):
    start, target = problem
    ref = jfit.fit_joint(start, target, ("strength",), pose_method="fd",
                         **JOINT)
    np.testing.assert_allclose(joint_fd[0].losses, ref.losses, rtol=RTOL,
                               atol=0)


# ---------------------------------------------------------------------------
# fit_joint_multiview
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mview():
    """Two on-axis views of the bulge, their targets and nudged starting
    cameras; the start's strength at 0.6 x."""
    truth = _scene(_bulge())
    views = [truth.camera,
             dataclasses.replace(truth.camera, camera=(0.0, 0.0, 0.5))]
    targets = np.stack([jrender_scene(dataclasses.replace(truth, camera=c))
                        for c in views])
    starts = [dataclasses.replace(views[0], camera=(0.52, 0.01, 0.0)),
              dataclasses.replace(views[1], camera=(0.01, 0.0, 0.52))]
    return _scene(_bulge(0.6)), targets, starts


MVIEW = dict(rounds=1, pose_steps=1, scene_steps=2, march="frozen")


def test_fit_joint_multiview_is_its_blocks(mview):
    scene, targets, starts = mview
    on_step, seen = _recorder()
    res = tfit.fit_joint_multiview(scene, targets, starts, ("strength",),
                                   on_step=on_step, **MVIEW, **CPU)
    assert seen == [0, 1, 2, 3]
    cams, losses = list(starts), []
    for v in range(2):
        pres = tfit.fit_pose_fd(dataclasses.replace(scene, camera=cams[v]),
                                targets[v], ("camera",), steps=1, lr=1e-2,
                                **CPU)
        cams[v], losses = pres.scene.camera, losses + pres.losses
    sres = tfit.fit_scene_multiview(scene, targets, cams, ("strength",),
                                    steps=2, lr=2e-2, march="frozen", **CPU)
    assert res.losses == losses + sres.losses
    assert res.cameras == cams
    assert [p["camera"] for p in res.params["poses"]] == [c.camera
                                                          for c in cams]
    for a, b in zip(tree_leaves(res.params["scene"]),
                    tree_leaves(sres.params)):
        np.testing.assert_array_equal(a, b)
    for fc, sc in zip(res.cameras, starts):
        assert fc.camera != sc.camera

    ref = jfit.fit_joint_multiview(scene, targets, starts, ("strength",),
                                   **MVIEW)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=RTOL, atol=0)


def test_fit_joint_multiview_abort_and_validation(mview, tmp_path):
    scene, targets, starts = mview
    on_step, seen = _recorder(stop_at=0)
    res = tfit.fit_joint_multiview(scene, targets, starts, ("strength",),
                                   on_step=on_step, checkpoint_path=str(
                                       tmp_path / "mv.ckpt"), **MVIEW, **CPU)
    # the first view's pose block stopped the whole fit
    assert seen == [0] and len(res.losses) == 1
    assert res.params["scene"] is None
    assert (tmp_path / "mv.ckpt.r0.pose0").exists()
    assert res.cameras[1] == starts[1]
    with pytest.raises(ValueError, match="targets for"):
        tfit.fit_joint_multiview(scene, targets[:1], starts, rounds=1, **CPU)
    with pytest.raises(ValueError, match="rounds"):
        tfit.fit_joint_multiview(scene, targets, starts, rounds=0, **CPU)
    with pytest.raises(ValueError, match="views must divide the mesh"):
        tfit.fit_joint_multiview(scene, targets, starts,
                                 mesh=Mesh(["cpu"] * 7), **CPU)
