"""The port's render service on the CPU (``device="cpu"``, the plain
march): the analogs of tests/test_serve.py on ``presets.spiral()``: job
lifecycle, cross-request batching, launches without pad frames, abort, failure
isolation, the pipeline, a mesh, animations, warm jobs, fit jobs (every
mode of submit_fit and submit_fit_multiview, each held bit for bit to its
library call, and abort between steps), the HTTP surface and the CLI
``serve``; and the port's service against
``gamer_tpu.serve.RenderService`` on the same scene dicts.

Tolerances: images served by the port equal the port's direct renders
exactly where both take the same path on the same tensor shapes, and stay
within 1 uint8 LSB where the shapes differ (a batch against singles; torch's
vector and scalar CPU paths may round an element differently); the port's
images are within 2 LSB of the JAX service's (the interpreted Pallas
kernel). Every wait has a timeout, so a stuck worker fails a test.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gamer_tpu import serve as jserve  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch import cli  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.scene import gax as tgax  # noqa: E402
from gamer_tpu_torch.scene.cameracontrols import orbit_path  # noqa: E402
from gamer_tpu_torch.scene.schema import scene_to_dict  # noqa: E402
from gamer_tpu_torch.serve import (  # noqa: E402
    ABORTED,
    DONE,
    FAILED,
    QueueFull,
    RenderService,
    _gif,
    serve,
)

serve_module = importlib.import_module("gamer_tpu_torch.serve")
WAIT = 120.0


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


def _scene(size=8, ray_step=0.3, **cfg):
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
        config=gt.RenderConfig(size=size, ray_step=ray_step, **cfg))


def _orbit(scene, n, deg=60.0):
    return [dataclasses.replace(scene, camera=c)
            for c in orbit_path(scene.camera, n, horizontal_deg=deg)]


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.fixture
def scene():
    return _scene()


@pytest.fixture
def service():
    """A CPU service that is stopped, worker and completer, after the test."""
    made = []

    def make(**kw):
        kw.setdefault("device", "cpu")
        svc = RenderService(**kw)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.stop(timeout=WAIT)
        assert svc._worker is None or not svc._worker.is_alive()
        assert svc._completer is None or not svc._completer.is_alive()


def _done(svc, jid):
    job = svc.wait(jid, timeout=WAIT)
    assert job.state == DONE, (job.state, job.error)
    return job


@pytest.mark.parametrize("n,entries", [
    (2, 1), (3, 1), (5, 1), (9, 1), (3, 2), (5, 3), (2, 4), (7, 4), (9, 8)])
def test_batch_launches_the_requests_as_they_are(service, scene, monkeypatch,
                                                 n, entries):
    """n queued requests are one launch of exactly n frames, on one device
    and on a mesh of any size (the deal takes any count): no pad frame, and
    each job gets its own frame. The launch is stubbed: no march runs."""
    launched = []

    def render_batch(scenes, device, device_out=False, mesh=None):
        launched.append((len(scenes), mesh))
        return torch.arange(len(scenes), dtype=torch.uint8)[
            :, None, None, None].expand(-1, 8, 8, 3).contiguous()

    monkeypatch.setattr(serve_module.batch, "render_batch", render_batch)
    mesh = None if entries == 1 else Mesh(["cpu"] * entries)
    svc = service(autostart=False, mesh=mesh)
    jids = [svc.submit(s) for s in _orbit(scene, n)]
    svc.start()
    jobs = [_done(svc, j) for j in jids]
    assert launched == [(n, svc._batch_mesh)]
    assert all(j.batched for j in jobs)
    assert [int(j.image.max()) for j in jobs] == list(range(n))
    assert svc.metrics["padded_frames"] == 0
    assert svc.metrics["batched_frames"] == n


def test_default_device_is_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="is_available"):
        RenderService()
    with pytest.raises(RuntimeError, match="is_available"):
        serve(port=0, poll=False)
    with pytest.raises(RuntimeError, match="is_available"):
        RenderService(mesh=Mesh(["cuda:0"] * 2))


def test_single_job_lifecycle(service, scene):
    svc = service(bands=8, single_fuse_below=0)  # exercise banding
    t_submit = time.time()
    job = _done(svc, svc.submit(scene))
    assert job.progress == 1.0 and not job.batched
    assert job.image.shape == (8, 8, 3) and job.image.dtype == np.uint8
    assert int(job.image.sum()) > 0
    np.testing.assert_array_equal(
        job.image, gt.render_progressive(scene, bands=8, device="cpu"))
    info = job.info()
    assert info["state"] == "done" and info["error"] is None
    assert 0 <= info["queued_s"] <= time.time() - t_submit + 1
    assert svc.metrics["frames_rendered"] == 1
    assert svc.metrics["singles_fused"] == 0


def test_small_single_is_one_fused_launch(service, scene, monkeypatch):
    calls = []
    real = cr.render_scene
    monkeypatch.setattr(cr, "render_scene",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    svc = service()  # default single_fuse_below=512
    job = _done(svc, svc.submit(scene))
    assert svc.metrics["singles_fused"] == 1
    assert len(calls) == 1 and calls[0]["device_out"] is True
    np.testing.assert_array_equal(job.image, real(scene, device="cpu"))


def test_preview_then_refine(service, scene):
    """The fast LOD frame is published FIRST (seen at the phase boundary
    through the quick-job hook), then the exact frame replaces it."""
    svc = service(autostart=False)
    observed = {}
    orig = svc._preempt_quick_jobs

    def spy():
        job = svc.jobs[jid]
        observed.update(preview_ready=job.preview_ready, state=job.state,
                        image=None if job.image is None else job.image.copy())
        return orig()

    svc._preempt_quick_jobs = spy
    jid = svc.submit(scene, preview=2)
    job = svc.jobs[jid]
    with svc._cond:
        svc._queue.clear()
    svc._execute_head(job)
    assert observed["preview_ready"] and observed["state"] == "running"
    assert observed["image"] is not None and int(observed["image"].sum()) > 0
    assert job.state == DONE and job.preview_ready
    assert svc.metrics["previews_rendered"] == 1
    np.testing.assert_array_equal(job.image,
                                  gt.render_scene(scene, device="cpu"))
    assert not np.array_equal(observed["image"], job.image)
    assert job.info()["preview_ready"] is True


def test_preview_wait_until(service, scene):
    svc = service()
    jid = svc.submit(scene, preview=2)
    job = svc.wait(jid, timeout=WAIT, until="preview")
    assert job.preview_ready and job.image is not None
    assert _done(svc, jid).state == DONE
    with pytest.raises(ValueError, match="until"):
        svc.wait(jid, until="nonsense")


def test_preview_validation(service, scene):
    svc = service(autostart=False)
    with pytest.raises(ValueError, match="preview octaves"):
        svc.submit(scene, preview=-1)
    assert svc.jobs[svc.submit(scene, preview=0)].preview_lod is None
    j1 = svc.jobs[svc.submit(scene, preview=True)]
    j2 = svc.jobs[svc.submit(scene, preview=True)]
    assert j1.key != j2.key and j1.preview_lod == 4


def test_cross_request_batching(service, scene):
    """Concurrent compatible requests collapse into ONE launch, with no pad
    frame; the frames are those of the direct batch."""
    scenes = _orbit(scene, 3)
    svc = service(autostart=False)
    jids = [svc.submit(s) for s in scenes]
    svc.start()
    jobs = [_done(svc, j) for j in jids]
    assert all(j.batched for j in jobs)
    assert svc.metrics["batches"] == 1
    assert svc.metrics["batched_frames"] == 3
    assert svc.metrics["padded_frames"] == 0
    direct = gt.render_batch(scenes, device="cpu")
    for j, frame in zip(jobs, direct):
        np.testing.assert_array_equal(j.image, frame)
    assert not np.array_equal(jobs[0].image, jobs[1].image)


def test_max_batch_caps_launch_size(service, scene):
    scenes = _orbit(scene, 5, 80.0)
    svc = service(autostart=False, max_batch=2)
    jids = [svc.submit(s) for s in scenes]
    svc.start()
    jobs = [_done(svc, j) for j in jids]
    # 5 jobs at cap 2 -> launches of 2, 2, 1 (the last one a single)
    assert svc.metrics["batches"] == 2
    assert svc.metrics["batched_frames"] == 4
    for a, b in zip(jobs, jobs[1:]):
        assert not np.array_equal(a.image, b.image)
    with pytest.raises(ValueError):
        RenderService(autostart=False, max_batch=0, device="cpu")


def test_incompatible_sizes_do_not_batch(service, scene):
    other = _scene(12)
    svc = service(autostart=False)
    j1, j2 = svc.submit(scene), svc.submit(other)
    svc.start()
    a, b = _done(svc, j1), _done(svc, j2)
    assert not a.batched and not b.batched
    assert svc.metrics["batches"] == 0
    assert a.image.shape == (8, 8, 3) and b.image.shape == (12, 12, 3)


def test_abort_queued_job(service, scene):
    svc = service(autostart=False)
    j1, j2 = svc.submit(scene), svc.submit(scene)
    assert svc.abort(j2) and not svc.abort(999)
    assert svc.jobs[j2].state == ABORTED
    assert svc.queue_depth() == 1
    svc.start()
    _done(svc, j1)
    assert svc.jobs[j2].image is None
    assert svc.metrics["jobs_aborted"] == 1


def test_abort_running_job_keeps_partial_frame(service):
    """Cooperative abort between bands (rasterizer.h:91-98): unrendered
    rows stay black."""
    big = _scene(96)
    svc = service(autostart=False, bands=3,  # 3 x 32-row bands at 96 px
                  single_fuse_below=0)
    jid = svc.submit(big)
    job = svc.jobs[jid]

    # the flag is read at each band's progress callback, one band behind
    # the dispatch: raised after band 1, it stops the render after band 2
    def abort_after_first_band():
        deadline = time.time() + WAIT
        while (job.progress < 0.3 and job.state != DONE
               and time.time() < deadline):
            time.sleep(0.001)
        svc.abort(jid)

    poller = threading.Thread(target=abort_after_first_band)
    poller.start()
    svc.start()
    job = svc.wait(jid, timeout=WAIT)
    poller.join(WAIT)
    assert not poller.is_alive()
    assert job.state == ABORTED
    assert job.image is not None and job.progress < 1.0
    assert int(job.image[:32].sum()) > 0
    assert int(job.image[64:].sum()) == 0


def test_render_failure_isolates_job(service, scene, monkeypatch):
    """A poisoned render fails THAT job; the worker keeps serving, and
    three failures in a row make the service unhealthy."""
    def boom(*a, **k):
        raise RuntimeError("device worker crashed")

    svc = service(autostart=False)
    monkeypatch.setattr(cr, "render_scene", boom)
    svc.start()
    job = svc.wait(svc.submit(scene), timeout=WAIT)
    assert job.state == FAILED and "device worker crashed" in job.error
    assert svc.healthy()
    for _ in range(2):
        svc.wait(svc.submit(scene), timeout=WAIT)
    assert not svc.healthy()
    monkeypatch.undo()
    _done(svc, svc.submit(scene))
    assert svc.healthy()
    assert svc.metrics["jobs_failed"] == 3


def test_readback_failure_isolates_job(service, scene, monkeypatch):
    """A launch that dispatches but whose download fails (a fault on the
    card surfaces where the host waits for it) fails that job on the
    completer, counts toward healthz, and the service keeps serving."""
    def poisoned(pending):
        raise RuntimeError("readback poisoned")

    svc = service(autostart=False)
    monkeypatch.setattr(svc._download, "finish", poisoned)
    svc.start()
    job = svc.wait(svc.submit(scene), timeout=WAIT)
    assert job.state == FAILED and "readback poisoned" in job.error
    assert svc.healthy() and svc.consecutive_failures == 1
    monkeypatch.undo()
    _done(svc, svc.submit(scene))
    assert svc.healthy() and svc.consecutive_failures == 0


def test_pipeline_mixed_size_stress(service, scene):
    """Interleaved incompatible sizes under the pipelined worker: every
    job finishes with the right-shaped frame, none lost or cross-wired
    between the worker and the completer."""
    other = _scene(12)
    svc = service(autostart=False, max_batch=1)
    jids = [svc.submit(scene if k % 2 == 0 else other) for k in range(8)]
    svc.start()
    jobs = [_done(svc, j) for j in jids]
    for k, j in enumerate(jobs):
        want = 8 if k % 2 == 0 else 12
        assert j.image.shape == (want, want, 3), (k, j.image.shape)
        assert int(j.image.sum()) > 0
    assert svc.metrics["frames_rendered"] == 8


def test_pipeline_off_is_synchronous(service, scene):
    svc = service(autostart=False, pipeline=False)
    svc.start()
    assert svc._completer is None
    job = _done(svc, svc.submit(scene))
    assert int(job.image.sum()) > 0


def test_service_over_device_mesh(service, scene):
    """RenderService(mesh=...): batches deal every frame's tile rows over
    the mesh with no pad frame, single jobs deal the frame's."""
    scenes = _orbit(scene, 3)
    svc = service(autostart=False, mesh=Mesh(["cpu"] * 2))
    jids = [svc.submit(s) for s in scenes]
    svc.start()
    jobs = [_done(svc, j) for j in jids]
    assert all(j.batched for j in jobs)
    assert svc.metrics["padded_frames"] == 0  # 3 frames on 2 entries
    for j, s in zip(jobs, scenes):
        assert _max_diff(j.image, gt.render_scene(s, device="cpu")) <= 1
    job = _done(svc, svc.submit(scene))
    assert not job.batched and svc.metrics["singles_fused"] == 0
    assert _max_diff(job.image, gt.render_scene(scene, device="cpu")) <= 1


def test_flythrough_job(service, scene):
    svc = service()
    job = _done(svc, svc.submit_flythrough(scene, 3, orbit_deg=120.0))
    assert job.frames.shape == (3, 8, 8, 3) and job.n_frames == 3
    direct = gt.render_flythrough(
        scene, orbit_path(scene.camera, 3, 120.0), device="cpu")
    np.testing.assert_array_equal(job.frames, direct)
    np.testing.assert_array_equal(job.image, direct[0])
    assert svc.metrics["frames_rendered"] == 3
    assert svc.metrics["padded_frames"] == 0
    assert _gif(job.frames)[:6] in (b"GIF87a", b"GIF89a")
    with pytest.raises(ValueError, match="frames"):
        svc.submit_flythrough(scene, 0)


def test_morph_job(service, scene):
    from gamer_tpu_torch.scene.morph import morph_scenes

    target = copy.deepcopy(scene.instances[0].galaxy)
    for c in target.components:
        c.strength *= 1.6
    svc = service()
    job = _done(svc, svc.submit_morph(scene, target, 3))
    assert job.frames.shape == (3, 8, 8, 3)
    direct = gt.render_batch(morph_scenes(scene, target, 3), device="cpu")
    np.testing.assert_array_equal(job.frames, direct)
    assert not np.array_equal(job.frames[0], job.frames[-1])
    bad = copy.deepcopy(target)
    bad.components = bad.components[:1]
    with pytest.raises(ValueError, match="morph-compatible"):
        svc.submit_morph(scene, bad, 3)
    with pytest.raises(ValueError, match="GalaxyData"):
        svc.submit_morph(scene, 42, 3)


def test_queue_backpressure(service, scene):
    svc = service(autostart=False, max_queue=2)
    svc.submit(scene)
    svc.submit(scene)
    with pytest.raises(QueueFull, match="queue is full"):
        svc.submit(scene)
    assert svc.metrics["jobs_rejected"] == 1
    assert svc.metrics["jobs_submitted"] == 2


def test_submit_rejects_invalid_payload(service):
    svc = service(autostart=False)
    with pytest.raises(Exception):
        svc.submit({"instances": ["not a galaxy"]})
    with pytest.raises(ValueError, match="expected Scene"):
        svc.submit(42)
    assert svc.metrics["jobs_submitted"] == 0


def _fit_scene():
    """The fit jobs' scene: the default galaxy's bulge at 8^2 with preview
    sampling. The service is the subject: an fd pose step renders 7 probe
    frames through the plain march, ~0.05 s a frame for this scene and
    ~4 s for the spiral at full sampling."""
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=gt.default_galaxy(1))],
        config=gt.RenderConfig(size=8, ray_step=0.025, is_preview=True))


def _fit_problem(strength=0.5, cam=(0.53, 0.01, 0.0)):
    """(scene, its target, a start with the galaxy's strengths scaled, a
    start with the camera moved)."""
    scene = _fit_scene()
    target = gt.render_scene(scene, device="cpu")
    weak = copy.deepcopy(scene)
    for c in weak.instances[0].galaxy.components:
        c.strength *= strength
    moved = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, camera=cam))
    return scene, target, weak, moved


def _assert_fit_result(job, lib, keys):
    """A finished fit job holds the library call's result, bit for bit:
    the result dict's keys, its losses and scene, and a render of the
    fitted scene as the image."""
    res = job.result
    assert set(res) == keys
    assert res["losses"] == [float(v) for v in lib.losses]
    assert res["fit_fields"] == list(lib.fit_fields)
    assert res["scene"] == scene_to_dict(lib.scene)
    np.testing.assert_array_equal(
        job.image, gt.render_scene(lib.scene, device="cpu"))
    assert job.progress == 1.0


FIT_KEYS = {"scene", "losses", "fit_fields"}  # gamer_tpu/serve.py:1078-1099


@pytest.mark.parametrize("pose", [False, True, "fd", "joint"])
def test_submit_fit_runs_each_fit(service, pose):
    """submit_fit runs fit_scene (pose=False), fit_pose (True), fit_pose_fd
    ("fd") and fit_joint ("joint") on the worker, and the job carries the
    library call's result (tests/test_serve.py:481-560)."""
    from gamer_tpu_torch.engine import fit as tfit

    _, target, weak, moved = _fit_problem()
    svc = service()
    cpu = dict(device="cpu")
    if pose is False:
        jid = svc.submit_fit(weak, target, ("strength",), steps=2, lr=5e-2,
                             march="frozen")
        lib = tfit.fit_scene(weak, target, ("strength",), steps=2, lr=5e-2,
                             march="frozen", **cpu)
        keys = FIT_KEYS
    elif pose is True:
        jid = svc.submit_fit(moved, target, steps=2, lr=1e-2, pose=True)
        lib = tfit.fit_pose(moved, target, ("camera",), steps=2, lr=1e-2,
                            **cpu)
        keys = FIT_KEYS | {"pose"}
    elif pose == "fd":
        jid = svc.submit_fit(moved, target, steps=2, lr=1e-2, pose="fd")
        lib = tfit.fit_pose_fd(moved, target, ("camera",), steps=2, lr=1e-2,
                               **cpu)
        keys = FIT_KEYS | {"pose"}
    else:
        start = dataclasses.replace(weak, camera=moved.camera)
        jid = svc.submit_fit(start, target, ("strength",), steps=1,
                             lr=5e-2, pose="joint", march="frozen",
                             rounds=1, pose_steps=1, pose_method="fd")
        lib = tfit.fit_joint(start, target, ("strength",), rounds=1,
                             pose_steps=1, scene_steps=1, scene_lr=5e-2,
                             pose_method="fd", march="frozen", **cpu)
        keys = FIT_KEYS | {"pose"}
    job = _done(svc, jid)
    _assert_fit_result(job, lib, keys)
    if pose:
        got = job.result["pose"]
        assert got["camera"] == list(job.result["scene"]["camera"]["camera"])
        assert isinstance(got["fov"], float)
        assert got["camera"] != list(moved.camera.camera)
    assert svc.metrics["frames_rendered"] == 1
    assert svc.metrics["render_seconds"] > 0


def test_submit_fit_validation(service):
    """Bad fit requests raise at submission (HTTP 400), before any worker
    time, with JAX's messages."""
    scene, target, weak, _ = _fit_problem()
    svc = service(autostart=False)
    bad = [
        (dict(fit_fields=("orientation",)), "unknown fit fields"),
        (dict(target_image=np.zeros((4, 4, 3), np.uint8)), "target image"),
        (dict(march="warp"), "march"),
        (dict(fit_fields=("scale",), march="frozen"), "frozen"),
        (dict(fit_fields=("camera",), pose=True, march="frozen"), "frozen"),
        (dict(fit_fields=("up",), pose=True), "unknown pose fit fields"),
        (dict(pose="joint", multiscale=True), "multiscale"),
        (dict(pose="fd", multiscale=True), "multiscale"),
        (dict(pose="joint", rounds=0), "rounds"),
        (dict(pose="maybe"), "pose"),
        (dict(pose_method="lbfgs"), "pose_method"),
        (dict(steps=0), "steps"),
    ]
    for kw, match in bad:
        kw = {"target_image": target, "fit_fields": ("strength",), **kw}
        with pytest.raises(ValueError, match=match):
            svc.submit_fit(weak, steps=kw.pop("steps", 1), **kw)
    assert svc.metrics["jobs_submitted"] == 0


@pytest.mark.parametrize("joint", [False, True], ids=["views", "joint"])
def test_submit_fit_multiview(service, joint):
    """submit_fit_multiview runs fit_scene_multiview (poses held), or with
    pose="joint" fit_joint_multiview (the result carries the K fitted
    cameras); the views are given as pose dicts with PNG or array
    targets."""
    import base64

    from gamer_tpu_torch.engine import fit as tfit
    from gamer_tpu_torch.io.png import encode_png

    scene, _, weak, _ = _fit_problem()
    cams = [scene.camera,
            dataclasses.replace(scene.camera, camera=(0.0, 0.0, 0.5))]
    targets = np.stack([gt.render_scene(dataclasses.replace(scene, camera=c),
                                        device="cpu") for c in cams])
    starts = ([dataclasses.replace(c, camera=tuple(
        v + d for v, d in zip(c.camera, (0.02, 0.01, 0.0)))) for c in cams]
        if joint else cams)
    views = [{"camera": list(c.camera), "target": list(c.target),
              "up": list(c.up), "fov": c.fov,
              "target_png": base64.b64encode(encode_png(t)).decode()
              if k == 0 else t}
             for k, (c, t) in enumerate(zip(starts, targets))]
    svc = service()
    cpu = dict(device="cpu")
    if joint:
        jid = svc.submit_fit_multiview(weak, views, ("strength",), steps=1,
                                       lr=5e-2, march="frozen", pose="joint",
                                       rounds=1, pose_steps=1)
        lib = tfit.fit_joint_multiview(weak, targets, starts, ("strength",),
                                       rounds=1, pose_steps=1, scene_steps=1,
                                       scene_lr=5e-2, march="frozen", **cpu)
        keys = FIT_KEYS | {"poses"}
    else:
        jid = svc.submit_fit_multiview(weak, views, ("strength",), steps=2,
                                       lr=5e-2, march="frozen")
        lib = tfit.fit_scene_multiview(weak, targets, cams, ("strength",),
                                       steps=2, lr=5e-2, march="frozen",
                                       **cpu)
        keys = FIT_KEYS
    job = _done(svc, jid)
    _assert_fit_result(job, lib, keys)
    if joint:
        assert job.result["poses"] == lib.params["poses"]
        assert len(job.result["poses"]) == 2
    with pytest.raises(ValueError, match="non-empty"):
        svc.submit_fit_multiview(weak, [])
    with pytest.raises(ValueError, match="view 0: target"):
        svc.submit_fit_multiview(weak, [dict(views[1], target_png=np.zeros(
            (4, 4, 3), np.uint8))])
    with pytest.raises(ValueError, match="bad camera pose"):
        svc.submit_fit_multiview(weak, [{"target_png": targets[0]}])
    with pytest.raises(ValueError, match="pose="):
        svc.submit_fit_multiview(weak, views, pose=True)


def test_fit_job_abort_between_steps(service):
    """abort() stops a running fit after the current step; the job keeps
    the best fit so far as its result and image, and queued renders are
    served between the fit's steps."""
    scene, target, weak, _ = _fit_problem()
    svc = service()
    jid = svc.submit_fit(weak, target, ("strength",), steps=100_000,
                         lr=5e-2, march="frozen")
    job = svc.jobs[jid]
    deadline = time.time() + WAIT
    while job.progress == 0.0 and time.time() < deadline:
        time.sleep(0.01)
    rid = svc.submit(scene)  # served between two steps of the fit
    assert svc.wait(rid, timeout=WAIT).state == DONE
    assert job.state == "running"
    svc.abort(jid)
    job = svc.wait(jid, timeout=WAIT)
    assert job.state == ABORTED
    assert 2 <= len(job.result["losses"]) < 100_000
    assert job.image.shape == (8, 8, 3)
    assert svc.metrics["worker_preemptions"] >= 1


def test_finished_job_eviction(service, scene):
    svc = service(max_finished=2)
    jids = []
    for _ in range(3):  # sequential: wait each out so none batch
        jids.append(svc.submit(scene))
        _done(svc, jids[-1])
    assert jids[0] not in svc.jobs
    assert jids[1] in svc.jobs and jids[2] in svc.jobs
    assert svc.metrics["jobs_evicted"] == 1


def test_metrics_text_format(service, scene):
    svc = service()
    _done(svc, svc.submit(scene))
    text = svc.metrics_text()
    assert "gamer_frames_rendered 1" in text
    assert "# TYPE gamer_queue_depth gauge" in text
    assert "gamer_uptime_seconds" in text
    assert "# TYPE gamer_request_seconds histogram" in text
    assert "gamer_request_seconds_count 1" in text
    cums = [int(v) for v in re.findall(
        r'gamer_request_seconds_bucket\{le="[^"]+"\} (\d+)', text)]
    assert cums == sorted(cums) and cums[-1] == 1
    s = float(re.search(r"gamer_request_seconds_sum ([\d.e+-]+)",
                        text).group(1))
    assert s > 0


def test_warm_job(service, scene):
    """submit_warm runs every launch shape the service would use (the
    single path and each batch size, per size) and reports seconds per
    shape; a request queued meanwhile is served between two shapes."""
    svc = service(autostart=False)
    jid = svc.submit_warm(scene, buckets=(1, 2), sizes=[8])
    rid = svc.submit(scene)
    svc.start()
    job = _done(svc, jid)
    assert sorted(job.result["warmed"]) == ["8px/batch1", "8px/batch2",
                                            "8px/single"]
    assert all(t >= 0 for t in job.result["warmed"].values())
    assert svc.metrics["warmed_executables"] == 3
    rjob = _done(svc, rid)
    assert int(rjob.image.sum()) > 0 and rjob.finished <= job.finished
    assert svc.metrics["worker_preemptions"] == 1
    assert svc.metrics["frames_rendered"] == 2
    with pytest.raises(ValueError):
        svc.submit_warm(scene, buckets=())
    with pytest.raises(ValueError):
        svc.submit_warm(scene, buckets=(0,))


@pytest.fixture
def http():
    """serve() on a loopback port picked by the system; shut down after."""
    httpd = serve(port=0, poll=False, device="cpu", batch_window_s=0.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, data=None, method=None, expect=200):
        if data is not None and not isinstance(data, bytes):
            data = json.dumps(data).encode()
        req = urllib.request.Request(base + path, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                status, body = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        assert status == expect, (path, status, body[:300])
        return body

    call.service = httpd.service
    try:
        yield call
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.stop(timeout=WAIT)
        thread.join(WAIT)
        assert not thread.is_alive()


def _poll_done(http, jid):
    deadline = time.time() + WAIT
    while time.time() < deadline:
        info = json.loads(http(f"/job/{jid}?wait=30"))
        if info["state"] not in ("queued", "running"):
            return info
    raise AssertionError(f"job {jid} still {info['state']}")


def test_warm_http_endpoint(http, scene):
    body = http("/warm", {"scene": scene_to_dict(scene), "buckets": [1, 2]},
                expect=202)
    jid = json.loads(body)["job"]
    assert _poll_done(http, jid)["state"] == "done"
    warmed = json.loads(http(f"/job/{jid}/result.json"))["warmed"]
    assert "8px/single" in warmed and "8px/batch2" in warmed


def test_http_surface(http, scene):
    from PIL import Image
    import io

    health = json.loads(http("/healthz"))
    assert health == {"ok": True, "platform": "cpu", "device": "cpu"}

    jid = json.loads(http("/render", scene_to_dict(scene), expect=202))["job"]
    assert _poll_done(http, jid)["state"] == "done"
    assert http.service.metrics["long_polls"] >= 1
    png = http(f"/job/{jid}/image.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(png)).convert("RGB")),
        gt.render_scene(scene, device="cpu"))
    assert json.loads(http("/jobs"))["jobs"][0]["job"] == jid
    assert b"gamer_frames_rendered 1" in http("/metrics")

    # preview-then-refine over HTTP
    pid = json.loads(http("/render", {"scene": scene_to_dict(scene),
                                      "preview": 2}, expect=202))["job"]
    info = json.loads(http(f"/job/{pid}?wait=60&until=preview"))
    assert info["preview_ready"] is True or info["state"] == "done"
    assert _poll_done(http, pid)["state"] == "done"

    # an animation, and its GIF
    fid = json.loads(http("/flythrough", {"scene": scene_to_dict(scene),
                                          "frames": 2, "orbit_deg": 40.0},
                          expect=202))["job"]
    http(f"/job/{jid}/animation.gif", expect=409)
    assert _poll_done(http, fid)["frames"] == 2
    assert http(f"/job/{fid}/animation.gif")[:6] in (b"GIF87a", b"GIF89a")

    # a fit without a target answers 400 (test_http_fit runs fits)
    err = json.loads(http("/fit", {"scene": scene_to_dict(scene)},
                          expect=400))["error"]
    assert "target image" in err

    # bad submissions and lookups
    http("/render", b"not json", expect=400)
    http("/morph", {"scene": scene_to_dict(scene), "frames": 1}, expect=400)
    http("/nope", {}, expect=404)
    http("/job/999", expect=404)
    http("/job/999/image.png", expect=404)
    http("/nope", expect=404)
    http(f"/job/{jid}?wait=soon", expect=400)
    http(f"/job/{jid}?wait=1&until=never", expect=400)
    http("/job/999", method="DELETE", expect=404)
    assert json.loads(http(f"/job/{jid}", method="DELETE"))["state"] == "done"


def test_http_fit(http):
    """POST /fit over HTTP: an fd pose job and a frozen scene job with
    base64 PNG targets, their result.json (JAX's keys) equal to the
    library calls, image.png the render of the fitted scene; a multi-view
    job; DELETE stops a running fit between steps; bad fits answer 400."""
    import base64

    from gamer_tpu_torch.engine import fit as tfit
    from gamer_tpu_torch.io.png import decode_png, encode_png

    _, target, weak, moved = _fit_problem()
    png = base64.b64encode(encode_png(target)).decode()
    jobs = {
        "fd": (dict(scene=scene_to_dict(moved), target_png=png, steps=2,
                    lr=1e-2, pose="fd"),
               tfit.fit_pose_fd(moved, target, ("camera",), steps=2,
                                lr=1e-2, device="cpu"),
               FIT_KEYS | {"pose"}),
        "frozen": (dict(scene=scene_to_dict(weak), target_png=png, steps=2,
                        lr=5e-2, fields=["strength"], march="frozen"),
                   tfit.fit_scene(weak, target, ("strength",), steps=2,
                                  lr=5e-2, march="frozen", device="cpu"),
                   FIT_KEYS),
    }
    for name, (payload, lib, keys) in jobs.items():
        jid = json.loads(http("/fit", payload, expect=202))["job"]
        assert _poll_done(http, jid)["state"] == "done", name
        res = json.loads(http(f"/job/{jid}/result.json"))
        assert set(res) == keys, name
        assert res["losses"] == [float(v) for v in lib.losses], name
        assert res["scene"] == json.loads(json.dumps(scene_to_dict(
            lib.scene))), name
        np.testing.assert_array_equal(
            decode_png(http(f"/job/{jid}/image.png")),
            gt.render_scene(lib.scene, device="cpu"))

    views = [{"camera": [0.5, 0, 0], "target_png": png},
             {"camera": [0.5, 0, 0], "target_png": png}]
    jid = json.loads(http("/fit", {"scene": scene_to_dict(weak),
                                   "views": views, "fields": ["strength"],
                                   "steps": 1, "march": "frozen"},
                          expect=202))["job"]
    assert _poll_done(http, jid)["state"] == "done"
    assert set(json.loads(http(f"/job/{jid}/result.json"))) == FIT_KEYS

    # DELETE aborts a running fit between steps
    jid = json.loads(http("/fit", {"scene": scene_to_dict(weak),
                                   "target_png": png, "steps": 100000,
                                   "fields": ["strength"],
                                   "march": "frozen"}, expect=202))["job"]
    job = http.service.jobs[jid]
    deadline = time.time() + WAIT
    while job.progress == 0.0 and time.time() < deadline:
        time.sleep(0.01)
    http(f"/job/{jid}", method="DELETE")
    assert _poll_done(http, jid)["state"] == "aborted"
    assert len(json.loads(http(f"/job/{jid}/result.json"))["losses"]) >= 2

    for bad in ({"scene": scene_to_dict(weak)},  # no target
                {"scene": scene_to_dict(weak), "target_png": png,
                 "march": "warp"},
                {"scene": scene_to_dict(weak), "views": views,
                 "pose": "fd"}):
        assert "Error" in json.loads(http("/fit", bad, expect=400))["error"]


def test_http_delete_aborts_a_queued_job_and_429(http, scene):
    svc = http.service
    svc.stop(timeout=WAIT)  # park the worker: submissions stay queued
    svc.max_queue = 1
    jid = json.loads(http("/render", scene_to_dict(scene), expect=202))["job"]
    http("/render", scene_to_dict(scene), expect=429)
    http(f"/job/{jid}/image.png", expect=409)
    assert json.loads(http(f"/job/{jid}", method="DELETE"))["state"] == "aborted"
    assert svc.queue_depth() == 0


def test_gif_without_pil_is_501(http, scene, monkeypatch):
    def no_gif(frames):
        raise serve_module.GifUnavailable("animation.gif needs PIL")

    monkeypatch.setattr(serve_module, "_gif", no_gif)
    fid = json.loads(http("/flythrough", {"scene": scene_to_dict(scene),
                                          "frames": 2}, expect=202))["job"]
    assert _poll_done(http, fid)["state"] == "done"
    assert "PIL" in json.loads(http(f"/job/{fid}/animation.gif",
                                    expect=501))["error"]


def test_cli_serve_args(monkeypatch, tmp_path):
    """``serve [port] [window] [bands] [mesh] [maxbatch=N] [warm=...]``
    and the trailing ``--device``."""
    calls = {}
    monkeypatch.setattr(
        serve_module, "serve",
        lambda port, w, b, mesh=None, on_start=None, max_batch=None,
        device="cuda": calls.update(port=port, w=w, b=b, mesh=mesh,
                                    on_start=on_start, max_batch=max_batch,
                                    device=device))
    assert cli.main(["serve", "9000", "0.1", "4"]) == 0
    assert calls == dict(port=9000, w=0.1, b=4, mesh=None, on_start=None,
                         max_batch=None, device="cuda")
    calls.clear()
    assert cli.main(["serve", "9000", "mesh", "maxbatch=4", "--device",
                     "cpu"]) == 0
    assert calls["mesh"] == Mesh(["cpu"]) and calls["max_batch"] == 4
    assert calls["device"] == "cpu"
    calls.clear()
    assert cli.main(["serve"]) == 0
    assert calls == dict(port=8100, w=0.05, b=8, mesh=None, on_start=None,
                         max_batch=None, device="cuda")
    assert cli.main(["serve", "maxbatch=many"]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "mesh"])

    # warm=FILE.gax:SIZES submits a startup warm job for that galaxy
    gaxfile = tmp_path / "spiral.gax"
    tgax.save(presets.spiral(), gaxfile)
    calls.clear()
    assert cli.main(["serve", "9000", f"warm={gaxfile}:16,32"]) == 0
    submitted = {}

    class FakeService:
        def submit_warm(self, scene, sizes=None, **kw):
            submitted.update(size=scene.config.size, sizes=sizes,
                             comps=len(scene.instances[0].galaxy.components))
            return 1

    calls["on_start"](FakeService())
    assert submitted == dict(size=16, sizes=[16, 32],
                             comps=len(presets.spiral().components))


# --- the port's service against the JAX package's, same scene dicts -------


@pytest.fixture(scope="module")
def both_services():
    """One 16^2 single and one 2-request batch through
    ``gamer_tpu.serve.RenderService`` (interpreted Pallas kernel) and
    through the port's service, from the same JSON scene dicts. The
    services are the subject, not the galaxy: the spiral's bulge and first
    disk keep the JAX kernel's two traces (single and batch), which are
    most of this fixture's time, short."""
    galaxy = presets.spiral()
    galaxy = dataclasses.replace(galaxy, components=galaxy.components[:2])
    base = dataclasses.replace(_scene(16, ray_step=0.025),
                               instances=[gt.GalaxyInstance(galaxy=galaxy)])
    single = scene_to_dict(base)
    pair = [scene_to_dict(s) for s in _orbit(base, 2, 0.0)]
    pair[1]["config"]["exposure"] = 2.0  # same structure, another frame
    out = {}
    for name, svc in (("jax", jserve.RenderService(autostart=False)),
                      ("torch", RenderService(autostart=False,
                                              device="cpu"))):
        try:
            jids = [svc.submit(json.loads(json.dumps(d))) for d in pair]
            svc.start()
            jobs = [svc.wait(j, timeout=600.0) for j in jids]
            jobs.append(svc.wait(svc.submit(json.loads(json.dumps(single))),
                                 timeout=600.0))
            out[name] = (jobs, dict(svc.metrics))
        finally:
            svc.stop()
    return out


def test_services_agree_on_states_and_flags(both_services):
    (jj, jm), (tj, tm) = both_services["jax"], both_services["torch"]
    assert [j.state for j in jj] == [j.state for j in tj] == [DONE] * 3, (
        [j.error for j in jj], [j.error for j in tj])
    assert [j.batched for j in jj] == [j.batched for j in tj] == [
        True, True, False]
    for key in ("batches", "batched_frames", "singles_fused",
                "frames_rendered", "jobs_failed"):
        assert jm[key] == tm[key], key
    assert jm["padded_frames"] == tm["padded_frames"] == 0


@pytest.mark.parametrize("k", [0, 1, 2], ids=["batch0", "batch1", "single"])
def test_services_agree_on_images(both_services, k):
    a = both_services["jax"][0][k].image
    b = both_services["torch"][0][k].image
    assert a.shape == b.shape == (16, 16, 3) and int(b.sum()) > 0
    assert _max_diff(a, b) <= 2
