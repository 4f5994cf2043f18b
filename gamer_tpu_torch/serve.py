"""The render service: an HTTP JSON API over the port's render paths, the
counterpart of ``gamer_tpu.serve``.

The reference's serving surfaces are in-process only: the GUI render queue
(a FIFO polled on a Qt timer, renderqueue.cpp:63-127) and the console
progress ticker (consolerenderer.cpp:80-93). This module lifts that
contract to a network service:

  * one worker thread makes every kernel launch (concurrency belongs in
    the batch axis of a launch, not in threads);
  * concurrent client requests that share a scene structure and size are
    drained into ONE batched launch (engine/batch.render_batch, K4): B
    requests cost one dispatch, the replacement for the reference's
    thread-per-image fan-out (rasterthread.cpp);
  * a launch takes any number of pages without a rebuild, on one card or
    dealt over a mesh, so a batch is never padded (``padded_frames``, kept
    for the JAX service's metrics, stays 0); the JAX service pads to
    power-of-two buckets, to compile few executables, and to a multiple
    of the mesh;
  * single jobs render progressively in row bands (K5) with percent-done
    and cooperative abort between bands (rasterizer.cpp:283-313); an
    aborted job keeps its partially filled frame, like the reference's
    aborted back buffer; small singles are one fused launch (K1);
  * with ``mesh=`` (parallel/sharding.Mesh) the tile rows of every single
    frame (S1) and of every frame of a batch or animation (S2) are dealt
    over the mesh's cards;
  * a render failure fails THAT job and the worker lives on.

The JSON scene payload is the scene-dict API (scene.schema.scene_from_dict),
so everything the CLI and the library can render is servable. Endpoints:

  POST   /render            scene dict (or {"scene": {...}}) -> {"job": id}
                            with "preview": true|octaves, the job first
                            publishes a fast LOD frame (poll
                            /job/<id>?wait=s&until=preview), then replaces
                            it with the exact frame (preview-then-refine,
                            mainwindow.cpp:483-495 as a service)
  POST   /flythrough        {"scene": {...}, "frames": N, "orbit_deg": D}
                            -> orbit animation, one batched launch
  POST   /morph             {"scene": {...}, "target_galaxy": {...},
                            "frames": N, "ease": "smoothstep"|"linear"}
  POST   /warm              {"scene": {...}, "buckets": [...], "sizes":
                            [...]} -> run every launch shape once
  POST   /fit               {"scene": {...}, "target_png": base64,
                            "fields": [...], "steps": N, "lr": x,
                            "multiscale": bool,
                            "pose": bool|"fd"|"joint", "rounds": N,
                            "pose_steps": N,
                            "pose_method": "multiscale"|"fd",
                            "march": "tensor"|"scan"|"frozen"} -> inverse
                            rendering: fit the galaxy (with "pose": true
                            the camera, "fd" the camera by finite
                            differences through the march kernel, "joint"
                            both, alternating pose and parameter blocks)
                            to the target image. With "views": [{"camera":
                            [...], "target_png": base64, ...}, ...]
                            instead of "target_png", one galaxy against K
                            posed views (fit_scene_multiview; with "pose":
                            "joint" the poses are refined per view,
                            fit_joint_multiview). fd pose jobs spread over
                            the batch mesh; autograd fits shard over the
                            service mesh where their rows or views tile it
  GET    /job/<id>          state/progress/timing (?wait=s long-polls)
  GET    /job/<id>/image.png       finished (or abort-partial) frame
  GET    /job/<id>/animation.gif   fly-through result (501 without PIL)
  GET    /job/<id>/result.json     a fit's scene dict, losses, fit_fields
                            (and "pose" / "poses"); a warm job's seconds
                            per shape
  DELETE /job/<id>          abort (between bands; queued jobs cancel)
  GET    /jobs              all jobs, newest first
  GET    /metrics           Prometheus text format
  GET    /healthz           liveness, torch's platform and the device name
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import queue
import threading
import time
import urllib.parse
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from .engine import batch, cuda_render
from .engine.scene_prep import flatten_scene
from .io.png import decode_png, encode_png
from .scene.schema import (
    CameraParams,
    GalaxyData,
    Scene,
    galaxy_from_dict,
    scene_from_dict,
    scene_to_dict,
)

QUEUED, RUNNING, DONE, FAILED, ABORTED = (
    "queued", "running", "done", "failed", "aborted")


class QueueFull(RuntimeError):
    """Submission rejected by backpressure (RenderService max_queue)."""


class GifUnavailable(RuntimeError):
    """No GIF encoder: PIL is not installed."""


@dataclass
class Job:
    id: int
    scene: Scene
    key: tuple     # batching compatibility key (structure, size, ss)
    state: str = QUEUED
    progress: float = 0.0
    batched: bool = False
    error: Optional[str] = None
    image: Optional[np.ndarray] = None  # uint8 (size, size, 3); partial if aborted
    frames: Optional[np.ndarray] = None  # uint8 (B, size, size, 3) animation
    anim_scenes: Optional[list] = None  # per-frame Scenes (fly-through/morph)
    n_frames: int = 0    # >0 marks an animation job
    fit_spec: Optional[dict] = None     # inverse-rendering job parameters
    warm_spec: Optional[dict] = None    # warm job parameters
    result: Optional[dict] = None       # a fit's scene and losses, or a
                                        # warm job's seconds per shape
    preview_lod: Optional[int] = None   # preview-then-refine: LOD octaves
    preview_ready: bool = False         # the fast LOD frame is in .image
    submitted: float = field(default_factory=time.time)
    started: Optional[float] = None
    finished: Optional[float] = None
    abort: threading.Event = field(default_factory=threading.Event)

    def info(self) -> dict:
        end = self.finished or time.time()
        return {
            "job": self.id, "state": self.state,
            "progress": round(self.progress, 4), "batched": self.batched,
            "error": self.error, "size": self.scene.config.size,
            "frames": self.n_frames or None,
            "preview_ready": self.preview_ready or None,
            "elapsed_s": round(end - (self.started or end), 4),
            "queued_s": round((self.started or end) - self.submitted, 4),
        }


class RenderService:
    """Job queue + device worker. Usable directly (no HTTP) and as the
    state behind ``serve()``.

    device: where the march runs, "cuda" (the default; raises where there
    is no card) or "cpu" (the plain torch march). mesh: a
    parallel/sharding.Mesh; the tile rows of single frames, batches and
    animations are dealt over its devices (``device`` is then its first
    entry).
    batch_window_s: after picking up a job, wait this long for compatible
    requests to arrive before launching (0 = batch only what is already
    queued). bands: progress granularity for single jobs. max_queue:
    backpressure: submissions beyond this many queued jobs raise QueueFull
    (HTTP 429) instead of growing the queue without bound. max_finished:
    finished jobs retained for retrieval; beyond that the oldest finished
    job (and its frame buffers) is evicted.
    single_fuse_below: single-frame jobs smaller than this render as ONE
    fused launch instead of ``bands`` progressive launches: a small frame
    is over before anyone could read its progress, and every band is a
    launch, a post chain and a download of its own. Larger frames keep the
    banded path (partial frames and mid-frame abort). 0 disables fusing.
    max_batch: latency/throughput dial: a cap on how many compatible
    requests merge into one launch (None = unlimited). A request's latency
    is that of the launch it lands in; capping splits a wave into cheaper
    launches whose first requests return sooner. Excess compatible jobs
    stay queued in FIFO order and form the next launch immediately.
    pipeline: overlap the download of launch N with packing and dispatching
    launch N+1 (default on). Kernel launches are asynchronous: the worker
    queues the copy of the finished frames into pinned memory on a side
    stream, hands the pending copy to a completer thread and drains the
    next batch at once; the completer waits for the copy's event and
    finishes the jobs. Only the two hot paths hand off (batched launches
    and fused small singles); animations, warm jobs and progressive
    singles keep their internal progress semantics. ``render_seconds``
    then counts the worker thread's dispatch occupancy, not readback. With
    the pipeline on, healthz/consecutive_failures lag one launch behind
    dispatch (bounded by the maxsize=2 completion queue).
    """

    def __init__(self, batch_window_s: float = 0.0, bands: int = 8,
                 mesh=None, autostart: bool = True,
                 max_queue: Optional[int] = 256,
                 max_finished: Optional[int] = 512,
                 single_fuse_below: int = 512,
                 max_batch: Optional[int] = None,
                 pipeline: bool = True, device="cuda"):
        self.batch_window_s = batch_window_s
        self.bands = bands
        self.single_fuse_below = single_fuse_below
        if max_batch is not None and max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.pipeline = pipeline
        self.mesh = mesh
        # no card, no service: nothing falls back to the CPU on its own
        self.device = (cuda_render.mesh_device(mesh) if mesh is not None
                       else cuda_render._device(device))
        # the batch axis over the same devices the single-frame path
        # row-shards over: frames are independent
        self._batch_mesh = (None if mesh is None
                            else batch.make_batch_mesh(mesh.devices))
        self._download = cuda_render._BandDownload(self.device)
        # one-launch-deep readback pipeline: the worker puts (jobs,
        # finalize) after dispatch; the completer thread waits for the
        # download and finishes while the worker packs the next launch.
        # maxsize bounds how many launches' frames can be pending.
        self._completions: "queue.Queue" = queue.Queue(maxsize=2)
        self._completer: Optional[threading.Thread] = None
        self.max_queue = max_queue
        self.max_finished = max_finished
        self._finished_order: deque[int] = deque()
        self.jobs: Dict[int, Job] = {}
        self._queue: deque[Job] = deque()
        self._cond = threading.Condition()
        self._next_id = 1
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        self.metrics = {
            "jobs_submitted": 0, "frames_rendered": 0, "jobs_failed": 0,
            "jobs_aborted": 0, "batches": 0, "batched_frames": 0,
            "padded_frames": 0, "jobs_rejected": 0, "jobs_evicted": 0,
            "worker_preemptions": 0, "warmed_executables": 0,
            "singles_fused": 0, "long_polls": 0, "previews_rendered": 0,
            "render_seconds": 0.0, "started_at": time.time(),
        }
        self._preempting = False
        # request-latency histogram (submit -> done), Prometheus buckets;
        # only DONE render/animation jobs are recorded
        self._lat_le = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
        self._lat_buckets = [0] * (len(self._lat_le) + 1)  # +Inf last
        self._lat_sum = 0.0
        self._lat_count = 0
        # a fault on the device usually poisons the whole process: after
        # enough consecutive render failures the service declares itself
        # unhealthy so an orchestrator restarts it. Any success resets the
        # count.
        self.max_consecutive_failures = 3
        self.consecutive_failures = 0
        if autostart:
            self.start()

    # -- client surface ----------------------------------------------------

    def submit(self, scene, preview=None) -> int:
        """Queue a Scene (or scene dict) for rendering; returns the job id.

        Raises ValueError for payloads that cannot flatten to a renderable
        scene: invalid requests fail at submission, not on the worker.

        ``preview`` enables preview-then-refine (mainwindow.cpp:483-495 as
        a service): the worker first renders a fast LOD frame (noise
        octaves capped at ``preview``; ``True`` means 4; with the preview
        min-step) and publishes it in ``job.image`` with ``preview_ready``
        set, then renders the EXACT frame in the long-running lane (queued
        quick jobs are served first) and replaces the image. Poll
        ``GET /job/<id>?wait=s&until=preview`` (or ``wait(until=
        "preview")``) for the fast frame; the terminal image is bit-equal
        to a direct exact render."""
        scene = self._coerce_scene(scene)
        static, _ = flatten_scene(scene)  # validates; also the batching key
        key = (static, scene.config.size, scene.config.supersample)
        lod = None
        if preview is not None and preview is not False and preview != 0:
            lod = 4 if preview is True else int(preview)
            if lod < 1:
                raise ValueError(f"preview octaves must be >= 1, got {lod}")
            # two-phase jobs never merge into request batches: a unique
            # key keeps _drain_compatible away
            key = ("preview", object())
        return self._enqueue(Job(id=0, scene=scene, key=key,
                                 preview_lod=lod))

    def _enqueue(self, job: Job) -> int:
        """Backpressure check + id allocation + FIFO append, under the lock."""
        with self._cond:
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                self.metrics["jobs_rejected"] += 1
                raise QueueFull(
                    f"queue is full ({self.max_queue} jobs); retry later")
            job.id = self._next_id
            self._next_id += 1
            self.jobs[job.id] = job
            self._queue.append(job)
            self.metrics["jobs_submitted"] += 1
            self._cond.notify()
        return job.id

    @staticmethod
    def _coerce_scene(scene) -> Scene:
        if isinstance(scene, dict):
            scene = scene_from_dict(scene)
        if not isinstance(scene, Scene):
            raise ValueError(f"expected Scene or scene dict, got {type(scene)}")
        return scene

    def submit_warm(self, scene, buckets=(1, 2, 4, 8),
                    sizes: Optional[list] = None) -> int:
        """Queue a warm-up: render ``scene`` once through the single-frame
        path and once per batch size in ``buckets`` through the batched
        path, at every requested size, so the first real client finds the
        kernel library built and loaded, the lookup tables on the card and
        the allocator's pools filled. Runs in the long-running lane: queued
        interactive jobs are served between shapes. Returns the job id;
        /job/<id>/result.json lists seconds per shape."""
        scene = self._coerce_scene(scene)
        buckets = [int(b) for b in buckets]
        if not buckets or any(b < 1 or b > 1024 for b in buckets):
            raise ValueError(f"buckets must be in [1, 1024], got {buckets}")
        sizes = [int(s) for s in (sizes or [scene.config.size])]
        scenes = []
        for s in sizes:
            sc = dataclasses.replace(
                scene, config=dataclasses.replace(scene.config, size=s))
            flatten_scene(sc)  # validate every size at submission
            scenes.append(sc)
        return self._enqueue(Job(id=0, scene=scenes[0], key=("warm", object()),
                                 warm_spec={"buckets": buckets,
                                            "scenes": scenes}))

    def _enqueue_animation(self, scene, anim_scenes: list) -> int:
        flatten_scene(anim_scenes[0])  # validate at submission
        # a unique key: an animation is already one batched launch and
        # never merges with other requests
        return self._enqueue(Job(id=0, scene=scene, key=("anim", object()),
                                 anim_scenes=anim_scenes,
                                 n_frames=len(anim_scenes)))

    def submit_flythrough(self, scene, n_frames: int,
                          orbit_deg: float = 360.0) -> int:
        """Queue an orbit fly-through: ``n_frames`` cameras around the
        scene, rendered as one batched launch (engine/batch). Returns the
        job id; the result is the (B, size, size, 3) frame stack."""
        from .scene.cameracontrols import orbit_path

        scene = self._coerce_scene(scene)
        n_frames = int(n_frames)
        if not 1 <= n_frames <= 1024:
            raise ValueError(f"frames must be in [1, 1024], got {n_frames}")
        cams = orbit_path(scene.camera, n_frames, float(orbit_deg))
        return self._enqueue_animation(
            scene, [dataclasses.replace(scene, camera=c) for c in cams])

    def submit_morph(self, scene, target_galaxy, n_frames: int,
                     ease: str = "smoothstep") -> int:
        """Queue a parameter-space morph of the scene's galaxy toward
        ``target_galaxy`` (a GalaxyData or galaxy dict): ``n_frames``
        interpolated scenes rendered as one batched launch. Structure
        incompatibility is rejected at submission (scene/morph.py)."""
        from .scene.morph import morph_scenes

        scene = self._coerce_scene(scene)
        if isinstance(target_galaxy, dict):
            target_galaxy = galaxy_from_dict(target_galaxy)
        if not isinstance(target_galaxy, GalaxyData):
            raise ValueError(
                f"expected GalaxyData or galaxy dict, got {type(target_galaxy)}")
        n_frames = int(n_frames)
        if not 2 <= n_frames <= 1024:
            raise ValueError(f"frames must be in [2, 1024], got {n_frames}")
        return self._enqueue_animation(
            scene, morph_scenes(scene, target_galaxy, n_frames, ease))

    def submit_fit(self, scene, target_image, fit_fields=None,
                   steps: int = 100, lr: float = 2e-2,
                   multiscale: bool = False, pose=False,
                   march: str = "tensor", rounds: int = 2,
                   pose_steps: int = 30,
                   pose_method: str = "multiscale") -> int:
        """Queue an inverse-rendering fit: optimize ``fit_fields`` of the
        scene's galaxy until its render matches ``target_image`` (a
        (size, size, 3) uint8 array, or a base64-encoded PNG over HTTP),
        with per-step progress on the job. The result is the fitted scene
        dict and the loss trace (GET /job/<id>/result.json) and a render of
        the fitted scene (/image.png).

        ``pose=True`` fits the camera (engine/fit.fit_pose) instead:
        fields from POSE_FITTABLE (default ("camera",)), and
        ``multiscale`` runs the LOD -> exact pose ladder.
        ``pose="fd"`` fits the camera by finite differences through the
        march kernel (fit_pose_fd: full quality, no ladder).
        ``pose="joint"`` fits the camera AND the named galaxy fields
        (fit_joint: ``rounds`` alternations of a pose block, ``pose_steps``
        steps of ``pose_method`` "multiscale" or "fd", and a parameter
        block of ``steps`` steps); it takes no ``multiscale``.

        Where it runs: fd pose jobs spread their probe frames over the
        service's batch mesh (as every batch does); every autograd fit,
        the parameter and pose blocks of joint fits included, shards its
        pixel rows over the service mesh when every rung's pooled rows
        tile it, else runs on the service's first device."""
        scene = self._coerce_scene(scene)
        target_image = _target_array(target_image)
        size = scene.config.size
        if target_image.shape != (size, size, 3):
            raise ValueError(
                f"target image must be ({size}, {size}, 3) to match the "
                f"scene size, got {target_image.shape}")
        steps = int(steps)
        if not 1 <= steps <= 100_000:
            raise ValueError(f"steps must be in [1, 100000], got {steps}")
        from .engine.fit import FITTABLE_FIELDS, POSE_FITTABLE

        joint = pose == "joint"
        fd = pose == "fd"
        if pose_method not in ("multiscale", "fd"):
            raise ValueError(
                f"pose_method must be 'multiscale' or 'fd', "
                f"got {pose_method!r}")
        if joint:
            if multiscale:
                raise ValueError(
                    "joint fits run their own pose ladder; drop 'multiscale'")
            rounds = int(rounds)
            if not 1 <= rounds <= 20:
                raise ValueError(f"rounds must be in [1, 20], got {rounds}")
            pose_steps = int(pose_steps)
            if not 1 <= pose_steps <= 10_000:
                raise ValueError(
                    f"pose_steps must be in [1, 10000], got {pose_steps}")
        elif fd:
            if multiscale:
                raise ValueError(
                    "pose='fd' needs no LOD ladder; drop 'multiscale'")
        elif not isinstance(pose, bool):
            raise ValueError(
                f"pose must be true, false, 'fd' or 'joint', got {pose!r}")
        if fit_fields is None:
            fit_fields = (("camera",) if pose and not joint
                          else ("strength", "r0", "z0"))
        fit_fields = tuple(fit_fields)
        # a joint fit moves the camera anyway; its named fields are scene
        # fields
        allowed = POSE_FITTABLE if (pose and not joint) else FITTABLE_FIELDS
        unknown = set(fit_fields) - set(allowed)
        if unknown:
            raise ValueError(
                f"unknown {'pose ' if pose and not joint else ''}fit fields "
                f"{sorted(unknown)}; valid: {sorted(allowed)}")
        static, _ = flatten_scene(scene)  # validate at submission
        march = self._check_march(march, pose and not joint, static,
                                  fit_fields)
        spec = dict(target=target_image, fit_fields=fit_fields, steps=steps,
                    lr=float(lr), multiscale=bool(multiscale),
                    pose=("joint" if joint else "fd" if fd else bool(pose)),
                    march=march)
        if joint:
            spec["rounds"] = rounds
            spec["pose_steps"] = pose_steps
            spec["pose_method"] = pose_method
        return self._enqueue(Job(id=0, scene=scene, key=("fit", object()),
                                 fit_spec=spec))

    def _check_march(self, march, pose, static, fit_fields) -> str:
        """Validate a fit job's march at submission, so a bad request
        answers 400 instead of failing later on the worker (engine/fit
        checks the same again when it runs)."""
        march = str(march)
        if march not in ("tensor", "scan", "frozen"):
            raise ValueError(
                f"unknown march backend {march!r}; use 'tensor', 'scan' "
                f"or 'frozen'")
        if march == "frozen":
            if pose:
                raise ValueError(
                    "march='frozen' cannot fit poses: moving the camera "
                    "moves every noise input; use march='tensor'")
            from .engine.tensor_march import check_frozen_fields

            check_frozen_fields(static, fit_fields)
        return march

    def submit_fit_multiview(self, scene, views, fit_fields=None,
                             steps: int = 100, lr: float = 2e-2,
                             march: str = "tensor", pose=False,
                             rounds: int = 2, pose_steps: int = 30) -> int:
        """Queue a multi-view fit (engine/fit.fit_scene_multiview): one
        galaxy fitted to K views at once. ``views`` is a list of
        {"camera": [x,y,z], "target": [x,y,z], "up": [x,y,z], "fov": f,
        "target_png": base64 PNG or array} dicts; the poses are known and
        held. ``pose="joint"`` takes them as starting guesses instead
        (fit_joint_multiview: ``rounds`` alternations of per-view
        fit_pose_fd blocks of ``pose_steps`` and a shared parameter
        block); the result then carries the K fitted cameras. The view
        axis shards over the service mesh when K divides it, else the fit
        runs on the service's first device."""
        scene = self._coerce_scene(scene)
        size = scene.config.size
        if not views:
            raise ValueError("views must be a non-empty list")
        cams, targets = [], []
        for k, v in enumerate(views):
            try:
                cams.append(CameraParams(
                    camera=tuple(v["camera"]),
                    target=tuple(v.get("target", (0.0, 0.0, 0.0))),
                    up=tuple(v.get("up", (0.0, 1.0, 0.0))),
                    fov=float(v.get("fov", scene.camera.fov))))
            except (KeyError, TypeError) as e:
                raise ValueError(f"view {k}: bad camera pose ({e})")
            t = _target_array(v.get("target_png"))
            if t.shape != (size, size, 3):
                raise ValueError(
                    f"view {k}: target must be ({size}, {size}, 3), "
                    f"got {t.shape}")
            targets.append(t)
        steps = int(steps)
        if not 1 <= steps <= 100_000:
            raise ValueError(f"steps must be in [1, 100000], got {steps}")
        from .engine.fit import FITTABLE_FIELDS

        if fit_fields is None:
            fit_fields = ("strength", "r0", "z0")
        fit_fields = tuple(fit_fields)
        unknown = set(fit_fields) - set(FITTABLE_FIELDS)
        if unknown:
            raise ValueError(f"unknown fit fields {sorted(unknown)}")
        static, _ = flatten_scene(scene)  # validate at submission
        march = self._check_march(march, False, static, fit_fields)
        if pose not in (False, "joint"):
            raise ValueError(
                "multi-view fits take pose=False (known poses, held "
                "fixed) or pose='joint' (poses refined per view)")
        if pose == "joint" and not 1 <= int(rounds) <= 100:
            raise ValueError(f"rounds must be in [1, 100], got {rounds}")
        spec = dict(target=np.stack(targets), cameras=cams,
                    fit_fields=fit_fields, steps=steps, lr=float(lr),
                    multiscale=False, pose=pose, march=march,
                    rounds=int(rounds), pose_steps=int(pose_steps))
        return self._enqueue(Job(id=0, scene=scene, key=("fit", object()),
                                 fit_spec=spec))

    def abort(self, job_id: int) -> bool:
        """Request cancellation. Queued jobs cancel immediately; a running
        single job stops at the next band boundary (keeping the partial
        frame); a running fit stops after the current optimizer step
        (keeping the best fit so far); a job already inside a batched
        launch finishes with it."""
        job = self.jobs.get(job_id)
        if job is None:
            return False
        job.abort.set()
        with self._cond:
            if job in self._queue and job.state == QUEUED:
                self._queue.remove(job)
                self._finish(job, ABORTED)
        return True

    def wait(self, job_id: int, timeout: float = 300.0,
             until: str = "done") -> Job:
        """Block until the job reaches a terminal state (or timeout),
        event-driven on the service condition (_finish notifies), so a
        waiter costs nothing while the job runs. The HTTP long-poll
        (GET /job/<id>?wait=s) rides this too: one blocked request replaces
        a polling loop per client.

        ``until="preview"`` returns as soon as a preview-then-refine job's
        fast LOD frame is published (or the job terminates)."""
        if until not in ("done", "preview"):
            raise ValueError(f"until must be 'done' or 'preview', not {until!r}")
        job = self.jobs[job_id]
        deadline = time.time() + timeout
        with self._cond:
            while job.state in (QUEUED, RUNNING):
                if until == "preview" and job.preview_ready:
                    break
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        return job

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service counters."""
        m = dict(self.metrics)
        m["queue_depth"] = self.queue_depth()
        m["consecutive_failures"] = self.consecutive_failures
        m["healthy"] = int(self.healthy())
        m["uptime_seconds"] = time.time() - m.pop("started_at")
        gauges = ("queue_depth", "uptime_seconds", "consecutive_failures",
                  "healthy")
        lines = []
        for k, v in sorted(m.items()):
            lines.append(f"# TYPE gamer_{k} "
                         f"{'gauge' if k in gauges else 'counter'}")
            lines.append(f"gamer_{k} {v}")
        with self._cond:
            buckets = list(self._lat_buckets)
            lat_sum, lat_count = self._lat_sum, self._lat_count
        lines.append("# TYPE gamer_request_seconds histogram")
        cum = 0
        for le, n in zip(self._lat_le, buckets):
            cum += n
            lines.append(f'gamer_request_seconds_bucket{{le="{le}"}} {cum}')
        lines.append(
            f'gamer_request_seconds_bucket{{le="+Inf"}} {cum + buckets[-1]}')
        lines.append(f"gamer_request_seconds_sum {round(lat_sum, 6)}")
        lines.append(f"gamer_request_seconds_count {lat_count}")
        return "\n".join(lines) + "\n"

    # -- worker ------------------------------------------------------------

    def start(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="gamer-render-worker")
            self._worker.start()
        if self.pipeline and (self._completer is None
                              or not self._completer.is_alive()):
            # a prior stop() can leave a stale sentinel (worker joined but
            # completer join timed out) or stranded handoff items (worker
            # join timed out) in _completions; drain them so the fresh
            # completer doesn't exit immediately, running any stranded
            # finalizers inline so their jobs still finish.
            while True:
                try:
                    item = self._completions.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._complete(*item)
            self._completer = threading.Thread(
                target=self._completer_run, daemon=True,
                name="gamer-render-completer")
            self._completer.start()

    def stop(self, timeout: float = 30.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        worker_down = True
        if self._worker is not None:
            self._worker.join(timeout)
            worker_down = not self._worker.is_alive()
        if self._completer is not None and worker_down:
            # the worker is down, so every handoff is already enqueued; the
            # sentinel lands behind them and the completer drains in order.
            # If the worker join TIMED OUT a sentinel now could land AHEAD
            # of a handoff the still-alive worker enqueues next, stranding
            # those jobs RUNNING forever, so leave the completer up in that
            # case; a later stop()/start() cleans up. put() is bounded so
            # stop() honors its own timeout even with the queue full.
            try:
                self._completions.put(None, timeout=timeout)
                self._completer.join(timeout)
            except queue.Full:
                pass

    def _finish(self, job: Job, state: str, error: str | None = None) -> None:
        # under the lock: called from the worker, the completer AND from
        # abort() on HTTP handler threads (Condition wraps an RLock, so the
        # abort() caller that already holds it re-enters safely)
        with self._cond:
            job.state = state
            job.error = error
            job.finished = time.time()
            if state == DONE:
                job.progress = 1.0
                self.metrics["frames_rendered"] += 1
                self.consecutive_failures = 0
                if job.fit_spec is None and job.warm_spec is None:
                    dt = job.finished - job.submitted
                    for i, le in enumerate(self._lat_le):
                        if dt <= le:
                            self._lat_buckets[i] += 1
                            break
                    else:
                        self._lat_buckets[-1] += 1
                    self._lat_sum += dt
                    self._lat_count += 1
            elif state == FAILED:
                self.metrics["jobs_failed"] += 1
            elif state == ABORTED:
                self.metrics["jobs_aborted"] += 1
            # bounded retention: evict the oldest finished job beyond the
            # cap, frame buffers included
            self._finished_order.append(job.id)
            while (self.max_finished is not None
                   and len(self._finished_order) > self.max_finished):
                self.jobs.pop(self._finished_order.popleft(), None)
                self.metrics["jobs_evicted"] += 1
            self._cond.notify_all()  # wake wait()/long-poll clients

    def healthy(self) -> bool:
        return self.consecutive_failures < self.max_consecutive_failures

    def _drain_compatible(self, head: Job) -> List[Job]:
        """Pull every queued job sharing head's structure and size, up to
        ``max_batch`` in all (FIFO order preserved for the rest)."""
        jobs = [head]
        with self._cond:
            keep = deque()
            while self._queue:
                j = self._queue.popleft()
                if (j.key == head.key and not j.abort.is_set()
                        and (self.max_batch is None
                             or len(jobs) < self.max_batch)):
                    jobs.append(j)
                else:
                    keep.append(j)
            self._queue = keep
        return jobs

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop:
                    return
                head = self._queue.popleft()
            if head.abort.is_set():
                self._finish(head, ABORTED)
                continue
            if self.batch_window_s > 0 and head.anim_scenes is None \
                    and head.fit_spec is None and head.warm_spec is None \
                    and head.preview_lod is None:
                # animations, fit, warm and preview jobs never merge with other
                # requests (their keys are unique by construction): don't
                # pay the batching window for them. Under sustained load,
                # compatible requests pile up DURING the previous launch,
                # so if any are already queued the window is pure added
                # latency: sleep only when the head is (so far) alone.
                with self._cond:
                    alone = not any(j.key == head.key for j in self._queue)
                if alone:
                    time.sleep(self.batch_window_s)
            self._execute_head(head)

    def _execute_head(self, head: Job) -> None:
        """Run one job (plus any batch-compatible queued jobs) on the
        calling thread: the worker loop and the quick-job lane share this
        body."""
        jobs = self._drain_compatible(head)
        t0 = time.time()
        for j in jobs:
            j.state = RUNNING
            j.started = t0
        try:
            if head.fit_spec is not None:
                self._run_fit(head)
            elif head.warm_spec is not None:
                self._run_warm(head)
            elif head.anim_scenes is not None:
                self._render_animation(head)
            elif head.preview_lod is not None:
                self._render_preview_refine(head)
            elif len(jobs) > 1:
                self._render_batch(jobs)
            else:
                self._render_single(head)
        except Exception as e:  # noqa: BLE001 - job isolation
            self._fail(jobs, e)
        with self._cond:
            self.metrics["render_seconds"] += time.time() - t0

    def _fail(self, jobs: List[Job], e: Exception) -> None:
        with self._cond:
            self.consecutive_failures += 1
        for j in jobs:
            if j.state == RUNNING:
                self._finish(j, FAILED, f"{type(e).__name__}: {e}")

    # -- readback pipeline ---------------------------------------------------

    def _handoff(self, jobs: List[Job], finalize) -> None:
        """Queue ``finalize`` (the wait for the download and the job finish
        of an already DISPATCHED launch) on the completer thread so the
        worker can at once drain, pack and dispatch the next launch. Runs
        inline when pipelining is off or the completer isn't up (direct
        _execute_head callers in tests)."""
        if (self.pipeline and self._completer is not None
                and self._completer.is_alive()):
            self._completions.put((jobs, finalize))
        else:
            self._complete(jobs, finalize)

    def _complete(self, jobs: List[Job], finalize) -> None:
        """Run a launch's readback and finish with the same failure
        isolation as _execute_head: a poisoned readback fails THOSE jobs
        and bumps the healthz counter; the service lives on."""
        try:
            finalize()
        except Exception as e:  # noqa: BLE001 - job isolation
            self._fail(jobs, e)

    def _completer_run(self) -> None:
        while True:
            item = self._completions.get()
            if item is None:
                return
            self._complete(*item)

    def _preempt_quick_jobs(self) -> None:
        """Interactive lane: between the phases of a long job (the steps of
        a fit, the shapes of a warm job, the preview and the exact frame of
        a preview job), serve every queued job that is not itself a fit or
        a warm job, so that long work cannot head-of-line block quick
        renders (the reference's queue stays responsive via its 50 ms poll
        tick, renderqueue.cpp:63-87). Fits stay FIFO among themselves."""
        if self._preempting:
            return  # a preempted job's own callbacks must not recurse
        self._preempting = True
        try:
            while True:
                with self._cond:
                    head = next((j for j in self._queue
                                 if j.fit_spec is None
                                 and j.warm_spec is None), None)
                    if head is None:
                        return
                    self._queue.remove(head)
                if head.abort.is_set():
                    self._finish(head, ABORTED)
                    continue
                with self._cond:
                    self.metrics["worker_preemptions"] += 1
                self._execute_head(head)
        finally:
            self._preempting = False

    def _render_batch(self, jobs: List[Job]) -> None:
        """One launch for every compatible queued request."""
        # dispatch only: the frames stay on the device, and their copy to
        # pinned memory is queued on a side stream; the completer waits for
        # it while the worker packs the next launch (pipeline=True)
        frames = batch.render_batch([j.scene for j in jobs],
                                    device=self.device, device_out=True,
                                    mesh=self._batch_mesh)
        pending = self._download.start(frames)
        with self._cond:
            self.metrics["batches"] += 1
            self.metrics["batched_frames"] += len(jobs)

        def finalize():
            host = self._download.finish(pending)
            for j, frame in zip(jobs, host):
                j.batched = True
                j.image = frame
                self._finish(j, DONE)

        self._handoff(jobs, finalize)

    def _render_animation(self, job: Job) -> None:
        """One batched launch for a whole fly-through or morph."""
        job.frames = batch.render_batch(list(job.anim_scenes),
                                        device=self.device,
                                        mesh=self._batch_mesh)
        job.image = job.frames[0]
        with self._cond:
            self.metrics["frames_rendered"] += job.n_frames - 1  # +1 in _finish
        self._finish(job, DONE)

    def _fuses(self, scene: Scene) -> bool:
        """Whether a single frame of this scene is one launch (a frame
        over a mesh always is: band-level progress would serialize the
        mesh on every band boundary)."""
        return (self.mesh is not None
                or 0 < scene.config.size < self.single_fuse_below)

    def _run_warm(self, job: Job) -> None:
        """Run every launch shape the service would use for the warm
        scene(s): the single-frame path plus each batch size of the batched
        path. Queued interactive jobs are drained between shapes, so
        warming never blocks real traffic for more than one shape."""
        buckets = job.warm_spec["buckets"]
        scenes = job.warm_spec["scenes"]
        plan = [(sc, b) for sc in scenes for b in [None] + buckets]
        timings: Dict[str, float] = {}
        for i, (sc, b) in enumerate(plan):
            if job.abort.is_set():
                self._finish(job, ABORTED)
                return
            t0 = time.time()
            if b is None:  # the path a lone interactive request takes
                if self._fuses(sc):
                    cuda_render.render_scene(sc, device=self.device,
                                             mesh=self.mesh)
                else:
                    cuda_render.render_progressive(sc, bands=self.bands,
                                                   device=self.device)
                label = f"{sc.config.size}px/single"
            else:
                batch.render_batch([sc] * b, device=self.device,
                                   mesh=self._batch_mesh)
                label = f"{sc.config.size}px/batch{b}"
            timings[label] = round(time.time() - t0, 3)
            with self._cond:
                self.metrics["warmed_executables"] += 1
            job.progress = (i + 1) / len(plan)
            self._preempt_quick_jobs()
        job.result = {"warmed": timings}
        self._finish(job, DONE)

    def _run_fit(self, job: Job) -> None:
        """Inverse rendering on the worker, with per-step progress; the
        result is the fitted scene dict and loss trace, plus a render of
        the fitted scene (``render_scene``, K1 on the card) for
        /image.png. fd pose jobs spread their probe frames over the batch
        mesh; the autograd fits shard over the service mesh where every
        rung tiles it (``_fit_mesh``; multi-view fits where the views
        divide it), else they run on the service's device.

        The sharding is the JAX service's, and it costs time: one host
        thread issues every entry's launches, so a fit on a mesh of n
        cards takes n x the launches of the unsharded fit at 1/n of the
        pixels and runs slower (PERF.md section 5: a fit_scene step
        2.5 x, a fit_pose step ~5 x on four NVIDIA H100 80GB HBM3 at
        700 W), with 1/n of the peak
        memory on each card. A service that should fit faster is started
        without a mesh."""
        from .engine.fit import (
            DEFAULT_POSE_SCHEDULE,
            DEFAULT_SCENE_SCHEDULE,
            fit_joint,
            fit_joint_multiview,
            fit_pose,
            fit_pose_fd,
            fit_pose_multiscale,
            fit_scene,
            fit_scene_multiscale,
            fit_scene_multiview,
        )

        spec = job.fit_spec
        pose = spec.get("pose", False)
        joint = pose == "joint"
        multiview = spec.get("cameras") is not None
        pose_steps = spec.get("pose_steps", 30)
        if joint and multiview:
            # rounds x (K per-view fd pose blocks + the shared scene block)
            total = spec["rounds"] * (
                len(spec["cameras"]) * pose_steps + spec["steps"])
        elif joint:
            pose_block = (pose_steps if spec.get("pose_method") == "fd"
                          else pose_steps * len(DEFAULT_POSE_SCHEDULE))
            total = spec["rounds"] * (pose_block + spec["steps"])
        elif pose == "fd":
            total = spec["steps"]
        else:
            schedule = DEFAULT_POSE_SCHEDULE if pose else DEFAULT_SCENE_SCHEDULE
            total = spec["steps"] * (len(schedule) if spec["multiscale"]
                                     else 1)

        def on_step(i, loss):
            job.progress = min(1.0, (i + 1) / total)
            # serve queued quick jobs between steps, so the fit does not
            # head-of-line block the service
            self._preempt_quick_jobs()
            # DELETE /job/<id> stops the fit after this step; the best fit
            # so far is still the result
            return not job.abort.is_set()

        dev = dict(device=self.device)
        if multiview:
            # the view axis shards over the service mesh when it tiles
            # (K % n == 0), else the fit runs on the first device
            mesh = self.mesh
            if mesh is not None and len(spec["cameras"]) % mesh.size:
                mesh = None
        elif joint:
            # both blocks must tile the mesh: the pose ladder's rungs and
            # the full-size parameter block (the JAX service's rule, which
            # checks the ladder for fd pose blocks too)
            mesh = self._fit_mesh(job.scene, True, pose=True)
            if mesh is not None and \
                    self._fit_mesh(job.scene, False, pose=False) is None:
                mesh = None
        if multiview and joint:
            result = fit_joint_multiview(
                job.scene, spec["target"], spec["cameras"],
                spec["fit_fields"], rounds=spec["rounds"],
                pose_steps=pose_steps, scene_steps=spec["steps"],
                scene_lr=spec["lr"], on_step=on_step, mesh=mesh,
                march=spec.get("march", "frozen"), **dev)
        elif multiview:
            result = fit_scene_multiview(
                job.scene, spec["target"], spec["cameras"],
                spec["fit_fields"], steps=spec["steps"], lr=spec["lr"],
                on_step=on_step, mesh=mesh,
                march=spec.get("march", "tensor"), **dev)
        elif joint:
            result = fit_joint(
                job.scene, spec["target"], spec["fit_fields"],
                rounds=spec["rounds"], pose_steps=pose_steps,
                scene_steps=spec["steps"], scene_lr=spec["lr"],
                on_step=on_step,
                pose_method=spec.get("pose_method", "multiscale"),
                march=spec.get("march", "tensor"), mesh=mesh, **dev)
        elif pose == "fd":
            # the 2K+1 probe frames of a step are one batch: they spread
            # over the batch mesh like any batch
            result = fit_pose_fd(
                job.scene, spec["target"], spec["fit_fields"],
                steps=spec["steps"], lr=spec["lr"], on_step=on_step,
                mesh=self._batch_mesh, **dev)
        else:
            fitter = ((fit_pose_multiscale if spec["multiscale"]
                       else fit_pose) if pose else
                      (fit_scene_multiscale if spec["multiscale"]
                       else fit_scene))
            result = fitter(job.scene, spec["target"], spec["fit_fields"],
                            steps=spec["steps"], lr=spec["lr"],
                            on_step=on_step,
                            march=spec.get("march", "tensor"),
                            mesh=self._fit_mesh(job.scene,
                                                spec["multiscale"], pose),
                            **dev)
        job.result = {
            "scene": scene_to_dict(result.scene),
            "losses": [float(v) for v in result.losses],
            "fit_fields": list(result.fit_fields),
        }
        if joint and multiview:
            job.result["poses"] = (result.params or {}).get("poses")
        elif joint or pose:
            # the fitted pose (it is also the scene's camera)
            pose_params = ((result.params or {}).get("pose") or {}
                           if joint else result.params)
            job.result["pose"] = {
                k: (np.asarray(v).tolist() if np.ndim(v) else float(v))
                for k, v in pose_params.items()}
        job.image = cuda_render.render_scene(result.scene, device=self.device)
        self._finish(job, ABORTED if job.abort.is_set() else DONE)

    def _fit_mesh(self, scene, multiscale: bool, pose: bool = False):
        """The service mesh if every rung of an autograd fit tiles it with
        whole pooled rows, else None (the fit then runs on the first
        device, so odd sizes stay serviceable). Scene rungs render at
        size // s over DEFAULT_SCENE_SCHEDULE; pose rungs render at full
        size and pool the loss by the schedule's pool factor."""
        if self.mesh is None:
            return None
        from .engine.fit import DEFAULT_POSE_SCHEDULE, DEFAULT_SCENE_SCHEDULE

        n = self.mesh.size
        size = int(scene.config.size)
        if pose:
            divisors = ([p for _, p in DEFAULT_POSE_SCHEDULE]
                        if multiscale else [1])
        else:
            divisors = list(DEFAULT_SCENE_SCHEDULE) if multiscale else [1]
        if all(size % s == 0 and (size // s) % n == 0 for s in divisors):
            return self.mesh
        return None

    def _render_preview_refine(self, job: Job) -> None:
        """Preview-then-refine: publish a fast LOD frame, then replace it
        with the exact frame (mainwindow.cpp:483-495: every edit re-renders
        at previewSize with rayStep forced coarse, the Render button then
        produces the exact frame). Phase 1 caps the fractal octaves at
        ``preview_lod`` and uses the preview min-step (RenderConfig
        is_preview, the rasterizer.cpp:439-442 coarse sampling), one fused
        launch; the frame lands in ``job.image`` with ``preview_ready`` set
        and waiters are woken. Phase 2 runs in the long-running lane
        (queued quick jobs are served first) and renders the EXACT frame,
        bit-equal to a direct render_scene of the submitted scene; the
        preview stays visible until the exact frame replaces it (no
        partial band frames)."""
        pv_scene = dataclasses.replace(
            job.scene, config=dataclasses.replace(
                job.scene.config, noise_octaves=int(job.preview_lod),
                is_preview=True))
        pv = cuda_render.render_scene(pv_scene, device=self.device,
                                      mesh=self.mesh)
        with self._cond:
            job.image = pv
            job.preview_ready = True
            job.progress = 0.5
            self.metrics["previews_rendered"] += 1
            self._cond.notify_all()  # wake wait(until="preview") clients
        if job.abort.is_set():
            self._finish(job, ABORTED)  # preview kept as the partial frame
            return
        # exact phase in the long-running lane: interactive work first
        self._preempt_quick_jobs()
        if job.abort.is_set():
            self._finish(job, ABORTED)
            return
        if self._fuses(job.scene):
            exact = cuda_render.render_scene(job.scene, device=self.device,
                                             mesh=self.mesh)
        else:
            def on_progress(frac: float, partial: np.ndarray):
                # progress ticks, but the preview frame STAYS in job.image
                job.progress = 0.5 + 0.5 * frac
                return not job.abort.is_set()

            exact = cuda_render.render_progressive(
                job.scene, bands=self.bands, on_progress=on_progress,
                device=self.device)
            if job.abort.is_set():
                self._finish(job, ABORTED)
                return
        job.image = exact
        self._finish(job, ABORTED if job.abort.is_set() else DONE)

    def _render_single(self, job: Job) -> None:
        if self._fuses(job.scene):
            # one launch (one per mesh entry over a mesh). Dispatch, then
            # hand off like batches: the download of this frame overlaps
            # the worker's next launch.
            frame = cuda_render.render_scene(job.scene, device=self.device,
                                             device_out=True, mesh=self.mesh)
            pending = self._download.start(frame)
            if self.mesh is None:
                with self._cond:
                    self.metrics["singles_fused"] += 1

            def finalize():
                job.image = self._download.finish(pending)
                self._finish(job, ABORTED if job.abort.is_set() else DONE)

            self._handoff([job], finalize)
            return

        def on_progress(frac: float, partial: np.ndarray):
            job.progress = frac
            job.image = partial
            return not job.abort.is_set()

        job.image = cuda_render.render_progressive(
            job.scene, bands=self.bands, on_progress=on_progress,
            device=self.device)
        self._finish(job, ABORTED if job.abort.is_set() else DONE)


# -- HTTP layer -------------------------------------------------------------


def _gif(frames: np.ndarray, duration_ms: int = 80) -> bytes:
    """The frames as an animated GIF; needs PIL (GifUnavailable without)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise GifUnavailable(
            "animation.gif needs PIL, which is not installed here; the "
            "frames are available to library callers as job.frames") from e
    imgs = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    imgs[0].save(buf, format="GIF", save_all=True, duration=duration_ms,
                 loop=0, append_images=imgs[1:])
    return buf.getvalue()


def _platform(device: torch.device) -> dict:
    """torch's platform and the device name, for /healthz."""
    if device.type == "cuda":
        return {"platform": "cuda",
                "device": torch.cuda.get_device_name(device)}
    return {"platform": device.type, "device": device.type}


def _target_array(target) -> np.ndarray:
    """A fit target as a uint8 array: a base64-encoded PNG (the HTTP
    payload) is decoded, anything else taken as an array."""
    if isinstance(target, str):
        return decode_png(base64.b64decode(target))
    return np.asarray(target)


def _submit_fit_payload(service: RenderService, scene, payload: dict) -> int:
    """POST /fit: a single-target fit, or with "views" a multi-view one."""
    fields = payload.get("fields")
    fields = tuple(fields) if fields is not None else None
    if payload.get("views") is not None:
        if payload.get("multiscale") or payload.get("pose") not in (
                None, False, "joint"):
            raise ValueError(
                "multi-view fits take 'pose': 'joint' (poses refined per "
                "view) or no 'pose' (poses held fixed); no 'multiscale'")
        pose_mv = payload.get("pose") or False
        return service.submit_fit_multiview(
            scene, payload["views"], fields, payload.get("steps", 100),
            payload.get("lr", 2e-2),
            payload.get("march", "frozen" if pose_mv else "tensor"),
            pose=pose_mv, rounds=payload.get("rounds", 2),
            pose_steps=payload.get("pose_steps", 30))
    return service.submit_fit(
        scene, payload.get("target_png"), fields, payload.get("steps", 100),
        payload.get("lr", 2e-2), payload.get("multiscale", False),
        payload.get("pose", False), payload.get("march", "tensor"),
        payload.get("rounds", 2), payload.get("pose_steps", 30),
        payload.get("pose_method", "multiscale"))


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, "application/json", json.dumps(obj).encode())

        def _job(self, path: str) -> Optional[Job]:
            try:
                return service.jobs.get(int(path.split("/")[2]))
            except (IndexError, ValueError):
                return None

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            if path not in ("/render", "/flythrough", "/morph", "/fit",
                            "/warm"):
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                scene = payload.get("scene", payload)
                if path == "/flythrough":
                    job_id = service.submit_flythrough(
                        scene, payload.get("frames", 16),
                        payload.get("orbit_deg", 360.0))
                elif path == "/morph":
                    job_id = service.submit_morph(
                        scene, payload.get("target_galaxy"),
                        payload.get("frames", 16),
                        payload.get("ease", "smoothstep"))
                elif path == "/warm":
                    job_id = service.submit_warm(
                        scene, payload.get("buckets", (1, 2, 4, 8)),
                        payload.get("sizes"))
                elif path == "/fit":
                    job_id = _submit_fit_payload(service, scene, payload)
                else:
                    job_id = service.submit(scene,
                                            preview=payload.get("preview"))
                self._json(202, {"job": job_id})
            except QueueFull as e:
                self._json(429, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - a bad request, reported
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def do_DELETE(self):
            path = urllib.parse.urlparse(self.path).path
            job = self._job(path)
            if path.startswith("/job/") and job is not None:
                service.abort(job.id)
                self._json(200, job.info())
            else:
                self._json(404, {"error": "no such job"})

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/healthz":
                platform = _platform(service.device)
                if not service.healthy():
                    # repeated render failures usually mean a poisoned
                    # device runtime: tell the orchestrator to restart us
                    return self._json(503, {
                        "ok": False, **platform,
                        "error": f"{service.consecutive_failures} consecutive"
                                 " render failures"})
                self._json(200, {"ok": True, **platform})
            elif path == "/metrics":
                self._send(200, "text/plain; version=0.0.4",
                           service.metrics_text().encode())
            elif path == "/jobs":
                jobs = [j.info() for j in
                        sorted(service.jobs.values(), key=lambda j: -j.id)]
                self._json(200, {"jobs": jobs})
            elif path.startswith("/job/") and path.endswith("/result.json"):
                job = self._job(path)
                if job is None:
                    self._json(404, {"error": "no such job"})
                elif job.result is None:
                    self._json(409, {"error": f"job is {job.state} or has "
                                     "no result", **job.info()})
                else:
                    self._json(200, job.result)
            elif path.startswith("/job/") and path.endswith("/animation.gif"):
                job = self._job(path)
                if job is None:
                    self._json(404, {"error": "no such job"})
                elif job.frames is None:
                    self._json(409, {"error": f"job is {job.state} or not a "
                                     "fly-through", **job.info()})
                else:
                    try:
                        self._send(200, "image/gif", _gif(job.frames))
                    except GifUnavailable as e:
                        self._json(501, {"error": str(e)})
            elif path.startswith("/job/") and path.endswith("/image.png"):
                job = self._job(path)
                if job is None:
                    self._json(404, {"error": "no such job"})
                elif job.image is None:
                    self._json(409, {"error": f"job is {job.state}",
                                     **job.info()})
                else:
                    self._send(200, "image/png", encode_png(job.image))
            elif path.startswith("/job/"):
                job = self._job(path)
                if job is None:
                    self._json(404, {"error": "no such job"})
                else:
                    # long-poll: ?wait=SECONDS blocks (cap 60 s) until the
                    # job is terminal: one request replaces a client-side
                    # polling loop. Each waiter occupies only a handler
                    # thread parked on the service condition.
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query)
                    if "wait" in q:
                        try:
                            timeout = min(float(q["wait"][0]), 60.0)
                        except ValueError:
                            return self._json(400, {"error": "bad wait="})
                        until = q.get("until", ["done"])[0]
                        if until not in ("done", "preview"):
                            return self._json(400, {"error": "bad until="})
                        with service._cond:
                            service.metrics["long_polls"] += 1
                        service.wait(job.id, timeout=timeout, until=until)
                    self._json(200, job.info())
            else:
                self._json(404, {"error": "not found"})

    return Handler


def serve(port: int = 8100, batch_window_s: float = 0.05, bands: int = 8,
          mesh=None, poll: bool = True, on_start=None,
          max_batch: Optional[int] = None, device="cuda"):
    """Start the render API on 127.0.0.1. Returns the HTTPServer
    (caller-managed when poll=False: used by tests and embedders, who call
    ``httpd.shutdown()``, ``httpd.server_close()`` and
    ``httpd.service.stop()``). on_start(service) runs once the service
    exists, e.g. to submit a startup warm job (CLI warm=)."""
    service = RenderService(batch_window_s=batch_window_s, bands=bands,
                            mesh=mesh, max_batch=max_batch, device=device)
    try:
        if on_start is not None:
            on_start(service)
        httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(service))
    except BaseException:
        service.stop()
        raise
    httpd.service = service  # type: ignore[attr-defined]
    print(f"gamer_tpu_torch render service on "
          f"http://127.0.0.1:{httpd.server_address[1]}/ "
          f"(POST /render, GET /job/<id>, /metrics)", flush=True)
    if poll:
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            service.stop()
    return httpd
