"""Render queue and skybox jobs: RenderQueue parity
(source/galaxy/renderqueue.{h,cpp}), the counterpart of
``gamer_tpu.engine.queue``.

Jobs run one after another, as the reference's FIFO does; each renders
through the band path (``cuda_render.render_progressive``, K5), which gives
the per-job percent-done. The JAX queue renders through its lockstep XLA
march, which the port does not have; the frames agree within the port's
tolerance ladder. PNGs are written with the port's standard-library writer.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from ..io.png import write_png
from ..scene.schema import CameraParams, Scene
from .cuda_render import render_progressive

# Skybox face definitions (renderqueue.cpp:129-173): target = camera + plane.
SKYBOX_FACES = (
    ("Z-", (0, 0, -1), (0, 1, 0)),
    ("Z+", (0, 0, 1), (0, 1, 0)),
    ("Y-", (0, 1, 0), (0, 0, -1)),
    ("Y+", (0, -1, 0), (0, 0, 1)),
    ("X-", (1, 0, 0), (0, 1, 0)),
    ("X+", (-1, 0, 0), (0, 1, 0)),
)


@dataclass
class RenderJob:
    scene: Scene
    filename: str  # without extension, like the reference queue items


def skybox_jobs(scene: Scene, prefix: str = "Skybox") -> List[RenderJob]:
    """Six cube-face jobs: fov 90, camera fixed, target = camera + axis."""
    jobs = []
    cam = np.asarray(scene.camera.camera, np.float64)
    for name, plane, up in SKYBOX_FACES:
        face_cam = CameraParams(
            camera=tuple(cam),
            target=tuple(cam + np.asarray(plane, np.float64)),
            up=up,
            fov=90.0,
        )
        face_scene = dataclasses.replace(scene, camera=face_cam)
        jobs.append(RenderJob(scene=face_scene, filename=f"{prefix}{name}"))
    return jobs


class RenderQueue:
    """Sequential job runner with per-job progress (RenderQueue::Update's
    poll loop as a synchronous iterator)."""

    def __init__(self, chunks: int = 16, device="cuda"):
        self.jobs: List[RenderJob] = []
        self.chunks = chunks
        self.device = device

    def add(self, job: RenderJob) -> None:
        self.jobs.append(job)

    def add_skybox(self, scene: Scene, prefix: str = "Skybox") -> None:
        for job in skybox_jobs(scene, prefix):
            self.add(job)

    def render_all(self, save_dir: str = ".",
                   on_progress: Optional[Callable[[str, float], None]] = None):
        """Render every queued job in ``chunks`` row bands, saving
        <save_dir>/<filename>.png. Yields (job, image, seconds) as each
        finishes."""
        for job in list(self.jobs):
            t0 = time.perf_counter()
            cb = (lambda frac, _img, name=job.filename:
                  on_progress(name, frac)) if on_progress else None
            img = render_progressive(job.scene, self.chunks, cb, self.device)
            write_png(Path(save_dir) / f"{job.filename}.png", img)
            yield job, img, time.perf_counter() - t0
        self.jobs.clear()
