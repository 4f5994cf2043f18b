"""Render queue, skybox jobs and the XLA-form progressive frame:
RenderQueue parity (source/galaxy/renderqueue.{h,cpp}) and the progress
contract (rasterizer.cpp:283-313, percent-done polling), the counterpart of
``gamer_tpu.engine.queue``.

``render_progressive`` is the JAX queue's form: fixed-height row chunks
of the XLA-form march (``render.render_rows``), a callback with the
partial frame after each chunk, abort between chunks. ``RenderQueue`` runs
its jobs one after another, as the reference's FIFO does, through the band
path (``cuda_render.render_progressive``, K5: the march kernel, one launch
a band), which also gives the per-job percent-done; its frames agree with
the XLA-form queue's within the port's tolerance ladder. PNGs are written
with the port's standard-library writer.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ..io.png import write_png
from ..scene.schema import CameraParams, Scene
from . import cuda_render
from .cuda_render import _device
from .render import assemble, render_rows, scene_args

# (fraction done, partial image) -> False aborts the render (Rasterizer::Abort
# analog, rasterizer.h:91-98: cooperative cancellation between chunks)
ProgressFn = Callable[[float, np.ndarray], object]

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


def render_progressive(scene: Scene, chunks: int = 16,
                       on_progress: Optional[ProgressFn] = None,
                       device="cuda", dtype=torch.float32) -> np.ndarray:
    """Render a scene with the XLA-form march in row chunks on ``device``,
    reporting progress after each chunk; returns the uint8 frame.

    The frame is cut into ``chunks`` chunks of ceil(size / chunks) output
    rows (at most one row a chunk); each chunk's supersampled rays are
    pooled per chunk. After chunk c, ``on_progress((c + 1) / chunks,
    partial)`` sees the frame assembled so far (stars, then the post
    chain), the rows not yet rendered black; a False from it stops the
    render and the partial frame is returned. Chunks past the frame's last
    row render nothing but still report. ``dtype`` is the march's float
    type. The finished frame is bit-equal to the unsharded
    ``render.render_scene`` of the same dtype on the same device."""
    dev = _device(device)
    cfg = scene.config
    size = cfg.size
    (static, params, camera, inv_vp, rs, ms, ex, ga,
     sa) = scene_args(scene, dev, dtype)
    chunks = max(1, min(chunks, size))
    rows_per = -(-size // chunks)
    linear = torch.zeros((size, size, 3), dtype=dtype, device=dev)

    def frame():
        return assemble(linear, cfg, ex, ga, sa)[0].cpu().numpy()

    with torch.no_grad():
        for c in range(chunks):
            row0 = c * rows_per
            rows = min(rows_per, size - row0)
            if rows > 0:
                linear[row0:row0 + rows] = render_rows(
                    static, size, cfg.supersample, params, camera, inv_vp,
                    rs, ms, row0, rows)
            if on_progress is not None:
                partial = frame()
                if on_progress((c + 1) / chunks, partial) is False:
                    return partial
        return frame()


class RenderQueue:
    """Sequential job runner with per-job progress (RenderQueue::Update's
    poll loop as a synchronous iterator). Each job renders through the
    band path (``cuda_render.render_progressive``, K5), not the XLA-form
    ``render_progressive`` of this module."""

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
            img = cuda_render.render_progressive(job.scene, self.chunks, cb,
                                                 self.device)
            write_png(Path(save_dir) / f"{job.filename}.png", img)
            yield job, img, time.perf_counter() - t0
        self.jobs.clear()
