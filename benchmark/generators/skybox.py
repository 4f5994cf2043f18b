"""Closed loop of skyboxes: for each, the six cube faces of
``queue.skybox_jobs`` rendered by one ``batch.render_batch`` call (one K4
launch) to a host uint8 array. Skybox k's camera is the configuration's
camera turned about the galaxy's axis by an azimuth drawn from the
seed."""

from __future__ import annotations

import time

import numpy as np

from harness import pixels
from harness.cell import rng, scene_dict, turned


def face_cameras(config: dict, camera: dict) -> list:
    """The six faces' cameras as the configuration states them (the
    reference's RenderQueue::RenderSkybox): target = camera + plane."""
    cam = np.asarray(camera["camera"], np.float64)
    return [{"camera": list(cam), "target": list(cam + np.asarray(plane)),
             "up": list(up), "fov": 90.0}
            for _, plane, up in config["skybox_faces"]]


class Run:
    def __init__(self, cell, seed: int, devices):
        import torch

        self.cell, self.seed = cell, seed
        self.size = int(cell.mix["size"])
        self.devices = [torch.device(devices[0])]
        self.az = rng(seed, "azimuth")
        self.k_px = int(cell.mix["check_pixels_per_face"])
        self.pix_rng = rng(seed, "pixels")
        self.taken = []   # (camera, six faces' pixels, their uint8 values)

    def camera(self) -> dict:
        return turned(self.cell.config["camera"],
                      float(self.az.uniform(0.0, 360.0)))

    def draw(self):
        """The next skybox's camera and the pixels of each face that are
        kept for the check."""
        n = self.size * self.size
        return self.camera(), [self.pix_rng.choice(n, self.k_px,
                                                   replace=False)
                               for _ in range(6)]

    def plan(self, units: int):
        """Draw ``units`` skyboxes as a window would, without the program
        (the precision control's views)."""
        for _ in range(units):
            self.taken.append((*self.draw(), None))

    def setup(self, seconds: float):
        from gamer_tpu_torch.engine import batch, queue
        from gamer_tpu_torch.scene.schema import scene_from_dict

        self.batch, self.queue = batch, queue
        self.scene_from_dict = scene_from_dict
        self.skybox(turned(self.cell.config["camera"], -1.0))

    def skybox(self, camera):
        base = self.scene_from_dict(scene_dict(self.cell.config, camera,
                                               self.size))
        jobs = self.queue.skybox_jobs(base)
        return self.batch.render_batch([j.scene for j in jobs],
                                       device=self.devices[0])

    def install(self, spans) -> list:
        from gamer_tpu_torch.engine import batch

        return [spans.wrap(batch, "_scene_groups", "host_prep")]

    def window(self, seconds: float, spans) -> dict:
        n = self.size * self.size
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            cam, px = self.draw()
            with spans.span("skybox"):
                faces = self.skybox(cam)
            self.taken.append((cam, px, [f.reshape(-1, 3)[p].copy()
                                         for f, p in zip(faces, px)]))
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - t0
        k = len(self.taken)
        return {"attempted": k, "failed": 0, "units": k, "rays": 6 * k * n,
                "elapsed_s": elapsed,
                "e2e": {"mrays_per_s": 6 * k * n / elapsed / 1e6}}

    def release(self):
        self.batch = self.queue = None

    def groups(self, max_rays: int) -> list:
        """A seeded sample of every face's kept pixels, about ``max_rays``
        rays in all, as (scene, views, got) groups."""
        frames = [(fc, self.size, px, None if gots is None else gots[k])
                  for cam, pxs, gots in self.taken
                  for k, (fc, px) in enumerate(zip(
                      face_cameras(self.cell.config, cam), pxs))]
        return pixels.sampled(self.cell.config, frames, max_rays, self.seed)

    def check(self, max_rays: int) -> dict:
        """The window's faces against the plain reference, once the
        program's state is freed."""
        return pixels.check(self.groups(max_rays))
