"""Closed loop of stills: one frame after another through
``cuda_render.render_scene`` to a host uint8 array, on one card or, with
``mesh`` > 1 in the mix, on a 1-D mesh of that many cards (S1). Frame k's
camera is the configuration's camera turned about the galaxy's axis by
the seed's phase plus ``orbit_deg_per_frame`` * k."""

from __future__ import annotations

import time

from harness import pixels
from harness.cell import rng, scene_dict, turned


class Run:
    def __init__(self, cell, seed: int, devices):
        import torch

        self.cell, self.seed = cell, seed
        mix = cell.mix
        self.size = int(mix["size"])
        self.n_cards = int(mix.get("mesh", 1))
        if self.n_cards != len(devices):
            raise ValueError(f"the mix deals frames over {self.n_cards} "
                             f"cards, the cell runs on {len(devices)}")
        self.devices = [torch.device(d) for d in devices]
        self.phase = float(rng(seed, "phase").uniform(0.0, 360.0))
        self.step = float(mix["orbit_deg_per_frame"])
        self.k_px = int(mix["check_pixels_per_frame"])
        self.pix_rng = rng(seed, "pixels")
        self.taken = []   # (camera, flat pixel indices, their uint8 values)

    def camera(self, k: int) -> dict:
        return turned(self.cell.config["camera"], self.phase + self.step * k)

    def draw(self):
        """The next frame's camera and the pixels of it that are kept for
        the check."""
        cam = self.camera(len(self.taken))
        return cam, self.pix_rng.choice(self.size * self.size, self.k_px,
                                        replace=False)

    def plan(self, units: int):
        """Draw ``units`` frames as a window would, without the program
        (the precision control's views)."""
        for _ in range(units):
            self.taken.append((*self.draw(), None))

    def _scene(self, camera):
        from gamer_tpu_torch.scene.schema import scene_from_dict

        return scene_from_dict(scene_dict(self.cell.config, camera, self.size))

    def setup(self, seconds: float):
        from gamer_tpu_torch.engine import cuda_render
        from gamer_tpu_torch.parallel.sharding import Mesh

        self.render = cuda_render.render_scene
        self.mesh = Mesh(tuple(self.devices)) if self.n_cards > 1 else None
        # the frame shape the window uses, from a camera the window does not
        self.frame(self._scene(self.camera(-1)))

    def frame(self, scene):
        if self.mesh is None:
            return self.render(scene, device=self.devices[0])
        return self.render(scene, mesh=self.mesh)

    def install(self, spans) -> list:
        from gamer_tpu_torch.engine import cuda_render

        undo = [spans.wrap(cuda_render, "prepare", "host_prep")]
        if self.mesh is not None:
            undo.append(spans.wrap(cuda_render, "_gather", "assembly"))
        return undo

    def window(self, seconds: float, spans) -> dict:
        """Frames until the clock passes ``seconds``; the window ends with
        the last frame on the host."""
        n = self.size * self.size
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            cam, px = self.draw()
            scene = self._scene(cam)
            with spans.span("frame"):
                img = self.frame(scene)
            self.taken.append((cam, px, img.reshape(-1, 3)[px].copy()))
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - t0
        k = len(self.taken)
        return {"attempted": k, "failed": 0, "units": k, "rays": k * n,
                "elapsed_s": elapsed,
                "e2e": {"mrays_per_s": k * n / elapsed / 1e6}}

    def release(self):
        self.render = self.mesh = None

    def groups(self, max_rays: int) -> list:
        """A seeded sample of every frame's kept pixels, about
        ``max_rays`` rays in all, as (scene, views, got) groups."""
        return pixels.sampled(self.cell.config,
                              [(cam, self.size, px, g)
                               for cam, px, g in self.taken],
                              max_rays, self.seed)

    def check(self, max_rays: int) -> dict:
        """The window's frames against the plain reference, once the
        program's state is freed."""
        return pixels.check(self.groups(max_rays))
