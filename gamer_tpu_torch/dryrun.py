"""Entry points that check the port from outside, the counterpart of the
repo's ``__graft_entry__.py``: one forward frame step, and a dry run of
every sharded path on a device mesh.

  entry(device="cuda", galaxy=None) -> (fn, example_args)
  dryrun_multichip(n_devices, budget_s=2400.0, devices=None)

    python -m gamer_tpu_torch.dryrun N [--device cpu]

Both run on the card unless the caller asks for the CPU: ``device="cpu"``,
or ``devices=["cpu"] * n`` (a mesh of CPU entries runs the plain march per
entry). A mesh may name one card several times (``["cuda:0"] * 4``), which
is how a one-card machine runs the sharded code.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import functools
import sys
import tempfile
import time

import numpy as np

from .engine import cuda_render
from .engine.allsky import render_allsky_map
from .engine.batch import make_batch_mesh, render_batch, render_flythrough
from .engine.fit import fit_scene
from .engine.jobs import DatasetJob
from .engine.render import render_frame, scene_args
from .engine.render import render_scene as render_scene_xla
from .models.presets import FIXTURE_DIR
from .parallel import (make_pixel_mesh, pixel_tile_mesh_2d,
                       render_scene_sharded)
from .parallel.sharding import local_cuda_devices
from .scene import gax
from .scene.cameracontrols import orbit_path
from .scene.schema import (CameraParams, GalaxyInstance, RenderConfig, Scene,
                           default_galaxy)
from .serve import RenderService

ENTRY_SIZE = 32
# rung h off the card: the CPU's plain march may round a ray's last ulp
# differently with another block of rays, so the sharded map is held to
# the JAX dry run's gate there (bit-equal on CUDA entries)
MAP_RTOL, MAP_ATOL = 2e-5, 1e-7


def spiral_galaxy():
    """(galaxy, where it came from): ``FIXTURE_DIR/Spiral.gax`` where the
    reference's galaxies are at hand, else the default template."""
    path = FIXTURE_DIR / "Spiral.gax"
    if path.exists():
        return gax.load(path), str(path)
    return default_galaxy(), f"default_galaxy() (no {path})"


def _spiral_scene(size: int, ray_step: float = 0.025, galaxy=None) -> Scene:
    return Scene(
        camera=CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                            up=(0, 1, 0), fov=90.0),
        instances=[GalaxyInstance(
            galaxy=spiral_galaxy()[0] if galaxy is None else galaxy)],
        config=RenderConfig(size=size, ray_step=ray_step),
    )


def entry(device="cuda", galaxy=None):
    """(fn, example_args): one forward frame of the XLA-form march (ray
    grid, masked march, post chain) at 32x32 on the spiral (``galaxy`` in
    its place when given). ``fn(*example_args)`` returns the uint8 frame
    and its linear radiance as tensors on ``device``; the arguments are
    the params, camera, inverse view-projection, ray step, min step,
    exposure, gamma and saturation tensors."""
    dev = cuda_render._device(device)
    scene = _spiral_scene(ENTRY_SIZE, galaxy=galaxy)
    static, *args = scene_args(scene, dev)
    return functools.partial(render_frame, static, ENTRY_SIZE), tuple(args)


def dryrun_multichip(n_devices: int, budget_s: float = 2400.0,
                     devices=None) -> dict:
    """Every sharded path once on an ``n_devices`` mesh at small shapes,
    rungs a-h: (a) a frame's row slabs (S1), (b) a fly-through's frames'
    tile rows dealt over a batch mesh (S2), (c) a 40x40 frame of row
    slabs against the unsharded frame, (d) a (batch, rows) mesh when n >= 4 and even, (e)
    one sharded fit step, (f) a burst into a mesh-backed render service,
    (g) a sharded DatasetJob resumed by a fresh job, (h) the all-sky map
    in ray blocks (S3) against the unsharded map. ``devices`` (default:
    the first n visible cards) may repeat a device or be CPU entries.

    Prints one tick per rung and returns {rung: seconds since the start}.
    ``budget_s`` arms a watchdog: a stuck launch would hang, so after the
    budget every thread's stack is dumped and the process exits non-zero.
    The watchdog is cancelled however the run ends."""
    try:
        sys.stderr.fileno()
        dump_to = sys.stderr
    except (AttributeError, OSError):  # a captured stream: the process's
        dump_to = sys.__stderr__
    faulthandler.dump_traceback_later(budget_s, exit=True, file=dump_to)
    try:
        return _rungs(n_devices, budget_s, devices)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _rungs(n_devices: int, budget_s: float, devices) -> dict:
    t_start = time.monotonic()
    ticks = {}

    def tick(rung: str) -> None:
        ticks[rung] = time.monotonic() - t_start
        print(f"[dryrun] rung {rung} done at {ticks[rung]:.1f}s", flush=True)

    devices = list(local_cuda_devices()[:n_devices] if devices is None
                   else devices)
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    print(f"[dryrun] {n_devices} entries {[str(d) for d in devices]}; "
          f"galaxy {spiral_galaxy()[1]}", flush=True)
    mesh = make_pixel_mesh(devices)
    dev = cuda_render.mesh_device(mesh)
    exact = dev.type == "cuda"  # the sharded forms' bit-equality contract

    # (a) a frame's tile rows dealt over the mesh (S1)
    size = max(16, 8 * n_devices)
    size += (-size) % n_devices
    img = render_scene_sharded(_spiral_scene(size), mesh)
    _check(img.shape == (size, size, 3) and img.dtype == np.uint8,
           f"sharded frame {img.shape} {img.dtype}")
    _check(int(img.sum()) > 0, "dry run rendered an empty frame")
    tick("a: pixel-row sharding")

    # (b) a fly-through's frames' tile rows dealt over a batch mesh (S2)
    bmesh = make_batch_mesh(devices)
    small = _spiral_scene(16)
    cams = orbit_path(small.camera, n_devices, horizontal_deg=90.0)
    frames = render_flythrough(small, cams, mesh=bmesh)
    _check(frames.shape == (n_devices, 16, 16, 3),
           f"sharded fly-through {frames.shape}")
    _check(int(frames.sum()) > 0, "sharded fly-through rendered empty frames")
    tick("b: batch sharding")

    # (c) a frame whose size does not tile the mesh, dealt, against
    # the unsharded frame: bit-equal on the card (S1's contract); the
    # CPU's plain march may round a pixel 1 LSB apart in another shape
    pscene = _spiral_scene(40)
    img_sharded = render_scene_sharded(pscene, mesh)
    _check(img_sharded.shape == (40, 40, 3) and int(img_sharded.sum()) > 0,
           "row-sharded 40x40 frame is empty")
    img_single = cuda_render.render_scene(pscene, device=dev)
    d = int(np.abs(img_sharded.astype(np.int16)
                   - img_single.astype(np.int16)).max())
    _check(d == 0 if exact else d <= 1,
           f"row-sharded frame {d} LSB from the unsharded render_scene")
    tick("c: row-slab sharding")

    # (d) the same on the JAX package's (batch, rows) form of the mesh,
    # dealt by card over its entries
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2d = pixel_tile_mesh_2d(rows_axis=n_devices // 2, devices=devices)
        cams2 = orbit_path(small.camera, 4, horizontal_deg=60.0)
        frames2d = render_flythrough(small, cams2, mesh=mesh2d)
        _check(frames2d.shape == (4, 16, 16, 3) and int(frames2d.sum()) > 0,
               "2-D mesh fly-through is empty")
        tick("d: 2-D batch x rows mesh")

    # (e) one fit step with the pixel rows over the mesh (each entry's
    # share of the loss and gradient, summed on the first device)
    fsize = 16
    while fsize % n_devices:
        fsize *= 2
    fit_target = render_scene_xla(_spiral_scene(fsize), device=dev)
    start = _spiral_scene(fsize)
    start.instances[0].galaxy.components[1].strength *= 0.5
    fit_res = fit_scene(start, fit_target, ("strength",), steps=1, lr=1e-2,
                        mesh=mesh)
    _check(bool(np.isfinite(fit_res.losses).all()),
           "sharded fit step: non-finite loss")
    _check(fit_res.losses[0] > 0, "sharded fit step: degenerate zero loss")
    tick("e: sharded fit step")

    # (f) a burst into a mesh-backed render service: the submissions drain
    # into batched launches over the batch axis
    svc = RenderService(autostart=False, mesh=mesh)
    try:
        burst = orbit_path(small.camera, n_devices, horizontal_deg=120.0)
        jids = [svc.submit(dataclasses.replace(small, camera=c))
                for c in burst]
        svc.start()
        for jid in jids:
            job = svc.wait(jid, timeout=budget_s / 2)
            _check(job.state == "done",
                   f"serve rung: job {jid} {job.state}: {job.error}")
            _check(int(job.image.sum()) > 0, "serve rung: empty frame")
        _check(svc.metrics["frames_rendered"] == len(jids),
               f"serve rung: {svc.metrics['frames_rendered']} frames")
        _check(svc.metrics["batches"] >= 1,
               "serve rung: the burst never became a batched launch")
        _check(svc.healthy(), "serve rung: the service is unhealthy")
    finally:
        svc.stop()
    tick("f: mesh-backed serve burst")

    # (g) a sharded DatasetJob: half the chunks, then a fresh job (as a new
    # process would after a kill) resumes from the manifest; the dataset
    # equals an uninterrupted run's bit for bit
    ds_cams = orbit_path(small.camera, 2 * n_devices, horizontal_deg=150.0)
    ds_scenes = [dataclasses.replace(small, camera=c) for c in ds_cams]
    with tempfile.TemporaryDirectory() as td:
        job1 = DatasetJob(ds_scenes, td + "/a", chunk_size=n_devices,
                          mesh=bmesh)
        _check(job1.n_chunks == 2, f"{job1.n_chunks} chunks")
        c0 = job1.remaining[0]
        lo = c0 * job1.chunk_size
        np.save(job1.out_dir / f"chunk_{c0:05d}.npy",
                render_batch(ds_scenes[lo:lo + job1.chunk_size], mesh=bmesh))
        job1.manifest["done"].append(c0)
        job1._save_manifest()
        job2 = DatasetJob(ds_scenes, td + "/a", chunk_size=n_devices,
                          mesh=bmesh)
        _check(job2.remaining == [1], f"resume saw {job2.remaining}")
        _check(job2.run() == 1, "the resumed job rendered another count")
        ref_job = DatasetJob(ds_scenes, td + "/b", chunk_size=n_devices,
                             mesh=bmesh)
        _check(ref_job.run() == 2, "the uninterrupted job's chunk count")
        _check(np.array_equal(job2.load_all(), ref_job.load_all()),
               "resumed dataset differs from the uninterrupted run")
    tick("g: sharded DatasetJob resume")

    # (h) the all-sky map's ray blocks over the mesh (S3) against the
    # unsharded map: bit-equal on the card
    m_single = render_allsky_map(small, nside=8, device=dev)
    m_sharded = render_allsky_map(small, nside=8, mesh=mesh)
    _check(m_sharded.shape == m_single.shape, "all-sky map shape")
    _check(float(m_single.max()) > 0, "all-sky map is empty")
    same = (np.array_equal(m_sharded, m_single) if exact
            else np.allclose(m_sharded, m_single, rtol=MAP_RTOL,
                             atol=MAP_ATOL))
    _check(same, "sharded all-sky map diverges from the single-device map")
    tick("h: sharded all-sky map")
    return ticks


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if len(argv) >= 2 and argv[-2] == "--device":
        device, argv = argv[-1], argv[:-2]
    if len(argv) != 1 or device not in ("cuda", "cpu"):
        print("usage: python -m gamer_tpu_torch.dryrun N [--device cpu]")
        return 1
    n = int(argv[0])
    ticks = dryrun_multichip(n, devices=["cpu"] * n if device == "cpu"
                             else None)
    print(f"[dryrun] {len(ticks)} rungs passed in {max(ticks.values()):.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
