"""Device meshes and the row-sharded still frame: the counterpart of
``gamer_tpu.parallel.sharding``.

A ``Mesh`` is an ordered list of ``torch.device`` entries with named axes.
A device may appear more than once: every entry has a CUDA stream of its
own, so ``Mesh(["cuda:0"] * 4)`` runs four shares of a frame as four
concurrent launches on one card, and ``Mesh(["cuda:0", "cuda:1", ...])``
puts them on several. The sharded launches (``engine/cuda_render.py``:
``march_rowshard``, ``march_batch_rowshard``, ``march_rays_rowshard``)
launch the march kernel once per entry, on that entry's device and stream,
and copy the outputs into one tensor on the mesh's first device: the
counterpart of the ``shard_map`` wrappers of ``pallas_render``. The
XLA-form frame (``render_scene_sharded(method="xla")``) and the autograd
fits (``engine/fit.py``'s ``mesh=``) run on the same meshes, each entry on
its device's current stream. No communication happens inside the march
(rays are independent); the only traffic is the final gather, the analog
of Rasterizer::AssembleImage (rasterizer.cpp:315-327), and for a fit the
sum of the gradients on the first device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..scene.schema import Scene

PIXEL_AXIS = "px"


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


@dataclass(frozen=True)
class Mesh:
    """An ordered, hashable list of devices with named axes.

    ``devices`` is flat, row-major over ``shape`` (one size per axis name;
    a 1-D mesh by default). Entry ``i`` launches on ``devices[i]`` and on
    ``stream(i)``, a stream of its own made at first use (None for a CPU
    entry). Two meshes with the same devices, names and shape are equal."""

    devices: tuple
    axis_names: tuple = (PIXEL_AXIS,)
    shape: Optional[tuple] = None
    _streams: dict = field(default_factory=dict, compare=False, hash=False,
                           repr=False)

    def __post_init__(self):
        devices = tuple(_as_device(d) for d in self.devices)
        names = tuple(self.axis_names)
        shape = ((len(devices),) if self.shape is None
                 else tuple(int(s) for s in self.shape))
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(names) != len(shape) or math.prod(shape) != len(devices):
            raise ValueError(
                f"mesh shape {shape} with axes {names} does not hold "
                f"{len(devices)} devices")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "shape", shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def index(self, **coords: int) -> int:
        """The flat entry index of one coordinate per axis name."""
        return int(np.ravel_multi_index(
            [coords[a] for a in self.axis_names], self.shape))

    def stream(self, i: int):
        """Entry i's own CUDA stream (None for a CPU entry)."""
        dev = self.devices[i]
        if dev.type != "cuda":
            return None
        s = self._streams.get(i)
        if s is None:
            s = self._streams[i] = torch.cuda.Stream(dev)
        return s


def local_cuda_devices() -> list:
    """Every visible CUDA device; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is False);"
            " name the devices, e.g. ['cpu'] * n for the plain torch march")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_pixel_mesh(devices: Optional[Sequence] = None,
                    axis_name: str = PIXEL_AXIS) -> Mesh:
    """1-D mesh over all visible CUDA devices (or the given ones, which may
    repeat a device or be CPU entries), for pixel-row sharding."""
    if devices is None:
        devices = local_cuda_devices()
    return Mesh(tuple(devices), (axis_name,))


def sharded_render_fn(static, size: int, mesh: Mesh, supersample: int = 1):
    """The XLA-form frame of one scene structure as a function of its
    tensor arguments, ``frame(params, camera, inv_vp, ray_step, min_step,
    exposure, gamma, saturation) -> (size, size, 3) uint8`` on the mesh's
    first device, its row slabs over the 1-D ``mesh``
    (``engine.render.render_rows_mesh``; the size must divide the mesh).
    The frame is bit-equal to ``engine.render.render_frame`` /
    ``render_frame_ss`` on the same device."""
    from ..engine.render import _post_uint8, render_rows_mesh

    def frame(params, camera, inv_vp, ray_step, min_step, exposure, gamma,
              saturation):
        with torch.no_grad():
            linear = render_rows_mesh(static, size, supersample, mesh,
                                      params, camera, inv_vp, ray_step,
                                      min_step)
            return _post_uint8(linear, exposure, gamma, saturation)

    return frame


def render_scene_sharded(scene: Scene, mesh: Optional[Mesh] = None,
                         dtype=torch.float32,
                         method: str = "pallas") -> np.ndarray:
    """Render a Scene with the frame's row slabs sharded over a mesh (by
    default every visible card).

    ``method="pallas"`` (the JAX package's name for the production kernel
    path; here the CUDA march kernel) launches one share of the frame per
    mesh entry, its dealt tile rows (every n-th from the entry's own): any
    size works on any mesh (entries past the last tile row launch nothing),
    and on the card the frame is bit-equal to the unsharded
    ``render_scene``. It renders in float32 only.
    ``method="xla"`` marches each entry's row slab through the XLA-form
    march (``engine.render.render_scene(mesh=...)``) in ``dtype``: the size
    must divide the mesh, and the frame is bit-equal to the unsharded
    XLA-form frame on the same device."""
    mesh = mesh if mesh is not None else make_pixel_mesh()
    if method == "xla":
        from ..engine.render import render_scene

        return render_scene(scene, mesh=mesh, dtype=dtype)
    if method != "pallas":
        raise ValueError(f"unknown sharded method {method!r}")
    if dtype != torch.float32:
        raise ValueError(
            f"method='pallas' renders in float32 only (got {dtype}); "
            "use method='xla' for the dtype-parametric conformance path")
    from ..engine.cuda_render import render_scene

    return render_scene(scene, mesh=mesh)
