"""Batched rendering: camera fly-throughs, morphs, skyboxes and dataset
chunks, as one march launch per scene structure (K4).

The counterpart of ``gamer_tpu.engine.batch``. A batch is B scenes of one
size and supersample factor; every frame has its own scalar page (camera
and galaxy numbers both live in the page, so a fly-through and a dataset
batch are the same launch). Frames are grouped by their flattened static
structure: ``flatten_scene`` sorts each frame's instances far to near from
that frame's own camera (rasterizer.cpp:190-201), so an orbit that crosses
the instances' depth order, or a batch of different galaxies, renders as
one launch per group. The post chain runs per frame with the frame's own
exposure, gamma and saturation, so each frame is bit-equal on the card to
its single ``render_scene``. With ``mesh=`` each structure group's frames
are spread over the entries of a device mesh (``march_batch_rowshard``): a
1-D mesh shards the batch axis, a ('batch', 'rows') mesh also cuts every
frame into row slabs; a group is padded to the mesh's batch divisor by
repeating its last page, and the pad frames are sliced off.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..ops.camera import inv_view_projection_batch
from ..scene.schema import CameraParams, Scene
from .cuda_render import (
    _build_layout,
    _build_table,
    _device,
    _pack_scalars,
    _star_overlay,
    batch_mesh_shape,
    march_batch,
    march_batch_rowshard,
    mesh_device,
    upload_table,
)
from .render import pool_linear, post_process
from .scene_prep import flatten_scene

f32 = np.float32


def _scene_groups(scenes: Sequence[Scene]):
    """Pack each scene's page and group the frames by static structure
    (insertion ordered, as ``gamer_tpu.engine.batch._scene_groups``).

    Returns [(static, pages (n, page_len) float32, frame indices)]."""
    flat = [flatten_scene(s) for s in scenes]
    inv_vps = inv_view_projection_batch(
        [np.asarray(s.camera.camera, f32) for s in scenes],
        [s.camera.target for s in scenes], [s.camera.up for s in scenes],
        [s.camera.fov for s in scenes])
    layouts = {}
    groups: dict = {}
    for i, (scene, (st, params), inv_vp) in enumerate(zip(scenes, flat,
                                                          inv_vps)):
        lay = layouts.get(st)
        if lay is None:
            lay = layouts[st] = _build_layout(st)
        cfg = scene.config
        page = _pack_scalars(st, lay, params,
                             np.asarray(scene.camera.camera, f32), inv_vp,
                             cfg.ray_step, cfg.min_ray_step)
        pages, idx = groups.setdefault(st, ([], []))
        pages.append(page)
        idx.append(i)
    return [(st, np.stack(pages), np.asarray(idx))
            for st, (pages, idx) in groups.items()]


BATCH_AXIS = "batch"


def make_batch_mesh(devices=None, axis_name: str = BATCH_AXIS):
    """1-D mesh over all visible CUDA devices (or the given ones, which may
    repeat a device or be CPU entries), for batch-axis sharding."""
    from ..parallel.sharding import make_pixel_mesh

    return make_pixel_mesh(devices, axis_name)


def _render_group(static, pages: np.ndarray, size: int, ss: int,
                  device: torch.device, mesh=None) -> torch.Tensor:
    """One launch for one structure group (one per mesh entry on a mesh)
    -> (n, size, size, 3) linear radiance on ``device``, supersampling
    pooled in linear space.

    On a mesh, the group is padded (repeating the last page) up to the
    mesh's batch divisor and the pad frames are sliced off; padding only
    costs anything when a batch does not tile the mesh."""
    table = upload_table(_build_table(static, _build_layout(static)), device)
    if mesh is None:
        lin = march_batch(torch.as_tensor(pages, device=device), table,
                          size * ss)
        return pool_linear(lin, ss)
    n = pages.shape[0]
    n_b, _ = batch_mesh_shape(mesh)
    pad = (-n) % n_b
    if pad:
        pages = np.concatenate([pages, np.repeat(pages[-1:], pad, axis=0)])
    lin = march_batch_rowshard(torch.as_tensor(pages, device=device), table,
                               size * ss, mesh)
    return pool_linear(lin[:n], ss)


def render_batch_linear(scenes: Sequence[Scene], device="cuda",
                        mesh=None) -> torch.Tensor:
    """Linear radiance of B scenes -> (B, size, size, 3) float32 on
    ``device``: one launch per structure group, no star overlay and no post
    chain (the forward model of finite-difference fit probes). With
    ``mesh`` each group is spread over the mesh's entries and assembled on
    its first device; ``device`` is then not consulted."""
    if not scenes:
        raise ValueError("render_batch needs at least one scene")
    dev = _device(device) if mesh is None else mesh_device(mesh)
    size, ss = scenes[0].config.size, scenes[0].config.supersample
    for s in scenes:
        if s.config.size != size:
            raise ValueError("all scenes in a batch must share the size")
        if s.config.supersample != ss:
            raise ValueError("all scenes in a batch must share the supersample")
    groups = _scene_groups(scenes)
    if len(groups) == 1:
        return _render_group(groups[0][0], groups[0][1], size, ss, dev, mesh)
    linear = torch.zeros((len(scenes), size, size, 3), dtype=torch.float32,
                         device=dev)
    for static, pages, idx in groups:
        linear[torch.as_tensor(idx, device=dev)] = _render_group(
            static, pages, size, ss, dev, mesh)
    return linear


def _star_key(cfg):
    return (cfg.no_stars, cfg.star_size, cfg.star_size_spread,
            cfg.star_strength, cfg.star_seed)


def render_batch(scenes: Sequence[Scene], device="cuda",
                 device_out: bool = False, mesh=None):
    """Render B scenes (one size and supersample) -> (B, size, size, 3)
    uint8: a numpy array, or with ``device_out`` a tensor left on
    ``device`` (on the first device of ``mesh``). Star overlays are made
    once per unique star configuration;
    the post chain runs per frame with its own scalars."""
    linear = render_batch_linear(scenes, device, mesh)
    fields = {}
    frames = []
    for lin, s in zip(linear, scenes):
        cfg = s.config
        if cfg.no_stars > 0:
            key = _star_key(cfg)
            if key not in fields:
                fields[key] = _star_overlay(cfg, linear.device)
            lin = lin + fields[key]
        frames.append(post_process(lin, f32(cfg.exposure), f32(cfg.gamma),
                                   f32(cfg.saturation)))
    img = torch.stack(frames)
    return img if device_out else img.cpu().numpy()


def render_flythrough(scene: Scene, cameras: Sequence[CameraParams],
                      device="cuda", mesh=None):
    """One scene seen from B cameras -> (B, size, size, 3) uint8."""
    return render_batch([dataclasses.replace(scene, camera=c)
                         for c in cameras], device=device, mesh=mesh)
