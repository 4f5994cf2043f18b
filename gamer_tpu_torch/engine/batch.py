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
its single ``render_scene``. ``mesh=`` (sharding the batch over devices)
is not ported.
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
    march_batch,
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
                             f32(cfg.ray_step), f32(cfg.min_ray_step))
        pages, idx = groups.setdefault(st, ([], []))
        pages.append(page)
        idx.append(i)
    return [(st, np.stack(pages), np.asarray(idx))
            for st, (pages, idx) in groups.items()]


def _render_group(static, pages: np.ndarray, size: int, ss: int,
                  device: torch.device) -> torch.Tensor:
    """One launch for one structure group -> (n, size, size, 3) linear
    radiance on ``device``, supersampling pooled in linear space."""
    table = _build_table(static, _build_layout(static))
    lin = march_batch(torch.as_tensor(pages, device=device),
                      upload_table(table, device), size * ss)
    return pool_linear(lin, ss)


def render_batch_linear(scenes: Sequence[Scene], device="cuda",
                        mesh=None) -> torch.Tensor:
    """Linear radiance of B scenes -> (B, size, size, 3) float32 on
    ``device``: one launch per structure group, no star overlay and no post
    chain (the forward model of finite-difference fit probes)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported: gamer_tpu_torch renders a batch on one "
            "device (multi-GPU batches are queued in ROADMAP.md)")
    if not scenes:
        raise ValueError("render_batch needs at least one scene")
    dev = _device(device)
    size, ss = scenes[0].config.size, scenes[0].config.supersample
    for s in scenes:
        if s.config.size != size:
            raise ValueError("all scenes in a batch must share the size")
        if s.config.supersample != ss:
            raise ValueError("all scenes in a batch must share the supersample")
    groups = _scene_groups(scenes)
    if len(groups) == 1:
        return _render_group(groups[0][0], groups[0][1], size, ss, dev)
    linear = torch.zeros((len(scenes), size, size, 3), dtype=torch.float32,
                         device=dev)
    for static, pages, idx in groups:
        linear[torch.as_tensor(idx, device=dev)] = _render_group(
            static, pages, size, ss, dev)
    return linear


def _star_key(cfg):
    return (cfg.no_stars, cfg.star_size, cfg.star_size_spread,
            cfg.star_strength, cfg.star_seed)


def render_batch(scenes: Sequence[Scene], device="cuda",
                 device_out: bool = False, mesh=None):
    """Render B scenes (one size and supersample) -> (B, size, size, 3)
    uint8: a numpy array, or with ``device_out`` a tensor left on
    ``device``. Star overlays are made once per unique star configuration;
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
