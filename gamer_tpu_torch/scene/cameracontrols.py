"""Orbit camera controls + fly-through path building — GamerCamera parity
(source/galaxy/gamercamera.cpp:96-182).

Pure-python host helpers operating on CameraParams (the GUI's mouse-orbit
surface, reshaped as functional transforms suitable for generating camera
paths for batched fly-through rendering).

A copy of ``gamer_tpu.scene.cameracontrols``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from .schema import CameraParams


def _norm(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v / n if n else v


def _rotate(axis: np.ndarray, angle_deg: float, v: np.ndarray) -> np.ndarray:
    """Rotate v about axis by angle (degrees), axis normalized like
    QQuaternion::fromAxisAndAngle."""
    a = _norm(axis)
    half = math.radians(angle_deg) / 2.0
    s, c = math.sin(half), math.cos(half)
    u = a * s
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (c * uv + uuv)


def rotate_vertical(cam: CameraParams, angle_deg: float) -> CameraParams:
    """GamerCamera::RotateVertical (gamercamera.cpp:167-175)."""
    c = np.asarray(cam.camera, np.float64)
    t = np.asarray(cam.target, np.float64)
    up = np.asarray(cam.up, np.float64)
    d = c - t
    side = np.cross(up, d)
    new_cam = _rotate(side, angle_deg, d) + t
    new_up = _norm(np.cross(new_cam - t, side))
    return dataclasses.replace(cam, camera=tuple(new_cam), up=tuple(new_up))


def rotate_horizontal(cam: CameraParams, angle_deg: float) -> CameraParams:
    """GamerCamera::RotateHorisontal (gamercamera.cpp:176-182)."""
    c = np.asarray(cam.camera, np.float64)
    t = np.asarray(cam.target, np.float64)
    up = np.asarray(cam.up, np.float64)
    d = c - t
    side = _norm(np.cross(up, d))
    new_cam = _rotate(up, angle_deg, d) + t
    new_up = _norm(np.cross(new_cam - t, side))
    return dataclasses.replace(cam, camera=tuple(new_cam), up=tuple(new_up))


def zoom(cam: CameraParams, delta: float) -> CameraParams:
    """GamerCamera::ZoomXY (gamercamera.cpp:103-105)."""
    c = np.asarray(cam.camera, np.float64)
    t = np.asarray(cam.target, np.float64)
    new_cam = c - _norm(c - t) * delta
    return dataclasses.replace(cam, camera=tuple(new_cam))


def translate(cam: CameraParams, dx: float, dy: float) -> CameraParams:
    """GamerCamera::TranslateXY (gamercamera.cpp:96-101)."""
    c = np.asarray(cam.camera, np.float64)
    t = np.asarray(cam.target, np.float64)
    up = np.asarray(cam.up, np.float64)
    right = _norm(np.cross(c - t, up))
    d = -dy * _norm(up) + right * dx
    return dataclasses.replace(cam, camera=tuple(c + d), target=tuple(t + d))


def rotate_up(cam: CameraParams, angle_deg: float) -> CameraParams:
    """GamerCamera::RotateUp — roll about the view direction
    (gamercamera.cpp:107-114)."""
    c = np.asarray(cam.camera, np.float64)
    t = np.asarray(cam.target, np.float64)
    up = np.asarray(cam.up, np.float64)
    d = _norm(c - t)
    right = _norm(np.cross(d, up))
    up2 = _norm(np.cross(right, d))
    return dataclasses.replace(cam, up=tuple(_rotate(d, angle_deg, up2)))


def orbit_path(cam: CameraParams, frames: int, horizontal_deg: float = 360.0,
               vertical_deg: float = 0.0, zoom_total: float = 0.0) -> List[CameraParams]:
    """A fly-through path: per-frame horizontal/vertical orbit + zoom."""
    out = [cam]
    dh = horizontal_deg / max(1, frames - 1)
    dv = vertical_deg / max(1, frames - 1)
    dz = zoom_total / max(1, frames - 1)
    for _ in range(frames - 1):
        cam = rotate_horizontal(cam, dh)
        if dv:
            cam = rotate_vertical(cam, dv)
        if dz:
            cam = zoom(cam, dz)
        out.append(cam)
    return out
