"""Spec-exact numpy renderer — the conformance oracle of the renderers.

Direct transcription of the reference render path with the reference's mixed
precision (float32 Qt vectors, float64 C++ scalars), vectorized over pixels
with masking that reproduces the per-pixel control flow exactly:

  render pixel:     source/galaxy/rasterizer.cpp:379-416 (renderPixel)
  march loop:       source/galaxy/rasterizer.cpp:422-483 (getIntensity)
  gating pipeline:  source/galaxy/galaxycomponent.cpp:45-88
  component kernels: source/galaxy/galaxycomponents.cpp:5-170
  post-processing:  source/util/buffer2d.cpp:106-126
  far->near sort:   source/galaxy/rasterizer.cpp:190-201

'stars small' is rand()-driven in the reference and intentionally omitted
here, exactly as the in-tree oracle does (tools/galaxy_repro.py:734-737).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np

from ..scene.schema import (
    CID_BULGE, CID_DISK, CID_DUST, CID_DUST2, CID_DUST_POSITIVE, CID_STARS,
    ComponentParams, GalaxyInstance, Scene,
)
from ..scene.spectra import find_spectrum
from . import noise as onoise
from . import qtmath as qm

F32 = np.float32
F64 = np.float64

_F32_01 = float(np.float32(0.1))
_F32_001 = float(np.float32(0.01))


@dataclass
class OracleTimings:
    seconds: float = 0.0
    samples: int = 0  # component-march samples evaluated (pixels x steps x comps)
    pixels: int = 0

    @property
    def msamples_per_sec(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds > 0 else 0.0


def arm_ladder_count(no_arms: float) -> int:
    """GalaxyComponent::calculateArmValue's equality ladder
    (galaxycomponent.h:120-137): exactly 1/2/3 arms only when no_arms
    compares EQUAL to 1/2/3; every other value (0, 2.5, 4, 7, ...) falls
    through to all 4 arms."""
    if no_arms == 1:
        return 1
    if no_arms == 2:
        return 2
    if no_arms == 3:
        return 3
    return 4


def _get_winding(rad: np.ndarray, winding_b: float, winding_n: float) -> np.ndarray:
    """galaxycomponent.h:156-165."""
    r = rad + 0.05
    return np.arctan(np.exp(-0.25 / (0.5 * r)) / winding_b) * 2.0 * winding_n


def _find_difference(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    """galaxycomponent.h:103-118 — min |t1-t2| over 0, +-2pi, +-4pi shifts."""
    d = t1 - t2
    v = np.abs(d)
    v = np.fmin(v, np.abs(d - 2 * np.pi))
    v = np.fmin(v, np.abs(d + 2 * np.pi))
    v = np.fmin(v, np.abs(d - 4 * np.pi))
    v = np.fmin(v, np.abs(d + 4 * np.pi))
    return v


def _twirl(p32: np.ndarray, t: np.ndarray, orientation32: np.ndarray) -> np.ndarray:
    """galaxycomponent.h:86-90 — rotate p about the instance orientation by
    twirl*180 degrees (float32 quaternion path)."""
    q = qm.quat_from_axis_angle_deg(orientation32, (t * 180.0).astype(F32))
    return qm.quat_rotate(q, p32)


def _perlin_cloud(p32, t, NN, ks, pers, orientation32) -> np.ndarray:
    """galaxycomponent.h:93-98 — octave noise of the twirled point."""
    r = _twirl(p32, t, orientation32)
    return onoise.octave_noise_3d(
        NN, pers, ks * _F32_01,
        r[..., 0].astype(F64), r[..., 1].astype(F64), r[..., 2].astype(F64),
    )


class _CompState:
    """Static per-component data resolved at scene-prep time."""

    def __init__(self, cp: ComponentParams, spectrum, scene_spectra):
        self.cp = cp
        self.cid = cp.cid
        self.spec32 = np.array(find_spectrum(cp.spectrum, scene_spectra), dtype=F32)


def _arm_value(radius, P32, comp: ComponentParams, gp, rotmat32) -> np.ndarray:
    """galaxycomponent.h:120-146 — max over up to 4 log-spiral arms."""
    rot = qm.quat_rotate(rotmat32, P32)
    theta = np.arctan2(rot[..., 0].astype(F64), rot[..., 2].astype(F64)) + comp.delta
    ww = _get_winding(radius, gp.winding_b, gp.winding_n)
    arms = [gp.arm1, gp.arm2, gp.arm3, gp.arm4]
    val = None
    with np.errstate(invalid="ignore"):
        for a in range(arm_ladder_count(gp.no_arms)):
            v = np.abs(_find_difference(ww, -theta + arms[a])) / np.pi
            arm_v = np.power(1.0 - v, comp.arm * 15.0)
            # std::max(a, b) NaN semantics: b>a ? b : a (NaN loses)
            val = arm_v if val is None else np.where(arm_v > val, arm_v, val)
    return val


def _march_instance(
    gi: GalaxyInstance,
    comps: List[_CompState],
    origin32: np.ndarray,      # (N,3) f32 — far intersection points (galaxy frame)
    isp2_32: np.ndarray,       # (N,3) f32 — near intersection points
    cam_rel32: np.ndarray,     # (3,)  f32 — camera - instance position
    alive: np.ndarray,         # (N,) bool — rays that intersect this instance
    I32: np.ndarray,           # (N,3) f32 — shared accumulator (mutated)
    winding: np.ndarray,       # (N,) f64 — shared winding state (mutated)
    ray_step: float,
    min_ray_step: float,
) -> int:
    gp = gi.galaxy.params
    orientation32 = np.asarray(gi.orientation, dtype=F32)
    rotmat32 = qm.quat_rotation_to(qm.v3(0, 1, 0), orientation32)
    axis_x = float(np.float32(gp.axis[0]))
    iscale = float(gi.intensity_scale)
    scale32 = F32(ray_step)  # rp.scale — base step, constant during the march

    diff32 = (origin32 - isp2_32).astype(F32)
    length32 = qm.length32(diff32)
    dir32 = qm.normalized32(diff32)
    ll32 = qm.normalized32((isp2_32 - origin32).astype(F32))
    length64 = length32.astype(F64)

    n = origin32.shape[0]
    p32 = origin32.copy()
    step_prev = np.full(n, ray_step, dtype=F64)
    done = ~alive
    samples = 0

    while True:
        idx = np.flatnonzero(~done)
        if idx.size == 0:
            break
        # Loop condition — checked before the body (rasterizer.cpp:447).
        d_along = qm.dot32(p32[idx] - origin32[idx], ll32[idx]).astype(F64)
        stop = d_along >= length64[idx] + step_prev[idx]
        done[idx[stop]] = True
        go = idx[~stop]
        if go.size == 0:
            continue

        p = p32[go]
        # Adaptive step (rasterizer.cpp:449).
        dist = qm.length32(p - cam_rel32).astype(F64)
        step = qm.qt_clamp64(dist * ray_step, min_ray_step, 0.01)
        weight = step * 200.0

        I = I32[go]
        wind = winding[go]

        for cs in comps:
            cp = cs.cp
            if cp.active != 1 or cs.cid < 0:
                continue  # rasterizer.cpp:458 active gate; unknown class skipped
            samples += go.size
            if cs.cid == CID_BULGE:
                # Bulge bypasses all gating (galaxycomponents.cpp:5-25).
                pos = qm.quat_rotate(rotmat32, p)
                rad = (qm.length32(pos).astype(F64) + 0.01) * cp.r0 + 0.01
                i_val = (cp.strength * weight) * (
                    np.power(rad, -0.855) * np.exp(-np.power(rad, 0.25)) - 0.05
                ) * iscale
                i_val = np.where(i_val < 0, 0.0, i_val)
                I = I + cs.spec32 * (i_val * float(scale32)).astype(F32)[:, None]
                continue

            # Shared geometry (rasterizer.cpp:460-462).
            dott = qm.dot32(p, orientation32)
            P = (p - orientation32 * dott[:, None]).astype(F32)
            radius = qm.length32(P).astype(F64) / axis_x
            h = np.abs(dott.astype(F64) / cp.z0)
            sech = 1.0 / ((np.exp(h) + np.exp(-h)) / 2.0)
            z = np.where(h > 2.0, 0.0, sech * sech)

            # Gating pipeline (galaxycomponent.cpp:45-88).
            ri = np.exp(-radius / (cp.r0 * 0.5))
            intensity = qm.qt_clamp64(ri - 0.01, 0.0, 1.0)
            intensity = np.where(intensity > 0.1, 0.1, intensity)
            gates = (z > 0.01) & (intensity > 0.001)

            scale_inner = np.power(qm.qt_smoothstep64(0.0, 1.0 * cp.inner, radius), 4.0)
            if cp.arm != 0:
                arm_val = _arm_value(radius, P, cp, gp, rotmat32)
                if cp.winding != 0:
                    new_wind = _get_winding(radius, gp.winding_b, gp.winding_n) * cp.winding
                else:
                    new_wind = np.zeros_like(radius)
            else:
                arm_val = np.ones_like(radius)
                new_wind = np.zeros_like(radius)
            wind = np.where(gates, new_wind, wind)

            val = cp.strength * scale_inner * arm_val * z * intensity * iscale
            with np.errstate(invalid="ignore"):
                emit = gates & (val * weight > 0.0005)
            e = np.flatnonzero(emit)
            if e.size == 0:
                continue

            ival = (val * weight)[e]
            pe = p[e]
            we = wind[e]

            if cs.cid == CID_DISK:
                p2 = np.abs(_perlin_cloud(pe, we, 10, cp.scale, cp.ks, orientation32))
                p2 = np.fmax(p2, 0.01)
                with np.errstate(invalid="ignore"):
                    p2 = np.power(p2, cp.noise_tilt)
                p2 = p2 + cp.noise_offset
                ok = p2 >= 0
                rhs = (ival * p2 * ray_step).astype(F32)
                add = cs.spec32 * rhs[:, None]
                I[e] = np.where(ok[:, None], (I[e] + add).astype(F32), I[e])
            elif cs.cid == CID_DUST:
                p2 = _perlin_cloud(pe, we, 9, cp.scale, cp.ks, orientation32)
                p2 = np.fmax(p2 - cp.noise_offset, 0.0)
                with np.errstate(invalid="ignore", divide="ignore"):
                    p2 = qm.qt_clamp64(np.power(5.0 * p2, cp.noise_tilt), -10.0, 10.0)
                att = np.exp(-p2[:, None] * ival[:, None] * cs.spec32.astype(F64) * 0.01)
                I[e] = (I[e] * att).astype(F32)
            elif cs.cid in (CID_DUST2, CID_DUST_POSITIVE):
                r = (_twirl(pe, we, orientation32) * F32(cp.scale)).astype(F32)
                p2 = onoise.ridged_mf(
                    r[:, 0].astype(F64), r[:, 1].astype(F64), r[:, 2].astype(F64),
                    cp.ks, 9, 2.5, cp.noise_offset, cp.noise_tilt,
                )
                p2 = np.fmax(p2, 0.0)
                if cs.cid == CID_DUST2:
                    att = np.exp(-p2[:, None] * ival[:, None] * cs.spec32.astype(F64) * 0.01)
                    I[e] = (I[e] * att).astype(F32)
                else:
                    rhs = (ival * p2 * ray_step).astype(F32)
                    I[e] = (I[e] + cs.spec32 * rhs[:, None]).astype(F32)
            elif cs.cid == CID_STARS:
                freq = (_F32_001 * cp.scale) * 100.0
                perlin = np.abs(onoise.octave_noise_3d(
                    10, cp.ks, freq,
                    pe[:, 0].astype(F64), pe[:, 1].astype(F64), pe[:, 2].astype(F64),
                ))
                add_n = 0.0
                if cp.noise_offset != 0:
                    add_n = cp.noise_offset * _perlin_cloud(pe, we, 4, 2.0, -2.0, orientation32)
                    add_n = add_n + 0.5 * cp.noise_offset * _perlin_cloud(
                        pe, we * 0.5, 4, 4.0, -2.0, orientation32
                    )
                with np.errstate(invalid="ignore"):
                    v = np.abs(np.power(perlin + 1.0 + add_n, cp.noise_tilt))
                rhs = (ival * v * ray_step).astype(F32)
                I[e] = (I[e] + cs.spec32 * rhs[:, None]).astype(F32)
            # CID_STARS_SMALL: rand()-based — deterministic mode omits it.

        # Advance and floor (rasterizer.cpp:467-470).
        p32[go] = (p - dir32[go] * step.astype(F32)[:, None]).astype(F32)
        I32[go] = np.fmax(I, F32(0.0))
        winding[go] = wind
        step_prev[go] = step

    return samples


def post_process(linear32: np.ndarray, exposure: float, gamma: float,
                 saturation: float) -> np.ndarray:
    """buffer2d.cpp:106-126 -> uint8 RGB (the PNG-saved shadow-buffer order)."""
    v = (linear32.astype(F32) * F32(1.0 / exposure)).astype(F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.power(v.astype(F64), gamma).astype(F32)
    csum = (v[..., 0] + v[..., 1]) + v[..., 2]  # f32 left-assoc sum
    center = csum.astype(F64) / 3.0
    tmp = (center[..., None] - v.astype(F64)).astype(F32)
    v = (center[..., None] - saturation * tmp.astype(F64)).astype(F32)
    c = qm.qt_clamp64((v * F32(10.0)).astype(F32).astype(F64), 0.0, 255.0)
    return c.astype(np.int32).astype(np.uint8)


def render_oracle(scene: Scene, return_linear: bool = False):
    """Render a scene with the spec-exact CPU path.

    Returns (uint8 image (S,S,3), OracleTimings) or, with return_linear, the
    pre-postprocessing float32 radiance buffer as a third element.
    """
    cfg = scene.config
    size = cfg.size
    t_start = time.perf_counter()

    inv_vp = qm.inv_view_projection(
        scene.camera.camera, scene.camera.target, scene.camera.up, scene.camera.fov
    )

    idx = np.arange(size * size, dtype=np.int64)
    i = (idx % size).astype(F64)
    j = ((idx - idx % size) // size).astype(F64)
    dirs32 = qm.coord2ray(i, j, float(size), inv_vp)
    I32, total_samples = _march_dirs(scene, dirs32)

    img_lin = I32.reshape(size, size, 3)
    out = post_process(img_lin, cfg.exposure, cfg.gamma, cfg.saturation)

    timings = OracleTimings(
        seconds=time.perf_counter() - t_start,
        samples=total_samples,
        pixels=size * size,
    )
    if return_linear:
        return out, timings, img_lin
    return out, timings


def render_oracle_rays(scene: Scene, dirs) -> np.ndarray:
    """The spec-exact CPU path's float32 linear radiance (N, 3) of explicit
    ray directions (N, 3) from the scene's camera, as the reference's
    HPXRasterizer hands renderPixel its directions (the port's ray-list
    march, K6, takes them the same way)."""
    return _march_dirs(scene, np.asarray(dirs, dtype=F32).reshape(-1, 3))[0]


def _march_dirs(scene: Scene, dirs32: np.ndarray):
    """(float32 (N, 3) radiance with the final scale, march samples) of the
    rays dirs32 through every instance, far to near."""
    cfg = scene.config
    cam32 = np.asarray(scene.camera.camera, dtype=F32)

    # Far->near sort relative to the camera (rasterizer.cpp:190-201).
    instances = sorted(
        scene.instances,
        key=lambda g: -float(qm.length32((np.asarray(g.position, F32) - cam32).astype(F32))),
    )

    n = dirs32.shape[0]
    I32 = np.zeros((n, 3), dtype=F32)
    winding = np.zeros(n, dtype=F64)
    total_samples = 0

    for gi in instances:
        comps = [_CompState(cp, None, scene.spectra) for cp in gi.galaxy.components]
        gp = gi.galaxy.params
        pos32 = np.asarray(gi.position, dtype=F32)
        o32 = (cam32 - pos32).astype(F32)

        # Ellipsoid intersection (util.h:66-98).
        ax32 = np.asarray(gp.axis, dtype=F32)
        # 1/(x*x) with the product in f64 (python-float semantics of the spec).
        inv32 = (1.0 / (ax32.astype(F64) * ax32.astype(F64))).astype(F32)
        rD = (dirs32 * inv32).astype(F32)
        rO = (o32 * inv32).astype(F32)
        A = qm.dot32(dirs32, rD).astype(F64)
        B = 2.0 * qm.dot32(dirs32, rO).astype(F64)
        C = float(qm.dot32(o32, rO)) - 1.0
        S = B * B - 4.0 * A * C
        hit = S > 0
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.where(hit, S, 0.0))
            t0 = (-B - sq) / (2.0 * A)
            t1 = (-B + sq) / (2.0 * A)
        isp1 = (o32 + dirs32 * t0.astype(F32)[:, None]).astype(F32)
        isp2 = (o32 + dirs32 * t1.astype(F32)[:, None]).astype(F32)
        # Behind-camera rules (rasterizer.cpp:396-403): ray dirs point backward
        # (reversed lookAt), so visible geometry has negative t.
        isp2 = np.where((t1 > 0)[:, None], o32, isp2)
        alive = hit & ~((t0 > 0) & (t1 > 0))

        total_samples += _march_instance(
            gi, comps, isp1, isp2, (cam32 - pos32).astype(F32), alive,
            I32, winding, float(cfg.ray_step), float(cfg.min_ray_step),
        )

    # Final scale (rasterizer.cpp:409).
    return (I32 * F32(0.01 / cfg.ray_step)).astype(F32), total_samples
