"""Scene flattening: dataclass scene -> (static structure, host params).

The numpy-only counterpart of ``gamer_tpu.engine.scene_prep``: the same
dataclasses and the same flattening rules (instances sorted far->near
relative to the camera, rasterizer.cpp:190-201; inactive and unknown-class
components dropped; 'stars small' dropped in deterministic mode,
galaxy_repro.py:734-737). Params are float32 numpy arrays — they only feed
the host-side scalar page (engine/cuda_render.py), which is the one
host->device transfer of a frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..scene.schema import CID_STARS, CID_STARS_SMALL, Scene
from ..scene.spectra import find_spectrum

F32 = np.float32
FUZZ = 1e-5  # qFuzzyIsNull's threshold for floats


# host float32 vector math with Qt's semantics (QVector3D / QQuaternion
# store float32; lengths sum in double; normalisation is skipped when the
# length is fuzzily 1 or 0)


def _length32(v: np.ndarray) -> np.float32:
    v64 = v.astype(np.float64)
    return F32(np.sqrt(v64[0] ** 2 + v64[1] ** 2 + v64[2] ** 2))


def _normalized32(v: np.ndarray) -> np.ndarray:
    """QVector3D::normalized."""
    v = v.astype(F32)
    n = _length32(v)
    if abs(n) <= F32(FUZZ):
        return np.zeros(3, F32)
    if abs(n - F32(1.0)) <= F32(FUZZ):
        return v
    return (v / n).astype(F32)


def _quat_rotation_to(v_from: np.ndarray, v_to: np.ndarray) -> np.ndarray:
    """QQuaternion::rotationTo: the shortest-arc quaternion (w, x, y, z)."""
    v0 = _normalized32(np.asarray(v_from, F32))
    v1 = _normalized32(np.asarray(v_to, F32))
    d = (v0[0] * v1[0] + v0[1] * v1[1]) + v0[2] * v1[2] + F32(1.0)
    if abs(float(d)) <= FUZZ:
        # opposite vectors: a half turn about any axis perpendicular to v0
        axis = np.cross(np.array([1, 0, 0], F32), v0).astype(F32)
        if float((axis.astype(np.float64) ** 2).sum()) <= FUZZ:
            axis = np.cross(np.array([0, 1, 0], F32), v0).astype(F32)
        axis = _normalized32(axis)
        return np.array([0.0, axis[0], axis[1], axis[2]], F32)
    d = F32(np.sqrt(F32(2.0) * d))
    axis = (np.cross(v0, v1).astype(F32) / d).astype(F32)
    q64 = np.array([d * F32(0.5), axis[0], axis[1], axis[2]], F32).astype(np.float64)
    return (q64 / np.sqrt((q64 ** 2).sum())).astype(F32)


@dataclass(frozen=True)
class CompStatic:
    """Per-component structure."""

    cid: int
    arm_enabled: bool        # comp.arm != 0 (galaxycomponent.cpp:66-72)
    winding_enabled: bool    # comp.winding != 0
    star_extra: bool         # stars: noise_offset != 0 adds 2 cloud octaves
    octave_cap: int = 0      # noise LOD (RenderConfig.noise_octaves); 0 = exact
    noise_kind: str = "simplex"  # raw-noise backend (RenderConfig.noise_kind)

    def oct(self, n: int) -> int:
        """Reference octave count ``n`` under the LOD cap."""
        return min(n, self.octave_cap) if self.octave_cap else n


@dataclass(frozen=True)
class InstanceStatic:
    comps: Tuple[CompStatic, ...]
    max_arms: int  # equality-ladder count (galaxycomponent.h:120-137)


@dataclass(frozen=True)
class SceneStatic:
    instances: Tuple[InstanceStatic, ...]
    dither: bool = False  # per-ray march-start dithering (RenderConfig.dither)


COMP_FIELDS = (
    "strength", "arm", "z0", "r0", "inner", "delta", "winding",
    "scale", "noise_offset", "noise_tilt", "ks",
)


def _arm_ladder_count(no_arms: float) -> int:
    if no_arms == 1:
        return 1
    if no_arms == 2:
        return 2
    if no_arms == 3:
        return 3
    return 4


def flatten_scene(scene: Scene, dtype=np.float32):
    """Build (SceneStatic, params) for the renderer; params is a tuple of
    per-instance dicts of numpy arrays (component fields under "comps")."""
    cam32 = np.asarray(scene.camera.camera, dtype=np.float32)
    instances = sorted(
        scene.instances,
        key=lambda g: -float(
            _length32((np.asarray(g.position, np.float32) - cam32).astype(np.float32))
        ),
    )

    inst_statics = []
    inst_params = []
    for gi in instances:
        gp = gi.galaxy.params
        comp_statics = []
        comp_params = []
        for cp in gi.galaxy.components:
            if cp.active != 1 or cp.cid < 0:
                continue
            if cp.cid == CID_STARS_SMALL and scene.config.deterministic:
                continue
            comp_statics.append(
                CompStatic(
                    cid=cp.cid,
                    arm_enabled=cp.arm != 0,
                    winding_enabled=cp.winding != 0,
                    star_extra=(cp.cid == CID_STARS and cp.noise_offset != 0),
                    octave_cap=int(scene.config.noise_octaves or 0),
                    noise_kind=scene.config.noise_kind,
                )
            )
            fields: Dict[str, np.ndarray] = {
                f: np.asarray(getattr(cp, f), dtype) for f in COMP_FIELDS
            }
            fields["spec"] = np.asarray(
                find_spectrum(cp.spectrum, scene.spectra), dtype
            )
            comp_params.append(fields)

        orientation32 = np.asarray(gi.orientation, np.float32)
        rotmat32 = _quat_rotation_to(np.array([0, 1, 0], F32), orientation32)
        # QQuaternion::fromAxisAndAngle normalizes a non-unit axis; every
        # other use of the orientation is raw (galaxycomponent.h:72-76,86-90).
        twirl_axis32 = _normalized32(orientation32)

        inst_statics.append(
            InstanceStatic(
                comps=tuple(comp_statics),
                max_arms=_arm_ladder_count(gp.no_arms),
            )
        )
        inst_params.append(
            {
                "comps": tuple(comp_params),
                "axis": np.asarray(gp.axis, dtype),
                "winding_b": np.asarray(gp.winding_b, dtype),
                "winding_n": np.asarray(gp.winding_n, dtype),
                "no_arms": np.asarray(gp.no_arms, dtype),
                "arms": np.asarray([gp.arm1, gp.arm2, gp.arm3, gp.arm4], dtype),
                "position": np.asarray(gi.position, dtype),
                "orientation": np.asarray(orientation32, dtype),
                "twirl_axis": np.asarray(twirl_axis32, dtype),
                "rotmat": np.asarray(rotmat32, dtype),
                "intensity_scale": np.asarray(gi.intensity_scale, dtype),
            }
        )

    return (
        SceneStatic(instances=tuple(inst_statics),
                    dither=bool(scene.config.dither)),
        tuple(inst_params),
    )


def from_jax_flat(static, params):
    """Carry a ``gamer_tpu.engine.scene_prep.flatten_scene`` result across:
    the JAX package's static structure becomes this package's dataclasses
    (field by field) and every param becomes a float32 numpy copy, so both
    engines can be fed identical parameters."""
    st = SceneStatic(
        instances=tuple(
            InstanceStatic(
                comps=tuple(
                    CompStatic(cid=int(c.cid), arm_enabled=bool(c.arm_enabled),
                               winding_enabled=bool(c.winding_enabled),
                               star_extra=bool(c.star_extra),
                               octave_cap=int(c.octave_cap),
                               noise_kind=str(c.noise_kind))
                    for c in inst.comps),
                max_arms=int(inst.max_arms))
            for inst in static.instances),
        dither=bool(static.dither),
    )

    def host(v):
        return np.array(v, np.float32)

    pr = tuple(
        {k: (tuple({f: host(x) for f, x in cp.items()} for cp in v)
             if k == "comps" else host(v))
         for k, v in inst.items()}
        for inst in params)
    return st, pr


def from_jax_pages(rows, n: int) -> np.ndarray:
    """Carry JAX scalar pages across: ``gamer_tpu``'s ``_pack_scalars`` rows
    ((B, smem_rows, 128) float32, as ``engine.batch._scene_groups`` stacks
    them) become this package's (B, n) pages: the first entries of each
    (the layout contract of ``cuda_render._build_layout``), then the steps'
    low words, 0 (a JAX page holds its steps in float32 alone)."""
    from .cuda_render import STEP_LO

    a = np.asarray(rows, np.float32)
    out = np.array(a.reshape(a.shape[0], -1)[:, :n])
    out[:, n - len(STEP_LO):] = 0.0
    return out
