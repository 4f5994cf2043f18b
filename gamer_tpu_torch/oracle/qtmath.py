"""Qt-semantics math helpers for the conformance oracle.

The reference engine mixes precisions: ``QVector3D``/``QMatrix4x4``/
``QQuaternion`` store and operate in float32, while scalar C++ math is double.
These helpers reproduce the float32 vector behavior (including Qt's fuzzy
normalization checks) on numpy arrays of shape (..., 3).

Semantics sources (all in the reference source tree):
  - QVector3D dot/length/normalized: Qt float storage; length uses a
    double-precision sum internally (Qt convention), normalized() skips the
    divide when length is fuzzily 1 (|len-1| <= 1e-5).
  - QQuaternion::fromAxisAndAngle(QVector3D, float): degrees, float sin/cos of
    half-angle, fuzzy-skips axis normalization for unit axes.
  - QQuaternion::rotationTo(from, to): shortest-arc quaternion.
  - QMatrix4x4 perspective/lookAt: gamercamera.cpp:185-217.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
F64 = np.float64

FUZZ = 1e-5  # qFuzzyIsNull threshold for floats


def v3(x, y, z) -> np.ndarray:
    return np.array([x, y, z], dtype=F32)


def dot32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """QVector3D::dotProduct — float32 multiplies and left-associated adds."""
    a = a.astype(F32, copy=False)
    b = b.astype(F32, copy=False)
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def length32(v: np.ndarray) -> np.ndarray:
    """QVector3D::length — double-precision sum/sqrt, float32 result."""
    v64 = v.astype(F64)
    return np.sqrt(v64[..., 0] ** 2 + v64[..., 1] ** 2 + v64[..., 2] ** 2).astype(F32)


def normalized32(v: np.ndarray) -> np.ndarray:
    """QVector3D::normalized — returns v unchanged if length fuzzily 1 or 0."""
    v = v.astype(F32, copy=False)
    len32 = length32(v)
    is_unit = np.abs(len32 - F32(1.0)) <= F32(FUZZ)
    is_null = np.abs(len32) <= F32(FUZZ)
    safe = np.where(is_null | is_unit, F32(1.0), len32)
    out = v / safe[..., None]
    keep = (is_unit | is_null)[..., None]
    return np.where(keep, np.where(is_null[..., None], np.zeros_like(v), v), out).astype(F32)


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product, float32, components (w, x, y, z)."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        axis=-1,
    ).astype(F32)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """QQuaternion::rotatedVector = (q * (0,v) * q^-1).vector(), float32.

    q shape (..., 4) as (w, x, y, z); v shape (..., 3).
    """
    q = q.astype(F32, copy=False)
    v = v.astype(F32, copy=False)
    zeros = np.zeros(v.shape[:-1] + (1,), dtype=F32)
    vq = np.concatenate([zeros, v], axis=-1)
    conj = np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)
    out = quat_mul(quat_mul(np.broadcast_to(q, vq.shape), vq), np.broadcast_to(conj, vq.shape))
    return out[..., 1:]


def quat_from_axis_angle_deg(axis: np.ndarray, angle_deg: np.ndarray) -> np.ndarray:
    """QQuaternion::fromAxisAndAngle(QVector3D, float).

    float32 throughout: half-angle sin/cos in float32, axis normalization
    skipped when the length is fuzzily 1, final quaternion normalized (with
    Qt's fuzzy skip when already near unit).
    """
    axis = np.asarray(axis, dtype=F32)
    angle = np.asarray(angle_deg, dtype=F32)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    length = np.sqrt(x * x + y * y + z * z).astype(F32)
    needs_norm = (np.abs(length - F32(1.0)) > F32(FUZZ)) & (np.abs(length) > F32(FUZZ))
    inv = np.where(needs_norm, F32(1.0) / np.where(length == 0, F32(1.0), length), F32(1.0))
    x, y, z = x * inv, y * inv, z * inv
    a = np.deg2rad(angle / F32(2.0)).astype(F32)
    s = np.sin(a, dtype=F32)
    c = np.cos(a, dtype=F32)
    q = np.stack([c, np.broadcast_to(x, a.shape) * s, np.broadcast_to(y, a.shape) * s,
                  np.broadcast_to(z, a.shape) * s], axis=-1).astype(F32)
    # QQuaternion::normalized(): double-precision sumsq, fuzzy skip near unit.
    q64 = q.astype(F64)
    len_sq = (q64 ** 2).sum(axis=-1)
    skip = np.abs(len_sq - 1.0) <= FUZZ
    norm = np.sqrt(len_sq)
    out = (q64 / np.where(skip, 1.0, norm)[..., None]).astype(F32)
    return np.where(skip[..., None], q, out)


def quat_rotation_to(v_from: np.ndarray, v_to: np.ndarray) -> np.ndarray:
    """QQuaternion::rotationTo — shortest arc from one vector to another.

    Matches Qt's implementation: normalize both, d = dot+1; if d fuzzily 0
    pick any perpendicular axis (prefer cross with +X, else +Y) for a 180-degree
    turn, else q = (d', cross/d')/|..| with d' = sqrt(2 d). float32.
    """
    v0 = normalized32(np.asarray(v_from, dtype=F32))
    v1 = normalized32(np.asarray(v_to, dtype=F32))
    d = dot32(v0, v1) + F32(1.0)
    if np.ndim(d) == 0 and abs(float(d)) <= FUZZ:
        axis = np.cross(v3(1, 0, 0), v0).astype(F32)
        if float((axis.astype(F64) ** 2).sum()) <= FUZZ:
            axis = np.cross(v3(0, 1, 0), v0).astype(F32)
        axis = normalized32(axis)
        return np.array([0.0, axis[0], axis[1], axis[2]], dtype=F32)
    d = np.sqrt(F32(2.0) * d).astype(F32)
    axis = (np.cross(v0, v1).astype(F32) / d).astype(F32)
    q = np.array([d * F32(0.5), axis[0], axis[1], axis[2]], dtype=F32)
    q64 = q.astype(F64)
    return (q64 / np.sqrt((q64 ** 2).sum())).astype(F32)


def qt_clamp64(val: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Util::clamp (util.cpp:76-80): max(lo, min(hi, val)) with std::min/max
    NaN semantics — clamp(NaN) == hi."""
    r = np.where(val < hi, val, hi)   # std::min(hi, val)
    return np.where(lo < r, r, lo)    # std::max(lo, r)


def qt_smoothstep64(edge0: float, edge1, x: np.ndarray) -> np.ndarray:
    """Util::smoothstep (util.cpp:113-120); 0/0 -> NaN -> clamp -> 1."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t = qt_clamp64((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# ---------------------------------------------------------------------------
# Camera (gamercamera.cpp:185-217)
# ---------------------------------------------------------------------------


def perspective_matrix(fov_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """QMatrix4x4::perspective — row-major 4x4, computed f64, stored f32."""
    radians = np.deg2rad(fov_deg / 2.0)
    sine = np.sin(radians)
    cotan = np.cos(radians) / sine
    clip = far - near
    m = np.zeros((4, 4), dtype=F64)
    m[0, 0] = cotan / aspect
    m[1, 1] = cotan
    m[2, 2] = -(near + far) / clip
    m[2, 3] = -(2.0 * near * far) / clip
    m[3, 2] = -1.0
    return m.astype(F32)


def look_at_matrix(eye, center, up) -> np.ndarray:
    """QMatrix4x4::lookAt — row-major 4x4, f32 storage.

    NOTE: the engine calls this with eye/center REVERSED —
    lookAt(rot*target, rot*camera, rot*up) (gamercamera.cpp:200) — which flips
    the ray direction convention; see ops/camera.py for the consequences.
    """
    eye = np.asarray(eye, dtype=F64)
    center = np.asarray(center, dtype=F64)
    up = np.asarray(up, dtype=F64)
    forward = center - eye
    forward = forward / np.sqrt((forward ** 2).sum())
    side = np.cross(forward, up)
    side = side / np.sqrt((side ** 2).sum())
    upv = np.cross(side, forward)
    m = np.eye(4, dtype=F64)
    m[0, :3] = side
    m[1, :3] = upv
    m[2, :3] = -forward
    m[0, 3] = -side @ eye
    m[1, 3] = -upv @ eye
    m[2, 3] = forward @ eye
    return m.astype(F32)


def inv_view_projection(camera, target, up, fov_deg: float) -> np.ndarray:
    """(projection * view)^-1 with view = lookAt(target, camera, up).

    Inverse computed in double precision, stored f32 (Qt convention).
    """
    proj = perspective_matrix(fov_deg, 1.0, 1.0, 100.0).astype(F64)
    view = look_at_matrix(target, camera, up).astype(F64)
    return np.linalg.inv(proj @ view).astype(F32)


def coord2ray(i, j, width, inv_vp: np.ndarray) -> np.ndarray:
    """GamerCamera::coord2ray (gamercamera.cpp:210-217), vectorized.

    i, j: pixel coords (arrays); returns (..., 3) float32 ray "directions"
    (pointing backward — see look_at_matrix note).
    """
    i = np.asarray(i, dtype=F64)
    j = np.asarray(j, dtype=F64)
    xx = (i / (width * 0.5) - 1.0).astype(F32)
    yy = (j / (width * 0.5) - 1.0).astype(F32)
    one = np.ones_like(xx)
    screen = (xx, -yy, one, one)
    m = inv_vp.astype(F32)
    # Explicit left-associated f32 row sums (QMatrix4x4 * QVector4D order).
    world = np.stack(
        [
            ((m[r, 0] * screen[0] + m[r, 1] * screen[1]) + m[r, 2] * screen[2])
            + m[r, 3] * screen[3]
            for r in range(3)
        ],
        axis=-1,
    )
    return normalized32(world)
