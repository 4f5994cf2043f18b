"""The plain reference of the galaxy march: numpy, no kernel, no cache.

A frozen copy of the spec oracle's arithmetic (the reference renderer's
mixed precision: float32 Qt vectors, float64 C++ scalars and float64
simplex noise), taken from the scene description in a configuration file,
never from anything the program under test derived:

  march loop:        rasterizer.cpp:379-483 (renderPixel, getIntensity)
  gating pipeline:   galaxycomponent.cpp:45-88
  component kernels: galaxycomponents.cpp:5-170
  simplex noise:     simplexnoise.cpp:243-330, noise.cpp:81-180
  post chain:        buffer2d.cpp:106-126
  camera:            gamercamera.cpp:185-217

Against the oracle it was copied from, three things are new: each ray
carries its own camera (so the sampled pixels of many frames march in one
lockstep loop), ``stats`` counts the work the data needs in the units of
``work.WORK``, and ``lower=True`` is the precision control (the rays'
directions and the radiance accumulator held in bfloat16).

Nothing here imports the program, torch or jax.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32
F64 = np.float64
FUZZ = 1e-5  # qFuzzyIsNull threshold for floats

_F32_01 = float(np.float32(0.1))
_F32_001 = float(np.float32(0.01))

# Spectra::PopulateSpectra (spectrum.h:50-58)
SPECTRA = {
    "red": (1.0, 0.6, 0.4),
    "yellow": (1.0, 0.9, 0.45),
    "blue": (0.4, 0.6, 1.0),
    "white": (1.0, 1.0, 1.0),
    "cyan": (0.3, 0.7, 1.0),
    "purple": (1.0, 0.3, 0.8),
}
CLASSES = {"bulge": 0, "disk": 1, "dust": 2, "dust2": 3, "dust positive": 4,
           "stars": 5, "stars small": 6}
BULGE, DISK, DUST, DUST2, DUST_POSITIVE, STARS = range(6)
# the reference's component defaults (componentparams.h:7-59) and galaxy
# defaults (galaxyparams.h:10-43)
COMPONENT_DEFAULTS = dict(class_name="bulge", spectrum="White", strength=1.0,
                          arm=1.0, z0=0.02, r0=0.5, inner=0.0, active=1.0,
                          delta=0.0, winding=0.1, scale=1.0, noise_offset=0.0,
                          noise_tilt=1.0, ks=1.0)
GALAXY_DEFAULTS = dict(axis=(1.0, 1.0, 1.0), winding_b=0.5, winding_n=4.0,
                       no_arms=2.0, arm1=0.0, arm2=math.pi,
                       arm3=2.0 * math.pi, arm4=3.0 * math.pi)
# octaves of each fractal (galaxycomponents.cpp), and the ridged count
OCT10, OCT9, OCT4, RIDGED = 10, 9, 4, 9

PERM_HALF = (
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140,
    36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148, 247, 120, 234,
    75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32, 57, 177, 33, 88, 237,
    149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165, 71, 134, 139, 48,
    27, 166, 77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133, 230, 220, 105,
    92, 41, 55, 46, 245, 40, 244, 102, 143, 54, 65, 25, 63, 161, 1, 216, 80, 73,
    209, 76, 132, 187, 208, 89, 18, 169, 200, 196, 135, 130, 116, 188, 159, 86,
    164, 100, 109, 198, 173, 186, 3, 64, 52, 217, 226, 250, 124, 123, 5, 202, 38,
    147, 118, 126, 255, 82, 85, 212, 207, 206, 59, 227, 47, 16, 58, 17, 182, 189,
    28, 42, 223, 183, 170, 213, 119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101,
    155, 167, 43, 172, 9, 129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232,
    178, 185, 112, 104, 218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12,
    191, 179, 162, 241, 81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31,
    181, 199, 106, 157, 184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254,
    138, 236, 205, 93, 222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215,
    61, 156, 180,
)

_PERM = np.array(PERM_HALF * 2, dtype=np.int64)
_GRAD3 = np.array([(1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
                   (1, 0, 1), (-1, 0, 1), (1, 0, -1), (-1, 0, -1),
                   (0, 1, 1), (0, -1, 1), (0, 1, -1), (0, -1, -1)], F64)
_GX, _GY, _GZ = _GRAD3[:, 0], _GRAD3[:, 1], _GRAD3[:, 2]


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    as float32: the control's storage precision."""
    a = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    r = (a + np.uint32(0x7FFF) + ((a >> np.uint32(16)) & np.uint32(1)))
    return (r & np.uint32(0xFFFF0000)).view(F32)


# ---------------------------------------------------------------------------
# simplex noise, float64 (simplexnoise.cpp:243-330, noise.cpp)
# ---------------------------------------------------------------------------


def _fastfloor(x):
    """simplexnoise.h:130: trunc for x > 0, else trunc - 1."""
    t = np.trunc(x)
    return np.where(x > 0, t, t - 1.0).astype(np.int64)


def raw_noise_3d(x, y, z):
    x = np.asarray(x, dtype=F64)
    y = np.asarray(y, dtype=F64)
    z = np.asarray(z, dtype=F64)
    F3, G3 = 1.0 / 3.0, 1.0 / 6.0
    s = (x + y + z) * F3
    i, j, k = _fastfloor(x + s), _fastfloor(y + s), _fastfloor(z + s)
    t = (i + j + k).astype(F64) * G3
    x0, y0, z0 = x - (i - t), y - (j - t), z - (k - t)
    A, B, C = x0 >= y0, y0 >= z0, x0 >= z0
    i1 = (A & (B | C)).astype(np.int64)
    j1 = (~A & B).astype(np.int64)
    k1 = ((A & ~B & ~C) | (~A & ~B)).astype(np.int64)
    i2 = (A | (B & C)).astype(np.int64)
    j2 = (~A | B).astype(np.int64)
    k2 = ((A & ~B) | (~A & (~B | ~C))).astype(np.int64)
    x1, y1, z1 = x0 - i1 + G3, y0 - j1 + G3, z0 - k1 + G3
    x2, y2, z2 = x0 - i2 + 2.0 * G3, y0 - j2 + 2.0 * G3, z0 - k2 + 2.0 * G3
    x3, y3, z3 = x0 - 1.0 + 3.0 * G3, y0 - 1.0 + 3.0 * G3, z0 - 1.0 + 3.0 * G3
    ii, jj, kk = i & 255, j & 255, k & 255
    gi0 = _PERM[ii + _PERM[jj + _PERM[kk]]] % 12
    gi1 = _PERM[ii + i1 + _PERM[jj + j1 + _PERM[kk + k1]]] % 12
    gi2 = _PERM[ii + i2 + _PERM[jj + j2 + _PERM[kk + k2]]] % 12
    gi3 = _PERM[ii + 1 + _PERM[jj + 1 + _PERM[kk + 1]]] % 12

    def contrib(tv, gi, cx, cy, cz):
        gd = _GX[gi] * cx + _GY[gi] * cy + _GZ[gi] * cz
        tt = tv * tv
        return np.where(tv < 0, 0.0, tt * tt * gd)

    n0 = contrib(0.6 - x0 * x0 - y0 * y0 - z0 * z0, gi0, x0, y0, z0)
    n1 = contrib(0.6 - x1 * x1 - y1 * y1 - z1 * z1, gi1, x1, y1, z1)
    n2 = contrib(0.6 - x2 * x2 - y2 * y2 - z2 * z2, gi2, x2, y2, z2)
    n3 = contrib(0.6 - x3 * x3 - y3 * y3 - z3 * z3, gi3, x3, y3, z3)
    return 32.0 * (n0 + n1 + n2 + n3)


def octave_noise_3d(octaves, persistence, scale, x, y, z):
    """noise.cpp:162-180."""
    total, frequency, amplitude, max_amp = 0.0, float(scale), 1.0, 0.0
    for _ in range(int(octaves)):
        total = total + raw_noise_3d(x * frequency, y * frequency,
                                     z * frequency) * amplitude
        frequency *= 2.0
        max_amp += amplitude
        amplitude *= persistence
    return total / max_amp


def ridged_mf(px, py, pz, frequency, octaves, lacunarity, offset, gain):
    """noise.cpp:81-128; the point is a QVector3D, so each octave's
    ``vt *= lacunarity`` rounds it to float32."""
    vx, vy, vz = (np.asarray(v, dtype=F32) for v in (px, py, pz))
    value = np.zeros(np.broadcast(vx, vy, vz).shape, dtype=F64)
    weight = np.ones_like(value)
    lac32 = F32(lacunarity)
    freq = float(frequency)
    for _ in range(int(octaves)):
        signal = raw_noise_3d(vx.astype(F64), vy.astype(F64), vz.astype(F64))
        signal = offset - np.abs(signal)
        signal = signal * signal * weight
        weight = np.clip(signal * gain, 0.0, 1.0)
        value = value + signal * math.pow(freq, -0.05)
        vx, vy, vz = vx * lac32, vy * lac32, vz * lac32
        freq *= lacunarity
    return value * 1.25 - 1.0


# ---------------------------------------------------------------------------
# Qt's float32 vectors and quaternions
# ---------------------------------------------------------------------------


def dot32(a, b):
    a = a.astype(F32, copy=False)
    b = b.astype(F32, copy=False)
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def length32(v):
    v64 = v.astype(F64)
    return np.sqrt(v64[..., 0] ** 2 + v64[..., 1] ** 2
                   + v64[..., 2] ** 2).astype(F32)


def normalized32(v):
    v = v.astype(F32, copy=False)
    len32 = length32(v)
    is_unit = np.abs(len32 - F32(1.0)) <= F32(FUZZ)
    is_null = np.abs(len32) <= F32(FUZZ)
    safe = np.where(is_null | is_unit, F32(1.0), len32)
    out = v / safe[..., None]
    keep = (is_unit | is_null)[..., None]
    return np.where(keep, np.where(is_null[..., None], np.zeros_like(v), v),
                    out).astype(F32)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
                     w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2], axis=-1).astype(F32)


def quat_rotate(q, v):
    q = q.astype(F32, copy=False)
    v = v.astype(F32, copy=False)
    vq = np.concatenate([np.zeros(v.shape[:-1] + (1,), dtype=F32), v], axis=-1)
    conj = np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)
    out = quat_mul(quat_mul(np.broadcast_to(q, vq.shape), vq),
                   np.broadcast_to(conj, vq.shape))
    return out[..., 1:]


def quat_from_axis_angle_deg(axis, angle_deg):
    axis = np.asarray(axis, dtype=F32)
    angle = np.asarray(angle_deg, dtype=F32)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    length = np.sqrt(x * x + y * y + z * z).astype(F32)
    needs_norm = ((np.abs(length - F32(1.0)) > F32(FUZZ))
                  & (np.abs(length) > F32(FUZZ)))
    inv = np.where(needs_norm,
                   F32(1.0) / np.where(length == 0, F32(1.0), length), F32(1.0))
    x, y, z = x * inv, y * inv, z * inv
    a = np.deg2rad(angle / F32(2.0)).astype(F32)
    s = np.sin(a, dtype=F32)
    c = np.cos(a, dtype=F32)
    q = np.stack([c, np.broadcast_to(x, a.shape) * s,
                  np.broadcast_to(y, a.shape) * s,
                  np.broadcast_to(z, a.shape) * s], axis=-1).astype(F32)
    q64 = q.astype(F64)
    len_sq = (q64 ** 2).sum(axis=-1)
    skip = np.abs(len_sq - 1.0) <= FUZZ
    out = (q64 / np.where(skip, 1.0, np.sqrt(len_sq))[..., None]).astype(F32)
    return np.where(skip[..., None], q, out)


def quat_rotation_to(v_from, v_to):
    v0 = normalized32(np.asarray(v_from, dtype=F32))
    v1 = normalized32(np.asarray(v_to, dtype=F32))
    d = dot32(v0, v1) + F32(1.0)
    if abs(float(d)) <= FUZZ:
        axis = np.cross(np.array([1, 0, 0], F32), v0).astype(F32)
        if float((axis.astype(F64) ** 2).sum()) <= FUZZ:
            axis = np.cross(np.array([0, 1, 0], F32), v0).astype(F32)
        axis = normalized32(axis)
        return np.array([0.0, axis[0], axis[1], axis[2]], dtype=F32)
    d = np.sqrt(F32(2.0) * d).astype(F32)
    axis = (np.cross(v0, v1).astype(F32) / d).astype(F32)
    q = np.array([d * F32(0.5), axis[0], axis[1], axis[2]], dtype=F32)
    q64 = q.astype(F64)
    return (q64 / np.sqrt((q64 ** 2).sum())).astype(F32)


def qt_clamp64(val, lo, hi):
    """Util::clamp: max(lo, min(hi, val)); clamp(NaN) == hi."""
    r = np.where(val < hi, val, hi)
    return np.where(lo < r, r, lo)


def qt_smoothstep64(edge0, edge1, x):
    with np.errstate(divide="ignore", invalid="ignore"):
        t = qt_clamp64((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# ---------------------------------------------------------------------------
# camera (gamercamera.cpp:185-217)
# ---------------------------------------------------------------------------


def inv_view_projection(camera, target, up, fov_deg):
    """(projection * view)^-1 with view = lookAt(target, camera, up): the
    reference calls lookAt with eye and centre reversed."""
    radians = np.deg2rad(fov_deg / 2.0)
    cotan = np.cos(radians) / np.sin(radians)
    near, far = 1.0, 100.0
    proj = np.zeros((4, 4), dtype=F64)
    proj[0, 0] = proj[1, 1] = cotan
    proj[2, 2] = -(near + far) / (far - near)
    proj[2, 3] = -(2.0 * near * far) / (far - near)
    proj[3, 2] = -1.0
    eye = np.asarray(target, dtype=F64)
    center = np.asarray(camera, dtype=F64)
    forward = center - eye
    forward = forward / np.sqrt((forward ** 2).sum())
    side = np.cross(forward, np.asarray(up, dtype=F64))
    side = side / np.sqrt((side ** 2).sum())
    upv = np.cross(side, forward)
    view = np.eye(4, dtype=F64)
    view[0, :3], view[1, :3], view[2, :3] = side, upv, -forward
    view[0, 3], view[1, 3], view[2, 3] = -side @ eye, -upv @ eye, forward @ eye
    proj = proj.astype(F32).astype(F64)
    view = view.astype(F32).astype(F64)
    return np.linalg.inv(proj @ view).astype(F32)


def pixel_rays(pixels, size, inv_vp):
    """GamerCamera::coord2ray of flat pixel indices (row-major, row j and
    column i) of a size x size frame: (N, 3) float32 directions."""
    pixels = np.asarray(pixels, dtype=np.int64)
    i = (pixels % size).astype(F64)
    j = (pixels // size).astype(F64)
    xx = (i / (size * 0.5) - 1.0).astype(F32)
    yy = (j / (size * 0.5) - 1.0).astype(F32)
    one = np.ones_like(xx)
    screen = (xx, -yy, one, one)
    m = inv_vp.astype(F32)
    world = np.stack([((m[r, 0] * screen[0] + m[r, 1] * screen[1])
                       + m[r, 2] * screen[2]) + m[r, 3] * screen[3]
                      for r in range(3)], axis=-1)
    return normalized32(world)


# ---------------------------------------------------------------------------
# the scene, from the configuration's plain description
# ---------------------------------------------------------------------------


class Component:
    def __init__(self, d: dict):
        p = dict(COMPONENT_DEFAULTS, **d)
        for k in COMPONENT_DEFAULTS:
            setattr(self, k, p[k] if k in ("class_name", "spectrum")
                    else float(p[k]))
        self.cid = CLASSES.get(self.class_name.lower(), -1)
        self.spec32 = np.array(SPECTRA.get(self.spectrum.lower(),
                                           (1.0, 1.0, 1.0)), dtype=F32)

    def n_raw(self) -> int:
        """Raw noise evaluations of one emitting sample."""
        return {DUST: OCT9, DUST2: RIDGED, DUST_POSITIVE: RIDGED,
                DISK: OCT10,
                STARS: OCT10 + (2 * OCT4 if self.noise_offset != 0 else 0),
                }.get(self.cid, 0)


class Instance:
    def __init__(self, d: dict):
        g = dict(GALAXY_DEFAULTS, **d["galaxy"].get("params", {}))
        self.axis = tuple(float(v) for v in g["axis"])
        self.winding_b, self.winding_n = float(g["winding_b"]), float(g["winding_n"])
        self.no_arms = float(g["no_arms"])
        self.arms = [float(g[f"arm{k}"]) for k in (1, 2, 3, 4)]
        self.components = [Component(c) for c in d["galaxy"]["components"]]
        self.position = tuple(float(v) for v in d.get("position", (0, 0, 0)))
        self.orientation = tuple(float(v) for v in d.get("orientation", (0, 1, 0)))
        self.intensity_scale = float(d.get("intensity_scale", 1.0))

    def max_arms(self) -> int:
        """galaxycomponent.h:120-137: exactly 1, 2 or 3 arms only when
        no_arms equals it; otherwise all four."""
        return {1.0: 1, 2.0: 2, 3.0: 3}.get(self.no_arms, 4)


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _get_winding(rad, winding_b, winding_n):
    r = rad + 0.05
    return np.arctan(np.exp(-0.25 / (0.5 * r)) / winding_b) * 2.0 * winding_n


def _find_difference(t1, t2):
    d = t1 - t2
    v = np.abs(d)
    for k in (-2 * np.pi, 2 * np.pi, -4 * np.pi, 4 * np.pi):
        v = np.fmin(v, np.abs(d + k))
    return v


def _twirl(p32, t, orientation32):
    q = quat_from_axis_angle_deg(orientation32, (t * 180.0).astype(F32))
    return quat_rotate(q, p32)


def _perlin_cloud(p32, t, octaves, ks, pers, orientation32):
    r = _twirl(p32, t, orientation32)
    return octave_noise_3d(octaves, pers, ks * _F32_01, r[..., 0].astype(F64),
                           r[..., 1].astype(F64), r[..., 2].astype(F64))


def _arm_value(radius, P32, cp, inst, rotmat32):
    rot = quat_rotate(rotmat32, P32)
    theta = np.arctan2(rot[..., 0].astype(F64), rot[..., 2].astype(F64)) + cp.delta
    ww = _get_winding(radius, inst.winding_b, inst.winding_n)
    val = None
    with np.errstate(invalid="ignore"):
        for a in range(inst.max_arms()):
            v = np.abs(_find_difference(ww, -theta + inst.arms[a])) / np.pi
            arm_v = np.power(1.0 - v, cp.arm * 15.0)
            val = arm_v if val is None else np.where(arm_v > val, arm_v, val)
    return val


def _march_instance(inst, origin32, isp2_32, cam_rel32, alive, I32, winding,
                    ray_step, min_ray_step, lower, stats):
    """March every live ray through one instance in lockstep (rays leave
    the working set as they finish). cam_rel32: (N, 3), each ray's camera
    relative to the instance. I32 and winding are updated in place."""
    orientation32 = np.asarray(inst.orientation, dtype=F32)
    rotmat32 = quat_rotation_to(np.array([0, 1, 0], F32), orientation32)
    axis_x = float(np.float32(inst.axis[0]))
    iscale = inst.intensity_scale
    scale32 = F32(ray_step)
    diff32 = (origin32 - isp2_32).astype(F32)
    length64 = length32(diff32).astype(F64)
    dir32 = normalized32(diff32)
    ll32 = normalized32((isp2_32 - origin32).astype(F32))
    p32 = origin32.copy()
    step_prev = np.full(origin32.shape[0], ray_step, dtype=F64)
    done = ~alive
    comps = [c for c in inst.components if c.active == 1 and c.cid >= 0]
    while True:
        idx = np.flatnonzero(~done)
        if idx.size == 0:
            return
        # the loop condition, before the body (rasterizer.cpp:447)
        d_along = dot32(p32[idx] - origin32[idx], ll32[idx]).astype(F64)
        stop = d_along >= length64[idx] + step_prev[idx]
        done[idx[stop]] = True
        go = idx[~stop]
        if go.size == 0:
            continue
        _count(stats, "samples", go.size)
        p = p32[go]
        dist = length32(p - cam_rel32[go]).astype(F64)
        step = qt_clamp64(dist * ray_step, min_ray_step, 0.01)
        weight = step * 200.0
        I = I32[go]
        wind = winding[go]
        for cp in comps:
            if cp.cid == BULGE:
                _count(stats, "bulge", go.size)
                pos = quat_rotate(rotmat32, p)
                rad = (length32(pos).astype(F64) + 0.01) * cp.r0 + 0.01
                i_val = (cp.strength * weight) * (
                    np.power(rad, -0.855) * np.exp(-np.power(rad, 0.25)) - 0.05
                ) * iscale
                i_val = np.where(i_val < 0, 0.0, i_val)
                I = I + cp.spec32 * (i_val * float(scale32)).astype(F32)[:, None]
                continue
            dott = dot32(p, orientation32)
            P = (p - orientation32 * dott[:, None]).astype(F32)
            radius = length32(P).astype(F64) / axis_x
            h = np.abs(dott.astype(F64) / cp.z0)
            sech = 1.0 / ((np.exp(h) + np.exp(-h)) / 2.0)
            z = np.where(h > 2.0, 0.0, sech * sech)
            ri = np.exp(-radius / (cp.r0 * 0.5))
            intensity = qt_clamp64(ri - 0.01, 0.0, 1.0)
            intensity = np.where(intensity > 0.1, 0.1, intensity)
            gates = (z > 0.01) & (intensity > 0.001)
            if stats is not None:
                r_thr = (float(F32(cp.r0) * F32(2.2552)) if cp.r0 > 0
                         else float(F32(3.4e38)))
                n_gated = int(gates.sum())
                _count(stats, "triggers", go.size)
                _count(stats, "triggered", ((h <= 2.0) & (radius < r_thr)).sum())
                _count(stats, "gated", n_gated)
                _count(stats, "arm_gated", n_gated if cp.arm != 0 else 0)
            scale_inner = np.power(qt_smoothstep64(0.0, 1.0 * cp.inner, radius), 4.0)
            if cp.arm != 0:
                arm_val = _arm_value(radius, P, cp, inst, rotmat32)
                new_wind = (_get_winding(radius, inst.winding_b, inst.winding_n)
                            * cp.winding if cp.winding != 0
                            else np.zeros_like(radius))
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
            _count(stats, "emitting", e.size)
            _count(stats, "raw_noise", e.size * cp.n_raw())
            ival = (val * weight)[e]
            pe = p[e]
            we = wind[e]
            if cp.cid == DISK:
                p2 = np.abs(_perlin_cloud(pe, we, OCT10, cp.scale, cp.ks,
                                          orientation32))
                p2 = np.fmax(p2, 0.01)
                with np.errstate(invalid="ignore"):
                    p2 = np.power(p2, cp.noise_tilt)
                p2 = p2 + cp.noise_offset
                ok = p2 >= 0
                rhs = (ival * p2 * ray_step).astype(F32)
                add = cp.spec32 * rhs[:, None]
                I[e] = np.where(ok[:, None], (I[e] + add).astype(F32), I[e])
            elif cp.cid == DUST:
                p2 = _perlin_cloud(pe, we, OCT9, cp.scale, cp.ks, orientation32)
                p2 = np.fmax(p2 - cp.noise_offset, 0.0)
                with np.errstate(invalid="ignore", divide="ignore"):
                    p2 = qt_clamp64(np.power(5.0 * p2, cp.noise_tilt), -10.0, 10.0)
                att = np.exp(-p2[:, None] * ival[:, None]
                             * cp.spec32.astype(F64) * 0.01)
                I[e] = (I[e] * att).astype(F32)
            elif cp.cid in (DUST2, DUST_POSITIVE):
                r = (_twirl(pe, we, orientation32) * F32(cp.scale)).astype(F32)
                p2 = ridged_mf(r[:, 0].astype(F64), r[:, 1].astype(F64),
                               r[:, 2].astype(F64), cp.ks, RIDGED, 2.5,
                               cp.noise_offset, cp.noise_tilt)
                p2 = np.fmax(p2, 0.0)
                if cp.cid == DUST2:
                    att = np.exp(-p2[:, None] * ival[:, None]
                                 * cp.spec32.astype(F64) * 0.01)
                    I[e] = (I[e] * att).astype(F32)
                else:
                    rhs = (ival * p2 * ray_step).astype(F32)
                    I[e] = (I[e] + cp.spec32 * rhs[:, None]).astype(F32)
            elif cp.cid == STARS:
                freq = (_F32_001 * cp.scale) * 100.0
                perlin = np.abs(octave_noise_3d(
                    OCT10, cp.ks, freq, pe[:, 0].astype(F64),
                    pe[:, 1].astype(F64), pe[:, 2].astype(F64)))
                add_n = 0.0
                if cp.noise_offset != 0:
                    add_n = cp.noise_offset * _perlin_cloud(
                        pe, we, OCT4, 2.0, -2.0, orientation32)
                    add_n = add_n + 0.5 * cp.noise_offset * _perlin_cloud(
                        pe, we * 0.5, OCT4, 4.0, -2.0, orientation32)
                with np.errstate(invalid="ignore"):
                    v = np.abs(np.power(perlin + 1.0 + add_n, cp.noise_tilt))
                rhs = (ival * v * ray_step).astype(F32)
                I[e] = (I[e] + cp.spec32 * rhs[:, None]).astype(F32)
            # 'stars small' draws from rand() in the reference: left out,
            # as the deterministic renderer leaves it out
        # advance and floor (rasterizer.cpp:467-470)
        p32[go] = (p - dir32[go] * step.astype(F32)[:, None]).astype(F32)
        I = np.fmax(I, F32(0.0))
        I32[go] = bf16(I) if lower else I
        winding[go] = wind
        step_prev[go] = step


def march_rays(scene: dict, cams, dirs, lower: bool = False, stats=None):
    """(N, 3) float32 linear radiance (with the final 0.01 / ray_step
    scale) of rays with directions ``dirs`` (N, 3) from cameras ``cams``
    (N, 3) through the scene's instances, far to near. ``lower``: the
    precision control. ``stats`` (a dict) receives the work counts."""
    cfg = scene["config"]
    ray_step = float(cfg["ray_step"])
    min_ray_step = 0.01 if cfg.get("is_preview", False) else 0.001
    cams32 = np.asarray(cams, dtype=F32).reshape(-1, 3)
    dirs32 = np.asarray(dirs, dtype=F32).reshape(-1, 3)
    if lower:
        dirs32 = bf16(dirs32)
    instances = [Instance(d) for d in scene["instances"]]
    # far -> near from the camera (rasterizer.cpp:190-201); the rays of one
    # call must agree on the order
    dist = np.stack([length32((np.asarray(g.position, F32) - cams32).astype(F32))
                     for g in instances], axis=-1)
    order = np.argsort(-dist, axis=-1, kind="stable")
    if (order != order[:1]).any():
        raise ValueError("the rays' cameras see the instances in different "
                         "orders; march them in separate calls")
    n = dirs32.shape[0]
    I32 = np.zeros((n, 3), dtype=F32)
    winding = np.zeros(n, dtype=F64)
    for k in order[0]:
        gi = instances[k]
        pos32 = np.asarray(gi.position, dtype=F32)
        o32 = (cams32 - pos32).astype(F32)
        # the ellipsoid (util.h:66-98); 1/(x*x) with the product in double
        ax32 = np.asarray(gi.axis, dtype=F32)
        inv32 = (1.0 / (ax32.astype(F64) * ax32.astype(F64))).astype(F32)
        rD = (dirs32 * inv32).astype(F32)
        rO = (o32 * inv32).astype(F32)
        A = dot32(dirs32, rD).astype(F64)
        B = 2.0 * dot32(dirs32, rO).astype(F64)
        C = dot32(o32, rO).astype(F64) - 1.0
        S = B * B - 4.0 * A * C
        hit = S > 0
        with np.errstate(invalid="ignore", divide="ignore"):
            sq = np.sqrt(np.where(hit, S, 0.0))
            t0 = (-B - sq) / (2.0 * A)
            t1 = (-B + sq) / (2.0 * A)
        isp1 = (o32 + dirs32 * t0.astype(F32)[:, None]).astype(F32)
        isp2 = (o32 + dirs32 * t1.astype(F32)[:, None]).astype(F32)
        # behind-camera rules (rasterizer.cpp:396-403)
        isp2 = np.where((t1 > 0)[:, None], o32, isp2)
        alive = hit & ~((t0 > 0) & (t1 > 0))
        _march_instance(gi, isp1, isp2, o32, alive, I32, winding, ray_step,
                        min_ray_step, lower, stats)
    out = (I32 * F32(0.01 / ray_step)).astype(F32)
    return bf16(out) if lower else out


def post_process(linear32, exposure, gamma, saturation):
    """buffer2d.cpp:106-126 -> uint8 RGB."""
    v = (linear32.astype(F32) * F32(1.0 / exposure)).astype(F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.power(v.astype(F64), gamma).astype(F32)
    csum = (v[..., 0] + v[..., 1]) + v[..., 2]
    center = csum.astype(F64) / 3.0
    tmp = (center[..., None] - v.astype(F64)).astype(F32)
    v = (center[..., None] - saturation * tmp.astype(F64)).astype(F32)
    c = qt_clamp64((v * F32(10.0)).astype(F32).astype(F64), 0.0, 255.0)
    return c.astype(np.int32).astype(np.uint8)


def render_pixels(scene: dict, views, lower: bool = False, stats=None):
    """uint8 (N, 3) of sampled pixels. ``views``: a list of (camera dict,
    size, flat pixel indices) as the frames were asked for; the rays of
    all views march together."""
    cams, dirs = [], []
    for cam, size, pixels in views:
        inv_vp = inv_view_projection(cam["camera"], cam["target"], cam["up"],
                                     float(cam["fov"]))
        d = pixel_rays(pixels, int(size), inv_vp)
        dirs.append(d)
        cams.append(np.broadcast_to(np.asarray(cam["camera"], F32), d.shape))
    lin = march_rays(scene, np.concatenate(cams), np.concatenate(dirs),
                     lower, stats)
    cfg = scene["config"]
    return post_process(lin, float(cfg.get("exposure", 1.0)),
                        float(cfg.get("gamma", 1.0)),
                        float(cfg.get("saturation", 1.0)))
