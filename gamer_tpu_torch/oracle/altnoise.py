"""Scalar-exact float64 transcriptions of the reference's alternative
noise backends, for conformance-gating `ops/altnoise`.

  - iq_noise: IQ sin-hash trilinear value noise — an exact transcription of
    IQnoise::noise / iqhashStatic (source/noise/iqnoise.cpp:21-53). The
    only non-arithmetic dependency is libm sin; numpy's sin and std::sin
    may differ in the last ulp, which after the x753.5453123 fract-hash
    amplification bounds the transcription error at ~1e-13 absolute — the
    gate tolerance in tests/test_altnoise_oracle.py documents this.

  - perlin_noise3 / perlin_raw_3d: Ken Perlin's classic 3-D gradient noise
    lattice — an exact transcription of Perlin::noise3 (source/noise/
    perlin.cpp:99-150) plus the x2 output scaling of Perlin::raw_3d
    (perlin.h:32-37). The tables (p, g3) are ARGUMENTS: the reference
    seeds its tables from libc srand/rand (perlin.cpp Perlin::init), a
    stream that is not part of any observable contract (the class is never
    instantiated by the engine, rasterizer.h:57-67), so the gate passes
    ops/altnoise's reproducible seeded tables to this fixed-table twin and
    checks the lattice ALGORITHM, not the table contents.

Both are vectorized over numpy arrays while keeping scalar C semantics
(float64 throughout, like the reference's double math).
"""

from __future__ import annotations

import numpy as np

SAMPLE_SIZE = 1024
_BM = SAMPLE_SIZE - 1
_N = 0x1000


def iq_hash(n):
    """IQnoise::iqhashStatic (iqnoise.cpp:21-24): frac(sin(n) * 753.5453123)."""
    v = np.sin(np.asarray(n, np.float64)) * 753.5453123
    return v - np.floor(v)


def iq_noise(x, y, z):
    """IQnoise::noise (iqnoise.cpp:34-53), exact float64 semantics.

    The reference passes the point through a QVector3D (float32 storage),
    so callers modelling the full engine should pre-round inputs to f32;
    the lattice math itself is double.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    px, py, pz = np.floor(x), np.floor(y), np.floor(z)
    fx, fy, fz = x - px, y - py, z - pz
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)
    fz = fz * fz * (3.0 - 2.0 * fz)
    n = px + py * 157.0 + 113.0 * pz

    def lerp(a, b, w):  # IQnoise::lerp(a, b, w) = a + w*(b-a)
        return a + w * (b - a)

    return lerp(
        lerp(lerp(iq_hash(n + 0.0), iq_hash(n + 1.0), fx),
             lerp(iq_hash(n + 157.0), iq_hash(n + 158.0), fx), fy),
        lerp(lerp(iq_hash(n + 113.0), iq_hash(n + 114.0), fx),
             lerp(iq_hash(n + 270.0), iq_hash(n + 271.0), fx), fy),
        fz,
    )


def _setup(v):
    """The setup() macro (perlin.cpp:24-29): t = v + 0x1000, integer-trunc
    lattice cell + fractional offsets."""
    t = np.asarray(v, np.float64) + _N
    it = np.trunc(t)  # (int)t — t >= 0 for all in-range inputs
    b0 = it.astype(np.int64) & _BM
    b1 = (b0 + 1) & _BM
    r0 = t - it
    r1 = r0 - 1.0
    return b0, b1, r0, r1


def perlin_noise3(p, g3, x, y, z):
    """Perlin::noise3 (perlin.cpp:99-150) with explicit tables.

    p:  int array of at least SAMPLE_SIZE*2+2 entries (the doubled
        permutation, p[i] == p[i & 1023] over the reachable index range)
    g3: float array (len(p), 3) of unit-ish gradients, doubled the same way
    """
    p = np.asarray(p, np.int64)
    g3 = np.asarray(g3, np.float64)
    bx0, bx1, rx0, rx1 = _setup(x)
    by0, by1, ry0, ry1 = _setup(y)
    bz0, bz1, rz0, rz1 = _setup(z)

    i = p[bx0]
    j = p[bx1]
    b00 = p[i + by0]
    b10 = p[j + by0]
    b01 = p[i + by1]
    b11 = p[j + by1]

    def s_curve(t):
        return t * t * (3.0 - 2.0 * t)

    def lerp(t, a, b):
        return a + t * (b - a)

    t = s_curve(rx0)
    sy = s_curve(ry0)
    sz = s_curve(rz0)

    def at3(q, rx, ry, rz):
        g = g3[q]
        return rx * g[..., 0] + ry * g[..., 1] + rz * g[..., 2]

    a = lerp(t, at3(b00 + bz0, rx0, ry0, rz0), at3(b10 + bz0, rx1, ry0, rz0))
    b = lerp(t, at3(b01 + bz0, rx0, ry1, rz0), at3(b11 + bz0, rx1, ry1, rz0))
    c = lerp(sy, a, b)
    a = lerp(t, at3(b00 + bz1, rx0, ry0, rz1), at3(b10 + bz1, rx1, ry0, rz1))
    b = lerp(t, at3(b01 + bz1, rx0, ry1, rz1), at3(b11 + bz1, rx1, ry1, rz1))
    d = lerp(sy, a, b)
    return lerp(sz, c, d)


def perlin_raw_3d(p, g3, x, y, z):
    """Perlin::raw_3d = 2 * noise3 (perlin.h:32-37)."""
    return 2.0 * perlin_noise3(p, g3, x, y, z)


def perlin_noise2(p, g2, x, y):
    """Perlin::noise2 (perlin.cpp:56-97) with explicit tables — the 2-D
    half of the Noise interface (noise.h:41). g2: (len(p), 2) unit-ish
    gradient pairs, doubled like g3."""
    p = np.asarray(p, np.int64)
    g2 = np.asarray(g2, np.float64)
    bx0, bx1, rx0, rx1 = _setup(x)
    by0, by1, ry0, ry1 = _setup(y)

    i = p[bx0]
    j = p[bx1]
    b00 = p[i + by0]
    b10 = p[j + by0]
    b01 = p[i + by1]
    b11 = p[j + by1]

    def s_curve(t):
        return t * t * (3.0 - 2.0 * t)

    def lerp(t, a, b):
        return a + t * (b - a)

    sx = s_curve(rx0)
    sy = s_curve(ry0)

    def at2(q, rx, ry):
        g = g2[q]
        return rx * g[..., 0] + ry * g[..., 1]

    a = lerp(sx, at2(b00, rx0, ry0), at2(b10, rx1, ry0))
    b = lerp(sx, at2(b01, rx0, ry1), at2(b11, rx1, ry1))
    return lerp(sy, a, b)


def perlin_raw_2d(p, g2, x, y):
    """Perlin::raw_2d = 2 * noise2 (perlin.h:26-30)."""
    return 2.0 * perlin_noise2(p, g2, x, y)


def iq_raw_2d(x, y):
    """IQnoise::raw_2d (iqnoise.h:22-24): the 3-D noise at z = 0."""
    return iq_noise(x, y, 0.0)
