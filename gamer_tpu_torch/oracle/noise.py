"""Vectorized float64 simplex noise for the conformance oracle.

Semantics are an exact transcription of the reference noise stack:
  - raw 3-D simplex:   source/noise/simplexnoise.cpp:243-330 (Gustavson)
  - octave fractal:    source/noise/noise.cpp:162-180
  - ridged multifractal: source/noise/noise.cpp:81-128
  - offset octave variant ("get"): source/noise/noise.cpp:16-40 (unused by
    components but part of the Noise interface)

All math is float64 (the C++ computes noise in double); inputs typically carry
float32-rounded values because they pass through QVector3D first.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.tables import GRAD3, PERM

_PERM = PERM.astype(np.int64)
_GX = GRAD3[:, 0].astype(np.float64)
_GY = GRAD3[:, 1].astype(np.float64)
_GZ = GRAD3[:, 2].astype(np.float64)


def fastfloor(x: np.ndarray) -> np.ndarray:
    """simplexnoise.h:130 — trunc for x>0 else trunc-1 (NOT floor: differs at
    exact non-positive integers)."""
    t = np.trunc(x)
    return np.where(x > 0, t, t - 1.0).astype(np.int64)


def raw_noise_3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Raw 3-D simplex noise in [-1, 1], vectorized float64."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)

    F3 = 1.0 / 3.0
    G3 = 1.0 / 6.0
    s = (x + y + z) * F3
    i = fastfloor(x + s)
    j = fastfloor(y + s)
    k = fastfloor(z + s)
    t = (i + j + k).astype(np.float64) * G3
    x0 = x - (i - t)
    y0 = y - (j - t)
    z0 = z - (k - t)

    # Simplex corner ranking — mirrors the exact nested >=/< conditionals.
    A = x0 >= y0
    B = y0 >= z0
    C = x0 >= z0
    i1 = (A & (B | C)).astype(np.int64)
    j1 = (~A & B).astype(np.int64)
    k1 = ((A & ~B & ~C) | (~A & ~B)).astype(np.int64)
    i2 = (A | (B & C)).astype(np.int64)
    j2 = (~A | B).astype(np.int64)
    k2 = ((A & ~B) | (~A & (~B | ~C))).astype(np.int64)

    x1 = x0 - i1 + G3
    y1 = y0 - j1 + G3
    z1 = z0 - k1 + G3
    x2 = x0 - i2 + 2.0 * G3
    y2 = y0 - j2 + 2.0 * G3
    z2 = z0 - k2 + 2.0 * G3
    x3 = x0 - 1.0 + 3.0 * G3
    y3 = y0 - 1.0 + 3.0 * G3
    z3 = z0 - 1.0 + 3.0 * G3

    ii = i & 255
    jj = j & 255
    kk = k & 255
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


def raw_noise_2d(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Raw 2-D simplex noise in [-1, 1], vectorized float64
    (simplexnoise.cpp:173-239). Part of the Noise interface
    (noise.h:41 raw_2d) — no component calls it; kept for interface
    parity with the reference."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)

    F2 = 0.5 * (np.sqrt(3.0) - 1.0)
    G2 = (3.0 - np.sqrt(3.0)) / 6.0
    s = (x + y) * F2
    i = fastfloor(x + s)
    j = fastfloor(y + s)
    t = (i + j).astype(np.float64) * G2
    x0 = x - (i - t)
    y0 = y - (j - t)

    lower = x0 > y0  # lower triangle: (1,0); upper: (0,1)
    i1 = lower.astype(np.int64)
    j1 = (~lower).astype(np.int64)

    x1 = x0 - i1 + G2
    y1 = y0 - j1 + G2
    x2 = x0 - 1.0 + 2.0 * G2
    y2 = y0 - 1.0 + 2.0 * G2

    ii = i & 255
    jj = j & 255
    gi0 = _PERM[ii + _PERM[jj]] % 12
    gi1 = _PERM[ii + i1 + _PERM[jj + j1]] % 12
    gi2 = _PERM[ii + 1 + _PERM[jj + 1]] % 12

    def contrib(tv, gi, cx, cy):
        gd = _GX[gi] * cx + _GY[gi] * cy
        tt = tv * tv
        return np.where(tv < 0, 0.0, tt * tt * gd)

    n0 = contrib(0.5 - x0 * x0 - y0 * y0, gi0, x0, y0)
    n1 = contrib(0.5 - x1 * x1 - y1 * y1, gi1, x1, y1)
    n2 = contrib(0.5 - x2 * x2 - y2 * y2, gi2, x2, y2)
    return 70.0 * (n0 + n1 + n2)


def octave_noise_2d(octaves: int, persistence: float, scale: float, x, y) -> np.ndarray:
    """simplexnoise.cpp:55-71 / Noise::get 2-D (noise.cpp:47-63) — the
    same frequency-doubling combinator over raw_2d."""
    total = 0.0
    frequency = float(scale)
    amplitude = 1.0
    max_amp = 0.0
    for _ in range(int(octaves)):
        total = total + raw_noise_2d(x * frequency, y * frequency) * amplitude
        frequency *= 2.0
        max_amp += amplitude
        amplitude *= persistence
    return total / max_amp


def octave_noise_3d(octaves: int, persistence: float, scale: float, x, y, z) -> np.ndarray:
    """noise.cpp:162-180 — frequency doubling, persistence amplitudes,
    normalized by the total amplitude."""
    total = 0.0
    frequency = float(scale)
    amplitude = 1.0
    max_amp = 0.0
    for _ in range(int(octaves)):
        total = total + raw_noise_3d(x * frequency, y * frequency, z * frequency) * amplitude
        frequency *= 2.0
        max_amp += amplitude
        amplitude *= persistence
    return total / max_amp


def ridged_mf(px, py, pz, frequency: float, octaves: int, lacunarity: float,
              offset: float, gain: float) -> np.ndarray:
    """noise.cpp:81-128 — ridged multifractal with weight feedback.

    The sample point lives in a QVector3D in the reference, so the per-octave
    ``vt *= lacunarity`` scaling rounds the coordinates to float32 each octave
    (noise.cpp:106 ``vt = vt * lacunarity``); the noise itself is evaluated in
    double. (The C++ writes ``double w = -0.05f``; the in-tree oracle — the
    designated conformance datum — uses the double -0.05, kept here.)
    """
    f32 = np.float32
    vx = np.asarray(px, dtype=f32)
    vy = np.asarray(py, dtype=f32)
    vz = np.asarray(pz, dtype=f32)
    value = np.zeros(np.broadcast(vx, vy, vz).shape, dtype=np.float64)
    weight = np.ones_like(value)
    w = -0.05
    lac32 = f32(lacunarity)
    freq = float(frequency)
    for _ in range(int(octaves)):
        signal = raw_noise_3d(vx.astype(np.float64), vy.astype(np.float64),
                              vz.astype(np.float64))
        signal = offset - np.abs(signal)
        signal = signal * signal
        signal = signal * weight
        weight = np.clip(signal * gain, 0.0, 1.0)
        # math.pow (C libm) — np.power can differ in the last ulp
        value = value + signal * math.pow(freq, w)
        vx = vx * lac32
        vy = vy * lac32
        vz = vz * lac32
        freq *= lacunarity
    return value * 1.25 - 1.0


def offset_octave_noise_3d(octaves: int, persistence: float, frequency: float, x, y, z):
    """Noise::get with per-octave coordinate offsets (noise.cpp:16-40)."""
    total = 0.0
    freq = float(frequency)
    amplitude = 1.0
    max_amp = 0.0
    for i in range(int(octaves)):
        total = total + raw_noise_3d(
            (x + 0.1231 * i) * freq, (y + 0.6123 * i) * freq, (z + 100.539127 * i) * freq
        ) * amplitude
        freq *= 2.0
        max_amp += amplitude
        amplitude *= persistence
    return total / max_amp
