"""Simplex noise as torch ops — the plain versions of the march kernel's
noise device functions (csrc/noise.cuh).

Same semantics as ``gamer_tpu.ops.noise`` and the oracle:

  raw 3-D simplex:       source/noise/simplexnoise.cpp:173+ (Gustavson tables)
  octave fractal:        source/noise/noise.cpp:162-180
  ridged multifractal:   source/noise/noise.cpp:81-128

dtype-generic: float32 on the render path, float64 for the oracle gates.
The permutation table is indexed directly (``PERM[idx]``); the scalar
octave bookkeeping (frequency, amplitude, their sums) runs in the input's
precision, as the kernel's float registers do.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import PERM

_PERM_CACHE: dict = {}


def perm_table(device, dtype=torch.int64) -> torch.Tensor:
    """The 512-entry permutation as a ``dtype`` tensor on ``device``."""
    key = (str(torch.device(device)), dtype)
    t = _PERM_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(PERM, device=device).to(dtype)
        _PERM_CACHE[key] = t
    return t


def _np_float(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def _grad_dot(gi, x, y, z):
    """dot(GRAD3[gi], (x, y, z)) without a table: gi in [0,4) is
    (sx, sy, 0), [4,8) (sx, 0, sz), [8,12) (0, sy, sz); bit 0 flips the first
    nonzero component's sign, bit 1 the second's."""
    group = gi >> 2
    u = torch.where(group == 2, y, x)
    v = torch.where(group == 0, y, z)
    u = torch.where((gi & 1) == 1, -u, u)
    v = torch.where((gi & 2) == 2, -v, v)
    return u + v


def fastfloor(x):
    """trunc for x > 0 else trunc - 1 (simplexnoise.h:130 — NOT floor at
    exact non-positive integers)."""
    t = torch.trunc(x)
    return torch.where(x > 0, t, t - 1.0).to(torch.int64)


def raw_noise_3d(x, y, z):
    """Raw 3-D simplex noise in [-1, 1], elementwise."""
    dtype = x.dtype
    third = 1.0 / 3.0
    sixth = 1.0 / 6.0
    s = (x + y + z) * third
    i = fastfloor(x + s)
    j = fastfloor(y + s)
    k = fastfloor(z + s)
    t = (i + j + k).to(dtype) * sixth
    x0 = x - (i.to(dtype) - t)
    y0 = y - (j.to(dtype) - t)
    z0 = z - (k.to(dtype) - t)

    # corner ranking — exact transcription of the nested conditionals
    A = x0 >= y0
    B = y0 >= z0
    C = x0 >= z0
    i1 = (A & (B | C)).long()
    j1 = (~A & B).long()
    k1 = ((A & ~B & ~C) | (~A & ~B)).long()
    i2 = (A | (B & C)).long()
    j2 = (~A | B).long()
    k2 = ((A & ~B) | (~A & (~B | ~C))).long()

    x1 = x0 - i1.to(dtype) + sixth
    y1 = y0 - j1.to(dtype) + sixth
    z1 = z0 - k1.to(dtype) + sixth
    x2 = x0 - i2.to(dtype) + 2.0 * sixth
    y2 = y0 - j2.to(dtype) + 2.0 * sixth
    z2 = z0 - k2.to(dtype) + 2.0 * sixth
    x3 = x0 - 1.0 + 3.0 * sixth
    y3 = y0 - 1.0 + 3.0 * sixth
    z3 = z0 - 1.0 + 3.0 * sixth

    perm = perm_table(x.device)
    ii = i & 255
    jj = j & 255
    kk = k & 255
    gi0 = perm[ii + perm[jj + perm[kk]]] % 12
    gi1 = perm[ii + i1 + perm[jj + j1 + perm[kk + k1]]] % 12
    gi2 = perm[ii + i2 + perm[jj + j2 + perm[kk + k2]]] % 12
    gi3 = perm[ii + 1 + perm[jj + 1 + perm[kk + 1]]] % 12

    def contrib(tv, gi, cx, cy, cz):
        tt = tv * tv
        return torch.where(tv < 0, 0.0, tt * tt * _grad_dot(gi, cx, cy, cz))

    n0 = contrib(0.6 - x0 * x0 - y0 * y0 - z0 * z0, gi0, x0, y0, z0)
    n1 = contrib(0.6 - x1 * x1 - y1 * y1 - z1 * z1, gi1, x1, y1, z1)
    n2 = contrib(0.6 - x2 * x2 - y2 * y2 - z2 * z2, gi2, x2, y2, z2)
    n3 = contrib(0.6 - x3 * x3 - y3 * y3 - z3 * z3, gi3, x3, y3, z3)
    return 32.0 * (n0 + n1 + n2 + n3)


def octave_noise_3d(octaves: int, persistence, scale, x, y, z):
    """noise.cpp:162-180 — frequency doubling, persistence amplitudes,
    normalized by the total amplitude. All octaves' raw noise is evaluated
    in one batched call (elementwise, so each value is the per-octave one);
    the sum then runs octave by octave in the reference's order."""
    f = _np_float(x)
    octaves = int(octaves)
    freqs, amps = [], []
    freq, amp, max_amp = f(scale), f(1.0), f(0.0)
    for _ in range(octaves):
        freqs.append(float(freq))
        amps.append(float(amp))
        freq = freq * f(2.0)
        max_amp = max_amp + amp
        amp = amp * f(persistence)
    total = torch.zeros_like(x)
    if octaves == 0:
        return total / float(max_amp)
    fr = torch.tensor(freqs, dtype=x.dtype, device=x.device).reshape(
        (-1,) + (1,) * x.dim())
    raw = raw_noise_3d(x * fr, y * fr, z * fr)
    for k in range(octaves):
        total = total + raw[k] * amps[k]
    return total / float(max_amp)


def ridged_weights(frequency, octaves: int, lacunarity: float = 2.5,
                   dtype=np.float32) -> np.ndarray:
    """Per-octave spectral weights pow(frequency * lacunarity^k, -0.05) of
    the ridged multifractal (noise.cpp:122), on the host."""
    lac = dtype(lacunarity)
    freqs = dtype(frequency) * lac ** np.arange(int(octaves), dtype=dtype)
    return np.power(freqs, dtype(-0.05)).astype(dtype)


def ridged_mf(x, y, z, spectral_weights, lacunarity, offset, gain):
    """noise.cpp:81-128 with the per-octave weights given (``ridged_weights``);
    their count sets the octave count. Coordinates scale per octave in the
    input's precision (the reference's float32 QVector3D)."""
    value = torch.zeros_like(x)
    weight = torch.ones_like(x)
    if len(spectral_weights) == 0:
        return value * 1.25 - 1.0
    # the coordinates do not depend on the weight feedback: scale them
    # octave by octave, then evaluate every octave's raw noise in one call
    coords = [(x, y, z)]
    for _ in range(len(spectral_weights) - 1):
        vx, vy, vz = coords[-1]
        coords.append((vx * lacunarity, vy * lacunarity, vz * lacunarity))
    raw = raw_noise_3d(*(torch.stack(c) for c in zip(*coords)))
    for k, sw in enumerate(spectral_weights):
        signal = offset - torch.abs(raw[k])
        signal = signal * signal
        signal = signal * weight
        weight = torch.clamp(signal * gain, 0.0, 1.0)
        value = value + signal * float(sw)
    return value * 1.25 - 1.0


def noise_probe_plain(points, octaves: int, persistence, scale,
                      spectral_weights, lacunarity, offset, gain):
    """(N, 3) float32 points -> (N, 3): raw simplex, octave noise and
    ridged multifractal at each point, with these torch ops."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return torch.stack([
        raw_noise_3d(x, y, z),
        octave_noise_3d(octaves, persistence, scale, x, y, z),
        ridged_mf(x, y, z, spectral_weights, lacunarity, offset, gain),
    ], dim=1)


def noise_probe(points, octaves: int, persistence, scale, spectral_weights,
                lacunarity, offset, gain):
    """The march kernel's noise device functions at explicit points: CPU
    tensors run ``noise_probe_plain``; CUDA tensors launch
    csrc/noise_probe.cu (counted in ``noise_probe.launch_count``) or raise.
    Scalars are float32 values; at most 32 spectral weights."""
    if points.device.type == "cpu":
        return noise_probe_plain(points, octaves, persistence, scale,
                                 spectral_weights, lacunarity, offset, gain)
    if points.device.type != "cuda":
        raise ValueError(f"points must be on the CPU or a CUDA device, got "
                         f"{points.device}")
    if points.dtype != torch.float32 or points.dim() != 2 \
            or points.shape[1] != 3 or not points.is_contiguous():
        raise ValueError("points must be a contiguous (N, 3) float32 tensor")
    sw = torch.as_tensor(np.asarray(spectral_weights, np.float32),
                         device=points.device)
    if sw.numel() > 32:
        raise ValueError("at most 32 spectral weights")
    from ..kernels import library

    lib = library()
    out = torch.empty_like(points)
    perm = perm_table(points.device, torch.int32)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    with torch.cuda.device(points.device):
        rc = lib.gamer_noise_probe(
            points.data_ptr(), points.shape[0], perm.data_ptr(), int(octaves),
            float(persistence), float(scale), sw.data_ptr(), sw.numel(),
            float(lacunarity), float(offset), float(gain), out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"noise probe launch failed: CUDA error {rc} "
                           f"({lib.gamer_error_string(rc).decode()})")
    noise_probe.launch_count += 1
    return out


noise_probe.launch_count = 0
