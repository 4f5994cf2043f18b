"""The alternative raw-noise backends as torch ops: classic Perlin gradient
noise and IQ sin-hash value noise — the plain versions of the march
kernel's ``perlin_raw_3d`` and ``iq_raw_3d`` device functions
(csrc/noise.cuh), with the 2-D half of the Noise interface.

Same semantics as ``gamer_tpu.ops.altnoise``:

  perlin_raw_3d / _2d:   source/noise/perlin.cpp:56-150, x2 of perlin.h:26-37
  iq_value_noise_3d/_2d: source/noise/iqnoise.cpp:34-53, iqnoise.h:22-24

dtype-generic: float32 on the render path, float64 for the oracle gates.

The kernels render the tables of table seed 94, the only seed any render
path uses. Its 1024-entry permutation and 2-D gradient table are stored as
data (data/perlin_seed94.npz) and not drawn at run time: they came from a
``numpy.random.Generator``, whose method streams are not promised across
numpy versions. The torch ops also take another table ``seed``, for parity
with the JAX package's functions: that seed's tables are drawn on every
call by the JAX package's recipe (``_perlin_build``, ``_perlin_build2``),
so they depend on numpy's stream, and they never enter the cached tables
of the render path. The 3-D gradient triples are an integer hash of the
lattice index (``grad_hash_q``), decoded here at each corner; the kernels
read the same decoded values from a table built by this hash on the host
(``ops/noise.py::perlin_grad_table``), so this version stays an independent
check of that table. The 1024-entry permutation is indexed directly
(``p[idx & 1023]``); the packed, chunked and one-hot lookup forms of the
JAX package answer a TPU constraint and are not ported.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from .math3d import wrap_i32
from .noise import device_table

SAMPLE_SIZE = 1024
_MASK = SAMPLE_SIZE - 1
_N_OFF = 4096.0  # perlin.cpp's N = 0x1000
PERLIN_SEED = 94
PERLIN_TABLES = (Path(__file__).resolve().parent.parent / "data"
                 / "perlin_seed94.npz")

# 10-bit gradient quantization: q in [0, 1023] <-> g = (q - 511.5) / 511.5,
# both decode constants rounded to float32 first.
_GRAD_MID = float(np.float32(511.5))
_GRAD_INV = float(np.float32(1.0 / 511.5))

# Two rounds of multiply-xorshift (lowbias32 constants) over int32 with
# two's-complement wrap and arithmetic right shifts.
GRAD_HASH_M1 = int(np.uint32(0x7FEB352D).view(np.int32))
GRAD_HASH_M2 = int(np.uint32(0x846CA68B).view(np.int32))


def grad_hash_seedk(seed: int) -> int:
    """The per-seed xor key folded into the gradient hash (an int32)."""
    return int(np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF).view(np.int32))


PERLIN_DEFAULT_SEEDK = grad_hash_seedk(PERLIN_SEED)


def grad_hash_q(idx, seed: int = PERLIN_SEED):
    """(qx, qy, qz) 10-bit gradient components of lattice index ``idx``
    (an integer tensor), for table ``seed``. The int32 multiplies run in
    int64 and wrap to 32 bits by hand; a sign-extended int64 shifts right
    as the int32 would."""
    h = (idx.long() & _MASK) ^ grad_hash_seedk(seed)
    h = wrap_i32(h * GRAD_HASH_M1)
    h = h ^ (h >> 15)
    h = wrap_i32(h * GRAD_HASH_M2)
    h = h ^ (h >> 13)
    return h & 1023, (h >> 10) & 1023, (h >> 20) & 1023


def _perlin_build(seed: int) -> np.ndarray:
    """The (1024,) int32 permutation of table ``seed``: an MT19937-shuffled
    arange (``gamer_tpu.ops.altnoise._perlin_build``'s perm)."""
    rng = np.random.Generator(np.random.MT19937(seed))
    perm = np.arange(SAMPLE_SIZE)
    rng.shuffle(perm)
    return perm.astype(np.int32)


def _perlin_build2(seed: int) -> np.ndarray:
    """The (1024, 2) int32 10-bit quantized 2-D gradients of table ``seed``,
    drawn from an MT19937 stream keyed off ``seed ^ 0x2D2D``
    (``gamer_tpu.ops.altnoise._perlin_build2`` before its decode)."""
    rng = np.random.Generator(np.random.MT19937(seed ^ 0x2D2D))
    g2 = rng.uniform(-1.0, 1.0, (SAMPLE_SIZE, 2))
    g2 /= np.linalg.norm(g2, axis=1, keepdims=True)
    return np.clip(np.rint(g2 * 511.5 + 511.5), 0, 1023).astype(np.int32)


@functools.lru_cache(maxsize=1)
def _stored_tables():
    """Seed 94's (perm, g2), read once from the stored file."""
    with np.load(PERLIN_TABLES) as z:
        return _decoded(z["perm"].astype(np.int32),
                        z["g2q"].astype(np.float32))


def _decoded(perm: np.ndarray, g2q: np.ndarray):
    return perm, (g2q - np.float32(_GRAD_MID)) * np.float32(_GRAD_INV)


def perlin_tables(seed: int = PERLIN_SEED):
    """(perm (1024,) int32, g2 (1024, 2) float32) of table ``seed``: the
    permutation and the decoded 2-D gradients; seed 94's from the stored
    file (cached), any other seed's drawn on each call."""
    if seed == PERLIN_SEED:
        return _stored_tables()
    return _decoded(_perlin_build(seed),
                    _perlin_build2(seed).astype(np.float32))


def perlin_perm_table(device, dtype=torch.int64,
                      seed: int = PERLIN_SEED) -> torch.Tensor:
    """The 1024-entry Perlin permutation of table ``seed`` as a ``dtype``
    tensor on ``device``: seed 94's uploaded once per device and dtype,
    another seed's built for the call."""
    if seed != PERLIN_SEED:
        return torch.as_tensor(perlin_tables(seed)[0], device=device,
                               dtype=dtype)
    return device_table("perlin_perm", perlin_tables()[0], device, dtype)


def _setup(v):
    """The setup() macro (perlin.cpp:24-29): t = v + 0x1000, the truncated
    lattice cell and the fractional offsets. Truncation is the cell only
    for t >= 0, i.e. coordinates above -4096; kept as written."""
    t = v + _N_OFF
    it = torch.trunc(t)
    b0 = it.long() & _MASK
    return b0, (b0 + 1) & _MASK, t - it, (t - it) - 1.0


def _s_curve(t):
    return t * t * (3.0 - 2.0 * t)


def _lerp(w, a, b):
    return a + w * (b - a)


def _corner_indices(perm, bx0, bx1, by0, by1):
    i = perm[bx0]
    j = perm[bx1]
    return (perm[(i + by0) & _MASK], perm[(j + by0) & _MASK],
            perm[(i + by1) & _MASK], perm[(j + by1) & _MASK])


def perlin_raw_3d(x, y, z, seed: int = PERLIN_SEED):
    """Classic Perlin gradient noise in roughly [-1, 1], elementwise (x2
    scaling like Perlin::raw_3d), with the tables of table ``seed``."""
    dtype = x.dtype
    perm = perlin_perm_table(x.device, seed=seed)
    bx0, bx1, rx0, rx1 = _setup(x)
    by0, by1, ry0, ry1 = _setup(y)
    bz0, bz1, rz0, rz1 = _setup(z)
    b00, b10, b01, b11 = _corner_indices(perm, bx0, bx1, by0, by1)

    def at3(idx, rx, ry, rz):
        qx, qy, qz = grad_hash_q(idx, seed)
        # the decode runs in float32 whatever the working precision, so
        # every precision sees the same gradient values
        gx = ((qx.to(torch.float32) - _GRAD_MID) * _GRAD_INV).to(dtype)
        gy = ((qy.to(torch.float32) - _GRAD_MID) * _GRAD_INV).to(dtype)
        gz = ((qz.to(torch.float32) - _GRAD_MID) * _GRAD_INV).to(dtype)
        return rx * gx + ry * gy + rz * gz

    t = _s_curve(rx0)
    sy = _s_curve(ry0)
    sz = _s_curve(rz0)
    a = _lerp(t, at3(b00 + bz0, rx0, ry0, rz0), at3(b10 + bz0, rx1, ry0, rz0))
    b = _lerp(t, at3(b01 + bz0, rx0, ry1, rz0), at3(b11 + bz0, rx1, ry1, rz0))
    c = _lerp(sy, a, b)
    a = _lerp(t, at3(b00 + bz1, rx0, ry0, rz1), at3(b10 + bz1, rx1, ry0, rz1))
    b = _lerp(t, at3(b01 + bz1, rx0, ry1, rz1), at3(b11 + bz1, rx1, ry1, rz1))
    d = _lerp(sy, a, b)
    return 2.0 * _lerp(sz, c, d)


def perlin_raw_2d(x, y, seed: int = PERLIN_SEED):
    """Classic Perlin 2-D gradient noise, x2 scaling (perlin.h:26-30), with
    the tables of table ``seed``: the 2-D half of the Noise interface; no
    component samples it."""
    perm = perlin_perm_table(x.device, seed=seed)
    if seed != PERLIN_SEED:
        g2 = torch.as_tensor(perlin_tables(seed)[1], device=x.device,
                             dtype=x.dtype)
    else:
        g2 = device_table("perlin_g2", perlin_tables()[1], x.device, x.dtype)
    bx0, bx1, rx0, rx1 = _setup(x)
    by0, by1, ry0, ry1 = _setup(y)
    b00, b10, b01, b11 = _corner_indices(perm, bx0, bx1, by0, by1)

    def at2(idx, rx, ry):
        g = g2[idx]
        return rx * g[..., 0] + ry * g[..., 1]

    sx = _s_curve(rx0)
    sy = _s_curve(ry0)
    a = _lerp(sx, at2(b00, rx0, ry0), at2(b10, rx1, ry0))
    b = _lerp(sx, at2(b01, rx0, ry1), at2(b11, rx1, ry1))
    return 2.0 * _lerp(sy, a, b)


def iq_value_noise_3d(x, y, z):
    """IQ sin-hash trilinear value noise (iqnoise.cpp:34-53). The hash is
    frac(sin(n) * 753.5453123): the multiply amplifies the last ulps of the
    sine, so two sine implementations (this one, a libm, the card's sinf)
    agree closely in float64 and only statistically in float32."""
    px, py, pz = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = _s_curve(x - px), _s_curve(y - py), _s_curve(z - pz)
    n = px + py * 157.0 + 113.0 * pz

    def h(o):
        v = torch.sin(n + o) * 753.5453123
        return v - torch.floor(v)

    return _lerp(
        fz,
        _lerp(fy, _lerp(fx, h(0.0), h(1.0)), _lerp(fx, h(157.0), h(158.0))),
        _lerp(fy, _lerp(fx, h(113.0), h(114.0)), _lerp(fx, h(270.0), h(271.0))),
    )


def iq_value_noise_2d(x, y):
    """IQnoise::raw_2d (iqnoise.h:22-24): the 3-D value noise at z = 0."""
    return iq_value_noise_3d(x, y, torch.zeros_like(x))
