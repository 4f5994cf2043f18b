"""Simplex noise and the noise combinators as torch ops — the plain
versions of the march kernel's noise device functions (csrc/noise.cuh).

Same semantics as ``gamer_tpu.ops.noise`` and the oracle:

  raw 3-D / 2-D simplex: source/noise/simplexnoise.cpp:173+ (Gustavson tables)
  octave fractal:        source/noise/noise.cpp:47-63,162-180
  offset octave fractal: source/noise/noise.cpp:16-40
  ridged multifractal:   source/noise/noise.cpp:81-128

The combinators take the raw backend as ``raw_fn`` (``resolve_raw(kind)``:
simplex here, perlin and iq in ops/altnoise.py), as the kernel takes it as
a template parameter. dtype-generic: float32 on the render path, float64
for the oracle gates.
The permutation table is indexed directly (``PERM[idx]``); the scalar
octave bookkeeping (frequency, amplitude, their sums) runs in the input's
precision, as the kernel's float registers do.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from .tables import PERM

_TABLE_CACHE: dict = {}


def device_table(name: str, values, device, dtype) -> torch.Tensor:
    """A constant lookup table as a ``dtype`` tensor on ``device``, uploaded
    once per (name, device, dtype)."""
    key = (name, str(torch.device(device)), dtype)
    t = _TABLE_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(values, device=device).to(dtype)
        _TABLE_CACHE[key] = t
    return t


def perm_table(device, dtype=torch.int64) -> torch.Tensor:
    """The 512-entry permutation as a ``dtype`` tensor on ``device``."""
    return device_table("perm", PERM, device, dtype)


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


def _grad_dot_2d(gi, x, y):
    """dot(GRAD3[gi].xy, (x, y)): the 2-D noise uses the (x, y) components
    of the 3-D gradient set (simplexnoise.cpp:219)."""
    group = gi >> 2
    u = torch.where(group == 2, y, x)
    u = torch.where((gi & 1) == 1, -u, u)
    v = torch.where((gi & 2) == 2, -y, y)
    return u + torch.where(group == 0, v, torch.zeros_like(v))


def raw_noise_2d(x, y):
    """Raw 2-D simplex noise in [-1, 1], elementwise
    (simplexnoise.cpp:173-239): the 2-D half of the Noise interface; no
    component samples it."""
    dtype = x.dtype
    f = _np_float(x)
    F2 = float(f(0.5 * (np.sqrt(3.0) - 1.0)))
    G2 = float(f((3.0 - np.sqrt(3.0)) / 6.0))
    s = (x + y) * F2
    i = fastfloor(x + s)
    j = fastfloor(y + s)
    t = (i + j).to(dtype) * G2
    x0 = x - (i.to(dtype) - t)
    y0 = y - (j.to(dtype) - t)

    lower = x0 > y0
    i1 = lower.long()
    j1 = (~lower).long()
    x1 = x0 - i1.to(dtype) + G2
    y1 = y0 - j1.to(dtype) + G2
    x2 = x0 - 1.0 + 2.0 * G2
    y2 = y0 - 1.0 + 2.0 * G2

    perm = perm_table(x.device)
    ii = i & 255
    jj = j & 255
    gi0 = perm[ii + perm[jj]] % 12
    gi1 = perm[ii + i1 + perm[jj + j1]] % 12
    gi2 = perm[ii + 1 + perm[jj + 1]] % 12

    def contrib(tv, gi, cx, cy):
        tt = tv * tv
        return torch.where(tv < 0, 0.0, tt * tt * _grad_dot_2d(gi, cx, cy))

    n0 = contrib(0.5 - x0 * x0 - y0 * y0, gi0, x0, y0)
    n1 = contrib(0.5 - x1 * x1 - y1 * y1, gi1, x1, y1)
    n2 = contrib(0.5 - x2 * x2 - y2 * y2, gi2, x2, y2)
    return 70.0 * (n0 + n1 + n2)


def resolve_raw(kind):
    """The raw 3-D noise backend by name (RenderConfig.noise_kind)."""
    if kind in (None, "simplex"):
        return raw_noise_3d
    if kind == "perlin":
        from .altnoise import perlin_raw_3d

        return perlin_raw_3d
    if kind == "iq":
        from .altnoise import iq_value_noise_3d

        return iq_value_noise_3d
    raise ValueError(
        f"unknown noise kind {kind!r}: expected 'simplex', 'perlin' or 'iq'")


def _octave_schedule(x, octaves: int, persistence, scale):
    """(per-octave frequencies, amplitudes, their sum) of the octave
    fractal, in the input's precision as the kernel's registers hold them."""
    f = _np_float(x)
    freqs, amps = [], []
    freq, amp, max_amp = f(scale), f(1.0), f(0.0)
    for _ in range(int(octaves)):
        freqs.append(float(freq))
        amps.append(float(amp))
        freq = freq * f(2.0)
        max_amp = max_amp + amp
        amp = amp * f(persistence)
    return freqs, amps, float(max_amp)


def _octave_sum(raw, amps, max_amp, like):
    """The octave sum in the reference's order over raw[k], one per octave."""
    total = torch.zeros_like(like)
    for k, amp in enumerate(amps):
        total = total + raw[k] * amp
    return total / max_amp


def _per_octave(freqs, x):
    return torch.tensor(freqs, dtype=x.dtype, device=x.device).reshape(
        (-1,) + (1,) * x.dim())


def octave_noise_3d(octaves: int, persistence, scale, x, y, z, raw_fn=None):
    """noise.cpp:162-180 — frequency doubling, persistence amplitudes,
    normalized by the total amplitude. All octaves' raw noise is evaluated
    in one batched call (elementwise, so each value is the per-octave one);
    the sum then runs octave by octave in the reference's order. ``raw_fn``
    swaps the raw backend (simplex by default)."""
    raw_fn = raw_noise_3d if raw_fn is None else raw_fn
    freqs, amps, max_amp = _octave_schedule(x, octaves, persistence, scale)
    if not freqs:
        return torch.zeros_like(x) / max_amp
    fr = _per_octave(freqs, x)
    return _octave_sum(raw_fn(x * fr, y * fr, z * fr), amps, max_amp, x)


def octave_noise_2d(octaves: int, persistence, scale, x, y, raw_fn=None):
    """Noise::get 2-D (noise.cpp:47-63, simplexnoise.cpp:55-71): the same
    combinator over a raw 2-D backend (simplex by default)."""
    raw_fn = raw_noise_2d if raw_fn is None else raw_fn
    freqs, amps, max_amp = _octave_schedule(x, octaves, persistence, scale)
    if not freqs:
        return torch.zeros_like(x) / max_amp
    fr = _per_octave(freqs, x)
    return _octave_sum(raw_fn(x * fr, y * fr), amps, max_amp, x)


def offset_octave_noise_3d(octaves: int, persistence, frequency, x, y, z):
    """Noise::get — the octave fractal with per-octave coordinate offsets
    (noise.cpp:16-40), over simplex. Part of the Noise interface; no
    component uses it."""
    freqs, amps, max_amp = _octave_schedule(x, octaves, persistence,
                                            frequency)
    raw = [raw_noise_3d((x + 0.1231 * i) * fr, (y + 0.6123 * i) * fr,
                        (z + 100.539127 * i) * fr)
           for i, fr in enumerate(freqs)]
    return _octave_sum(raw, amps, max_amp, x)


def ridged_weights(frequency, octaves: int, lacunarity: float = 2.5,
                   dtype=np.float32) -> np.ndarray:
    """Per-octave spectral weights pow(frequency * lacunarity^k, -0.05) of
    the ridged multifractal (noise.cpp:122), on the host."""
    lac = dtype(lacunarity)
    freqs = dtype(frequency) * lac ** np.arange(int(octaves), dtype=dtype)
    return np.power(freqs, dtype(-0.05)).astype(dtype)


def ridged_mf(x, y, z, spectral_weights, lacunarity, offset, gain,
              raw_fn=None):
    """noise.cpp:81-128 with the per-octave weights given (``ridged_weights``);
    their count sets the octave count. Coordinates scale per octave in the
    input's precision (the reference's float32 QVector3D). ``raw_fn`` swaps
    the raw backend (simplex by default)."""
    raw_fn = raw_noise_3d if raw_fn is None else raw_fn
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
    raw = raw_fn(*(torch.stack(c) for c in zip(*coords)))
    for k, sw in enumerate(spectral_weights):
        signal = offset - torch.abs(raw[k])
        signal = signal * signal
        signal = signal * weight
        weight = torch.clamp(signal * gain, 0.0, 1.0)
        value = value + signal * float(sw)
    return value * 1.25 - 1.0


def noise_statistics(sampler, n: int = 100000, lo: float = -1.0,
                     hi: float = 1.0, seed: int = 0, device="cuda"):
    """Min, max, mean and std of ``sampler(x, y, z)`` over ``n`` uniform
    points of the cube [lo, hi)^3, drawn from ``seed`` (float32 tensors on
    ``device``): Noise::calculate_statistics (noise.cpp:132-160), seeded."""
    from ..engine.cuda_render import _device

    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(lo, hi, size=(int(n), 3)),
                          dtype=torch.float32, device=_device(device))
    vals = sampler(pts[:, 0], pts[:, 1], pts[:, 2]).cpu().numpy()
    return {"min": float(vals.min()), "max": float(vals.max()),
            "mean": float(vals.mean()), "std": float(vals.std())}


NOISE_KINDS = ("simplex", "perlin", "iq")


def _paired(perm: np.ndarray) -> np.ndarray:
    """perm[x] | perm[(x + 1) mod len] << 16: an entry with its successor
    in one int32 word (every entry is below 2^16)."""
    perm = perm.astype(np.int32)
    return perm | (np.roll(perm, -1) << 16)


# The perlin kernels' table (csrc/noise.cuh): PERLIN_PERM_WORDS int32 words
# of the paired permutation, then PERLIN_GRADS gradients (perlin_grads), one
# float4 (gx, gy, gz, 0) per lattice index k = idx & 1023.
PERLIN_PERM_WORDS = 1024
PERLIN_GRADS = 1024


def split_perlin_table(table: np.ndarray) -> tuple:
    """The two parts of ``kernel_noise_table("perlin")``: (the paired
    permutation (PERLIN_PERM_WORDS,) int32, the gradients (PERLIN_GRADS, 4)
    float32)."""
    return (table[:PERLIN_PERM_WORDS],
            table[PERLIN_PERM_WORDS:].view(np.float32).reshape(PERLIN_GRADS,
                                                               4))


def perlin_grad_table() -> np.ndarray:
    """(PERLIN_GRADS, 4) float32: row k the decoded gradient of lattice
    index k, (q - 511.5) * (1 / 511.5) of ``altnoise.grad_hash_q(k)``'s
    three fields in float32 (the kernels' and the plain noise's decode,
    both constants rounded to float32 first; the subtraction is exact and
    the product rounds once), then a 0 that pads the row to 16 bytes."""
    from .altnoise import _GRAD_INV, _GRAD_MID, grad_hash_q

    q = torch.stack(grad_hash_q(torch.arange(PERLIN_GRADS)), dim=1).numpy()
    g = (q.astype(np.float32) - np.float32(_GRAD_MID)) * np.float32(_GRAD_INV)
    return np.concatenate([g, np.zeros((PERLIN_GRADS, 1), np.float32)],
                          axis=1)


@functools.lru_cache(maxsize=None)
def kernel_noise_table(kind: str) -> np.ndarray:
    """The int32 lookup table csrc/noise.cuh reads for a noise kind:
    simplex [P2[512] | GI[512]] with P2 = PERM paired with its successor and
    GI = PERM % 12; perlin the seed-94 permutation paired with its
    successor (PERLIN_PERM_WORDS words), then ``perlin_grad_table()``'s
    float32 bits (``split_perlin_table`` parts them again); iq reads none and gets the simplex table as a valid
    pointer."""
    if kind == "perlin":
        from .altnoise import perlin_tables

        return np.concatenate([_paired(perlin_tables()[0]),
                               perlin_grad_table().view(np.int32).ravel()])
    return np.concatenate([_paired(PERM), PERM % 12]).astype(np.int32)


def noise_table(kind: str, device) -> torch.Tensor:
    """The table a kernel of noise kind ``kind`` reads on ``device``:
    ``kernel_noise_table(kind)`` as an int32 tensor, uploaded once per
    device; for iq on a CUDA device the hash table ``iq_hash_table``."""
    resolve_raw(kind)  # an unknown kind raises ValueError
    if kind == "iq":
        if torch.device(device).type == "cuda":
            return iq_hash_table(device)
        kind = "simplex"
    return device_table(f"kernel_{kind}", kernel_noise_table(kind), device,
                        torch.int32)


# The iq kernels' hash table (csrc/noise.cuh): pair j holds (h(n), h(n + 1))
# at n = j - IQ_TABLE_R, h(n) = frac(sinf(n) * 753.5453123), so a cell whose
# hash argument n has |n| <= IQ_TABLE_R reads its eight corners from the
# pairs at n + IQ_CORNER_PAIRS; other arguments take the sines.
IQ_TABLE_R = 1 << 20
IQ_TABLE_PAIRS = 2 * IQ_TABLE_R + 271
IQ_CORNER_PAIRS = (0, 157, 113, 270)

_IQ_TABLES: dict = {}
_IQ_LOCK = threading.Lock()


def iq_hash_table(device) -> torch.Tensor:
    """The iq kernels' hash table on a CUDA device, (IQ_TABLE_PAIRS, 2)
    float32, filled by the kernel library (``gamer_iq_table_fill``, the
    kernels' own sinf) at the first call for that device, under a lock (the
    service renders from threads); later calls return the same tensor.
    ``iq_hash_table.launch_count`` counts the builds (one launch of the
    fill kernel each) and ``iq_hash_table.build_ms`` holds each device's
    fill time (CUDA events). A failed build raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the iq hash table lives on a CUDA device, got "
                         f"{device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    table = _IQ_TABLES.get(device.index)
    if table is None:
        with _IQ_LOCK:
            table = _IQ_TABLES.get(device.index)
            if table is None:
                table = _IQ_TABLES[device.index] = _build_iq_table(device)
    return table


def _build_iq_table(device: torch.device) -> torch.Tensor:
    from ..kernels import library

    lib = library()
    table = torch.empty((IQ_TABLE_PAIRS, 2), dtype=torch.float32,
                        device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rc = lib.gamer_iq_table_fill(table.data_ptr(), IQ_TABLE_PAIRS,
                                     stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"iq hash table build failed: CUDA error {rc} "
                               f"({lib.gamer_error_string(rc).decode()})")
        end.record(stream)
        # every launch of any stream may read it from now on
        end.synchronize()
    iq_hash_table.launch_count += 1
    iq_hash_table.build_ms[device.index] = start.elapsed_time(end)
    return table


iq_hash_table.launch_count = 0
iq_hash_table.build_ms = {}


def iq_hash_table_plain(device) -> torch.Tensor:
    """The iq hash table with torch ops on ``device``: (IQ_TABLE_PAIRS, 2)
    float32, h(n) = frac(sin(n) * 753.5453123) in float32 as
    ops/altnoise.py hashes, pair j at n = j - IQ_TABLE_R."""
    n = torch.arange(-IQ_TABLE_R, IQ_TABLE_R + 272, dtype=torch.float32,
                     device=device)
    v = torch.sin(n) * 753.5453123
    h = v - torch.floor(v)
    return torch.stack([h[:-1], h[1:]], dim=1)


@contextlib.contextmanager
def iq_census(keep: bool = False):
    """Counts the hash arguments of the plain iq raw evaluations made
    inside the block (``altnoise.iq_value_noise_3d``, as ``resolve_raw``
    hands it to the plain march and the plain probe; for one thread):
    yields a dict of ``evaluations``, ``max_abs`` (the largest finite
    |n|), ``outside`` (evaluations whose n the kernels' table does not
    hold: |n| > IQ_TABLE_R, NaN or inf; on the card they take the sines)
    and ``non_integer`` (finite n that are not integers: none may be);
    with ``keep``, ``arguments`` too: the distinct finite n, sorted."""
    from . import altnoise

    twin = altnoise.iq_value_noise_3d
    got = {"evaluations": 0, "max_abs": 0.0, "outside": 0, "non_integer": 0}
    seen = []

    def counted(x, y, z):
        # the hash argument, as csrc/noise.cuh and ops/altnoise.py form it
        n = torch.floor(x) + torch.floor(y) * 157.0 + 113.0 * torch.floor(z)
        finite = torch.isfinite(n)
        got["evaluations"] += n.numel()
        if bool(finite.any()):
            got["max_abs"] = max(got["max_abs"], float(n[finite].abs().max()))
            if keep:
                seen.append(torch.unique(n[finite]).cpu())
        got["outside"] += int((~(n.abs() <= IQ_TABLE_R)).sum())
        got["non_integer"] += int((finite & (n != torch.floor(n))).sum())
        return twin(x, y, z)

    altnoise.iq_value_noise_3d = counted
    try:
        yield got
    finally:
        altnoise.iq_value_noise_3d = twin
        if keep:
            got["arguments"] = (torch.unique(torch.cat(seen)).numpy() if seen
                                else np.zeros(0, np.float32))


def noise_probe_plain(points, octaves: int, persistence, scale,
                      spectral_weights, lacunarity, offset, gain,
                      kind: str = "simplex"):
    """(N, 3) float32 points -> (N, 3): the kind's raw noise, octave noise
    and ridged multifractal at each point, with these torch ops."""
    raw_fn = resolve_raw(kind)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return torch.stack([
        raw_fn(x, y, z),
        octave_noise_3d(octaves, persistence, scale, x, y, z, raw_fn),
        ridged_mf(x, y, z, spectral_weights, lacunarity, offset, gain, raw_fn),
    ], dim=1)


def noise_probe(points, octaves: int, persistence, scale, spectral_weights,
                lacunarity, offset, gain, kind: str = "simplex"):
    """The march kernel's noise device functions of one kind at explicit
    points: CPU tensors run ``noise_probe_plain``; CUDA tensors launch
    csrc/noise_probe.cu (counted in ``noise_probe.launch_count``) or raise.
    Scalars are float32 values; at most 32 spectral weights."""
    resolve_raw(kind)  # an unknown kind raises ValueError
    if points.device.type == "cpu":
        return noise_probe_plain(points, octaves, persistence, scale,
                                 spectral_weights, lacunarity, offset, gain,
                                 kind)
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
    perm = noise_table(kind, points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    with torch.cuda.device(points.device):
        rc = lib.gamer_noise_probe(
            points.data_ptr(), points.shape[0], perm.data_ptr(), int(octaves),
            float(persistence), float(scale), sw.data_ptr(), sw.numel(),
            float(lacunarity), float(offset), float(gain), out.data_ptr(),
            NOISE_KINDS.index(kind), stream)
    if rc != 0:
        raise RuntimeError(f"noise probe launch failed: CUDA error {rc} "
                           f"({lib.gamer_error_string(rc).decode()})")
    noise_probe.launch_count += 1
    return out


noise_probe.launch_count = 0
