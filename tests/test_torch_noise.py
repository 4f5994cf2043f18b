"""gamer_tpu_torch noise, atan and hash against the JAX package and the
oracle: f32 bit-exact against the TPU kernel's device functions
(pallas_noise, evaluated op by op) and within 1e-6 of gamer_tpu.ops.noise
(2e-6 for the ridged multifractal, see its test), f64 within 1e-12 of
gamer_tpu.oracle.noise, atan within 1 ulp of the kernel's minimax, and the
integer hash bit-exact. The perlin and iq backends: perlin f32 bit-exact
against both JAX forms (``ops.altnoise`` and the kernel's ``pallas_noise``
twin) and exact in f64 against the oracle's fixed-table lattice; iq within
1e-12 of the oracle in f64 (two sines, amplified by 753.5) and within 2e-4
of ``ops.altnoise`` in f32 away from hash wraps; the 2-D half of the Noise
interface in f64 against the oracle."""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gamer_tpu.engine import render as jrender  # noqa: E402
from gamer_tpu.ops import altnoise as jalt  # noqa: E402
from gamer_tpu.ops import noise as jnoise  # noqa: E402
from gamer_tpu.ops import pallas_noise as pn  # noqa: E402
from gamer_tpu.oracle import altnoise as oalt  # noqa: E402
from gamer_tpu.oracle import noise as onoise  # noqa: E402

from gamer_tpu_torch.engine import render as trender  # noqa: E402
from gamer_tpu_torch.ops import altnoise as talt  # noqa: E402
from gamer_tpu_torch.ops import math3d as tm  # noqa: E402
from gamer_tpu_torch.ops import noise as tnoise  # noqa: E402


@pytest.fixture(scope="module")
def points():
    # the point set of tests/test_engine.py
    rng = np.random.default_rng(7)
    return rng.uniform(-3.0, 3.0, size=(512, 3))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _xyz32(points):
    p = points.astype(np.float32)
    return [p[:, k] for k in range(3)]


def _pallas_eager(fn, *xyz_and_args):
    """A pallas_noise device function evaluated op by op (no jit, so no
    fusion or contraction) on (4, 128) tiles, as the kernel's arithmetic."""
    from gamer_tpu.ops.tables import PERM_PACKED32

    perm = jnp.asarray(np.broadcast_to(PERM_PACKED32, (4, 128)).copy())
    xyz = [jnp.asarray(v.reshape(4, 128)) for v in xyz_and_args[:3]]
    with jax.disable_jit():
        return np.asarray(fn(perm, *xyz, *xyz_and_args[3:])).reshape(-1)


def test_raw_noise_f32_matches_jax(points):
    x, y, z = _xyz32(points)
    ours = tnoise.raw_noise_3d(_t(x), _t(y), _t(z)).numpy()
    ref = np.asarray(jnoise.raw_noise_3d(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(z)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours, _pallas_eager(pn.raw_noise_3d, x, y, z))


@pytest.mark.parametrize("octaves,pers,scale", [(10, 0.7, 0.35), (4, -2.0, 0.2),
                                                (9, 1.2, 0.1)])
def test_octave_noise_f32_matches_jax(points, octaves, pers, scale):
    x, y, z = _xyz32(points)
    ours = tnoise.octave_noise_3d(octaves, pers, scale, _t(x), _t(y), _t(z))
    ref = jnoise.octave_noise_3d(octaves, jnp.float32(pers), jnp.float32(scale),
                                 jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    kern = _pallas_eager(
        lambda perm, a, b, c: pn.octave_noise_3d(
            perm, octaves, jnp.float32(pers), jnp.float32(scale), a, b, c),
        x, y, z)
    np.testing.assert_array_equal(ours.numpy(), kern)


@pytest.mark.parametrize("octaves", [9, 4, 1])
def test_ridged_f32_matches_jax(points, octaves):
    """Bit-exact against the kernel's device function (pallas_noise) and
    within 2e-6 of ops.noise: its XLA-fused scan body itself differs from
    pallas_noise.ridged_mf by up to 1.2e-6 on this point set."""
    x, y, z = _xyz32(points)
    # the weights as ops.noise forms them: f32 frequency products, XLA pow
    freqs = [np.float32(1.3)]
    for _ in range(octaves - 1):
        freqs.append(freqs[-1] * np.float32(2.5))
    sw = np.asarray(jnp.power(jnp.asarray(freqs), jnp.float32(-0.05)))
    ours = tnoise.ridged_mf(_t(x), _t(y), _t(z), sw, 2.5, 1.0, 0.8)
    ref = jnoise.ridged_mf(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                           jnp.float32(1.3), octaves, 2.5, jnp.float32(1.0),
                           jnp.float32(0.8))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=2e-6)
    kern = _pallas_eager(
        lambda perm, a, b, c: pn.ridged_mf(
            perm, a, b, c, [jnp.float32(w) for w in sw], 2.5,
            jnp.float32(1.0), jnp.float32(0.8)),
        x, y, z)
    np.testing.assert_array_equal(ours.numpy(), kern)


def test_raw_and_octave_f64_match_oracle(points):
    x, y, z = (_t(points[:, k], torch.float64) for k in range(3))
    raw = tnoise.raw_noise_3d(x, y, z).numpy()
    np.testing.assert_allclose(
        raw, onoise.raw_noise_3d(points[:, 0], points[:, 1], points[:, 2]),
        rtol=0, atol=1e-12)
    octv = tnoise.octave_noise_3d(10, 0.7, 0.35, x, y, z).numpy()
    np.testing.assert_allclose(
        octv, onoise.octave_noise_3d(10, 0.7, 0.35, points[:, 0],
                                     points[:, 1], points[:, 2]),
        rtol=0, atol=1e-12)


def test_ridged_f64_matches_oracle_raw(points):
    """f64 ridged multifractal against a loop over the oracle's raw noise
    with f64 coordinates (the oracle's own ridged_mf rounds them to f32)."""
    freq, octs, lac, off, gain = 1.3, 9, 2.5, 1.0, 0.8
    vx, vy, vz = (points[:, k].copy() for k in range(3))
    value, weight, f = np.zeros(len(points)), np.ones(len(points)), freq
    for _ in range(octs):
        s = off - np.abs(onoise.raw_noise_3d(vx, vy, vz))
        s = s * s * weight
        weight = np.clip(s * gain, 0, 1)
        value = value + s * math.pow(f, -0.05)
        vx, vy, vz, f = vx * lac, vy * lac, vz * lac, f * lac
    ref = value * 1.25 - 1.0
    x, y, z = (_t(points[:, k], torch.float64) for k in range(3))
    ours = tnoise.ridged_mf(x, y, z, tnoise.ridged_weights(
        freq, octs, lac, dtype=np.float64), lac, off, gain).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_fastfloor_at_non_positive_integers():
    x = torch.tensor([0.0, -0.0, -1.0, -2.0, -3.5, 1.0, 2.0, 0.5, -0.5],
                     dtype=torch.float32)
    ours = tnoise.fastfloor(x).tolist()
    ref = np.asarray(jnoise.fastfloor(jnp.asarray(x.numpy()))).tolist()
    assert ours == ref == [-1, -1, -2, -3, -4, 1, 2, 0, -1]


def test_atan_within_one_ulp_of_kernel_minimax():
    x = np.concatenate([np.linspace(-30, 30, 20001),
                        [0.0, -0.0, 0.41421357, 2.4142137, 1e-30, -1e30,
                         np.inf, -np.inf]]).astype(np.float32)
    ours = tm.atan_f32(_t(x)).numpy()
    ref = np.asarray(pn.atan_f32(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(ours, ref, maxulp=1)


def test_atan2_within_one_ulp_of_kernel_minimax():
    rng = np.random.default_rng(3)
    y = rng.uniform(-5, 5, 5000).astype(np.float32)
    x = rng.uniform(-5, 5, 5000).astype(np.float32)
    x[::17] = 0.0
    y[::29] = 0.0
    ours = tm.atan2_f32(_t(y), _t(x)).numpy()
    ref = np.asarray(pn.atan2_f32(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_array_max_ulp(ours, ref, maxulp=1)


def test_hash3_i32_bit_exact():
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(11)
    special = np.array([0, 1, -1, i32.min, i32.max, i32.min + 1, 97,
                        -1640531527, 1013904223, 1 << 30], np.int32)
    bx = np.concatenate([special, rng.integers(i32.min, i32.max, 4000,
                                               dtype=np.int32)])
    by = np.roll(bx, 3)
    bz = np.roll(bx, 7)
    ours = trender.hash3_i32(_t(bx, torch.int32), _t(by, torch.int32),
                             _t(bz, torch.int32)).numpy()
    ref = np.asarray(jrender.hash3_i32(jnp.asarray(bx), jnp.asarray(by),
                                       jnp.asarray(bz)))
    np.testing.assert_array_equal(ours, ref.astype(np.int64))
    # abs keeps INT_MIN negative; % is a floor modulo
    h = np.concatenate([special, ref]).astype(np.int32)
    a = trender.abs_i32(_t(h, torch.int64))
    np.testing.assert_array_equal(a.numpy(), np.asarray(jnp.abs(jnp.asarray(h))))
    for m in (8192, 10, 7, 1):
        np.testing.assert_array_equal(
            torch.remainder(a, m).numpy(),
            np.asarray(jnp.abs(jnp.asarray(h)) % jnp.int32(m)))
        np.testing.assert_array_equal(
            torch.remainder(a >> 8, m).numpy(),
            np.asarray((jnp.abs(jnp.asarray(h)) >> 8) % jnp.int32(m)))
    assert jax.numpy.abs(jnp.int32(i32.min)) < 0  # the case under test


def test_noise_probe_plain_is_the_three_functions(points):
    p = torch.as_tensor(points.astype(np.float32))
    sw = tnoise.ridged_weights(1.3, 9)
    out = tnoise.noise_probe(p, 10, 0.7, 0.35, sw, 2.5, 1.0, 0.8)
    assert out.shape == (512, 3) and tnoise.noise_probe.launch_count == 0
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    torch.testing.assert_close(out[:, 0], tnoise.raw_noise_3d(x, y, z),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        out[:, 1], tnoise.octave_noise_3d(10, 0.7, 0.35, x, y, z),
        rtol=0, atol=0)
    torch.testing.assert_close(
        out[:, 2], tnoise.ridged_mf(x, y, z, sw, 2.5, 1.0, 0.8), rtol=0,
        atol=0)


# ---------------------------------------------------------------------------
# the perlin and iq backends, and the 2-D half of the Noise interface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_points():
    """Points over the range the march reaches (ridged coordinates grow by
    2.5 per octave), with exact integers and negatives among them."""
    rng = np.random.default_rng(13)
    p = rng.uniform(-60.0, 60.0, size=(1024, 3))
    p[:32] = np.round(p[:32])
    return p


def _perlin_chunks():
    """The packed permutation as the Pallas kernel's four lane chunks."""
    pp = jalt.perlin_packed_tables(94)
    return tuple(jnp.asarray(np.broadcast_to(pp[c * 128:(c + 1) * 128],
                                             (8, 128)).copy())
                 for c in range(4))


def _pallas_alt_eager(fn, x, y, z):
    tiles = [jnp.asarray(v.reshape(8, 128)) for v in (x, y, z)]
    with jax.disable_jit():
        return np.asarray(fn(*tiles)).reshape(-1)


def test_grad_hash_matches_jax_on_every_index():
    idx = np.arange(-3, 2 * 1024 + 5)
    ours = talt.grad_hash_q(torch.as_tensor(idx))
    ref = jalt._grad_hash_q(idx, 94)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    assert talt.PERLIN_DEFAULT_SEEDK == jalt.PERLIN_DEFAULT_SEEDK
    assert (talt.GRAD_HASH_M1, talt.GRAD_HASH_M2) == (jalt.GRAD_HASH_M1,
                                                      jalt.GRAD_HASH_M2)


def test_perlin_raw_f32_bit_equal_to_jax(wide_points):
    x, y, z = _xyz32(wide_points)
    ours = talt.perlin_raw_3d(_t(x), _t(y), _t(z)).numpy()
    ref = np.asarray(jalt.perlin_raw_3d(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(z)))
    np.testing.assert_array_equal(ours, ref)
    chunks = _perlin_chunks()
    kern = _pallas_alt_eager(
        lambda a, b, c: pn.perlin_raw_3d(chunks, a, b, c), x, y, z)
    np.testing.assert_array_equal(ours, kern)
    assert float(np.abs(ours).max()) > 0.1


def test_perlin_combinators_f32_bit_equal_to_kernel_twin(wide_points):
    """octave_noise_3d and ridged_mf over the perlin backend, against the
    kernel's device functions evaluated op by op."""
    x, y, z = _xyz32(wide_points / 20.0)
    chunks = _perlin_chunks()
    raw = lambda a, b, c: pn.perlin_raw_3d(chunks, a, b, c)  # noqa: E731
    ours = tnoise.octave_noise_3d(9, 0.6, 0.35, _t(x), _t(y), _t(z),
                                  talt.perlin_raw_3d).numpy()
    kern = _pallas_alt_eager(
        lambda a, b, c: pn.octave_noise_3d(None, 9, jnp.float32(0.6),
                                           jnp.float32(0.35), a, b, c,
                                           raw_fn=raw), x, y, z)
    np.testing.assert_array_equal(ours, kern)
    sw = tnoise.ridged_weights(1.3, 9)
    ours = tnoise.ridged_mf(_t(x), _t(y), _t(z), sw, 2.5, 1.0, 0.8,
                            talt.perlin_raw_3d).numpy()
    kern = _pallas_alt_eager(
        lambda a, b, c: pn.ridged_mf(None, a, b, c,
                                     [jnp.float32(w) for w in sw], 2.5,
                                     jnp.float32(1.0), jnp.float32(0.8),
                                     raw_fn=raw), x, y, z)
    np.testing.assert_array_equal(ours, kern)


def test_perlin_f64_matches_oracle(wide_points):
    """The lattice algorithm against the oracle's fixed-table twin, fed the
    JAX package's seed-94 tables: exact in f64 (integer work and the same
    lerps)."""
    p = wide_points
    x, y, z = (_t(p[:, k], torch.float64) for k in range(3))
    perm, g3 = jalt._perlin_tables(94)
    np.testing.assert_allclose(
        talt.perlin_raw_3d(x, y, z).numpy(),
        oalt.perlin_raw_3d(perm, g3, p[:, 0], p[:, 1], p[:, 2]),
        rtol=0, atol=1e-12)
    perm2, g2 = jalt._perlin_tables2(94)
    np.testing.assert_allclose(
        talt.perlin_raw_2d(x, y).numpy(),
        oalt.perlin_raw_2d(perm2, g2, p[:, 0], p[:, 1]), rtol=0, atol=1e-12)
    ref2 = jalt.perlin_raw_2d(jnp.asarray(p[:, 0], jnp.float32),
                              jnp.asarray(p[:, 1], jnp.float32))
    np.testing.assert_array_equal(
        talt.perlin_raw_2d(_t(p[:, 0]), _t(p[:, 1])).numpy(), np.asarray(ref2))


def test_iq_f64_matches_oracle(wide_points):
    """1e-12: torch's sine and numpy's may differ in the last ulp, which the
    x753.5453123 hash amplifies (the bound oracle/altnoise.py documents)."""
    p = wide_points
    x, y, z = (_t(p[:, k], torch.float64) for k in range(3))
    np.testing.assert_allclose(
        talt.iq_value_noise_3d(x, y, z).numpy(),
        oalt.iq_noise(p[:, 0], p[:, 1], p[:, 2]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        talt.iq_value_noise_2d(x, y).numpy(),
        oalt.iq_raw_2d(p[:, 0], p[:, 1]), rtol=0, atol=1e-12)


def test_iq_f32_close_to_jax_away_from_hash_wraps(wide_points):
    """In f32 the argument of the sine reaches the thousands, where one ulp
    is ~1e-4 before the multiply by 753.5: a corner whose hash sits next to
    a wrap of the fraction may land on its other side. At least 99 % of the
    points agree with ops.altnoise within 2e-4 and the mean difference is
    below 1e-4; the rest are single corner hashes that wrapped."""
    x, y, z = _xyz32(wide_points)
    ours = talt.iq_value_noise_3d(_t(x), _t(y), _t(z)).numpy()
    ref = np.asarray(jalt.iq_value_noise_3d(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(z)))
    d = np.abs(ours - ref)
    assert float((d <= 2e-4).mean()) >= 0.99
    assert float(d.mean()) < 1e-4
    assert 0.0 <= float(ours.min()) and float(ours.max()) < 1.0 + 1e-6


def test_simplex_2d_and_offset_octaves_f64_match_oracle(points):
    x, y, z = (_t(points[:, k], torch.float64) for k in range(3))
    px, py, pz = (points[:, k] for k in range(3))
    np.testing.assert_allclose(tnoise.raw_noise_2d(x, y).numpy(),
                               onoise.raw_noise_2d(px, py), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tnoise.octave_noise_2d(6, 0.7, 0.35, x, y).numpy(),
        onoise.octave_noise_2d(6, 0.7, 0.35, px, py), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tnoise.offset_octave_noise_3d(6, 0.7, 0.35, x, y, z).numpy(),
        onoise.offset_octave_noise_3d(6, 0.7, 0.35, px, py, pz),
        rtol=0, atol=1e-12)
    # f32 against the JAX ops
    x32, y32, _ = _xyz32(points)
    np.testing.assert_allclose(
        tnoise.raw_noise_2d(_t(x32), _t(y32)).numpy(),
        np.asarray(jnoise.raw_noise_2d(jnp.asarray(x32), jnp.asarray(y32))),
        rtol=0, atol=1e-6)
    # the 2-D combinator over another raw backend, against a loop over the
    # oracle's perlin (f64: in f32 perlin's t = v + 4096 quantises the cell
    # offset to 2^-11, so a fused multiply-add upstream moves single values)
    perm2, g2 = jalt._perlin_tables2(94)
    ref, freq, amp, max_amp = 0.0, 0.4, 1.0, 0.0
    for _ in range(5):
        ref = ref + oalt.perlin_raw_2d(perm2, g2, px * freq, py * freq) * amp
        freq, max_amp, amp = freq * 2.0, max_amp + amp, amp * 0.6
    np.testing.assert_allclose(
        tnoise.octave_noise_2d(5, 0.6, 0.4, x, y, talt.perlin_raw_2d).numpy(),
        ref / max_amp, rtol=0, atol=1e-12)


def test_resolve_raw_names_the_three_backends():
    assert tnoise.resolve_raw(None) is tnoise.raw_noise_3d
    assert tnoise.resolve_raw("simplex") is tnoise.raw_noise_3d
    assert tnoise.resolve_raw("perlin") is talt.perlin_raw_3d
    assert tnoise.resolve_raw("iq") is talt.iq_value_noise_3d
    with pytest.raises(ValueError, match="gabor"):
        tnoise.resolve_raw("gabor")
    with pytest.raises(ValueError, match="gabor"):
        jnoise.resolve_raw("gabor")


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
def test_noise_probe_plain_takes_every_kind(points, kind):
    p = torch.as_tensor(points.astype(np.float32))
    sw = tnoise.ridged_weights(1.3, 5)
    out = tnoise.noise_probe(p, 6, 0.7, 0.35, sw, 2.5, 1.0, 0.8, kind)
    raw_fn = tnoise.resolve_raw(kind)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    assert tnoise.noise_probe.launch_count == 0
    torch.testing.assert_close(out[:, 0], raw_fn(x, y, z), rtol=0, atol=0)
    torch.testing.assert_close(
        out[:, 1], tnoise.octave_noise_3d(6, 0.7, 0.35, x, y, z, raw_fn),
        rtol=0, atol=0)
    torch.testing.assert_close(
        out[:, 2], tnoise.ridged_mf(x, y, z, sw, 2.5, 1.0, 0.8, raw_fn),
        rtol=0, atol=0)
    table = tnoise.noise_table(kind, "cpu")
    assert table.dtype == torch.int32
    # the paired tables of csrc/noise.cuh (iq reads none and is handed the
    # simplex one); perlin's paired permutation is followed by its 1024
    # float4 gradients
    assert table.numel() == (
        tnoise.PERLIN_PERM_WORDS + 4 * tnoise.PERLIN_GRADS
        if kind == "perlin" else 1024)
    with pytest.raises(ValueError, match="gabor"):
        tnoise.noise_probe(p, 6, 0.7, 0.35, sw, 2.5, 1.0, 0.8, "gabor")

