"""The perlin kernels' gradient table, on the CPU.

The perlin kernels (csrc/noise.cuh) read each lattice corner's decoded
gradient from a table of 1,024 float4 (gx, gy, gz, 0) that follows the
paired permutation in the perlin kernel table
(``ops/noise.py::kernel_noise_table("perlin")``), in place of the gradient
hash and its int->float decode. Here: the table in that layout holds, bit
for bit, the decode of the port's ``grad_hash_q`` and of the TPU kernel's
``_perlin_grad_dot`` (plain jnp, unit offsets, which return each component
exactly); and a torch twin of the kernels' raw evaluation, which indexes
the paired permutation and the table as the kernels do, equals the plain
``altnoise.perlin_raw_3d`` (which rehashes) and the TPU kernel's
``pallas_noise.perlin_raw_3d`` bit for bit. The card checks the staged
table against the kernels' own hash (chip_smoke.perlin_grad_check,
tests/test_torch_cuda.py).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gamer_tpu.ops import altnoise as jalt  # noqa: E402
from gamer_tpu.ops import pallas_noise as pn  # noqa: E402

from gamer_tpu_torch.ops import altnoise as talt  # noqa: E402
from gamer_tpu_torch.ops import noise as tnoise  # noqa: E402

N_GRADS = tnoise.PERLIN_GRADS
N_POINTS = 4096


def _kernel_layout():
    """(paired permutation (1024,) int64, gradients (1024, 4) float32) as
    the perlin kernels read them from their table."""
    q, g = tnoise.split_perlin_table(tnoise.kernel_noise_table("perlin"))
    return q.astype(np.int64), g


def _hash_decode(idx):
    """The plain noise's decode of grad_hash_q(idx): (N, 3) float32."""
    qs = talt.grad_hash_q(torch.as_tensor(idx))
    return torch.stack([(q.to(torch.float32) - talt._GRAD_MID)
                        * talt._GRAD_INV for q in qs], dim=1).numpy()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_table_layout_decodes_to_the_gradient_hash():
    tab = tnoise.kernel_noise_table("perlin")
    assert tab.dtype == np.int32
    assert tab.shape == (tnoise.PERLIN_PERM_WORDS + 4 * N_GRADS,)
    _, g = _kernel_layout()
    np.testing.assert_array_equal(_bits(g[:, :3]),
                                  _bits(_hash_decode(np.arange(N_GRADS))))
    assert (_bits(g[:, 3]) == 0).all()
    np.testing.assert_array_equal(tnoise.perlin_grad_table(), g)
    on_dev = tnoise.noise_table("perlin", "cpu")
    assert on_dev.dtype == torch.int32
    np.testing.assert_array_equal(on_dev.numpy(), tab)
    # every component is one of the 1,024 decodes of a 10-bit field
    assert np.abs(g[:, :3]).max() <= 1.0 and (g[:, :3] != 0).all()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_table_equals_the_tpu_kernels_gradient_dot(axis):
    """pallas_noise._perlin_grad_dot as plain jnp at a unit offset returns
    the axis's component exactly (1 * g + 0 * g' + 0 * g''), for every
    lattice index a corner can take (b + bz in [0, 2046], wrapped by
    & 1023 into the table)."""
    idx = np.arange(2 * N_GRADS, dtype=np.int32)
    unit = [jnp.zeros(idx.shape, jnp.float32) for _ in range(3)]
    unit[axis] = jnp.ones(idx.shape, jnp.float32)
    with jax.disable_jit():
        got = np.asarray(pn._perlin_grad_dot(jnp.asarray(idx), *unit))
    _, g = _kernel_layout()
    np.testing.assert_array_equal(_bits(got), _bits(g[idx & 1023, axis]))


def _points(seed):
    """N_POINTS float32 points: uniform, negatives, coordinates at the
    -4096 edge of the setup macro's truncation (both sides), exact
    integers, lattice wraps at 1023 -> 0, and large magnitudes."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-60.0, 60.0, (N_POINTS, 3))
    k = N_POINTS // 8
    p[k:2 * k] = -4096.0 + rng.uniform(-2.0, 2.0, (k, 3))
    p[2 * k:3 * k] = np.round(rng.uniform(-600.0, 600.0, (k, 3)))
    p[3 * k:4 * k] = (1023.0 - 4096.0 + 1024.0 * rng.integers(-2, 5, (k, 3))
                      + rng.uniform(0.0, 0.999, (k, 3)))
    p[4 * k:5 * k] = rng.uniform(-1e6, 1e6, (k, 3))
    p[5 * k:6 * k] = rng.choice([-1.0, 1.0], (k, 3)) * rng.uniform(
        1e7, 1e8, (k, 3))
    p[6 * k:] = rng.uniform(-3000.0, 3000.0, (N_POINTS - 6 * k, 3))
    return p.astype(np.float32)


def _perlin_raw_tabled(x, y, z):
    """The kernels' perlin_raw_3d in torch ops: the setup macro, the paired
    permutation's three loads and each corner's gradient read from the
    table, the dot and the lerps in the kernels' order."""
    q, g = (torch.as_tensor(a) for a in _kernel_layout())
    bx0, _, rx0, rx1 = talt._setup(x)
    by0, _, ry0, ry1 = talt._setup(y)
    bz0, bz1, rz0, rz1 = talt._setup(z)
    qx = q[bx0]
    i, j = qx & 0xFFFF, qx >> 16
    qi, qj = q[(i + by0) & 1023], q[(j + by0) & 1023]
    b00, b01 = qi & 0xFFFF, qi >> 16
    b10, b11 = qj & 0xFFFF, qj >> 16

    def dot(idx, rx, ry, rz):
        gg = g[idx & 1023]
        return rx * gg[..., 0] + ry * gg[..., 1] + rz * gg[..., 2]

    lerp, s_curve = talt._lerp, talt._s_curve
    t, sy, sz = s_curve(rx0), s_curve(ry0), s_curve(rz0)
    a = lerp(t, dot(b00 + bz0, rx0, ry0, rz0), dot(b10 + bz0, rx1, ry0, rz0))
    b = lerp(t, dot(b01 + bz0, rx0, ry1, rz0), dot(b11 + bz0, rx1, ry1, rz0))
    c = lerp(sy, a, b)
    a = lerp(t, dot(b00 + bz1, rx0, ry0, rz1), dot(b10 + bz1, rx1, ry0, rz1))
    b = lerp(t, dot(b01 + bz1, rx0, ry1, rz1), dot(b11 + bz1, rx1, ry1, rz1))
    d = lerp(sy, a, b)
    return 2.0 * lerp(sz, c, d)


def _pallas_perlin(p):
    """pallas_noise.perlin_raw_3d op by op (no jit, so no fusion) on
    (N_POINTS / 128, 128) tiles, with the packed permutation as its four
    lane chunks."""
    rows = N_POINTS // 128
    pp = jalt.perlin_packed_tables(94)
    chunks = tuple(jnp.asarray(np.broadcast_to(pp[c * 128:(c + 1) * 128],
                                               (rows, 128)).copy())
                   for c in range(4))
    tiles = [jnp.asarray(p[:, k].reshape(rows, 128)) for k in range(3)]
    with jax.disable_jit():
        return np.asarray(pn.perlin_raw_3d(chunks, *tiles)).reshape(-1)


@pytest.mark.parametrize("seed", [5, 21])
def test_tabled_raw_evaluation_is_bit_equal(seed):
    p = _points(seed)
    x, y, z = (torch.as_tensor(p[:, k]) for k in range(3))
    got = _perlin_raw_tabled(x, y, z).numpy()
    plain = talt.perlin_raw_3d(x, y, z).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(_pallas_perlin(p)))
    # the point set reaches negative cells, the 1023 wrap and both sides
    # of the -4096 edge
    t = p + np.float32(4096.0)
    assert (t < 0).any() and (t > 0).any() and (p < 0).any()
    assert (np.trunc(t).astype(np.int64) % 1024 == 1023).any()
    assert float(np.abs(got).max()) > 0.1
