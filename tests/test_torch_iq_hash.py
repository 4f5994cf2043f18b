"""The iq hash table's domain and layout, on the CPU.

The iq kernels (csrc/noise.cuh) read h(n) = frac(sinf(n) * 753.5453123)
from a table of pairs (h(n), h(n + 1)) for every integer |n| <=
IQ_TABLE_R, pair j at n = j - IQ_TABLE_R, and a raw evaluation's eight
corners n + (0, 1, 157, 158, 113, 114, 270, 271) from the pairs at
n + (0, 157, 113, 270); other arguments take the sines. Here: every
preset's hash arguments are integers inside the table (R read from the
port's constant, so a preset that outgrows the table fails here), the
scene the card's fallback gate uses reaches past it, the port's
constants hold the kernel's numbers, and the port's plain table indexed
as the kernels index it gives the plain noise of ops/altnoise.py at all
eight corners. The card checks the table and the kernels' own corner
reads bit for bit (chip_smoke.py, tests/test_torch_cuda.py).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.ops import altnoise  # noqa: E402
from gamer_tpu_torch.ops import noise as tnoise  # noqa: E402

SIZE = 16
PRESETS = ["spiral", "barred_spiral", "elliptical", "irregular", "dusty_disk",
           "ring", "flocculent"]
# a raw evaluation's eight corners, as iq_raw_3d hashes them
CORNERS = (0, 1, 157, 158, 113, 114, 270, 271)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain march runs thousands of small torch ops; one intra-op
    thread keeps each worker of the parallel test run at its own pace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _census(scene, keep=False):
    page, table, size, _ = cr.prepare(scene, "cpu")
    with tnoise.iq_census(keep) as got:
        cr.march_plain(page, table, size)
    return got


@pytest.mark.parametrize("name", PRESETS)
def test_every_preset_hashes_inside_the_table(name):
    got = _census(cs.spiral_scene(SIZE, getattr(presets, name)(),
                                  noise_kind="iq"))
    assert got["evaluations"] > 0
    assert got["non_integer"] == 0
    assert got["outside"] == 0 and got["max_abs"] <= tnoise.IQ_TABLE_R, got


def test_the_fallback_scene_reaches_past_the_table():
    """chip_smoke.iq_far_scene, which the card holds against the plain
    version to run the fallback: some arguments pass R, all integers."""
    got = _census(cs.iq_far_scene(SIZE))
    assert got["non_integer"] == 0
    assert got["outside"] > 0 and got["max_abs"] > tnoise.IQ_TABLE_R, got


def test_port_constants_are_the_kernels():
    """The numbers csrc/noise.cuh holds (the card's fill refuses any other
    count of pairs, and its exhaustive check reads the corners through the
    kernels' own iq_corners)."""
    assert tnoise.IQ_TABLE_R == 1 << 20
    assert tnoise.IQ_TABLE_PAIRS == 2 * tnoise.IQ_TABLE_R + 271
    assert tnoise.IQ_CORNER_PAIRS == (0, 157, 113, 270)


def test_table_layout_gives_the_eight_corners():
    """The port's table (iq_hash_table_plain, to which the card's fill is
    held bit for bit) read at n + IQ_TABLE_R + IQ_CORNER_PAIRS, for the
    spiral's own hash arguments and the ends of the range: the pairs'
    halves are the plain iq noise of ops/altnoise.py at the cell's eight
    corners n + (0, 1, 157, 158, 113, 114, 270, 271) (at an integer point
    the noise is its hash). The plain noise is taken over the table's
    whole range at once, so that torch's sine takes the same code for
    each element as in the table."""
    r = tnoise.IQ_TABLE_R
    table = tnoise.iq_hash_table_plain("cpu")
    assert table.shape == (tnoise.IQ_TABLE_PAIRS, 2)
    m = torch.arange(-r, r + 272, dtype=torch.float32)
    zero = torch.zeros_like(m)
    hash_at = altnoise.iq_value_noise_3d(m, zero, zero)  # [n + r]: h(n)
    got = _census(cs.spiral_scene(SIZE, noise_kind="iq"), keep=True)
    ns = np.concatenate([got["arguments"],
                         np.float32([-r, -r + 1, -1, 0, 1, r - 1, r])])
    assert len(ns) > 1000 and np.all(np.abs(ns) <= r)
    idx = torch.from_numpy(ns.astype(np.int64) + r)
    pairs = torch.stack([table[idx + o] for o in tnoise.IQ_CORNER_PAIRS],
                        dim=1).reshape(len(ns), 8)
    want = torch.stack([hash_at[idx + c] for c in CORNERS], dim=1)
    np.testing.assert_array_equal(pairs.numpy().view(np.int32),
                                  want.numpy().view(np.int32))


def test_the_table_lives_on_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        tnoise.iq_hash_table("cpu")
    # the CPU's iq table stays the valid pointer it was (unread there)
    np.testing.assert_array_equal(tnoise.noise_table("iq", "cpu").numpy(),
                                  tnoise.kernel_noise_table("simplex"))
