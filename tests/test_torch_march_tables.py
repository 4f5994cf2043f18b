"""The march kernels' host-built noise tables and launch geometry, on the
CPU: the paired tables decode back to the permutations they come from, a
numpy emulation of csrc/noise.cuh's shortened lookup chains gives the same
gradient indices as the reference's chains on 10^5 points, and the
persistent launch's tiles cover every ray of a frame, a band, a batch and a
ray list exactly once. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.ops import noise as tnoise  # noqa: E402
from gamer_tpu_torch.ops.altnoise import perlin_tables  # noqa: E402
from gamer_tpu_torch.ops.tables import PERM  # noqa: E402

f32 = np.float32
N_POINTS = 100_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread under the parallel test run (see
    tests/test_torch_allsky.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lo(w):
    return w & 0xFFFF


def _hi(w):
    return w >> 16


def test_simplex_tables_decode_to_perm():
    tab = tnoise.kernel_noise_table("simplex")
    assert tab.dtype == np.int32 and tab.shape == (1024,)
    p2, gi = tab[:512], tab[512:]
    np.testing.assert_array_equal(_lo(p2), PERM)
    np.testing.assert_array_equal(_hi(p2), np.roll(PERM, -1))
    np.testing.assert_array_equal(gi, PERM % 12)
    on_dev = tnoise.noise_table("simplex", "cpu")
    assert on_dev.dtype == torch.int32
    np.testing.assert_array_equal(on_dev.numpy(), tab)
    # iq stages nothing; it is handed the simplex table as a valid pointer
    np.testing.assert_array_equal(tnoise.noise_table("iq", "cpu").numpy(), tab)


def test_perlin_table_decodes_to_seed94_permutation():
    perm = perlin_tables()[0]
    tab = tnoise.kernel_noise_table("perlin")
    # the paired permutation, then the gradient table's 1024 float4
    # (tests/test_torch_perlin_grad.py)
    assert tab.dtype == np.int32 and tab.shape == (
        tnoise.PERLIN_PERM_WORDS + 4 * tnoise.PERLIN_GRADS,)
    q, _ = tnoise.split_perlin_table(tab)
    np.testing.assert_array_equal(_lo(q), perm)
    np.testing.assert_array_equal(_hi(q), perm[(np.arange(1024) + 1) & 1023])
    with pytest.raises(ValueError, match="gabor"):
        tnoise.noise_table("gabor", "cpu")


def _points(rng, scale):
    """N_POINTS float32 points: uniform, negatives, exact integers and
    coordinates at the 255/256 lattice edge."""
    p = rng.uniform(-scale, scale, (N_POINTS, 3)).astype(f32)
    n = N_POINTS // 8
    p[:n] = np.round(p[:n])                                   # integers
    edge = np.array([255.0, 256.0, -256.0, -255.0, 511.0, 512.0, -1.0, 0.0],
                    f32)
    p[n:2 * n] = rng.choice(edge, (n, 3)) + rng.choice(
        np.array([0.0, 1e-3, -1e-3, 0.5], f32), (n, 3))
    return p


def _fastfloor(v):
    t = np.trunc(v)
    return np.where(v > 0, t, t - f32(1.0)).astype(np.int64)


def test_simplex_index_chain_matches_the_reference_chain():
    """noise.cuh's 7-load chain (P2, then two P2, then four GI) against
    PERM[ii + a + PERM[jj + b + PERM[kk + c]]] % 12 on the corners the skew
    of each point picks, with the kernel's float32 skew."""
    rng = np.random.default_rng(11)
    p = _points(rng, 600.0)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    third, sixth = f32(1.0 / 3.0), f32(1.0 / 6.0)
    s = (x + y + z) * third
    i, j, k = _fastfloor(x + s), _fastfloor(y + s), _fastfloor(z + s)
    t = (i + j + k).astype(f32) * sixth
    x0 = x - (i.astype(f32) - t)
    y0 = y - (j.astype(f32) - t)
    z0 = z - (k.astype(f32) - t)
    A, B, C = x0 >= y0, y0 >= z0, x0 >= z0
    i1 = (A & (B | C)).astype(np.int64)
    j1 = (~A & B).astype(np.int64)
    k1 = ((A & ~B & ~C) | (~A & ~B)).astype(np.int64)
    i2 = (A | (B & C)).astype(np.int64)
    j2 = (~A | B).astype(np.int64)
    k2 = ((A & ~B) | (~A & (~B | ~C))).astype(np.int64)
    ii, jj, kk = i & 255, j & 255, k & 255
    assert (i < 0).any() and (ii == 255).any() and (kk == 0).any()

    perm = PERM.astype(np.int64)
    want = [perm[ii + a + perm[jj + b + perm[kk + c]]] % 12
            for a, b, c in ((0, 0, 0), (i1, j1, k1), (i2, j2, k2), (1, 1, 1))]

    tab = tnoise.kernel_noise_table("simplex").astype(np.int64)
    gi = tab[512:]
    pk = tab[kk]
    pj0, pj1 = tab[jj + _lo(pk)], tab[jj + _hi(pk)]
    q1, q2 = np.where(k1 == 1, pj1, pj0), np.where(k2 == 1, pj1, pj0)
    got = [gi[ii + _lo(pj0)],
           gi[ii + i1 + np.where(j1 == 1, _hi(q1), _lo(q1))],
           gi[ii + i2 + np.where(j2 == 1, _hi(q2), _lo(q2))],
           gi[ii + 1 + _hi(pj1)]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_perlin_index_chain_matches_the_reference_chain():
    """noise.cuh's 3 paired loads against the 6 loads of perlin.cpp's
    lattice hashes, with the setup() macro's truncation and & 1023 wrap."""
    rng = np.random.default_rng(12)
    p = _points(rng, 3000.0)
    # cells at the 1023 -> 0 wrap: t = v + 4096 with trunc(t) & 1023 == 1023
    n = N_POINTS // 8
    p[2 * n:3 * n] = (f32(1023.0 - 4096.0) + 1024.0 * rng.integers(
        -2, 5, (n, 3)) + rng.uniform(0.0, 0.999, (n, 3))).astype(f32)
    perm = perlin_tables()[0].astype(np.int64)
    q = tnoise.split_perlin_table(
        tnoise.kernel_noise_table("perlin"))[0].astype(np.int64)

    def setup(v):
        it = np.trunc(v + f32(4096.0)).astype(np.int64)
        b0 = it & 1023
        return b0, (b0 + 1) & 1023

    (bx0, bx1), (by0, by1) = setup(p[:, 0]), setup(p[:, 1])
    assert (bx0 == 1023).any() and (by0 == 1023).any()
    i, j = perm[bx0], perm[bx1]
    want = (i, j, perm[(i + by0) & 1023], perm[(j + by0) & 1023],
            perm[(i + by1) & 1023], perm[(j + by1) & 1023])
    qx = q[bx0]
    gi, gj = _lo(qx), _hi(qx)
    qi, qj = q[(gi + by0) & 1023], q[(gj + by0) & 1023]
    got = (gi, gj, _lo(qi), _lo(qj), _hi(qi), _hi(qj))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _frame_tile_pixels(t, frame_size, rows):
    """The kernel's decode of frame tile t: (frame, row, col) of each lane
    and whether the lane is inside the rows and the frame."""
    tiles_x = -(-frame_size // cr.TILE_W)
    per_frame = tiles_x * -(-rows // cr.TILE_H)
    f = t // per_frame
    rem = t - f * per_frame
    ty = rem // tiles_x
    lane = np.arange(cr.WARP)
    row = ty * cr.TILE_H + lane // cr.TILE_W
    col = (rem - ty * tiles_x) * cr.TILE_W + lane % cr.TILE_W
    return f, row, col, (row < rows) & (col < frame_size)


def _pull_tiles(grid, block_warps, n_tiles):
    """The tiles each warp of a persistent launch takes from the counter,
    warps taking turns; every warp takes one value past the end."""
    counter, taken = 0, []
    live = list(range(grid * block_warps))
    while live:
        for w in list(live):
            t = counter
            counter += 1
            if t >= n_tiles:
                live.remove(w)
            else:
                taken.append(t)
    assert counter == n_tiles + grid * block_warps
    return taken


@pytest.mark.parametrize("frame_size,rows,n_frames,blocks_per_sm", [
    (512, 512, 1, 3),      # the still
    (100, 100, 1, 4),      # not a multiple of the tile
    (100, 48, 1, 3),       # a band of 48 rows (past the frame at row0 80)
    (512, 32, 1, 3),       # one band of the progressive 512^2 frame
    (100, 100, 3, 2),      # a batch of 3 frames at size 100
    (64, 64, 8, 8),        # more warps than tiles
])
def test_frame_tiles_cover_every_pixel_once(frame_size, rows, n_frames,
                                            blocks_per_sm):
    n_tiles = cr.frame_tiles(frame_size, rows, n_frames)
    grid = cr.persistent_grid(blocks_per_sm, 132, n_tiles, 8)
    assert 1 <= grid <= blocks_per_sm * 132
    assert grid * 8 <= n_tiles + 7 or grid == blocks_per_sm * 132
    hits = np.zeros((n_frames, rows, frame_size), np.int64)
    for t in _pull_tiles(grid, 8, n_tiles):
        f, row, col, ok = _frame_tile_pixels(t, frame_size, rows)
        assert 0 <= f < n_frames
        np.add.at(hits[f], (row[ok], col[ok]), 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("n_rays", [1, 31, 1000, 3 * 4096 + 5])
def test_ray_tiles_cover_every_ray_once(n_rays):
    n_tiles = cr.ray_tiles(n_rays)
    assert n_tiles == -(-n_rays // 32)
    grid = cr.persistent_grid(3, 132, n_tiles, 4)
    hits = np.zeros(n_rays, np.int64)
    for t in _pull_tiles(grid, 4, n_tiles):
        i = t * cr.WARP + np.arange(cr.WARP)
        np.add.at(hits, i[i < n_rays], 1)
    assert (hits == 1).all()


def test_persistent_grid_from_occupancy():
    # the card's resident blocks when the work fills them
    assert cr.persistent_grid(3, 132, 8192, 8) == 396
    # no more blocks than give each warp one tile
    assert cr.persistent_grid(3, 132, 512, 8) == 64
    assert cr.persistent_grid(4, 132, 1, 8) == 1
    # the progressive launch leaves spare blocks out of full residency
    assert cr.persistent_grid(3, 132, 8192, 8, spare=2) == 394
    assert cr.persistent_grid(3, 132, 512, 8, spare=2) == 64
