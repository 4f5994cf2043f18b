"""S1, S2 and S3 dealt across a mesh: entry i of n takes the tile rows
(``cuda_render.TILE_H`` rows each) i, i + n, i + 2n, ... of a frame (S1)
or of every frame of a batch (S2), or the ray list's 32-ray tiles i,
i + n, ... (S3), and its outputs are placed back into one frame, batch or
list on the mesh's first device.

The index arithmetic and the assembly run here with synthetic shares (each
element its own global index), so they cover every size; the plain march
checks the whole path at a few pixels. The dealt plain runs are held to the
unsharded plain run bit for bit in a child process with torch's scalar CPU
kernels (``ATEN_CPU_CAPABILITY=default``) and the power's exponent as a
tensor, as ``tests/test_torch_plain_reuse.py`` does, since torch's CPU
kernels compute a tensor's tail elements with other code. The JAX
comparisons of S1, S2 and S3 are in ``tests/test_torch_sharding.py`` and
``tests/test_torch_sharding_batch.py``; the kernels on the card in
``tests/test_torch_cuda.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402

ENTRIES = [1, 2, 3, 4, 8]
# meshes that name cards (no card is touched: a mesh is a list of devices)
CARD_MESHES = {
    "4 cards": ["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
    "4 x card 0": ["cuda:0"] * 4,
    "2 cards, 2 entries each": ["cuda:0", "cuda:0", "cuda:1", "cuda:1"],
    "2 cards in turn": ["cuda:0", "cuda:1"] * 3,
    "3 cards": ["cuda:1", "cuda:0", "cuda:2"],
}


@pytest.fixture(scope="module")
def page_table():
    """A prepared page and table (the synthetic shares ignore them)."""
    page, table, _, _ = cr.prepare(cs.spiral_scene(8), "cpu")
    return page, table


def _items(plan):
    return [first + stride * k for _, first, stride, count in plan
            for k in range(count)]


@pytest.mark.parametrize("n_items", [5, 10, 25, 125, 512])
@pytest.mark.parametrize("n", ENTRIES)
def test_deal_covers_every_item_once(n, n_items):
    """n CPU entries (each a card of its own): entry i owns the items i,
    i + n, ..., every item once; the shares differ by at most one, and
    min(n, items) entries own one."""
    plan = cr.deal_plan(Mesh(["cpu"] * n), n_items)
    assert sorted(_items(plan)) == list(range(n_items))
    assert [(i, first, stride) for i, first, stride, _ in plan] == [
        (i, i, n) for i in range(min(n, n_items))]
    counts = [count for *_, count in plan]
    assert counts == [cr.dealt(n_items, n, i) for i in range(len(plan))]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("n_items", [3, 25, 128, 512])
@pytest.mark.parametrize("mesh", list(CARD_MESHES))
def test_deal_plan_deals_cards_and_runs_within_a_card(mesh, n_items):
    """Card c of the distinct cards owns the items c, c + cards, ...; the
    entries that name one card split its items into contiguous runs in
    mesh order; every item once."""
    devices = CARD_MESHES[mesh]
    cards = list(dict.fromkeys(devices))
    plan = cr.deal_plan(Mesh(devices), n_items)
    assert sorted(_items(plan)) == list(range(n_items))
    for card_index, card in enumerate(cards):
        mine = [row for row in plan if devices[row[0]] == card]
        items = _items(mine)
        assert items == list(range(card_index, n_items, len(cards)))
        assert all(stride == len(cards) for _, _, stride, _ in mine)
        counts = [count for *_, count in mine] or [0]
        assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("size", [20, 40, 100, 2048])
def test_dealt_rows_cover_the_frame(size):
    """The rows the kernel marches for a share (tile row first + ty *
    stride, lane / TILE_W within it) over four cards are every row of the
    frame padded to whole tile rows, each once."""
    tile_rows = -(-size // cr.TILE_H)
    rows = [(first + ty * stride) * cr.TILE_H + lane // cr.TILE_W
            for _, first, stride, count in cr.deal_plan(
                Mesh(CARD_MESHES["4 cards"]), tile_rows)
            for ty in range(count) for lane in range(0, cr.WARP, cr.TILE_W)]
    assert sorted(rows) == list(range(tile_rows * cr.TILE_H))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("size", [20, 500])
@pytest.mark.parametrize("n_frames", [1, 3, 5])
def test_dealt_batch_covers_every_frame_tile_row_once(n_frames, size, n):
    """The dealt kernel's tile enumeration for a share of a stack (tile t:
    the launch's tile row t // (tiles_x * n_frames), then the frame, then
    the column; the frame's tile row first + ty * stride) over n entries:
    every (frame, tile row, tile col) of the batch once, each tile's
    output row in its entry's (n_frames, count * TILE_H) strip stack, and
    the launch's last tiles the last tile row of every frame."""
    tile_rows, tiles_x = -(-size // cr.TILE_H), -(-size // cr.TILE_W)
    seen = []
    for _, first, stride, count in cr.deal_plan(Mesh(["cpu"] * n),
                                                tile_rows):
        per_row = tiles_x * n_frames
        t = torch.arange(per_row * count)
        ty, r = t // per_row, t % per_row
        f, tx = r // tiles_x, r % tiles_x
        assert int(ty.max()) * cr.TILE_H + cr.TILE_H - 1 < count * cr.TILE_H
        assert torch.equal(f[-per_row:].unique(), torch.arange(n_frames))
        assert bool((ty[-per_row:] == count - 1).all())
        seen.append(torch.stack([f, first + ty * stride, tx], 1))
    seen = torch.cat(seen)
    key = (seen[:, 0] * tile_rows + seen[:, 1]) * tiles_x + seen[:, 2]
    assert torch.equal(key.sort().values,
                       torch.arange(n_frames * tile_rows * tiles_x))


def _strip_rows(first, stride, count):
    ty = first + stride * torch.arange(count)
    return (ty[:, None] * cr.TILE_H + torch.arange(cr.TILE_H)).reshape(-1)


@pytest.mark.parametrize("size", [20, 40, 100])
@pytest.mark.parametrize("n", ENTRIES)
def test_strip_assembly_is_the_identity(n, size, page_table):
    """Each entry returns its strips with every element its global row
    index; the assembled frame is the row index of every pixel: every row
    placed once, in its place."""
    page, table = page_table
    calls = []

    def strips(pg, tb, frame_size, first, stride, count):
        assert frame_size == size
        calls.append((first, stride, count))
        rows = _strip_rows(first, stride, count).float()
        return rows[:, None, None].expand(-1, size, 3).contiguous()

    mesh = Mesh(["cpu"] * n)
    got = cr._rowshard(strips, page, table, size, mesh)
    want = torch.arange(size).float()[:, None, None].expand(size, size, 3)
    assert got.shape == (size, size, 3) and torch.equal(got, want)
    assert calls == [row[1:] for row in cr.deal_plan(
        mesh, -(-size // cr.TILE_H))]


@pytest.mark.parametrize("n_frames", [1, 3, 5])
@pytest.mark.parametrize("mesh", [
    Mesh(["cpu"] * 2, ("batch",)),
    Mesh(["cpu"] * 3, ("batch",)),
    Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2)),
], ids=["1d-2", "1d-3", "2d-2x2"])
def test_batch_strip_assembly_is_the_identity(mesh, n_frames, page_table):
    """S2's assembly of a stack at size 20 (5 tile rows): each entry is
    called once with the whole stack, no pad frame, and returns its strips
    of every frame with each element its frame and global row; the
    assembled batch is every row of every frame once, in its place."""
    page, table = page_table
    size, calls = 20, []

    def strips(pg, tb, frame_size, first, stride, count):
        calls.append((pg.shape[0], first, stride, count))
        rows = _strip_rows(first, stride, count).float()
        frames = 1000 * torch.arange(pg.shape[0]).float()[:, None] + rows
        return frames[..., None, None].expand(-1, -1, size, 3).contiguous()

    pages = page[None].repeat(n_frames, 1)
    got = cr._rowshard(strips, pages, table, size, mesh)
    want = (1000 * torch.arange(n_frames).float()[:, None]
            + torch.arange(size).float())[..., None, None].expand(
                n_frames, size, size, 3)
    assert got.shape == (n_frames, size, size, 3) and torch.equal(got, want)
    assert calls == [(n_frames, *row[1:]) for row in cr.deal_plan(
        mesh, -(-size // cr.TILE_H))]


@pytest.mark.parametrize("n_rays", [11, 192, 1000, 3072])
@pytest.mark.parametrize("n", ENTRIES)
def test_ray_tile_assembly_is_the_identity(n, n_rays, page_table):
    """Each entry returns its dealt directions as its radiance; the
    assembled list is the input list: every ray placed once, in its
    place, the zero padding dropped."""
    page, table = page_table
    dirs = torch.arange(n_rays * 3, dtype=torch.float32).reshape(-1, 3) + 1
    shares = []

    def rays(pg, tb, d):
        assert d.shape[0] % cr.WARP == 0 and d.is_contiguous()
        shares.append(d.shape[0] // cr.WARP)
        return d.clone()

    mesh = Mesh(["cpu"] * n)
    got = cr._rays_rowshard(rays, page, table, dirs, mesh)
    assert got.shape == (n_rays, 3) and torch.equal(got, dirs)
    assert shares == [count for *_, count in cr.deal_plan(
        mesh, cr.ray_tiles(n_rays))]


def test_dealt_wrapper_arguments(page_table):
    page, table = page_table
    for bad in ((-1, 1, 1), (0, 0, 1), (0, 1, 0), (1 << 22, 1, 1)):
        for pages in (page, page[None].repeat(2, 1)):
            with pytest.raises(ValueError, match="dealt share"):
                cr.march_dealt(pages, table, 8, *bad)
    with pytest.raises(ValueError, match="2-D"):
        cr.march_dealt(page[None, None], table, 8, 0, 1, 1)
    assert cr.march_dealt.launch_count == 0  # no kernel on the CPU


CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
_pow = torch.pow


def pow_same_everywhere(x, e, *args, **kwargs):
    if isinstance(x, torch.Tensor) and not isinstance(e, torch.Tensor):
        e = torch.full_like(x, e)
    return _pow(x, e, *args, **kwargs)


torch.pow = pow_same_everywhere
sys.path.insert(0, sys.argv[1])
import dataclasses
import chip_smoke as cs
from gamer_tpu_torch.engine import cuda_render as cr
from gamer_tpu_torch.engine.allsky import allsky_dirs
from gamer_tpu_torch.engine.batch import _scene_groups
from gamer_tpu_torch.models import presets
from gamer_tpu_torch.parallel import Mesh
from gamer_tpu_torch.scene.cameracontrols import orbit_path


def differ(a, b):
    return -1 if a.shape != b.shape else int(
        (a.view(torch.int32) != b.view(torch.int32)).sum())


preview = dict(is_preview=True, noise_octaves=2)
out = {}
size = 12
page, table, _, _ = cr.prepare(cs.spiral_scene(size, **preview), "cpu")
want = cr.march_plain(page, table, size)
for n in (2, 4):
    out[f"S1 on {n}"] = differ(
        cr.march_rowshard(page, table, size, Mesh(["cpu"] * n)), want)
# S2: dusty_disk (the cheapest preset to march) at 8^2, 2 tile rows: the
# plain march's lockstep loop runs once per entry and frame, whatever its
# rays
scene = cs.spiral_scene(8, presets.dusty_disk(), **preview)
fly = [dataclasses.replace(scene, camera=c)
       for c in orbit_path(scene.camera, 3, horizontal_deg=120.0)]
st, pages, _ = _scene_groups(fly)[0]
pages = torch.as_tensor(pages)
tab = torch.as_tensor(cr._build_table(st, cr._build_layout(st)))
out["S2 3 frames on 2x2"] = differ(
    cr.march_batch_rowshard(pages, tab, 8,
                            Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2))),
    cr.march_batch_plain(pages, tab, 8))
sp, stb, _, _ = cr.prepare(cs.allsky_scene(**preview), "cpu")
dirs = torch.as_tensor(allsky_dirs(4))
out["S3 on 8"] = differ(cr.march_rays_rowshard(sp, stb, dirs,
                                               Mesh(["cpu"] * 8)),
                        cr.march_rays_plain(sp, stb, dirs))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dealt_plain():
    """{case: elements that differ from the unsharded plain run}, from one
    child process whose torch ops compute every element alike."""
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    r = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["S1 on 2", "S1 on 4", "S2 3 frames on 2x2",
                                  "S3 on 8"])
def test_dealt_plain_is_the_unsharded_plain(dealt_plain, case):
    """Size 12 is 3 tile rows: on 2 entries the first gets two (its strips
    stacked in order), on 4 the last gets none; 3 orbit frames of 8^2 (2
    tile rows) on a 2 x 2 mesh are one plain march an entry that owns a
    tile row, over that row of all three frames, no pad frame (the 1-D
    mesh: tests/test_torch_sharding_batch.py's fly-through); nside 4 is
    192 rays, 6 tiles: on 8 entries two get none.
    tests/test_torch_plain_reuse.py holds S1 on 3, S2's 2 frames and S3 on
    3 and 4 entries the same way."""
    assert dealt_plain[case] == 0
