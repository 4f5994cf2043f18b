"""The CUDA march kernel against its plain torch version: every launch
form (frame, band, progressive frame, batch, ray list) and every noise
kind (simplex, perlin, iq). These run only where a CUDA card and nvcc
are present (``pytest -m cuda`` on the card); elsewhere they skip.

Gates: <= 2 uint8 LSB between a kernel and its plain version for simplex
and perlin; for iq, whose sin-hash amplifies the last ulps of two sine
implementations, at least 98 % of the pixels within 2 LSB and a mean
difference below 0.25 LSB."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine.render import post_process  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(galaxy, size, **cfg):
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy)],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg))


@pytest.mark.parametrize("name", ["spiral", "dusty_disk", "flocculent",
                                  "ring", "irregular"])
def test_kernel_matches_plain(cuda, name):
    """<= 2 uint8 LSB between the kernel and march_plain on one page."""
    scene = _scene(getattr(presets, name)(), 48)
    page, table, size, _ = cr.prepare(scene, "cpu")
    before = cr.march.launch_count
    lin_k = cr.march(page.to(cuda), table.to(cuda), size)
    torch.cuda.synchronize()
    assert cr.march.launch_count == before + 1
    lin_p = cr.march_plain(page, table, size)
    assert bool(torch.isfinite(lin_k).all())
    post = (np.float32(1.0),) * 3
    a = post_process(lin_k.cpu(), *post).numpy().astype(np.int16)
    b = post_process(lin_p, *post).numpy().astype(np.int16)
    assert int(np.abs(a - b).max()) <= 2


def test_render_scene_device_out_stays_on_card(cuda):
    scene = _scene(presets.spiral(), 32)
    img = gt.render_scene(scene, device="cuda", device_out=True)
    assert img.device.type == "cuda" and img.dtype == torch.uint8
    np.testing.assert_array_equal(img.cpu().numpy(),
                                  gt.render_scene(scene, device="cuda"))


def test_noise_probe_matches_plain(cuda):
    """noise.cuh's device functions against the plain torch ops on the CPU:
    the same float32 operations in the same order."""
    from gamer_tpu_torch.ops import noise as tnoise

    rng = np.random.default_rng(4)
    pts = rng.uniform(-20.0, 20.0, (4096, 3)).astype(np.float32)
    pts[:32] = np.round(pts[:32])
    args = (10, 0.6, 0.1, tnoise.ridged_weights(1.5, 9), 2.5, 1.0, 1.2)
    before = tnoise.noise_probe.launch_count
    got = tnoise.noise_probe(torch.as_tensor(pts, device=cuda), *args).cpu()
    assert tnoise.noise_probe.launch_count == before + 1
    want = tnoise.noise_probe(torch.as_tensor(pts), *args)
    assert float((got - want).abs().max()) <= 1e-6


def test_band_frame_equals_fused_frame(cuda):
    """render_progressive's bands (K5) reassemble the fused frame bit for
    bit, supersampled and starred too; one march_progressive launch for all
    the bands, none of march_band, and one tick per band in order."""
    for scene, bands in ((_scene(presets.spiral(), 80), 3),
                         (_scene(presets.spiral(), 40, supersample=2,
                                 no_stars=40, star_size=40.0), 2)):
        before = (cr.march_progressive.launch_count,
                  cr.march_band.launch_count)
        ticks = []
        prog = gt.render_progressive(scene, bands=bands, device="cuda",
                                     on_progress=lambda f, _: ticks.append(f))
        n_bands = cr.band_geometry(scene.config.size,
                                   scene.config.supersample, bands)[1]
        assert (cr.march_progressive.launch_count,
                cr.march_band.launch_count) == (before[0] + 1, before[1])
        assert ticks == [(b + 1) / n_bands for b in range(n_bands)]
        np.testing.assert_array_equal(prog, gt.render_scene(scene,
                                                            device="cuda"))


def test_progressive_kernel_matches_plain(cuda):
    """march_progressive against march_progressive_plain at 40^2: <= 2
    uint8 LSB, every band flag set, rows past the frame 0; on the card the
    frame's rows are bit-equal to march's."""
    post = (np.float32(1.0),) * 3
    scene = _scene(presets.spiral(), 40)
    page, table, size, _ = cr.prepare(scene, "cpu")
    before = cr.march_progressive.launch_count
    launch = cr.march_progressive(page.to(cuda), table.to(cuda), size, 32, 2)
    assert launch.flags.is_pinned() and launch.abort.is_pinned()
    assert launch.wait(0) >= 1
    launch.stop()
    assert cr.march_progressive.launch_count == before + 1
    assert launch.flags.tolist() == [1, 1] and launch.abort.tolist() == [1]
    got = launch.out
    want = cr.march_progressive_plain(page, table, size, 32, 2)
    a = post_process(got.cpu(), *post).numpy().astype(np.int16)
    b = post_process(want, *post).numpy().astype(np.int16)
    assert int(np.abs(a - b).max()) <= 2
    assert float(got[size:].abs().max()) == 0.0
    assert torch.equal(got[:size], cr.march(page.to(cuda), table.to(cuda),
                                            size))


def test_progressive_abort_and_refused_words(cuda):
    """An abort at the first tick returns band 0 and black below; flag
    words the card cannot reach are refused before anything runs."""
    import ctypes

    from gamer_tpu_torch.kernels import library

    scene = _scene(presets.spiral(), 256)
    want = gt.render_scene(scene, device="cuda")
    band_rows = cr.band_geometry(256, 1, 8)[0]
    got = gt.render_progressive(scene, bands=8, device="cuda",
                                on_progress=lambda f, _: False)
    np.testing.assert_array_equal(got[:band_rows], want[:band_rows])
    assert int(got[band_rows:].sum()) == 0
    page, table, size, _ = cr.prepare(scene, cuda)
    words = (ctypes.c_int * 9)()  # pageable host memory
    out = torch.empty((8 * band_rows, size, 3), device=cuda)
    counters = torch.zeros(9, dtype=torch.int32, device=cuda)
    noise = cr.noise_table(cr.NOISE_KINDS[cr._table_kind(table)], cuda)
    rc = library().gamer_march_progressive(
        page.data_ptr(), page.numel(), table.data_ptr(), table.numel(),
        noise.data_ptr(), out.data_ptr(), size, band_rows, 8, 0, 1,
        counters.data_ptr(), ctypes.addressof(words),
        ctypes.addressof(words) + 32, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc != 0 and list(words) == [0] * 9
    assert counters.cpu().tolist() == [0] * 9


def test_progressive_on_a_card_that_is_not_current(cuda):
    """render_progressive on the second card while the first is current
    (a service, a viewer or a mesh entry on cuda:1): the launch's events
    are its own card's, so the frame is bit-equal to that card's still, the
    16 ticks come in order, an abort returns band 0 and black below, and
    every call waits for its launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    other = torch.device("cuda", 1)
    scene = _scene(presets.spiral(), 512)
    assert torch.cuda.current_device() == 0
    want = gt.render_scene(scene, device=other)
    band_rows = cr.band_geometry(512, 1, 16)[0]
    for _ in range(3):
        ticks = []
        got = gt.render_progressive(scene, bands=16, device=other,
                                    on_progress=lambda f, _: ticks.append(f))
        np.testing.assert_array_equal(got, want)
        assert ticks == [(b + 1) / 16 for b in range(16)]
        got = gt.render_progressive(scene, bands=16, device=other,
                                    on_progress=lambda f, _: False)
        np.testing.assert_array_equal(got[:band_rows], want[:band_rows])
        assert int(got[band_rows:].sum()) == 0
        assert torch.cuda.current_device() == 0


def test_batch_frame_equals_single_frame(cuda):
    """render_flythrough (K4): one launch, each frame bit-equal to its
    single render_scene."""
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    scene = _scene(presets.spiral(), 48)
    cams = orbit_path(scene.camera, 3, horizontal_deg=90.0)
    before = cr.march_batch.launch_count
    frames = gt.render_flythrough(scene, cams, device="cuda")
    assert cr.march_batch.launch_count == before + 1
    for frame, cam in zip(frames, cams):
        np.testing.assert_array_equal(
            frame, gt.render_scene(dataclasses.replace(scene, camera=cam),
                                   device="cuda"))


def test_band_and_batch_kernels_match_plain(cuda):
    """<= 2 uint8 LSB between each new launch and its plain version."""
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    post = (np.float32(1.0),) * 3
    scene = _scene(presets.dusty_disk(), 40)
    page, table, size, _ = cr.prepare(scene, "cpu")
    got = cr.march_band(page.to(cuda), table.to(cuda), size, 32, 32)
    want = cr.march_band_plain(page, table, size, 32, 32)
    a = post_process(got.cpu(), *post).numpy().astype(np.int16)
    b = post_process(want, *post).numpy().astype(np.int16)
    assert int(np.abs(a - b).max()) <= 2
    assert float(got[8:].abs().max()) == 0.0  # rows past the frame

    cams = orbit_path(scene.camera, 2, horizontal_deg=45.0)
    st, pages, _ = _scene_groups(
        [dataclasses.replace(scene, camera=c) for c in cams])[0]
    tab = torch.as_tensor(cr._build_table(st, cr._build_layout(st)))
    got = cr.march_batch(torch.as_tensor(pages, device=cuda), tab.to(cuda),
                         size)
    want = cr.march_batch_plain(torch.as_tensor(pages), tab, size)
    a = post_process(got.cpu(), *post).numpy().astype(np.int16)
    b = post_process(want, *post).numpy().astype(np.int16)
    assert got.shape == (2, size, size, 3) and int(np.abs(a - b).max()) <= 2


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
def test_batch_past_48k_of_shared_memory(cuda, kind):
    """A fly-through of ten spirals: the structure table and the batch's
    eight page slots take 32-44 KB of dynamic shared memory a block, which
    with the perlin kernels' 20 KB of static shared memory passes the 48 KB
    a launch gets without asking. Every kind's batch launches once, matches
    its plain version and is bit-equal to its stills."""
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.kernels import library
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    galaxy = presets.spiral()
    scene = dataclasses.replace(
        _scene(galaxy, 32, noise_kind=kind),
        instances=[gt.GalaxyInstance(galaxy=galaxy, position=(0.0, 0.0, z))
                   for z in np.linspace(-0.9, 0.9, 10)])
    cams = orbit_path(scene.camera, 2, horizontal_deg=45.0)
    scenes = [dataclasses.replace(scene, camera=c) for c in cams]
    st, pages, _ = _scene_groups(scenes)[0]
    tab = cr._build_table(st, cr._build_layout(st))
    warps = library().gamer_march_block_threads() // 32
    dynamic = (tab.size + warps * pages.shape[1]) * 4
    assert 32 * 1024 <= dynamic <= 44 * 1024, dynamic

    pages = torch.as_tensor(pages, device=cuda)
    tab = cr.upload_table(tab, cuda)
    before = cr.march_batch.launch_count
    got = cr.march_batch(pages, tab, 32)
    torch.cuda.synchronize()
    assert cr.march_batch.launch_count == before + 1
    assert float(got.sum()) > 0
    assert _lsb_gate(got, cr.march_batch_plain(pages, tab, 32), kind)
    frames = gt.render_flythrough(scene, cams, device="cuda")
    for frame, s in zip(frames, scenes):
        np.testing.assert_array_equal(frame,
                                      gt.render_scene(s, device="cuda"))


def test_batch_device_out_stays_on_card(cuda):
    scenes = [_scene(presets.spiral(), 24), _scene(presets.ring(), 24)]
    img = gt.render_batch(scenes, device="cuda", device_out=True)
    assert img.device.type == "cuda" and img.shape == (2, 24, 24, 3)
    np.testing.assert_array_equal(img.cpu().numpy(),
                                  gt.render_batch(scenes, device="cuda"))


def _inside_scene(**cfg):
    """The all-sky geometry: the camera inside the ellipsoid."""
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.3, 0.05, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
        config=gt.RenderConfig(size=16, ray_step=0.025, **cfg))


def test_march_rays_matches_plain(cuda):
    """K6 against march_rays_plain at nside 8 (768 rays) plus a zero
    direction: <= 1e-3 of the largest radiance, the zero ray exactly 0."""
    from gamer_tpu_torch.engine.allsky import allsky_dirs

    dirs = np.concatenate([allsky_dirs(8), np.zeros((1, 3), np.float32)])
    page, table, _, _ = cr.prepare(_inside_scene(), "cpu")
    before = cr.march_rays.launch_count
    got = cr.march_rays(page.to(cuda), table.to(cuda),
                        torch.as_tensor(dirs, device=cuda))
    torch.cuda.synchronize()
    assert cr.march_rays.launch_count == before + 1
    want = cr.march_rays_plain(page, table, torch.as_tensor(dirs))
    assert got.shape == (769, 3) and bool(torch.isfinite(got).all())
    assert float(got[-1].abs().max()) == 0.0
    assert bool((got[:-1].sum(dim=1) > 0).all())
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * scale


def test_ray_list_reproduces_the_frame(cuda):
    """march_rays on a frame's own ray grid, made on the card: the same
    direction bits give the frame's radiance bit for bit."""
    from gamer_tpu_torch.ops.camera import ray_grid

    scene = _scene(presets.spiral(), 64)
    page, table, size, _ = cr.prepare(scene, cuda)
    frame = cr.march(page, table, size)
    dirs = ray_grid(size, page[cr.G_INV_VP:cr.G_INV_VP + 16].cpu().numpy(),
                    0.0, device=cuda, rows=size).reshape(-1, 3).contiguous()
    rays = cr.march_rays(page, table, dirs)
    assert torch.equal(rays.reshape(size, size, 3), frame)


@pytest.mark.parametrize("kind", ["perlin", "iq"])
def test_kind_kernel_matches_plain(cuda, kind):
    scene = _scene(presets.spiral(), 48, noise_kind=kind)
    page, table, size, _ = cr.prepare(scene, "cpu")
    lin_k = cr.march(page.to(cuda), table.to(cuda), size)
    torch.cuda.synchronize()
    lin_p = cr.march_plain(page, table, size)
    assert bool(torch.isfinite(lin_k).all()) and float(lin_k.sum()) > 0
    post = (np.float32(1.0),) * 3
    a = post_process(lin_k.cpu(), *post).numpy().astype(np.int16)
    b = post_process(lin_p, *post).numpy().astype(np.int16)
    d = np.abs(a - b)
    if kind == "perlin":
        assert int(d.max()) <= 2
    else:
        assert float((d.max(-1) <= 2).mean()) >= 0.98
        assert float(d.mean()) <= 0.25


@pytest.mark.parametrize("kind", ["perlin", "iq"])
def test_kind_launch_forms_agree(cuda, kind):
    """Bands, a batch and the ray list of a second kind are bit-equal to
    that kind's still frame."""
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    scene = _scene(presets.spiral(), 80, noise_kind=kind)
    still = gt.render_scene(scene, device="cuda")
    np.testing.assert_array_equal(
        gt.render_progressive(scene, bands=3, device="cuda"), still)
    cams = orbit_path(scene.camera, 2, horizontal_deg=45.0)
    frames = gt.render_flythrough(scene, cams, device="cuda")
    for frame, cam in zip(frames, cams):
        np.testing.assert_array_equal(
            frame, gt.render_scene(dataclasses.replace(scene, camera=cam),
                                   device="cuda"))
    assert int(np.abs(still.astype(np.int16) - gt.render_scene(
        _scene(presets.spiral(), 80), device="cuda")).max()) > 2


@pytest.mark.parametrize("kind", ["perlin", "iq"])
def test_noise_probe_kind_matches_plain(cuda, kind):
    """perlin is integer lattice work and lerps in one order: bit-equal.
    iq: the card's sinf against torch's CPU sine, amplified by 753.5 — at
    least 99 % of the raw values within 2e-3, mean below 1e-3."""
    from gamer_tpu_torch.ops import noise as tnoise

    rng = np.random.default_rng(4)
    pts = rng.uniform(-20.0, 20.0, (4096, 3)).astype(np.float32)
    pts[:32] = np.round(pts[:32])
    args = (10, 0.6, 0.1, tnoise.ridged_weights(1.5, 9), 2.5, 1.0, 1.2, kind)
    before = tnoise.noise_probe.launch_count
    got = tnoise.noise_probe(torch.as_tensor(pts, device=cuda), *args).cpu()
    assert tnoise.noise_probe.launch_count == before + 1
    want = tnoise.noise_probe(torch.as_tensor(pts), *args)
    d = (got - want).abs()
    if kind == "perlin":
        assert float(d.max()) == 0.0
    else:
        assert float((d[:, 0] <= 2e-3).float().mean()) >= 0.99
        assert float(d[:, 0].mean()) < 1e-3


# --- the iq hash table (csrc/noise.cuh: iq_corners, march.cu: fill) -------


def _smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


def test_iq_table_equals_the_sines(cuda):
    """Every pair of the table, and the corners of every integer in
    [-2R - 300, 2R + 300], bit-equal to the kernels' own sinf; the
    fallback taken exactly past +-R."""
    bad, _ = _smoke().iq_table_check(cuda)
    assert bad["pairs"] == 0 and bad["corners"] == 0, bad
    assert bad["fallback"] == bad["fallback_expected"], bad


def test_perlin_grad_table_equals_the_hash(cuda):
    """Every entry of the perlin gradient table, and the perlin kernels'
    own staged reads of it for every lattice index in [0, 2048), bit-equal
    to the gradient hash's decode on the card."""
    bad, _ = _smoke().perlin_grad_check(cuda)
    assert bad == {"entries": 0, "dots": 0}, bad


def test_iq_scene_past_the_table_matches_plain(cuda):
    """The spiral with its ridged dust scaled up: some hash arguments pass
    R (the census of the plain run), and the kernel, taking the sines
    there, passes the iq gate against the plain version."""
    from gamer_tpu_torch.ops import noise as tnoise

    scene = _smoke().iq_far_scene(48)
    page, table, size, _ = cr.prepare(scene, "cpu")
    lin_k = cr.march(page.to(cuda), table.to(cuda), size)
    torch.cuda.synchronize()
    with tnoise.iq_census() as census:
        lin_p = cr.march_plain(page, table, size)
    assert census["outside"] > 0 and census["non_integer"] == 0, census
    assert bool(torch.isfinite(lin_k).all()) and float(lin_k.sum()) > 0
    assert _lsb_gate(lin_k, lin_p, "iq")


def test_iq_table_is_built_on_the_launch_card(cuda):
    """A launch on cuda:1 while card 0 is current builds cuda:1's own
    table, once, and its frame is bit-equal to card 0's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    from gamer_tpu_torch.ops import noise as tnoise

    other = torch.device("cuda", 1)
    scene = _scene(presets.spiral(), 64, noise_kind="iq")
    assert torch.cuda.current_device() == 0
    tnoise._IQ_TABLES.pop(1, None)
    before = tnoise.iq_hash_table.launch_count
    got = gt.render_scene(scene, device=other)
    assert tnoise.iq_hash_table.launch_count == before + 1
    assert tnoise.iq_hash_table(other).device == other
    gt.render_scene(scene, device=other)
    assert tnoise.iq_hash_table.launch_count == before + 1
    np.testing.assert_array_equal(got, gt.render_scene(scene, device="cuda"))


def test_iq_tables_on_every_card_from_threads_and_a_mesh(cuda):
    """Every visible card (needs at least two): two threads a card render
    the iq still at once, which builds each card's table once under the
    lock, on its own card, where it passes the exhaustive check; then S1
    over a mesh of every card gives card 0's frame bit for bit and builds
    nothing more."""
    import gamer_tpu_torch.parallel as par
    from concurrent.futures import ThreadPoolExecutor

    from gamer_tpu_torch.ops import noise as tnoise

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least two CUDA cards")
    scene = _scene(presets.spiral(), 200, noise_kind="iq")
    still = gt.render_scene(scene, device="cuda")
    for k in range(1, n):
        tnoise._IQ_TABLES.pop(k, None)
    before = tnoise.iq_hash_table.launch_count
    cards = [torch.device("cuda", k) for k in range(n)] * 2
    with ThreadPoolExecutor(len(cards)) as pool:
        frames = list(pool.map(
            lambda d: gt.render_scene(scene, device=d), cards))
    assert tnoise.iq_hash_table.launch_count == before + n - 1
    for frame in frames:
        np.testing.assert_array_equal(frame, still)
    for k in range(n):
        assert tnoise.iq_hash_table(cards[k]).device == cards[k]
        assert k in tnoise.iq_hash_table.build_ms
        bad, _ = _smoke().iq_table_check(cards[k])
        assert bad["pairs"] == bad["corners"] == 0, (k, bad)
        assert bad["fallback"] == bad["fallback_expected"], (k, bad)
    mesh = par.make_pixel_mesh()
    assert mesh.size == n and len(set(mesh.devices)) == n
    before_s1 = cr.march_rowshard.launch_count
    np.testing.assert_array_equal(gt.render_scene(scene, mesh=mesh), still)
    assert cr.march_rowshard.launch_count == before_s1 + n
    assert tnoise.iq_hash_table.launch_count == before + n - 1


def test_sharded_plain_equals_unsharded_plain_on_the_card(cuda):
    """The plain versions on the card, where every element of a torch op
    takes the same code: S1, S2 and S3's plain versions give the unsharded
    plain radiance bit for bit (chip_smoke.py holds the sharded kernels
    against the unsharded plain runs)."""
    from gamer_tpu_torch.engine.allsky import allsky_dirs
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    scene = _scene(presets.spiral(), 64)
    page, table, size, _ = cr.prepare(scene, cuda)
    want = cr.march_plain(page, table, size)
    assert torch.equal(cr.march_rowshard_plain(page, table, size,
                                               _one_card_mesh(4)), want)
    cams = orbit_path(scene.camera, 2, horizontal_deg=90.0)
    st, pages, _ = _scene_groups([dataclasses.replace(scene, camera=c)
                                  for c in cams])[0]
    tab = torch.as_tensor(cr._build_table(st, cr._build_layout(st)),
                          device=cuda)
    pages = torch.as_tensor(pages, device=cuda)
    assert torch.equal(
        cr.march_batch_rowshard_plain(
            pages, tab, 64, _one_card_mesh(4, ("batch", "rows"), (2, 2))),
        cr.march_batch_plain(pages, tab, 64))
    sky_page, sky_tab, _, _ = cr.prepare(_inside_scene(), cuda)
    dirs = torch.as_tensor(allsky_dirs(16), device=cuda)
    assert torch.equal(
        cr.march_rays_rowshard_plain(sky_page, sky_tab, dirs,
                                     _one_card_mesh(3)),
        cr.march_rays_plain(sky_page, sky_tab, dirs))


# --- the persistent warp-tile launch: odd shapes, streams, occupancy -------

# resident blocks of 256 threads per SM that csrc/march.cu's register budget
# (MIN_BLOCKS) is chosen for
MIN_BLOCKS = 3


def _lsb_gate(got, want, kind):
    post = (np.float32(1.0),) * 3
    a = post_process(got.cpu(), *post).numpy().astype(np.int16)
    b = post_process(want.cpu(), *post).numpy().astype(np.int16)
    d = np.abs(a - b)
    if kind == "iq":
        return (float((d.max(-1) <= 2).mean()) >= 0.98
                and float(d.mean()) <= 0.25)
    return int(d.max()) <= 2


def _odd_launch(form, kind, cuda):
    """(kernel radiance, plain radiance on the card) of one launch form at
    a shape that does not fill its tiles: a 100^2 still, a band of rows
    80-127 of a 100-row frame, 3 frames of 100^2, 1000 rays."""
    from gamer_tpu_torch.engine.allsky import allsky_dirs
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    scene = _scene(presets.spiral(), 100, noise_kind=kind)
    page, table, size, _ = cr.prepare(scene, cuda)
    if form == "still":
        return cr.march(page, table, size), cr.march_plain(page, table, size)
    if form == "band":
        return (cr.march_band(page, table, size, 48, 80),
                cr.march_band_plain(page, table, size, 48, 80))
    if form == "batch":
        st, pages, _ = _scene_groups(
            [dataclasses.replace(scene, camera=c)
             for c in orbit_path(scene.camera, 3, horizontal_deg=90.0)])[0]
        pages = torch.as_tensor(pages, device=cuda)
        tab = cr.upload_table(cr._build_table(st, cr._build_layout(st)), cuda)
        return (cr.march_batch(pages, tab, size),
                cr.march_batch_plain(pages, tab, size))
    page, table, _, _ = cr.prepare(_inside_scene(noise_kind=kind), cuda)
    dirs = torch.as_tensor(allsky_dirs(16)[::3][:1000].copy(), device=cuda)
    return (cr.march_rays(page, table, dirs),
            cr.march_rays_plain(page, table, dirs))


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
@pytest.mark.parametrize("form", ["still", "band", "batch", "rays"])
def test_odd_shapes_match_plain(cuda, form, kind):
    """Every launch form and kind where the last tiles run past the frame,
    the band, the batch's frames or the ray list: within the kernel gates
    of its plain version, and the band's rows past the frame are 0."""
    got, want = _odd_launch(form, kind, cuda)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float(got.sum()) > 0 and _lsb_gate(got, want, kind)
    if form == "band":
        assert float(got[20:].abs().max()) == 0.0


def test_odd_shapes_are_the_still_bit_for_bit(cuda):
    """At size 100 a band past the frame and each frame of a 3-frame batch
    give the stills' radiance bit for bit; so do the first 1000 rays of a
    128^2 still as a list (ray_grid's directions are the kernel's bits where
    the half size is a power of two)."""
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.ops.camera import ray_grid
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    page, table, size, _ = cr.prepare(_scene(presets.spiral(), 128), cuda)
    still = cr.march(page, table, size).reshape(-1, 3)
    dirs = ray_grid(size, page[cr.G_INV_VP:cr.G_INV_VP + 16].cpu().numpy(),
                    0.0, device=cuda, rows=size).reshape(-1, 3)
    assert torch.equal(cr.march_rays(page, table, dirs[:1000].contiguous()),
                       still[:1000])
    scene = _scene(presets.spiral(), 100)
    page, table, size, _ = cr.prepare(scene, cuda)
    still = cr.march(page, table, size)
    assert torch.equal(cr.march_band(page, table, size, 48, 80)[:20],
                       still[80:])
    scenes = [dataclasses.replace(scene, camera=c)
              for c in orbit_path(scene.camera, 3, horizontal_deg=90.0)]
    st, pages, _ = _scene_groups(scenes)[0]
    tab = cr.upload_table(cr._build_table(st, cr._build_layout(st)), cuda)
    batch = cr.march_batch(torch.as_tensor(pages, device=cuda), tab, size)
    for frame, s in zip(batch, scenes):
        p, t, _, _ = cr.prepare(s, cuda)
        assert torch.equal(frame, cr.march(p, t, size))


def test_concurrent_launches_keep_their_own_counters(cuda):
    """Two launches at once on two streams (a frame and a ray list), each
    with its own tile counter: each result is bit-equal to a lone launch."""
    from gamer_tpu_torch.engine.allsky import allsky_dirs

    page, table, size, _ = cr.prepare(_scene(presets.spiral(), 256), cuda)
    sky_page, sky_table, _, _ = cr.prepare(_inside_scene(), cuda)
    dirs = torch.as_tensor(allsky_dirs(64), device=cuda)
    lone_frame = cr.march(page, table, size)
    lone_rays = cr.march_rays(sky_page, sky_table, dirs)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(streams[0]):
        frame = cr.march(page, table, size)
    with torch.cuda.stream(streams[1]):
        rays = cr.march_rays(sky_page, sky_table, dirs)
    torch.cuda.synchronize()
    assert torch.equal(frame, lone_frame) and torch.equal(rays, lone_rays)


def test_occupancy_meets_the_register_budget(cuda):
    """The frame, ray-list, progressive, dealt and dealt stack kernels of
    every kind hold at least MIN_BLOCKS blocks of 256 threads per SM, and a
    launch's grid is the card's resident blocks."""
    for kind in range(len(cr.NOISE_KINDS)):
        for form in (cr.FORM_FRAMES, cr.FORM_RAYS, cr.FORM_PROGRESSIVE,
                     cr.FORM_DEALT, cr.FORM_DEALT_STACK):
            blocks, sms, warps = cr.occupancy(cuda, kind, form)
            assert warps == 8 and blocks >= MIN_BLOCKS
            assert sms == torch.cuda.get_device_properties(
                cuda).multi_processor_count
            assert cr.persistent_grid(blocks, sms, 10 ** 6, warps) == \
                blocks * sms


def test_allsky_map_on_the_card(cuda):
    """render_allsky_map on the card (one ray-list launch) against the
    same map from the plain version."""
    scene = _inside_scene()
    before = cr.march_rays.launch_count
    got = gt.render_allsky_map(scene, 8, device="cuda")
    assert cr.march_rays.launch_count == before + 1
    want = gt.render_allsky_map(scene, 8, device="cpu")
    assert got.shape == (768,) and (got > 0).all()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-3



# --- the sharded launches (S1-S3) and the service on the card -------------


def _one_card_mesh(n, *axes):
    """A mesh that names card 0 n times: n concurrent launches on n
    streams of one card, the form a one-card machine can run."""
    from gamer_tpu_torch.parallel import Mesh

    return Mesh(["cuda:0"] * n, *axes)


@pytest.mark.parametrize("n,size", [(1, 96), (2, 96), (3, 100), (4, 40)])
def test_rowshard_equals_fused_frame(cuda, n, size):
    """S1: the row-sharded frame is bit-equal to the fused frame, with one
    launch per entry that owns a tile row, min(n, tile rows); on one card
    size 100 on 3 entries cuts 25 tile rows into runs of 9, 8 and 8, size
    40 on 4 cuts 10 into 3, 3, 2 and 2."""
    scene = _scene(presets.spiral(), size)
    before = cr.march_rowshard.launch_count
    before_dealt = cr.march_dealt.launch_count
    got = gt.render_scene(scene, mesh=_one_card_mesh(n))
    owners = min(n, -(-size // cr.TILE_H))
    assert cr.march_rowshard.launch_count == before + owners
    assert cr.march_dealt.launch_count == before_dealt + owners
    np.testing.assert_array_equal(got, gt.render_scene(scene, device="cuda"))


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
def test_dealt_shares_equal_the_unsharded_kernels(cuda, kind):
    """S1 and S3 over 3 and 5 entries of one card: every frame and ray
    bit-equal to march / march_rays; a dealt launch's strips (every third
    tile row, as on three cards) are those tile rows of march's frame; size
    20 on 8 entries leaves three without a tile row, 100 rays on 5 entries
    (4 tiles, the last short) one without a tile."""
    from gamer_tpu_torch.engine.allsky import allsky_dirs

    scene = _scene(presets.spiral(), 100, noise_kind=kind)
    page, table, size, _ = cr.prepare(scene, cuda)
    want = cr.march(page, table, size)
    mesh = _one_card_mesh(3)
    assert torch.equal(cr.march_rowshard(page, table, size, mesh), want)
    tiles = want.view(size // cr.TILE_H, cr.TILE_H, size, 3)
    for i in range(3):
        strips = cr.march_dealt(page, table, size, i, 3, cr.dealt(25, 3, i))
        assert torch.equal(strips, tiles[i::3].reshape(-1, size, 3))
    small = _scene(presets.spiral(), 20, noise_kind=kind)
    before = cr.march_rowshard.launch_count
    np.testing.assert_array_equal(
        gt.render_scene(small, mesh=_one_card_mesh(8)),
        gt.render_scene(small, device="cuda"))
    assert cr.march_rowshard.launch_count == before + 5
    sky_page, sky_table, _, _ = cr.prepare(
        _inside_scene(noise_kind=kind), cuda)
    dirs = torch.as_tensor(allsky_dirs(8), device=cuda)
    for d, n in ((dirs, 3), (dirs[::7][:100].contiguous(), 5)):
        before = cr.march_rays_rowshard.launch_count
        assert torch.equal(
            cr.march_rays_rowshard(sky_page, sky_table, d,
                                   _one_card_mesh(n)),
            cr.march_rays(sky_page, sky_table, d))
        assert cr.march_rays_rowshard.launch_count == before + min(
            n, cr.ray_tiles(d.shape[0]))


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
def test_dealt_shares_on_every_card(cuda, kind):
    """S1 and S3 dealt over every visible card (needs at least two), and
    over two entries a card: the frame and the map bit-equal to card 0's
    march / march_rays."""
    import gamer_tpu_torch.parallel as par
    from gamer_tpu_torch.engine.allsky import allsky_dirs

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least two CUDA cards")
    mesh = par.make_pixel_mesh()
    page, table, size, _ = cr.prepare(
        _scene(presets.spiral(), 256, noise_kind=kind), cuda)
    before = cr.march_dealt.launch_count
    assert torch.equal(cr.march_rowshard(page, table, size, mesh),
                       cr.march(page, table, size))
    assert cr.march_dealt.launch_count == before + n
    twice = par.make_pixel_mesh(list(mesh.devices) * 2)
    assert torch.equal(cr.march_rowshard(page, table, size, twice),
                       cr.march(page, table, size))
    sky_page, sky_table, _, _ = cr.prepare(
        _inside_scene(noise_kind=kind), cuda)
    dirs = torch.as_tensor(allsky_dirs(32), device=cuda)
    for m in (mesh, twice):
        assert torch.equal(
            cr.march_rays_rowshard(sky_page, sky_table, dirs, m),
            cr.march_rays(sky_page, sky_table, dirs))


def _orbit_stack(size, n_frames, device, **cfg):
    """(pages (B, n), table) of B orbit frames of the spiral, one
    structure, on ``device``."""
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    scene = _scene(presets.spiral(), size, **cfg)
    cams = orbit_path(scene.camera, n_frames, horizontal_deg=90.0)
    st, pages, _ = _scene_groups([dataclasses.replace(scene, camera=c)
                                  for c in cams])[0]
    return (torch.as_tensor(pages, device=device),
            cr.upload_table(cr._build_table(st, cr._build_layout(st)),
                            device))


def _preset_scenes(size):
    """One scene of each gallery preset: 7 structure groups of a frame."""
    from gamer_tpu_torch.golden import oracle_scene

    return [oracle_scene(name, size) for name in presets.GALLERY]


@pytest.mark.parametrize("n_frames", [1, 3, 5])
def test_dealt_stack_equals_march_batch(cuda, n_frames):
    """S2 on one card: B orbit frames at 96^2 (24 tile rows) on 2, 3 and 4
    entries of the card, and on a 2 x 2 ('batch', 'rows') mesh, are one
    march_dealt launch an entry over its rows of all B frames (no pad
    frame), bit-equal to march_batch's frames; a dealt share of the stack
    (every third tile row, as on three cards) is those rows of
    march_batch's frames; size 500 (125 tile rows) on 3 entries and the
    seven presets (7 structure groups of one frame) on 4 entries too."""
    pages, tab = _orbit_stack(96, n_frames, cuda)
    want = cr.march_batch(pages, tab, 96)
    for mesh in (_one_card_mesh(2, ("batch",)), _one_card_mesh(3, ("batch",)),
                 _one_card_mesh(4, ("batch",)),
                 _one_card_mesh(4, ("batch", "rows"), (2, 2))):
        before = cr.march_dealt.launch_count
        got = cr.march_batch_rowshard(pages, tab, 96, mesh)
        assert cr.march_dealt.launch_count == before + mesh.size
        assert torch.equal(got, want)
    tiles = want.view(n_frames, 96 // cr.TILE_H, cr.TILE_H, 96, 3)
    for i in range(3):
        strips = cr.march_dealt(pages, tab, 96, i, 3, cr.dealt(24, 3, i))
        assert torch.equal(strips, tiles[:, i::3].reshape(n_frames, -1, 96,
                                                          3))
    pages, tab = _orbit_stack(500, n_frames, cuda)
    assert torch.equal(
        cr.march_batch_rowshard(pages, tab, 500,
                                _one_card_mesh(3, ("batch",))),
        cr.march_batch(pages, tab, 500))
    if n_frames == 1:
        scenes = _preset_scenes(64)
        before = cr.march_batch_rowshard.launch_count
        got = gt.render_batch_linear(scenes, mesh=_one_card_mesh(4, (
            "batch",)))
        assert cr.march_batch_rowshard.launch_count == before + 4 * 7
        assert torch.equal(got, gt.render_batch_linear(scenes,
                                                       device="cuda"))


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
def test_dealt_batch_on_every_card(cuda, kind):
    """S2 dealt over every visible card (needs at least two): 5 orbit
    frames at 256^2 on the 1-D batch mesh, on two entries a card and, with
    an even count of cards, on the ('batch', 'rows') mesh of two rows,
    bit-equal to card 0's march_batch, one launch an entry; for simplex
    also the seven presets in one render_batch_linear call."""
    import gamer_tpu_torch.parallel as par

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least two CUDA cards")
    mesh = par.global_batch_mesh()
    pages, tab = _orbit_stack(256, 5, cuda, noise_kind=kind)
    want = cr.march_batch(pages, tab, 256)
    before = cr.march_dealt.launch_count
    assert torch.equal(cr.march_batch_rowshard(pages, tab, 256, mesh), want)
    assert cr.march_dealt.launch_count == before + n
    meshes = [par.global_batch_mesh(list(mesh.devices) * 2)]
    if n % 2 == 0:
        meshes.append(par.pixel_tile_mesh_2d(rows_axis=2))
    for m in meshes:
        assert torch.equal(cr.march_batch_rowshard(pages, tab, 256, m), want)
    if kind == "simplex":
        scenes = _preset_scenes(128)
        assert torch.equal(gt.render_batch_linear(scenes, mesh=mesh),
                           gt.render_batch_linear(scenes, device="cuda"))


def test_rowshard_supersample_and_stars(cuda):
    scene = _scene(presets.spiral(), 48, supersample=2, no_stars=40,
                   star_seed=7)
    np.testing.assert_array_equal(
        gt.render_scene(scene, mesh=_one_card_mesh(3)),
        gt.render_scene(scene, device="cuda"))


def test_sharded_kernels_match_plain(cuda):
    """Each sharded launch against its plain version on the CPU, the same
    mesh shape: <= 2 uint8 LSB."""
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.parallel import Mesh
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    post = (np.float32(1.0),) * 3

    def lsb(a, b):
        return int(np.abs(
            post_process(a.cpu(), *post).numpy().astype(np.int16)
            - post_process(b, *post).numpy().astype(np.int16)).max())

    scene = _scene(presets.spiral(), 48)
    page, table, size, _ = cr.prepare(scene, "cpu")
    k = cr.march_rowshard(page.to(cuda), table.to(cuda), size,
                          _one_card_mesh(2))
    p = cr.march_rowshard_plain(page, table, size, Mesh(["cpu"] * 2))
    assert lsb(k, p) <= 2
    cams = orbit_path(scene.camera, 4, horizontal_deg=90.0)
    st, pages, _ = _scene_groups([dataclasses.replace(scene, camera=c)
                                  for c in cams])[0]
    tab = torch.as_tensor(cr._build_table(st, cr._build_layout(st)))
    pages = torch.as_tensor(pages)
    for axes, cpu_mesh in (
            ((("batch",),), Mesh(["cpu"] * 2, ("batch",))),
            ((("batch", "rows"), (2, 2)),
             Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2)))):
        n = 2 if len(axes) == 1 else 4
        k = cr.march_batch_rowshard(pages.to(cuda), tab.to(cuda), 48,
                                    _one_card_mesh(n, *axes))
        p = cr.march_batch_rowshard_plain(pages, tab, 48, cpu_mesh)
        assert lsb(k, p) <= 2, axes
    from gamer_tpu_torch.engine.allsky import allsky_dirs

    sky = _inside_scene()
    page, table, _, _ = cr.prepare(sky, "cpu")
    dirs = torch.as_tensor(allsky_dirs(8))
    k = cr.march_rays_rowshard(page.to(cuda), table.to(cuda), dirs.to(cuda),
                               _one_card_mesh(4))
    p = cr.march_rays_rowshard_plain(page, table, dirs, Mesh(["cpu"] * 4))
    assert lsb(k, p) <= 2


def test_batch_and_ray_shards_equal_unsharded(cuda):
    """S2 (3 frames on a 1-D mesh of 2 entries, no pad frame, and on a
    2-D one) and S3 (192 rays, 6 tiles dealt to 5 entries) are bit-equal
    to the unsharded launches."""
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    scene = _scene(presets.spiral(), 80)
    cams = orbit_path(scene.camera, 3, horizontal_deg=90.0)
    want = gt.render_flythrough(scene, cams, device="cuda")
    before = cr.march_batch_rowshard.launch_count
    got = gt.render_flythrough(scene, cams,
                               mesh=_one_card_mesh(2, ("batch",)))
    assert cr.march_batch_rowshard.launch_count == before + 2
    np.testing.assert_array_equal(got, want)
    got = gt.render_flythrough(
        scene, cams, mesh=_one_card_mesh(4, ("batch", "rows"), (2, 2)))
    np.testing.assert_array_equal(got, want)
    sky = _inside_scene()
    before = cr.march_rays_rowshard.launch_count
    got = gt.render_allsky_map(sky, 4, mesh=_one_card_mesh(5))
    assert cr.march_rays_rowshard.launch_count == before + 5
    np.testing.assert_array_equal(got, gt.render_allsky_map(sky, 4,
                                                            device="cuda"))


def test_service_round_trip_on_the_card(cuda):
    """Three concurrent requests are one batched launch, a lone one a
    fused launch; every served image is bit-equal to its render_scene."""
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.serve import DONE, RenderService

    scene = _scene(presets.spiral(), 64)
    scenes = [dataclasses.replace(scene, camera=c)
              for c in orbit_path(scene.camera, 3, horizontal_deg=60.0)]
    svc = RenderService(autostart=False)
    try:
        jids = [svc.submit(s) for s in scenes]
        svc.start()
        jobs = [svc.wait(j, timeout=120.0) for j in jids]
        assert [j.state for j in jobs] == [DONE] * 3, [j.error for j in jobs]
        assert svc.metrics["batches"] == 1 and all(j.batched for j in jobs)
        for j, s in zip(jobs, scenes):
            np.testing.assert_array_equal(
                j.image, gt.render_scene(s, device="cuda"))
        job = svc.wait(svc.submit(scene), timeout=120.0)
        assert job.state == DONE and svc.metrics["singles_fused"] == 1
        np.testing.assert_array_equal(job.image,
                                      gt.render_scene(scene, device="cuda"))
    finally:
        svc.stop()


def test_sharded_launches_on_several_cards(cuda):
    """S1-S3 and the service on a mesh of every visible card (needs at
    least two): the same frames, bit for bit, as card 0 alone."""
    import gamer_tpu_torch.parallel as par
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.serve import DONE, RenderService

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least two CUDA cards")
    mesh = par.make_pixel_mesh()
    assert mesh.size == n and len(set(mesh.devices)) == n
    scene = _scene(presets.spiral(), 200, supersample=2, no_stars=50)
    still = gt.render_scene(scene, device="cuda")
    before = cr.march_rowshard.launch_count
    np.testing.assert_array_equal(gt.render_scene(scene, mesh=mesh), still)
    assert cr.march_rowshard.launch_count > before
    cams = orbit_path(scene.camera, n + 1, horizontal_deg=90.0)
    small = _scene(presets.spiral(), 96)
    want = gt.render_flythrough(small, cams, device="cuda")
    np.testing.assert_array_equal(
        gt.render_flythrough(small, cams, mesh=par.global_batch_mesh()), want)
    if n % 2 == 0:
        np.testing.assert_array_equal(
            gt.render_flythrough(small, cams,
                                 mesh=par.pixel_tile_mesh_2d(rows_axis=2)),
            want)
    sky = _inside_scene()
    np.testing.assert_array_equal(gt.render_allsky_map(sky, 16, mesh=mesh),
                                  gt.render_allsky_map(sky, 16, device="cuda"))
    svc = RenderService(mesh=mesh, autostart=False)
    try:
        scenes = [dataclasses.replace(small, camera=c) for c in cams]
        jids = [svc.submit(s) for s in scenes] + [svc.submit(scene)]
        svc.start()
        jobs = [svc.wait(j, timeout=120.0) for j in jids]
        assert [j.state for j in jobs] == [DONE] * len(jobs), [
            j.error for j in jobs]
        for j, frame in zip(jobs, want):
            np.testing.assert_array_equal(j.image, frame)
        np.testing.assert_array_equal(jobs[-1].image, still)
    finally:
        svc.stop()


def _fit_problem(size=16):
    """A preview-sampled spiral, its frame as the target, and the spiral
    with winding_b x1.15 (fd) or every strength x1.5 (autograd)."""
    import copy

    scene = _scene(presets.spiral(), size, is_preview=True)
    target = gt.render_scene(scene, device="cpu")
    fd_start = copy.deepcopy(scene)
    fd_start.instances[0].galaxy.params.winding_b *= 1.15
    ag_start = copy.deepcopy(scene)
    for c in ag_start.instances[0].galaxy.components:
        c.strength *= 1.5
    return target, fd_start, ag_start


def test_fit_scene_fd_on_the_card_matches_cpu(cuda):
    """fit_scene_fd on the card: one march_batch launch per step plus the
    last iterate's, never the plain version; its losses within relative
    1e-3 of the CPU run's (the kernel is <= 2 LSB from its plain version,
    and finite differences magnify that in the later steps)."""
    from gamer_tpu_torch.engine import fit as tfit

    target, start, _ = _fit_problem()
    before = cr.march_batch.launch_count
    real_plain = cr.march_batch_plain
    cr.march_batch_plain = None  # a call to the plain version would raise
    try:
        card = tfit.fit_scene_fd(start, target, steps=2, device="cuda")
    finally:
        cr.march_batch_plain = real_plain
    assert cr.march_batch.launch_count == before + 3
    cpu = tfit.fit_scene_fd(start, target, steps=2, device="cpu")
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-3, atol=0)


def test_fit_scene_tensor_step_on_the_card_matches_cpu(cuda):
    """One tensor-march fit step on the card: losses and the fitted
    strengths within relative 1e-3 of the CPU's."""
    from gamer_tpu_torch.engine import fit as tfit

    target, _, start = _fit_problem()
    card = tfit.fit_scene(start, target, steps=1, march="tensor",
                          device="cuda")
    cpu = tfit.fit_scene(start, target, steps=1, march="tensor",
                         device="cpu")
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-3, atol=0)
    for a, b in zip(card.params[0]["comps"], cpu.params[0]["comps"]):
        np.testing.assert_allclose(a["strength"], b["strength"], rtol=1e-3)


@pytest.mark.parametrize("preset", ["spiral", "barred_spiral", "elliptical",
                                    "irregular", "dusty_disk", "ring",
                                    "flocculent"])
def test_kernel_meets_the_oracle_gate_at_512(cuda, preset):
    """The kernel's 512^2 frame of each preset against the spec oracle's
    stored frame (gamer_tpu_torch/golden.py): <= 3 LSB, < 5 % of pixels."""
    from gamer_tpu_torch.golden import (diff_record, load_oracle_frame,
                                        oracle_gate, oracle_scene)

    gold = load_oracle_frame(preset)["image"]
    ours = gt.render_scene(oracle_scene(preset, gold.shape[0]),
                           device="cuda")
    rec = diff_record(gold, ours)
    assert oracle_gate(rec), rec


def test_progressive_frame_at_4096_is_the_still(cuda):
    """render_progressive at 4096^2 (one launch, 16 bands of 256 rows):
    bit-equal to render_scene, its ticks in order."""
    scene = _scene(presets.spiral(), 4096)
    ticks = []
    before = cr.march_progressive.launch_count
    prog = gt.render_progressive(scene, bands=16, device="cuda",
                                 on_progress=lambda f, _: ticks.append(f))
    assert cr.march_progressive.launch_count == before + 1
    assert ticks == [(b + 1) / 16 for b in range(16)]
    np.testing.assert_array_equal(prog, gt.render_scene(scene,
                                                        device="cuda"))
