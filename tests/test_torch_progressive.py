"""The progressive frame as one launch (K5, ``march_progressive``) on the
CPU: the band each tile of the kernel's enumeration counts toward, the
plain version against ``march_plain``, ``render_progressive``'s host loop
over a completion source that reports bands out of order and in bursts
(ticks, partial frames, abort and errors), and the wrapper's checks. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: the progressive plain version marches more rows than the frame
in one lockstep run, and torch's vector and scalar paths on the CPU may
round a few transcendental results differently, so its frame is held to
``march_plain``'s within 1e-6 (as tests/test_torch_band.py holds a band).
The host loop's frames are held bit for bit: the epilogue of a run of
bands is elementwise, and at gamma 1 its operations round the same on
every path."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine.render import pool_linear, post_process  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread under the parallel test run (see
    tests/test_torch_band.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size, bulge_only=False, **cfg):
    galaxy = presets.spiral()
    if bulge_only:  # a cheap march: one component, no noise
        galaxy.components = galaxy.components[:1]
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy)],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg))


# --- the band of each tile ------------------------------------------------


def _tile_band(t, frame_size, band_rows):
    """csrc/march.cu's band of tile t (an int array) of the progressive
    launch: tiles are enumerated over (tile row, tile col) of the padded
    frame, and tile row ty counts toward band ty / (band_rows / TILE_H)."""
    return (t // -(-frame_size // cr.TILE_W)) // (band_rows // cr.TILE_H)



@pytest.mark.parametrize("size,ss,bands", [
    (40, 1, 2), (16, 1, 16), (20, 2, 2), (100, 3, 4), (100, 3, 16),
    (512, 1, 1), (512, 1, 16), (256, 2, 16), (600, 1, 7), (1000, 1, 16),
    (1024, 1, 16), (1024, 1, 3), (344, 3, 16)])
def test_tile_band(size, ss, bands):
    """Every tile of the progressive launch, in the kernel's (tile row,
    tile col) order over the padded frame, lies wholly in the band the
    kernel counts it toward; every band has frame_tiles(S, band_rows)
    tiles, the padded frame frame_tiles(S, rows) in all."""
    S = size * ss
    band_rows, n_bands = cr.band_geometry(size, ss, bands)
    assert band_rows % cr.TILE_H == 0 and n_bands * band_rows >= S
    assert band_rows % (cr.TILE_R_LARGE if S >= 1024 else cr.TILE_R) == 0
    rows = n_bands * band_rows
    n_tiles = cr.frame_tiles(S, rows)
    t = np.arange(n_tiles)
    band = _tile_band(t, S, band_rows)
    tiles_x = -(-S // cr.TILE_W)
    ty = t // tiles_x
    # the tile's first and last pixel rows lie in its band's rows
    assert ((ty * cr.TILE_H) // band_rows == band).all()
    assert ((ty * cr.TILE_H + cr.TILE_H - 1) // band_rows == band).all()
    counts = np.bincount(band, minlength=n_bands)
    assert len(counts) == n_bands
    assert (counts == cr.frame_tiles(S, band_rows)).all()
    assert counts.sum() == n_tiles
    # tiles are taken in order, so band b's tiles are one run
    assert (np.diff(band) >= 0).all()
    assert _tile_band(n_tiles - 1, S, band_rows) == n_bands - 1


# --- the plain version ----------------------------------------------------


def _quick_page(size):
    """The page of the spiral's bulge: a march of one component."""
    return cr.prepare(_scene(size, bulge_only=True), "cpu")


def test_march_progressive_plain_equals_march_plain():
    page, table, size, _ = _quick_page(8)
    full = cr.march_plain(page, table, size)
    got = cr.march_progressive_plain(page, table, size, 4, 3)
    assert got.shape == (12, 8, 3)
    torch.testing.assert_close(got[:8], full, rtol=0, atol=1e-6)
    assert float(got[8:].abs().max()) == 0.0  # rows past the frame
    # the frame starts at row 0 whatever row0 the page holds
    shifted = cr._with_row0(page, 4)
    torch.testing.assert_close(
        cr.march_progressive_plain(shifted, table, size, 4, 3), got,
        rtol=0, atol=0)
    assert float(shifted[cr.G_ROW0]) == 4.0  # the caller's page untouched


# --- the host loop over a completion source -------------------------------


class _Source:
    """Bands from a precomputed radiance ``lin``, finishing at the seeded
    times ``done_at`` (any order, several at once): ``wait(b)`` moves the
    clock to band b's time and reports the run of finished bands from b."""

    def __init__(self, lin, band_rows, done_at):
        self.lin, self.band_rows = lin, band_rows
        self.done_at = list(done_at)
        self.clock = -np.inf
        self.waits, self.stops = [], 0

    def wait(self, b):
        assert self.stops == 0, "waited after stop"
        self.waits.append(b)
        self.clock = max(self.clock, self.done_at[b])
        n = 1
        while b + n < len(self.done_at) and self.done_at[b + n] <= self.clock:
            n += 1
        return n

    def bands(self, b, n):
        return self.lin[b * self.band_rows:(b + n) * self.band_rows]

    def stop(self):
        self.stops += 1


def _orders(n, seed):
    """Completion times of n bands: in order one at a time, a seeded
    permutation and the reverse order (out of order), seeded bursts (runs
    that finish together) and all at once."""
    rng = np.random.default_rng(seed)
    bursty = np.repeat(np.arange(n), rng.integers(1, 5, n))[:n]
    return {"in_order": np.arange(n), "permuted": rng.permutation(n),
            "bursty": bursty, "all_at_once": np.zeros(n),
            "reversed": np.arange(n)[::-1]}


@pytest.fixture(scope="module")
def plan():
    """A 128^2 frame at supersample 2 with 40 stars: 8 bands of 32 march
    rows (16 output rows), with seeded radiance standing in for the
    march."""
    p = cr._Bands(_scene(128, supersample=2, no_stars=40, star_size=20.0,
                         star_seed=3), 16, CPU)
    assert (p.band_rows, p.n_bands, p.band_out) == (32, 8, 16)
    rng = np.random.default_rng(11)
    lin = torch.as_tensor(rng.uniform(
        0.0, 30.0, (p.n_bands * p.band_rows, p.S, 3)).astype(np.float32))
    return p, lin


def _run(plan, order, stop_at=None):
    p, lin = plan
    src = _Source(lin, p.band_rows, order)
    ticks, partials = [], []

    def on_progress(frac, partial):
        ticks.append(frac)
        partials.append(partial)
        return not (stop_at is not None and len(ticks) == stop_at + 1)

    img = cr._band_loop(p, src, on_progress)
    return img, ticks, partials, src


def test_host_loop_ticks_in_order_one_per_band(plan):
    p, lin = plan
    want = post_process(pool_linear(lin, p.ss) + p.overlay,
                        *p.post).numpy()[:p.size]
    base, base_ticks, base_partials, _ = _run(plan, _orders(8, 0)["in_order"])
    np.testing.assert_array_equal(base, want)
    assert base_ticks == [(b + 1) / 8 for b in range(8)]
    for b, partial in enumerate(base_partials):
        rows = (b + 1) * p.band_out
        np.testing.assert_array_equal(partial[:rows], want[:rows])
        assert int(partial[rows:].sum()) == 0
    for seed in (1, 2, 3):
        for name, order in _orders(8, seed).items():
            img, ticks, partials, src = _run(plan, order)
            assert ticks == base_ticks, name
            np.testing.assert_array_equal(img, base)
            for got, ref in zip(partials, base_partials):
                np.testing.assert_array_equal(got, ref)
            assert src.stops == 1 and len(src.waits) <= 8


@pytest.mark.parametrize("order", ["in_order", "bursty", "all_at_once"])
def test_host_loop_abort_at_every_tick(plan, order):
    """False at tick b returns bands 0..b and black below, the same array
    as the band-by-band path's; the source is stopped and not waited on
    again."""
    p, _ = plan
    _, _, base_partials, _ = _run(plan, _orders(8, 0)["in_order"])
    for b in range(8):
        img, ticks, partials, src = _run(plan, _orders(8, 4)[order],
                                         stop_at=b)
        assert len(ticks) == b + 1
        np.testing.assert_array_equal(img, base_partials[b])
        np.testing.assert_array_equal(img, partials[-1])
        assert src.stops == 1 and src.waits[-1] <= b


def test_host_loop_stops_the_source_on_an_error(plan):
    for b in (0, 3, 7):
        src_seen = []

        def run():
            p, lin = plan
            src = _Source(lin, p.band_rows, _orders(8, 5)["bursty"])
            src_seen.append(src)

            def on_progress(frac, partial):
                if frac * 8 == b + 1:
                    raise KeyError("from on_progress")

            return cr._band_loop(p, src, on_progress)

        with pytest.raises(KeyError):
            run()
        assert src_seen[0].stops == 1

    class Failing(_Source):
        def wait(self, b):
            if b >= 2:
                raise RuntimeError("the launch ended with the band unset")
            return super().wait(b)

    p, lin = plan
    src = Failing(lin, p.band_rows, np.arange(8))
    with pytest.raises(RuntimeError, match="unset"):
        cr._band_loop(p, src, None)
    assert src.stops == 1


def test_render_progressive_cpu_is_the_loop_over_plain_bands():
    """On the CPU render_progressive is the host loop over the plain bands:
    the same frame and ticks as the loop driven by hand, and as the loop
    over the wrapper's launch handle (its plain version: every band
    finished at once)."""
    scene = _scene(40, bulge_only=True)
    ticks = []
    img = gt.render_progressive(scene, bands=2, device="cpu",
                                on_progress=lambda f, _: ticks.append(f))
    p = cr._Bands(scene, 2, CPU)
    np.testing.assert_array_equal(
        img, cr._band_loop(p, cr._PlainBands(p), None))
    assert ticks == [0.5, 1.0]
    launch = cr.march_progressive(p.page, p.table, p.S, p.band_rows,
                                  p.n_bands)
    ticks.clear()
    np.testing.assert_array_equal(
        cr._band_loop(p, launch, lambda f, _: ticks.append(f)), img)
    assert ticks == [0.5, 1.0] and launch.abort.tolist() == [1]


# --- the wrapper ----------------------------------------------------------


def test_progress_words_on_the_cpu():
    """The plain version's launch handle: every band flag set, the abort
    word 0, host tensors that are not pinned, no device counters or end
    event; wait reports every band from the one asked for, and stop sets
    the abort word."""
    page, table, size, _ = _quick_page(4)
    launch = cr.march_progressive(page, table, size, 4, 5)
    flags, abort = launch.flags, launch.abort
    assert flags.dtype == abort.dtype == torch.int32
    assert flags.tolist() == [1] * 5 and abort.tolist() == [0]
    assert not flags.is_pinned() and not abort.is_pinned()
    assert launch.counters is None and launch.end is None
    assert [launch.wait(b) for b in range(5)] == [5, 4, 3, 2, 1]
    assert launch.bands(1, 2).shape == (8, size, 3)
    torch.testing.assert_close(launch.bands(1, 2), launch.out[4:12],
                               rtol=0, atol=0)
    launch.stop()
    assert abort.tolist() == [1]


def test_progressive_wrapper_launches_nothing_on_cpu():
    page, table, size, _ = _quick_page(4)
    before = (cr.march_progressive.launch_count, dict(cr.KIND_LAUNCHES),
              cr.march.launch_count, cr.march_band.launch_count)
    got = cr.march_progressive(page, table, size, 4, 2)
    want = cr.march_progressive_plain(page, table, size, 4, 2)
    torch.testing.assert_close(got.out, want, rtol=0, atol=0)
    assert got.flags.tolist() == [1, 1]
    assert (cr.march_progressive.launch_count, dict(cr.KIND_LAUNCHES),
            cr.march.launch_count, cr.march_band.launch_count) == before
    gt.render_progressive(_scene(6, bulge_only=True), bands=4, device="cpu")
    assert cr.march_progressive.launch_count == before[0]


def test_progressive_wrapper_rejects_bad_inputs():
    page, table, size, _ = _quick_page(4)
    before = cr.march_progressive.launch_count

    def call(**kw):
        args = dict(page=page, table=table, frame_size=size, band_rows=4,
                    n_bands=2)
        args.update(kw)
        return cr.march_progressive(**args)

    with pytest.raises(TypeError):
        call(page=page.double())
    with pytest.raises(TypeError):
        call(table=table.long())
    with pytest.raises(ValueError):
        call(table=table.to("meta"))
    with pytest.raises(ValueError, match="multiple"):
        call(band_rows=6)
    with pytest.raises(ValueError, match="positive"):
        call(n_bands=0)
    with pytest.raises(ValueError, match="positive"):
        call(band_rows=0)
    with pytest.raises(ValueError, match="positive"):
        call(frame_size=0)
    with pytest.raises(ValueError, match="2\\^24"):
        call(band_rows=1 << 22, n_bands=4)
    assert cr.march_progressive.launch_count == before  # nothing ran
