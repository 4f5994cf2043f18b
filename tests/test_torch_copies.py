"""The JAX-free modules that gamer_tpu_torch copies for its band, batch and
all-sky paths, held equal to the originals: the .gax codec,
RenderParams.dat, the seeded RNG, scene and dataset generation, morphing,
camera controls, the log and timers, HEALPix, Mollweide, the FITS reader
and the stored Perlin tables of seed 94. The port never imports ``gamer_tpu``, so each copy is
checked here on presets and seeds."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import gamer_tpu.scene.schema as jschema  # noqa: E402
from gamer_tpu.io import renderparams as jrp  # noqa: E402
from gamer_tpu.models import presets as jpresets  # noqa: E402
from gamer_tpu.scene import cameracontrols as jcc  # noqa: E402
from gamer_tpu.scene import gax as jgax  # noqa: E402
from gamer_tpu.scene import generate as jgen  # noqa: E402
from gamer_tpu.scene import morph as jmorph  # noqa: E402
from gamer_tpu.utils import log as jlog  # noqa: E402
from gamer_tpu.utils import rng as jrng  # noqa: E402
from gamer_tpu.utils import timers as jtimers  # noqa: E402

from gamer_tpu_torch.io import renderparams as trp  # noqa: E402
from gamer_tpu_torch.models import presets as tpresets  # noqa: E402
from gamer_tpu_torch.scene import cameracontrols as tcc  # noqa: E402
from gamer_tpu_torch.scene import gax as tgax  # noqa: E402
from gamer_tpu_torch.scene import generate as tgen  # noqa: E402
from gamer_tpu_torch.scene import morph as tmorph  # noqa: E402
from gamer_tpu_torch.scene import schema as tschema  # noqa: E402
from gamer_tpu_torch.utils import log as tlog  # noqa: E402
from gamer_tpu_torch.utils import rng as trng  # noqa: E402
from gamer_tpu_torch.utils import timers as ttimers  # noqa: E402

PRESETS = sorted(jpresets.GALLERY)


@pytest.mark.parametrize("name", PRESETS)
def test_gax_dumps_and_loads_match_jax(name):
    ours = tpresets.GALLERY[name]()
    data = tgax.dumps(ours)
    assert data == jgax.dumps(jpresets.GALLERY[name]())
    back = tgax.loads(data)
    assert back == ours
    assert tschema._to_dict(back) == jschema._to_dict(jgax.loads(data))


def test_gax_file_roundtrip_and_truncation(tmp_path):
    g = tpresets.spiral()
    tgax.save(g, tmp_path / "s.gax")
    assert (tmp_path / "s.gax").read_bytes() == jgax.dumps(jpresets.spiral())
    assert tgax.load(tmp_path / "s.gax") == g
    data = tgax.dumps(g)
    for cut in (3, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError):
            jgax.loads(data[:cut])
        with pytest.raises(ValueError):
            tgax.loads(data[:cut])


def _params_file(mod, schema):
    return mod.RenderParamsFile(
        camera=schema.CameraParams(camera=(0.5, 0.25, -1.0),
                                   target=(0.1, 0.0, 0.2), up=(0, 0, 1),
                                   fov=75.0),
        size=96, preview_size=48, exposure=1.3, gamma=0.9, saturation=1.2,
        no_stars=17, star_size=2.5, star_size_spread=0.7, star_strength=1.1,
        ray_step=0.02, current_galaxy="Spiral.gax", scene_mode="scene",
        spectra={"Custom": (0.1, 0.2, 0.3), "Warm": (1.0, 0.8, 0.5)},
        nside=16, render_type="hpx")


def test_renderparams_match_jax():
    ours = _params_file(trp, tschema)
    data = ours.dumps()
    assert data == _params_file(jrp, jschema).dumps()
    back = trp.RenderParamsFile.loads(data)
    assert back == ours
    assert (tschema._to_dict(back.to_render_config(size=40))
            == jschema._to_dict(jrp.RenderParamsFile.loads(data)
                                .to_render_config(size=40)))
    # a file from before nside/renderType ends at the spectra
    short = data[:-(4 + 4 + 2 * len("hpx"))]
    old_t, old_j = trp.RenderParamsFile.loads(short), jrp.RenderParamsFile.loads(short)
    assert (old_t.nside, old_t.render_type) == (old_j.nside, old_j.render_type)


@pytest.mark.parametrize("seed", [0, 1, 5489, 123456])
def test_rng_streams_match_jax(seed):
    a, b = trng.Rng(seed), jrng.Rng(seed)
    for _ in range(20):
        assert a.next_double(-2.0, 3.0) == b.next_double(-2.0, 3.0)
        assert a.next_gaussian(1.0, 0.5) == b.next_gaussian(1.0, 0.5)
        assert a.next_int(0, 9) == b.next_int(0, 9)
        assert a.next_bool() == b.next_bool()
        assert a.next_vec3(-1, 1) == b.next_vec3(-1, 1)


@pytest.mark.parametrize("seed", [3, 11])
def test_generate_scene_matches_jax(seed):
    names = ["spiral", "ring", "dusty_disk"]
    ours = tgen.generate_scene([tpresets.GALLERY[n]() for n in names], 5, 3.0,
                               seed=seed)
    ref = jgen.generate_scene([jpresets.GALLERY[n]() for n in names], 5, 3.0,
                              seed=seed)
    assert tschema.scene_to_dict(ours) == jschema.scene_to_dict(ref)


@pytest.mark.parametrize("name,seed", [("spiral", 0), ("flocculent", 5),
                                       ("irregular", 9)])
def test_generate_variations_match_jax(name, seed):
    ours = tgen.generate_galaxy_variations(tpresets.GALLERY[name](), 4,
                                           seed=seed, jitter=0.3)
    ref = jgen.generate_galaxy_variations(jpresets.GALLERY[name](), 4,
                                          seed=seed, jitter=0.3)
    assert [tschema._to_dict(g) for g in ours] == [jschema._to_dict(g)
                                                   for g in ref]


def test_morph_matches_jax():
    a_t, a_j = tpresets.spiral(), jpresets.spiral()
    b_t = tpresets.spiral(winding_n=6.0, winding_b=0.8)
    b_j = jpresets.spiral(winding_n=6.0, winding_b=0.8)
    for t in (0.0, 0.3, 1.0):
        assert (tschema._to_dict(tmorph.lerp_galaxy(a_t, b_t, t))
                == jschema._to_dict(jmorph.lerp_galaxy(a_j, b_j, t)))
    base_t = tschema.Scene(instances=[tschema.GalaxyInstance(galaxy=a_t)])
    base_j = jschema.Scene(instances=[jschema.GalaxyInstance(galaxy=a_j)])
    for ease in ("smoothstep", "linear"):
        ours = tmorph.morph_scenes(base_t, b_t, 4, ease=ease)
        ref = jmorph.morph_scenes(base_j, b_j, 4, ease=ease)
        assert ([tschema.scene_to_dict(s) for s in ours]
                == [jschema.scene_to_dict(s) for s in ref])
    for mod, a, b in ((tmorph, a_t, tpresets.ring()),
                      (jmorph, a_j, jpresets.ring())):
        with pytest.raises(ValueError, match="morph-compatible"):
            mod.lerp_galaxy(a, b, 0.5)


def test_camera_controls_match_jax():
    cams = [(tschema.CameraParams(camera=c, target=t, up=u),
             jschema.CameraParams(camera=c, target=t, up=u))
            for c, t, u in (((0.5, 0, 0), (0, 0, 0), (0, 1, 0)),
                            ((1.2, 0.3, -0.4), (0.1, 0, 0.2), (0, 0, 1)))]
    for ct, cj in cams:
        for fn, args in (("rotate_horizontal", (37.0,)),
                         ("rotate_vertical", (-15.0,)), ("zoom", (0.2,)),
                         ("translate", (0.1, -0.3)), ("rotate_up", (20.0,))):
            ours = getattr(tcc, fn)(ct, *args)
            ref = getattr(jcc, fn)(cj, *args)
            assert tschema._to_dict(ours) == jschema._to_dict(ref), fn
        ours = tcc.orbit_path(ct, 5, horizontal_deg=270.0, vertical_deg=30.0,
                              zoom_total=0.1)
        ref = jcc.orbit_path(cj, 5, horizontal_deg=270.0, vertical_deg=30.0,
                             zoom_total=0.1)
        assert ([tschema._to_dict(c) for c in ours]
                == [jschema._to_dict(c) for c in ref])


def test_log_and_timers_match_jax():
    for ms in (0.0, -5.0, 12.3, 999.9, 61_234.5, 3_725_000.0, 7.2e6):
        assert ttimers.format_ms(ms) == jtimers.format_ms(ms)
    tlog.Messages.clear()
    for k in range(9):
        tlog.Messages.message(f"m{k}")
    assert [m.split("] ", 1)[1] for m in tlog.Messages.last()] == [
        f"m{k}" for k in range(2, 9)]
    assert len(tlog.Messages.last()) == jlog._RING_CAPACITY
    with ttimers.ScopedTimer("t", quiet=True) as t:
        pass
    assert t.elapsed_ms is not None and t.elapsed_ms >= 0.0


# ---------------------------------------------------------------------------
# the all-sky path's copies and the stored Perlin tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nside", [1, 2, 8, 32])
def test_healpix_copy_matches_jax(nside):
    import numpy as np

    from gamer_tpu.post import healpix as jhp
    from gamer_tpu_torch.post import healpix as thp

    ipix = np.arange(jhp.npix(nside))
    assert thp.npix(nside) == jhp.npix(nside)
    np.testing.assert_array_equal(thp.pix2vec_ring(nside, ipix),
                                  jhp.pix2vec_ring(nside, ipix))
    for a, b in zip(thp.pix2ang_ring(nside, ipix),
                    jhp.pix2ang_ring(nside, ipix)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(nside)
    theta = rng.uniform(1e-6, np.pi - 1e-6, 4000)
    phi = rng.uniform(-2 * np.pi, 4 * np.pi, 4000)
    np.testing.assert_array_equal(thp.ang2pix_ring(nside, theta, phi),
                                  jhp.ang2pix_ring(nside, theta, phi))
    # a pixel's centre maps back to the pixel
    t, p = thp.pix2ang_ring(nside, ipix)
    np.testing.assert_array_equal(thp.ang2pix_ring(nside, t, p), ipix)


@pytest.mark.parametrize("size", [16, 33])
def test_mollweide_copy_matches_jax(size):
    import numpy as np

    from gamer_tpu.post import mollweide as jmw
    from gamer_tpu_torch.post import mollweide as tmw

    for a, b in zip(tmw.mollweide_lookup(size), jmw.mollweide_lookup(size)):
        np.testing.assert_array_equal(a, b)
    hpx = np.random.default_rng(size).uniform(0, 5, 12 * 4 * 4)
    ours = tmw.mollweide_image(hpx, 4, size)
    assert ours.shape == (size, size, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jmw.mollweide_image(hpx, 4, size))


@pytest.mark.parametrize("shape,dtype", [((5, 7), ">f8"), ((1, 48), ">f8"),
                                         ((4, 6), ">f4"), ((3, 3), ">i2"),
                                         ((12,), ">i4")])
def test_fits_reader_copy_matches_jax(tmp_path, shape, dtype):
    import numpy as np

    from gamer_tpu.io import fits as jfits
    from gamer_tpu_torch.io import fits as tfits

    data = (np.random.default_rng(len(shape)).uniform(-50, 50, shape)
            .astype(dtype))
    bitpix = {">f8": -64, ">f4": -32, ">i2": 16, ">i4": 32}[dtype]
    cards = [tfits._card("SIMPLE", "T"), tfits._card("BITPIX", str(bitpix)),
             tfits._card("NAXIS", str(len(shape)))]
    cards += [tfits._card(f"NAXIS{i + 1}", str(n))
              for i, n in enumerate(shape[::-1])]
    hdr = b"".join(cards) + "END".ljust(80).encode()
    raw = hdr.ljust(2880, b" ") + data.tobytes()
    path = tmp_path / "img.fits"
    path.write_bytes(raw + b"\0" * (-len(raw) % 2880))
    ours = tfits.read_fits_image(path)
    assert ours.shape == shape and ours.dtype == np.float64
    np.testing.assert_array_equal(ours, jfits.read_fits_image(path))
    np.testing.assert_array_equal(ours, data.astype(np.float64))
    if dtype == ">f8" and len(shape) == 2:
        # the writer's own files: rows flipped on export
        tfits.write_fits_image(tmp_path / "w.fits", ours)
        np.testing.assert_array_equal(
            tfits.read_fits_image(tmp_path / "w.fits"), ours[::-1])
    with pytest.raises(ValueError, match="truncated"):
        (tmp_path / "cut.fits").write_bytes(raw[:100])
        tfits.read_fits_image(tmp_path / "cut.fits")


def test_stored_perlin_tables_equal_the_seeded_build():
    """data/perlin_seed94.npz holds what ``_perlin_build(94)`` and
    ``_perlin_build2(94)`` draw here; the port never draws them itself."""
    import numpy as np

    from gamer_tpu.ops import altnoise as jalt
    from gamer_tpu_torch.ops import altnoise as talt

    perm, g2 = talt.perlin_tables()
    assert perm.dtype == np.int32 and g2.dtype == np.float32
    np.testing.assert_array_equal(perm, jalt._perlin_build(94)[0])
    np.testing.assert_array_equal(np.sort(perm), np.arange(1024))
    np.testing.assert_array_equal(g2, jalt._perlin_build2(94))
    # the gradient triples the hash regenerates are the stored g3 table
    qx, qy, qz = talt.grad_hash_q(torch.arange(1024))
    q = np.stack([qx.numpy(), qy.numpy(), qz.numpy()], axis=-1)
    np.testing.assert_array_equal(q, jalt._perlin_build(94)[1])
    assert talt.SAMPLE_SIZE == jalt.SAMPLE_SIZE



def test_presets_fixture_matches_jax(tmp_path, monkeypatch):
    """``presets.fixture`` / ``fixture_names`` load the same galaxies from
    the same directory in both packages, and miss the same way."""
    for name in ("spiral", "ring"):
        jgax.save(getattr(jpresets, name)(), tmp_path / f"{name}.gax")
    (tmp_path / "notes.txt").write_text("not a galaxy")
    monkeypatch.setattr(jpresets, "FIXTURE_DIR", tmp_path)
    monkeypatch.setattr(tpresets, "FIXTURE_DIR", tmp_path)
    assert tpresets.fixture_names() == jpresets.fixture_names() == [
        "ring", "spiral"]
    for name in tpresets.fixture_names():
        assert (tschema._to_dict(tpresets.fixture(name))
                == jschema._to_dict(jpresets.fixture(name)))
    with pytest.raises(FileNotFoundError, match="nebula"):
        tpresets.fixture("nebula")
    with pytest.raises(FileNotFoundError, match="nebula"):
        jpresets.fixture("nebula")
    monkeypatch.setattr(tpresets, "FIXTURE_DIR", tmp_path / "absent")
    assert tpresets.fixture_names() == []


@pytest.mark.parametrize("case", ["plain", "preview", "perlin-stars"])
def test_scene_dict_payload_round_trips_like_jax(case):
    """The service's state that crosses: the same JSON scene dict goes
    through both ``scene_from_dict`` and comes back out of both
    ``scene_to_dict`` equal, so both services render the same request;
    including the LOD fields the preview phase sets."""
    import json

    scene = jschema.Scene(
        camera=jschema.CameraParams(camera=(0.5, 0.1, 0), target=(0, 0, 0),
                                    up=(0, 1, 0), fov=75.0),
        instances=[jschema.GalaxyInstance(galaxy=jpresets.spiral()),
                   jschema.GalaxyInstance(galaxy=jpresets.dusty_disk(),
                                          position=(0.4, 0.0, -0.6),
                                          orientation=(0.3, 0.8, 0.1),
                                          intensity_scale=0.7)],
        config=jschema.RenderConfig(size=24, ray_step=0.025, **{
            "plain": {},
            "preview": dict(noise_octaves=3, is_preview=True),
            "perlin-stars": dict(noise_kind="perlin", no_stars=50,
                                 star_seed=9, supersample=2, exposure=1.5),
        }[case]))
    payload = json.loads(json.dumps(jschema.scene_to_dict(scene)))
    ours = tschema.scene_to_dict(tschema.scene_from_dict(payload))
    ref = jschema.scene_to_dict(jschema.scene_from_dict(payload))
    assert ours == ref == payload
    cfg = tschema.scene_from_dict(payload).config
    assert cfg.min_ray_step == jschema.scene_from_dict(
        payload).config.min_ray_step
    if case == "preview":
        assert cfg.noise_octaves == 3 and cfg.is_preview is True
