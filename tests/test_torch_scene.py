"""gamer_tpu_torch's own scene model, presets, tables, star draws and FITS
writer against the JAX package's: the port carries copies of them so that
it never imports ``gamer_tpu``, and the copies must not drift."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu.scene.schema as jschema  # noqa: E402
from gamer_tpu.io import fits as jfits  # noqa: E402
from gamer_tpu.models import presets as jpresets  # noqa: E402
from gamer_tpu.oracle import qtmath as qm  # noqa: E402
from gamer_tpu.ops.tables import PERM as JPERM  # noqa: E402
from gamer_tpu.post import stars as jstars  # noqa: E402
from gamer_tpu.scene.spectra import BUILTIN_SPECTRA, find_spectrum  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import scene_prep as tsp  # noqa: E402
from gamer_tpu_torch.io import fits as tfits  # noqa: E402
from gamer_tpu_torch.models import presets as tpresets  # noqa: E402
from gamer_tpu_torch.ops.tables import PERM  # noqa: E402
from gamer_tpu_torch.post import stars as tstars  # noqa: E402
from gamer_tpu_torch.scene import schema as tschema  # noqa: E402
from gamer_tpu_torch.scene import spectra as tspectra  # noqa: E402

CLASSES = ["GalaxyParams", "ComponentParams", "GalaxyData", "GalaxyInstance",
           "CameraParams", "RenderConfig", "Scene"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    ours, ref = getattr(tschema, name), getattr(jschema, name)

    def spec(cls):
        out = []
        for f in dataclasses.fields(cls):
            d = f.default
            if f.default_factory is not dataclasses.MISSING:
                d = jschema._to_dict(f.default_factory())
            out.append((f.name, f.type, d))
        return out

    assert spec(ours) == spec(ref)


def _rich_scene_dict():
    g = jpresets.spiral()
    g.components.append(jschema.ComponentParams(
        class_name="stars small", spectrum="Purple", strength=300.0,
        scale=40.0, active=0.0, inner=0.2, delta=0.3))
    scene = jschema.Scene(
        camera=jschema.CameraParams(camera=(1, 2, 3), target=(0.1, 0, 0),
                                    up=(0, 0, 1), fov=55.0),
        instances=[
            jschema.GalaxyInstance(galaxy=g, position=(0.5, 0.2, -0.8),
                                   orientation=(0.3, 0.8, 0.1),
                                   intensity_scale=0.7, redshift=0.1,
                                   name="a"),
            jschema.GalaxyInstance(galaxy=jpresets.ring()),
        ],
        config=jschema.RenderConfig(size=33, ray_step=0.02, exposure=1.5,
                                    gamma=0.8, saturation=0.5,
                                    is_preview=True, no_stars=12,
                                    star_size=3.0, star_seed=9,
                                    deterministic=False, noise_octaves=4,
                                    supersample=2, dither=True),
        spectra={"Custom": (0.1, 0.2, 0.3)},
    )
    return jschema.scene_to_dict(scene)


@pytest.mark.parametrize("case", ["rich", "sparse", "empty"])
def test_scene_dict_roundtrip_matches_jax(case):
    d = {
        "rich": _rich_scene_dict(),
        # ints where floats are expected, most keys absent
        "sparse": {"camera": {"camera": [0, 0, 2], "fov": 60},
                   "instances": [{"galaxy": {"params": {"no_arms": 3},
                                             "components": [{"class_name": "disk",
                                                             "strength": 5}]},
                                  "position": [1, 0, 0]}],
                   "config": {"size": 8, "noise_octaves": None}},
        "empty": {},
    }[case]
    ours = tschema.scene_from_dict(d)
    ref = jschema.scene_from_dict(d)
    assert tschema.scene_to_dict(ours) == jschema.scene_to_dict(ref)
    assert tschema.scene_from_dict(tschema.scene_to_dict(ours)) == ours


@pytest.mark.parametrize("kw", [dict(noise_kind="gabor"), dict(noise_octaves=0),
                                dict(noise_octaves=2.5), dict(supersample=0)])
def test_render_config_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        jschema.RenderConfig(**kw)
    with pytest.raises(ValueError):
        tschema.RenderConfig(**kw)


def test_class_ids_and_min_step_match():
    for name in [*jschema.CLASS_NAME_TO_CID, "Dust Positive", "nope", ""]:
        assert tschema.class_name_to_cid(name) == jschema.class_name_to_cid(name)
    for preview in (False, True):
        assert (tschema.RenderConfig(is_preview=preview).min_ray_step
                == jschema.RenderConfig(is_preview=preview).min_ray_step)


@pytest.mark.parametrize("name", sorted(jpresets.GALLERY))
def test_presets_match_jax(name):
    assert set(tpresets.GALLERY) == set(jpresets.GALLERY)
    ours = tschema._to_dict(tpresets.GALLERY[name]())
    assert ours == jschema._to_dict(jpresets.GALLERY[name]())


@pytest.mark.parametrize("n", [1, 2, 3])
def test_default_galaxy_matches_jax(n):
    assert (tschema._to_dict(gt.default_galaxy(n))
            == jschema._to_dict(jschema.default_galaxy(n)))


def test_spectra_and_perm_match_jax():
    assert tspectra.BUILTIN_SPECTRA == BUILTIN_SPECTRA
    table = {"Custom": (0.1, 0.2, 0.3), "RED": (0.5, 0.5, 0.5)}
    for name in ["Red", "yellow", "BLUE", "custom", "unknown", "red"]:
        assert tspectra.find_spectrum(name) == find_spectrum(name)
        assert (tspectra.find_spectrum(name, table)
                == find_spectrum(name, table))
    assert PERM.dtype == JPERM.dtype
    np.testing.assert_array_equal(PERM, JPERM)


@pytest.mark.parametrize("args", [(64, 50, 20.0, 1.0, 1.0, 7),
                                  (512, 300, 3.0, 0.5, 2.0, 0),
                                  (16, 0, 1.0, 1.0, 1.0, 1),
                                  (8, 10, 0.1, 1.0, 1.0, 2)])
def test_star_draws_match_jax(args):
    ours = tstars.star_params(*args)
    ref = jstars.star_params(*args)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tstars.pad_star_rows(ours),
                                  jstars.pad_star_rows(ref))


def test_fits_writer_matches_jax_bytes(tmp_path):
    lin = np.random.default_rng(3).normal(size=(5, 7, 3)).astype(np.float32)
    ours = tfits.write_fits_channels(tmp_path / "a", lin)
    ref = jfits.write_fits_channels(tmp_path / "b", lin)
    assert [p.name[1:] for p in ours] == [p.name[1:] for p in ref]
    for p, q in zip(ours, ref):
        assert p.read_bytes() == q.read_bytes()
    with pytest.raises(ValueError):
        tfits.write_fits_image(tmp_path / "c.fits", lin)


VECTORS = [(0, 1, 0), (0, -1, 0), (0.3, 0.8, 0.1), (1, 0, 0), (0, 0, 0),
           (0, 2, 0), (1e-7, 1.0, 0), (-1e-7, -1.0, 0), (-0.2, -0.9, 0.4),
           (3, -4, 12)]


@pytest.mark.parametrize("v", VECTORS)
def test_qt_vector_math_matches_qtmath(v):
    """scene_prep's host helpers against gamer_tpu.oracle.qtmath, bit for
    bit: the instance rotation, the twirl axis and the sort distance."""
    v = np.asarray(v, np.float32)
    np.testing.assert_array_equal(tsp._normalized32(v), qm.normalized32(v))
    assert tsp._length32(v) == qm.length32(v)
    up = qm.v3(0, 1, 0)
    np.testing.assert_array_equal(tsp._quat_rotation_to(up, v),
                                  qm.quat_rotation_to(up, v))
