"""The port's public names that the front end and the dry run reach, against
the JAX package's: ``DatasetJob(mesh=)``, ``dtype=`` on the XLA-form sky
and progressive frame, ``galaxy_to_dict``, ``verify_spectra``, the host
star field, the ``math3d`` quaternion helpers, ``noise_statistics``,
Perlin noise of another table seed, ``sharded_render_fn`` and every name
that ``gamer_tpu``'s ``__init__`` files export.

Tolerances: host copies (dicts, spectra, the star field, the seeded
tables) and Perlin raw noise (integer lattice work, lerps in one order)
are held bit for bit; the elementwise float32 quaternion helpers to
2 ulp-scale (XLA may contract or reorder a sum of products); a float64
march to the sky gate (max |d| / max |m| < 1e-3) and 2 uint8 LSB of the
float32 one, and bit for bit to the port's own float64 frame.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gamer_tpu.models import presets as jpresets  # noqa: E402
from gamer_tpu.ops import altnoise as jalt  # noqa: E402
from gamer_tpu.ops import math3d as jm3  # noqa: E402
from gamer_tpu.ops import noise as jnoise  # noqa: E402
from gamer_tpu.post import stars as jstars  # noqa: E402
from gamer_tpu.scene import schema as jschema  # noqa: E402
from gamer_tpu.scene import spectra as jspectra  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import allsky as tallsky  # noqa: E402
from gamer_tpu_torch.engine import queue as tqueue  # noqa: E402
from gamer_tpu_torch.engine import render as trender  # noqa: E402
from gamer_tpu_torch.models import presets as tpresets  # noqa: E402
from gamer_tpu_torch.ops import altnoise as talt  # noqa: E402
from gamer_tpu_torch.ops import math3d as tm3  # noqa: E402
from gamer_tpu_torch.ops import noise as tnoise  # noqa: E402
from gamer_tpu_torch.parallel import Mesh, sharded_render_fn  # noqa: E402
from gamer_tpu_torch.post import stars as tstars  # noqa: E402
from gamer_tpu_torch.scene import schema as tschema  # noqa: E402
from gamer_tpu_torch.scene import spectra as tspectra  # noqa: E402
from gamer_tpu_torch.scene.cameracontrols import orbit_path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NSIDE = 4
MAP_GATE = 1e-3
LSB = 2
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size, camera=(0.5, 0.0, 0.0), **cfg):
    cfg = {"is_preview": True, "noise_octaves": 2, **cfg}
    return gt.Scene(
        camera=gt.CameraParams(camera=camera, target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=tpresets.spiral())],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg))


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


# --- DatasetJob(mesh=) ------------------------------------------------------


def test_dataset_job_on_a_mesh_equals_the_device_run(tmp_path):
    """Chunks of 2 frames over a 2-entry batch mesh: the same bytes as the
    device="cpu" job; a fresh job on the mesh resumes from the manifest
    and renders only the chunk that is missing."""
    base = _scene(8)
    scenes = [dataclasses.replace(base, camera=c)
              for c in orbit_path(base.camera, 4, horizontal_deg=120.0)]
    mesh = Mesh(["cpu"] * 2, ("batch",))
    ref = gt.DatasetJob(scenes, tmp_path / "dev", chunk_size=2, **CPU)
    assert ref.run() == 2
    want = ref.load_all()
    assert want.shape == (4, 8, 8, 3) and int(want.sum()) > 0

    job = gt.DatasetJob(scenes, tmp_path / "mesh", chunk_size=2, mesh=mesh)
    assert job.mesh is mesh
    job.manifest["done"].append(0)  # chunk 0 from the device run
    np.save(job.out_dir / "chunk_00000.npy", want[:2])
    job._save_manifest()
    fresh = gt.DatasetJob(scenes, tmp_path / "mesh", chunk_size=2, mesh=mesh)
    assert fresh.remaining == [1]
    assert fresh.run() == 1
    np.testing.assert_array_equal(fresh.load_all(), want)
    np.testing.assert_array_equal(np.load(fresh.out_dir / "chunk_00001.npy"),
                                  np.load(ref.out_dir / "chunk_00001.npy"))


# --- dtype on the XLA-form surfaces -----------------------------------------


def test_xla_sky_marches_in_float64(monkeypatch):
    """render_allsky_map(kernel="xla", dtype=float64) marches float64 rays
    and stays within the sky gate of the float32 map; the image takes the
    dtype through to the map."""
    seen = []
    march = tallsky.render_rays

    def spy(static, params, dirs, *a):
        seen.append(dirs.dtype)
        return march(static, params, dirs, *a)

    monkeypatch.setattr(tallsky, "render_rays", spy)
    scene = _scene(8, camera=(0.3, 0.05, 0.0))
    f32 = gt.render_allsky_map(scene, NSIDE, kernel="xla", **CPU)
    f64 = gt.render_allsky_map(scene, NSIDE, kernel="xla",
                               dtype=torch.float64, **CPU)
    assert seen == [torch.float32, torch.float64]
    assert f64.shape == f32.shape == (12 * NSIDE ** 2,)
    assert (f64 > 0).all()
    assert np.abs(f64 - f32).max() / np.abs(f32).max() < MAP_GATE
    # the kernel path stays float32 whatever the dtype, as in JAX
    k = gt.render_allsky_map(scene, NSIDE, dtype=torch.float64, **CPU)
    np.testing.assert_array_equal(k, gt.render_allsky_map(scene, NSIDE,
                                                          **CPU))
    img = gt.render_allsky_image(scene, NSIDE, 16, dtype=torch.float64,
                                 **CPU)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8


def test_xla_progressive_marches_in_float64(monkeypatch):
    """queue.render_progressive(dtype=float64): float64 params and rows,
    the finished frame bit-equal to the float64 XLA-form frame and within
    2 LSB of the float32 one."""
    seen = []
    rows = tqueue.render_rows

    def spy(static, size, ss, params, *a):
        seen.append(params[0]["comps"][0]["strength"].dtype)
        return rows(static, size, ss, params, *a)

    monkeypatch.setattr(tqueue, "render_rows", spy)
    scene = _scene(8)
    ticks = []
    got = tqueue.render_progressive(scene, chunks=4, on_progress=lambda f, _p:
                                    ticks.append(f), dtype=torch.float64,
                                    **CPU)
    assert ticks == [0.25, 0.5, 0.75, 1.0]
    assert set(seen) == {torch.float64}
    np.testing.assert_array_equal(
        got, trender.render_scene(scene, dtype=torch.float64, **CPU))
    assert _lsb(got, trender.render_scene(scene, **CPU)) <= LSB


# --- small names held to JAX's ----------------------------------------------


@pytest.mark.parametrize("name", ["spiral", "ring", "dusty_disk"])
def test_galaxy_to_dict_matches_jax(name):
    ours = tschema.galaxy_to_dict(getattr(tpresets, name)())
    assert ours == jschema.galaxy_to_dict(getattr(jpresets, name)())
    assert tschema.galaxy_from_dict(ours) == getattr(tpresets, name)()


def test_verify_spectra_matches_jax():
    table = {"Teal": (0.2, 0.9, 0.8), "RED": (1, 0, 0)}
    for names in ([], ["Red", "blue"], ["Red", "Teal", "white"],
                  ["teal"], ["red", "Nope", "Other"]):
        for tbl in (None, table):
            assert (tspectra.verify_spectra(names, tbl)
                    == jspectra.verify_spectra(names, tbl)), (names, tbl)
    assert tspectra.verify_spectra(["Red", "Nope"]) == "Nope"


@pytest.mark.parametrize("seed", [0, 3])
def test_render_star_field_matches_jax(seed):
    """The host splatter, star for star: bit-equal, and within a float32
    ulp-scale of the device form on the same draws."""
    args = (64, 40, 12.0, 4.0, 1.5, seed)
    ours = tstars.render_star_field(*args)
    want = jstars.render_star_field(*args)
    assert ours.dtype == np.float32 and ours.shape == (64, 64, 3)
    assert float(ours.max()) > 0
    np.testing.assert_array_equal(ours, want)
    dev = tstars.star_field_device(tstars.star_params(*args), 64).numpy()
    np.testing.assert_allclose(dev, ours, rtol=1e-5, atol=1e-6)


def _vecs():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0
    v[1] = (0.0, -1.0, 0.0)   # antiparallel to +y: Qt's half-turn fallback
    v[2] = (0.0, 2.0, 0.0)
    v[3] = (1e-7, -1.0, 0.0)
    return v


def test_math3d_helpers_match_jax():
    v = _vecs()
    q = np.random.default_rng(5).normal(size=(2, 64, 4)).astype(np.float32)
    tol = dict(rtol=2e-7, atol=1e-7)
    np.testing.assert_allclose(tm3.normalize3(torch.as_tensor(v)).numpy(),
                               np.asarray(jm3.normalize3(jnp.asarray(v))),
                               **tol)
    assert not tm3.normalize3(torch.as_tensor(v)).numpy()[0].any()
    np.testing.assert_allclose(
        tm3.quat_mul(torch.as_tensor(q[0]), torch.as_tensor(q[1])).numpy(),
        np.asarray(jm3.quat_mul(jnp.asarray(q[0]), jnp.asarray(q[1]))),
        **tol)
    ours = tm3.quat_rotation_to_y(torch.as_tensor(v)).numpy()
    want = np.asarray(jm3.quat_rotation_to_y(jnp.asarray(v)))
    np.testing.assert_allclose(ours, want, **tol)
    np.testing.assert_array_equal(ours[1], [0, 0, 0, 1])
    np.testing.assert_allclose(ours[2], [1, 0, 0, 0], atol=1e-7)


def test_noise_statistics_matches_jax():
    ours = tnoise.noise_statistics(tnoise.raw_noise_3d, n=4096, seed=3,
                                   **CPU)
    want = jnoise.noise_statistics(jnoise.raw_noise_3d, n=4096, seed=3)
    assert set(ours) == {"min", "max", "mean", "std"}
    for k in ours:
        assert ours[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    assert -1.0 <= ours["min"] < ours["mean"] < ours["max"] <= 1.0
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="cuda"):
            tnoise.noise_statistics(tnoise.raw_noise_3d, n=8)


def test_perlin_of_another_table_seed_matches_jax():
    """Table seed 7 is drawn at run time by the JAX recipe (seed 94 stays
    the stored file): the permutation, the 2-D gradients and the raw 3-D
    and 2-D noise are JAX's bit for bit, and differ from seed 94's. Seed
    7's tables enter none of the cached tables the render path reads."""
    rng = np.random.default_rng(6)
    p = rng.uniform(-30.0, 30.0, (3, 2048)).astype(np.float32)
    t = [torch.as_tensor(a) for a in p]
    j = [jnp.asarray(a) for a in p]
    ours94 = talt.perlin_raw_3d(*t).numpy()
    talt.perlin_raw_2d(t[0], t[1])
    cached = set(tnoise._TABLE_CACHE)
    perm, g2 = talt.perlin_tables(7)
    np.testing.assert_array_equal(perm, jalt._perlin_build(7)[0])
    np.testing.assert_array_equal(g2, jalt._perlin_build2(7))
    assert not np.array_equal(perm, talt.perlin_tables()[0])
    ours3 = talt.perlin_raw_3d(*t, seed=7).numpy()
    np.testing.assert_array_equal(ours3,
                                  np.asarray(jalt.perlin_raw_3d(*j, seed=7)))
    assert not np.array_equal(ours3, ours94)
    np.testing.assert_array_equal(
        talt.perlin_raw_2d(t[0], t[1], seed=7).numpy(),
        np.asarray(jalt.perlin_raw_2d(j[0], j[1], seed=7)))
    assert set(tnoise._TABLE_CACHE) == cached
    assert talt._stored_tables.cache_info().currsize == 1
    np.testing.assert_array_equal(
        talt.perlin_raw_3d(*t, seed=94).numpy(),
        np.asarray(jalt.perlin_raw_3d(*j, seed=94)))


def test_sharded_render_fn_is_the_unsharded_frame():
    """The XLA-form frame's function over 2 CPU entries: bit-equal to
    render_frame on the CPU; the size must tile the mesh."""
    scene = _scene(8)
    static, *args = trender.scene_args(scene, "cpu")
    fn = sharded_render_fn(static, 8, Mesh(["cpu"] * 2))
    img = fn(*args)
    assert img.dtype == torch.uint8 and img.shape == (8, 8, 3)
    np.testing.assert_array_equal(
        img.numpy(), trender.render_frame(static, 8, *args)[0].numpy())
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        sharded_render_fn(static, 8, Mesh(["cpu"] * 3))(*args)


# --- the package-level names ------------------------------------------------


def _exported(init: Path) -> list:
    """The names a package's __init__.py imports for its users, and the
    names its module __getattr__ resolves lazily."""
    names = []
    for node in ast.walk(ast.parse(init.read_text())):
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                                str):
                    names.append(sub.value)
    return sorted({n for n in names if not n.startswith("_")
                   and n != "annotations" and n.isidentifier()})


# gamer_tpu/native (the optional C++ codec and splatter) is not ported: each
# of its entries has a pure-Python twin, which the port has
JAX_INITS = sorted(p for p in (REPO / "gamer_tpu").rglob("__init__.py")
                   if p.parent.name != "native")


@pytest.mark.parametrize(
    "init", JAX_INITS,
    ids=[str(p.parent.relative_to(REPO)) for p in JAX_INITS])
def test_every_exported_name_resolves_in_the_port(init):
    pkg = ".".join(init.parent.relative_to(REPO).parts)
    port = importlib.import_module(pkg.replace("gamer_tpu", "gamer_tpu_torch",
                                               1))
    missing = [n for n in _exported(init) if not hasattr(port, n)]
    assert not missing, f"{pkg}: {missing}"
