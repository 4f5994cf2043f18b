"""The perlin and iq raw-noise backends through the port's march
(``RenderConfig.noise_kind``), on the CPU: ``gamer_tpu_torch`` frames
against the JAX package's Pallas kernel (interpreted) and XLA march, and
every launch form (frame, band, batch, ray list) with a second kind.

Tolerances. Perlin is integer lattice work and a few lerps, so a perlin
frame is held to the simplex gate: <= 2 uint8 LSB of both JAX engines.
IQ's hash is frac(sin(n) * 753.5453123): the multiply amplifies the last
ulps of the sine, and the port's sine (torch's) is not XLA's, so single
lattice corners may hash differently. The iq gate is therefore
statistical: at least 98 % of the pixels within 2 LSB, and the mean
difference over the frame below 0.25 LSB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine.scene_prep import flatten_scene as jflatten  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine import scene_prep as tsp  # noqa: E402

SIZE = 16
IQ_SHARE_WITHIN_2LSB = 0.98
IQ_MEAN_LSB = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain march runs thousands of small torch ops. Under the
    parallel test run, each op's thread-pool region waits on threads that
    the other workers' load has descheduled. One intra-op thread keeps each
    worker at its own pace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size=SIZE, galaxy=None, **cfg):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy or presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025, **cfg))


def _diff(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


# The frames of the kind comparisons: the ring preset has each component
# class of the spiral (bulge, disk, dust2, stars) with one disk where the
# spiral has two, so each interpreted JAX kernel traces one component less.
def _kind_scene(kind):
    return _scene(galaxy=presets.ring(), noise_kind=kind)


@pytest.fixture(scope="module")
def port_frames():
    return {kind: gt.render_scene(_kind_scene(kind), device="cpu")
            for kind in ("simplex", "perlin", "iq")}


@pytest.fixture(scope="module")
def jax_frames():
    """Each JAX reference once: (kind, engine) -> uint8 frame."""
    from gamer_tpu.engine.pallas_render import render_scene_pallas
    from gamer_tpu.engine.render import render_scene

    out = {}
    for kind in ("perlin", "iq"):
        scene = _kind_scene(kind)
        out[kind, "pallas"] = np.asarray(render_scene_pallas(scene))
        out[kind, "xla"] = np.asarray(render_scene(scene))
    return out


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_perlin_frame_matches_jax(port_frames, jax_frames, engine):
    ours = port_frames["perlin"]
    assert ours.shape == (SIZE, SIZE, 3) and ours.dtype == np.uint8
    assert ours.sum() > 0
    d = _diff(ours, jax_frames["perlin", engine])
    assert d.max() <= 2, f"perlin: port vs {engine} {d.max()} LSB"


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_iq_frame_matches_jax_statistically(port_frames, jax_frames, engine):
    ours = port_frames["iq"]
    assert ours.sum() > 0
    d = _diff(ours, jax_frames["iq", engine])
    within = float((d.max(-1) <= 2).mean())
    assert within >= IQ_SHARE_WITHIN_2LSB, (
        f"iq: {within:.4f} of pixels within 2 LSB of {engine}")
    assert float(d.mean()) <= IQ_MEAN_LSB, (
        f"iq: mean |d| {d.mean():.3f} LSB from {engine}")


def test_kinds_give_different_frames(port_frames):
    """The kind reaches the noise: the three frames differ from each other."""
    for a, b in (("simplex", "perlin"), ("simplex", "iq"), ("perlin", "iq")):
        assert _diff(port_frames[a], port_frames[b]).max() > 2, (a, b)


@pytest.mark.parametrize("kind", ["perlin", "iq"])
def test_page_equals_jax_page_and_table_names_the_kind(kind):
    """The JAX package's flattened parameters carried across
    (``from_jax_flat``, noise_kind included) pack to the port's own page,
    and the table header names the kind."""
    scene = _scene(noise_kind=kind)
    st, pr = tsp.from_jax_flat(*jflatten(scene))
    assert {c.noise_kind for i in st.instances for c in i.comps} == {kind}
    st_own, pr_own = tsp.flatten_scene(scene)
    assert st == st_own
    lay = cr._build_layout(st)
    assert lay.kind == kind
    args = (np.zeros(3, np.float32), np.eye(4, dtype=np.float32),
            np.float32(0.025), np.float32(0.001))
    np.testing.assert_array_equal(
        cr._pack_scalars(st, lay, pr, *args),
        cr._pack_scalars(st_own, lay, pr_own, *args))
    table = cr._build_table(st, lay)
    assert cr.NOISE_KINDS[table[cr.T_KIND]] == kind
    assert all(inst["raw_fn"] is cr.resolve_raw(kind)
               for inst in cr._read_scene(cr._pack_scalars(st, lay, pr, *args),
                                          table))


def test_unknown_and_mixed_kinds_raise_value_error():
    st, _ = tsp.flatten_scene(_scene(noise_kind="perlin"))
    comps = st.instances[0].comps
    gabor = dataclasses.replace(st, instances=(dataclasses.replace(
        st.instances[0], comps=tuple(
            dataclasses.replace(c, noise_kind="gabor") for c in comps)),))
    with pytest.raises(ValueError, match="gabor"):
        cr._build_layout(gabor)
    mixed = dataclasses.replace(st, instances=(dataclasses.replace(
        st.instances[0], comps=(dataclasses.replace(
            comps[0], noise_kind="iq"),) + comps[1:]),))
    with pytest.raises(ValueError, match="one noise kind"):
        cr._build_layout(mixed)
    page, table, _, _ = cr.prepare(_scene(8), "cpu")
    bad = table.clone()
    bad[cr.T_KIND] = 7
    with pytest.raises(ValueError, match="noise kind 7"):
        cr.march_plain(page, bad, 8)


def test_empty_scene_is_simplex_and_black():
    scene = gamer_tpu.Scene(config=gamer_tpu.RenderConfig(
        size=8, noise_kind="perlin"))
    st, _ = tsp.flatten_scene(scene)
    assert cr._build_layout(st).kind == "simplex"
    assert int(gt.render_scene(scene, device="cpu").sum()) == 0


def test_perlin_bands_equal_the_perlin_still():
    """Two row bands (the second ragged) of a 40^2 perlin frame: <= 1 LSB
    from the fused frame on the CPU (bit-equal on the card)."""
    scene = _scene(40, noise_kind="perlin")
    still = gt.render_scene(scene, device="cpu")
    ticks = []
    prog = gt.render_progressive(scene, bands=2, device="cpu",
                                 on_progress=lambda f, _: ticks.append(f))
    assert ticks == [0.5, 1.0]
    assert still.sum() > 0 and _diff(prog, still).max() <= 1


def test_perlin_batch_frames_equal_their_stills():
    """A 2-frame perlin orbit in one batch group, and a batch that mixes
    kinds (one group per kind): each frame <= 1 LSB from its still."""
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    scene = _scene(12, noise_kind="perlin")
    cams = orbit_path(scene.camera, 2, horizontal_deg=60.0)
    scenes = [dataclasses.replace(scene, camera=c) for c in cams]
    assert len(_scene_groups(scenes)) == 1
    frames = gt.render_batch(scenes, device="cpu")
    for frame, s in zip(frames, scenes):
        still = gt.render_scene(s, device="cpu")
        assert still.sum() > 0 and _diff(frame, still).max() <= 1
    mixed = [scenes[0], _scene(12, noise_kind="iq"), _scene(12)]
    assert len(_scene_groups(mixed)) == 3
    frames = gt.render_batch(mixed, device="cpu")
    for frame, s in zip(frames, mixed):
        assert _diff(frame, gt.render_scene(s, device="cpu")).max() <= 1


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
def test_ray_list_takes_every_kind(kind):
    """``render_dirs`` on a frame's own ray grid reproduces the frame's
    linear radiance for each kind (<= 1e-6 of its maximum on the CPU)."""
    from gamer_tpu_torch.ops.camera import ray_grid

    scene = _scene(8, noise_kind=kind)
    page, table, size, _ = cr.prepare(scene, "cpu")
    frame = cr.march(page, table, size)
    dirs = ray_grid(size, page[cr.G_INV_VP:cr.G_INV_VP + 16].numpy(), 0.0,
                    device="cpu", rows=size).reshape(-1, 3)
    rays = gt.render_dirs(scene, dirs.numpy(), device="cpu")
    assert rays.shape == (size * size, 3) and rays.dtype == np.float32
    scale = float(frame.abs().max())
    assert scale > 0
    assert float(np.abs(rays - frame.reshape(-1, 3).numpy()).max()) <= 1e-6 * scale


@pytest.mark.parametrize("kind", ["perlin", "iq"])
def test_octave_cap_applies_to_every_kind(kind):
    """noise_octaves caps the kind's octave loops as it caps simplex's."""
    from gamer_tpu.engine.render import render_scene

    scene = _scene(8, presets.dusty_disk(), noise_kind=kind, noise_octaves=2)
    ours = gt.render_scene(scene, device="cpu")
    d = _diff(ours, np.asarray(render_scene(scene)))
    assert ours.sum() > 0
    assert float((d.max(-1) <= 2).mean()) >= IQ_SHARE_WITHIN_2LSB
