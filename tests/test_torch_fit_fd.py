"""``gamer_tpu_torch.engine.fit.fit_scene_fd`` on the CPU (its probe
batches run ``march_batch``'s plain version here, K4 on the card) against
``gamer_tpu.engine.fit.fit_scene_fd`` (the interpreted Pallas batch), and
its contracts: checkpoint resume, the dropped structure-flag dims, the
sweep stages and the bounded probe spread (tests/test_fit.py:301-486).

Tolerances: finite differences magnify small differences in loss, so the
probe losses are compared first: each within relative 1e-4 of JAX's (the
two marches are <= 2 uint8 LSB apart, and the float post chain keeps their
linear differences of ~1e-6). The 3-step trajectory then follows: losses
within relative 1e-4, the fitted value within relative 1e-4. Checkpoint
resume is bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import batch as jbatch  # noqa: E402
from gamer_tpu.engine import fit as jfit  # noqa: E402
from gamer_tpu.engine.render import render_scene as jrender_scene  # noqa: E402
from gamer_tpu.scene.schema import default_galaxy  # noqa: E402

from gamer_tpu_torch.engine import batch as tbatch  # noqa: E402
from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.engine.diff import post_process_float  # noqa: E402

SIZE = 12
KW = dict(fit_fields=("winding_b",), steps=3, lr=3e-2)
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy, size, **cfg):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy)],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025,
                                      is_preview=True, noise_octaves=2,
                                      **cfg))


def _perturbed(scene, **gp):
    g = scene.instances[0].galaxy
    g2 = dataclasses.replace(g, params=dataclasses.replace(g.params, **gp))
    return dataclasses.replace(
        scene, instances=[gamer_tpu.GalaxyInstance(galaxy=g2)])


@pytest.fixture(scope="module")
def problem():
    scene = _scene(default_galaxy(), SIZE)
    target = jrender_scene(scene)
    wb = scene.instances[0].galaxy.params.winding_b
    return _perturbed(scene, winding_b=wb * 1.2), target


def _spied(module, monkeypatch, fn, **kw):
    """fn's result and the linear radiance of every probe batch it
    rendered through ``module.render_batch_linear``."""
    real = module.render_batch_linear
    seen = []

    def spy(scenes, *a, **k):
        out = real(scenes, *a, **k)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "render_batch_linear", spy)
    try:
        return fn(**kw), seen
    finally:
        monkeypatch.setattr(module, "render_batch_linear", real)


@pytest.fixture(scope="module")
def fits(problem):
    """The same 3-step fit in both packages, with their probe batches."""
    start, target = problem
    mp = pytest.MonkeyPatch()
    try:
        ref = _spied(jbatch, mp, lambda: jfit.fit_scene_fd(start, target,
                                                           **KW))
        ours = _spied(tbatch, mp, lambda: tfit.fit_scene_fd(
            start, target, device="cpu", **KW))
    finally:
        mp.undo()
    return ref, ours


def _losses(lin, target):
    one = torch.tensor(1.0)
    img = post_process_float(torch.tensor(np.array(lin)), one, one, one) / 255.0
    t = torch.as_tensor(np.asarray(target, np.float32) / 255.0)
    return torch.mean((img - t) ** 2, dim=(1, 2, 3)).numpy()


def test_fd_probe_losses_match_jax(fits, problem):
    """Every step's probe batch (the current scene, then +h and -h) is one
    render_batch_linear call in both packages; the first batch's losses
    agree."""
    (_, ref_lin), (_, our_lin) = fits
    assert len(ref_lin) == len(our_lin) == KW["steps"] + 1
    assert our_lin[0].shape == (3, SIZE, SIZE, 3)
    a, b = _losses(ref_lin[0], problem[1]), _losses(our_lin[0], problem[1])
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)
    assert a[1] != a[2]  # the probes see the field


def test_fit_scene_fd_matches_jax(fits):
    (ref, _), (ours, _) = fits
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL, atol=0)
    a = float(ref.scene.instances[0].galaxy.params.winding_b)
    b = float(ours.scene.instances[0].galaxy.params.winding_b)
    assert b == pytest.approx(a, rel=RTOL)
    assert min(ours.losses) < ours.losses[0]


def test_fit_scene_fd_checkpoint_resume(problem, tmp_path):
    """Interrupted after 1 step and resumed, a 2-step fit replays the
    uninterrupted one bit for bit (host Adam moments in the checkpoint)."""
    start, target = problem
    kw = dict(fit_fields=("winding_b",), lr=3e-2, device="cpu")
    straight = tfit.fit_scene_fd(start, target, steps=2, **kw)
    ckpt = str(tmp_path / "fd.ckpt")
    tfit.fit_scene_fd(start, target, steps=1, checkpoint_path=ckpt,
                      checkpoint_every=1, **kw)
    resumed = tfit.fit_scene_fd(start, target, steps=2, checkpoint_path=ckpt,
                                checkpoint_every=1, **kw)
    assert resumed.losses == straight.losses
    np.testing.assert_array_equal(
        resumed.params[0]["winding_b"], straight.params[0]["winding_b"])
    with pytest.raises(ValueError, match="different fit"):
        tfit.fit_scene_fd(start, target, steps=2, checkpoint_path=ckpt,
                          fit_fields=("winding_b",), lr=1e-2, device="cpu")


def test_fit_scene_fd_rejects_unknown_fields(problem):
    start, target = problem
    with pytest.raises(ValueError, match="unknown fit fields"):
        tfit.fit_scene_fd(start, target, fit_fields=("per",), steps=1,
                          device="cpu")


def test_fit_scene_fd_drops_zero_structure_flag_dims():
    """winding / arm nonzero-ness is compiled structure: a dim that starts
    at exactly 0 is dropped with a warning, and a field set of only such
    dims is an error (tests/test_fit.py:308-322)."""
    g = default_galaxy(1)
    g = dataclasses.replace(g, components=[
        dataclasses.replace(c, winding=0.0) for c in g.components])
    scene = _scene(g, 8)
    with pytest.warns(RuntimeWarning, match="structure-flag"):
        with pytest.raises(ValueError, match="no probe dimensions"):
            tfit.fit_scene_fd(scene, np.zeros((8, 8, 3), np.uint8),
                              fit_fields=("winding",), steps=1, device="cpu")


def test_fit_scene_fd_needs_a_card_for_cuda(problem):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path is the card's test")
    start, target = problem
    with pytest.raises(RuntimeError, match="cuda"):
        tfit.fit_scene_fd(start, target, steps=1)


def test_fit_scene_fd_sweep_stages():
    """The staged search (a joint group grid, then zooming per-dim sweeps)
    never worsens the start; a group that matches no dim is rejected
    (tests/test_fit.py:357-379)."""
    scene = _scene(default_galaxy(2), 8, )
    scene = dataclasses.replace(scene, config=dataclasses.replace(
        scene.config, noise_octaves=1))
    target = jrender_scene(scene)
    start = _perturbed(
        scene, winding_b=scene.instances[0].galaxy.params.winding_b * 1.2)
    calls = []
    real = tbatch.render_batch_linear

    def spy(scenes, *a, **k):
        calls.append(len(scenes))
        return real(scenes, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(tbatch, "render_batch_linear", spy)
    try:
        res = tfit.fit_scene_fd(start, target, ("winding_b",), steps=1,
                                lr=1e-2, sweep=3, sweep_rounds=1,
                                sweep_groups=(("winding_b",),), device="cpu")
    finally:
        mp.undo()
    # the group grid (3 frames), one round of one dim (base + 3), one step
    # and the last iterate (3 probes each)
    assert calls == [3, 4, 3, 3]
    assert min(res.losses) <= res.losses[0]
    with pytest.raises(ValueError, match="matches no probe dims"):
        tfit.fit_scene_fd(start, target, ("winding_b",), steps=1, sweep=3,
                          sweep_groups=(("scale",),), device="cpu")


def test_fit_scene_fd_bounded_probe_spread():
    """A value on its _FIT_BOUNDS bound still gets a one-sided probe, and
    the update never crosses the bound (tests/test_fit.py:455-483)."""
    scene = _scene(default_galaxy(2), 8)
    g = scene.instances[0].galaxy
    g2 = dataclasses.replace(g, components=[
        dataclasses.replace(c, r0=tfit._FIT_BOUNDS["r0"])
        for c in g.components])
    start = dataclasses.replace(
        scene, instances=[gamer_tpu.GalaxyInstance(galaxy=g2)])
    res = tfit.fit_scene_fd(start, jrender_scene(scene), ("r0",), steps=1,
                            lr=5e-2, device="cpu")
    for cp in res.scene.instances[0].galaxy.components:
        assert cp.r0 >= float(np.float32(tfit._FIT_BOUNDS["r0"]))
    assert all(np.isfinite(res.losses))
