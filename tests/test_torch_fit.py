"""``gamer_tpu_torch.engine.fit``'s autograd fits on the CPU against
``gamer_tpu.engine.fit``: the written-out Adam against optax, 2-step
``fit_scene`` trajectories (tensor and scan marches), the parameter tree's
leaf order and the checkpoint fingerprint, ``apply_fit_to_scene``, and the
loop's contracts (checkpoint resume, mismatched setups, abort, field
checks, the resolution pyramid), as tests/test_fit.py holds them.

Tolerances:
- Adam against optax.adam: relative 1e-6 per element (float32; optax's
  bias correction pow runs in XLA's pow, the port's in torch's);
- fit_scene against the JAX package, 2 steps on a 12^2 preview frame:
  losses within relative 1e-4, fitted leaves within relative 1e-5 (the
  gradients agree to ~1e-6 and Adam's first steps are sign steps);
- checkpoint resume: bit-equal to the uninterrupted run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import fit as jfit  # noqa: E402
from gamer_tpu.engine import scene_prep as jprep  # noqa: E402
from gamer_tpu.engine.render import render_scene as jrender_scene  # noqa: E402
from gamer_tpu.scene.schema import default_galaxy  # noqa: E402

from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.engine import render as trender  # noqa: E402
from gamer_tpu_torch.engine import scene_prep as tprep  # noqa: E402
from gamer_tpu_torch.utils.tree import tree_leaves  # noqa: E402

SIZE = 12
KW = dict(fit_fields=("strength", "r0"), steps=2, lr=5e-2)


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
                                      is_preview=True, **cfg))


@pytest.fixture(scope="module")
def problem():
    """(start scene, target): the default galaxy's render, and the galaxy
    with the disk's strength halved (tests/test_fit.py:649-661)."""
    target = jrender_scene(_scene(default_galaxy(), SIZE))
    start = default_galaxy()
    start.components[1].strength *= 0.5
    return _scene(start, SIZE), target


@pytest.fixture(scope="module")
def jax_fits(problem):
    start, target = problem
    return {m: jfit.fit_scene(start, target, march=m, **KW)
            for m in ("tensor", "scan")}


def test_adam_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3,)).astype(np.float32),
              "b": np.float32(rng.normal())}
    grads = [{"a": rng.normal(size=(3,)).astype(np.float32) * s,
              "b": np.float32(rng.normal() * s)}
             for s in (1.0, 1e-3, 10.0, 0.0, 2.0)]
    opt = optax.adam(2e-2)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = opt.init(pj)
    ours = tfit.Adam(2e-2)
    pt = {k: torch.as_tensor(v) for k, v in params.items()}
    st = ours.init(pt)
    for g in grads:
        uj, sj = opt.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = ours.update({k: torch.as_tensor(v) for k, v in g.items()},
                             st, pt)
        pt = {k: pt[k] + ut[k] for k in pt}
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=0)
    # the state's leaves line up with optax's (checkpoint layout)
    assert len(tree_leaves(st)) == len(jax.tree_util.tree_leaves(sj))
    assert int(st[0]) == int(jax.tree_util.tree_leaves(sj)[0]) == len(grads)


def test_param_tree_leaf_order_matches_jax():
    """tree_leaves walks flatten_scene's params as jax.tree_util does, so a
    checkpoint's leaf k is the same parameter in both packages."""
    scene = _scene(default_galaxy(), 8)
    _, pj = jprep.flatten_scene(scene)
    _, pt = tprep.flatten_scene(scene)
    a = [np.asarray(x) for x in jax.tree_util.tree_leaves(pj)]
    b = [np.asarray(x) for x in tree_leaves(pt)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_fit_fingerprint_matches_jax(problem):
    start, target = problem
    _, pj = jprep.flatten_scene(start)
    _, pt = tprep.flatten_scene(start)
    tgt = np.asarray(target, np.float32) / 255.0
    aux = (start.camera.camera, 0.025, 0.01, 1.0, 321)
    assert tfit._fit_fingerprint("scene", ("strength", "r0"), 5e-2, "tensor",
                                 SIZE, pt, tgt, extra="pool1", aux=aux) == \
        jfit._fit_fingerprint("scene", ("strength", "r0"), 5e-2, "tensor",
                              SIZE, pj, jnp.asarray(tgt), extra="pool1",
                              aux=aux)


@pytest.mark.parametrize("march", ["tensor", "scan"])
def test_fit_scene_matches_jax(march, problem, jax_fits):
    start, target = problem
    ref = jax_fits[march]
    res = tfit.fit_scene(start, target, march=march, device="cpu", **KW)
    assert len(res.losses) == len(ref.losses) == 3
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4, atol=0)
    for cj, ct in zip(ref.params[0]["comps"], res.params[0]["comps"]):
        for k in ("strength", "r0"):
            np.testing.assert_allclose(ct[k], np.asarray(cj[k]), rtol=1e-5)
    assert res.losses[-1] < res.losses[0]
    fitted = res.scene.instances[0].galaxy.components
    assert fitted[1].strength == pytest.approx(
        float(res.params[0]["comps"][1]["strength"]))


def test_fit_frozen_starts_at_the_tensor_loss(problem, jax_fits):
    """march='frozen' evaluates the same forward as the tensor march at the
    starting parameters: the same first loss, bit for bit."""
    start, target = problem
    a = tfit.fit_scene(start, target, march="frozen", device="cpu",
                       **{**KW, "steps": 0})
    b = tfit.fit_scene(start, target, march="tensor", device="cpu",
                       **{**KW, "steps": 0})
    assert a.losses == b.losses
    assert a.losses[0] == pytest.approx(jax_fits["tensor"].losses[0],
                                        rel=1e-4)


def test_fit_checkpoint_resume_exact(problem, tmp_path):
    """Interrupted after 1 step and resumed, a 3-step fit replays the
    uninterrupted trajectory bit for bit (tests/test_fit.py:649-676)."""
    start, target = problem
    kw = dict(fit_fields=("strength",), lr=5e-2, march="frozen",
              device="cpu")
    straight = tfit.fit_scene(start, target, steps=3, **kw)
    ckpt = str(tmp_path / "fit.ckpt")
    tfit.fit_scene(start, target, steps=1, checkpoint_path=ckpt,
                   checkpoint_every=1, **kw)
    resumed = tfit.fit_scene(start, target, steps=3, checkpoint_path=ckpt,
                             checkpoint_every=1, **kw)
    assert resumed.losses == straight.losses
    for a, b in zip(tree_leaves(resumed.params),
                    tree_leaves(straight.params)):
        np.testing.assert_array_equal(a, b)


def test_fit_checkpoint_rejects_mismatched_setup(problem, tmp_path):
    """tests/test_fit.py:679-706: other fields, lr or camera are another
    fit; fewer steps than the checkpoint holds is an error."""
    start, target = problem
    kw = dict(march="frozen", device="cpu")
    ckpt = str(tmp_path / "fit.ckpt")
    tfit.fit_scene(start, target, fit_fields=("strength",), steps=1, lr=5e-2,
                   checkpoint_path=ckpt, checkpoint_every=1, **kw)
    with pytest.raises(ValueError, match="different fit"):
        tfit.fit_scene(start, target, fit_fields=("strength", "r0"), steps=1,
                       lr=5e-2, checkpoint_path=ckpt, **kw)
    with pytest.raises(ValueError, match="different fit"):
        tfit.fit_scene(start, target, fit_fields=("strength",), steps=1,
                       lr=1e-2, checkpoint_path=ckpt, **kw)
    moved = dataclasses.replace(
        start, camera=dataclasses.replace(start.camera, camera=(0.6, 0, 0)))
    with pytest.raises(ValueError, match="different fit"):
        tfit.fit_scene(moved, target, fit_fields=("strength",), steps=1,
                       lr=5e-2, checkpoint_path=ckpt, **kw)
    with pytest.raises(ValueError, match="already holds"):
        tfit.fit_scene(start, target, fit_fields=("strength",), steps=0,
                       lr=5e-2, checkpoint_path=ckpt, **kw)


def test_fit_cooperative_abort(problem):
    """on_step returning False stops after the current step and still
    returns the best fit so far (tests/test_fit.py:849-868)."""
    start, target = problem
    seen = []

    def on_step(i, loss):
        seen.append(i)
        return i < 1

    res = tfit.fit_scene(start, target, fit_fields=("strength",), steps=50,
                         lr=5e-2, march="frozen", on_step=on_step,
                         device="cpu")
    assert seen == [0, 1]
    assert len(res.losses) == 3  # 2 loop entries + the last iterate's
    assert res.scene.instances[0].galaxy.components[1].strength > 0


def test_fit_rejects_unknown_fields_and_not_ported_mesh(problem):
    start, target = problem
    with pytest.raises(ValueError, match="unknown fit fields"):
        tfit.fit_scene(start, target, fit_fields=("orientation",), steps=1,
                       device="cpu")
    with pytest.raises(ValueError, match="must divide the mesh"):
        tfit.fit_scene(start, target, steps=1, mesh=Mesh(["cpu"] * 7),
                       device="cpu")
    with pytest.raises(ValueError, match="target size"):
        tfit.fit_scene(start, target[:8, :8], steps=1, device="cpu")


def test_fit_scene_needs_a_card_for_cuda(problem):
    """device='cuda' (the default) raises without a card: no fit carries
    on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path is the card's test")
    start, target = problem
    with pytest.raises(RuntimeError, match="cuda"):
        tfit.fit_scene(start, target, steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tfit.fit_scene_multiscale(start, target, steps=1, schedule=(1,))


def test_fit_axis_bound_and_headroom():
    """Fitting 'axis' projects it above its bound (tests/test_fit.py:194)."""
    scene = _scene(default_galaxy(2), 8)
    res = tfit.fit_scene(scene, np.zeros((8, 8, 3), np.uint8),
                         fit_fields=("axis",), steps=2, lr=5e-2,
                         march="tensor", device="cpu")
    assert all(a >= 1e-2 for a in res.scene.instances[0].galaxy.params.axis)
    assert all(np.isfinite(res.losses))


def test_fit_warns_winding_fields_on_tensor_march(problem):
    start, target = problem
    with pytest.warns(RuntimeWarning, match="march='scan'"):
        tfit.fit_scene(start, target, fit_fields=("winding_b",), steps=0,
                       device="cpu")
    import warnings

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tfit.fit_scene(start, target, fit_fields=("winding_b",), steps=0,
                       march="scan", device="cpu")
    assert not [w for w in rec if "winding" in str(w.message)]


def test_fit_forward_matches_supersampled_render():
    """The forward model pools ss^2 rays per pixel in linear space: at the
    true parameters the loss against the port's own XLA render sits at the
    uint8 truncation floor (tests/test_fit.py:486-499)."""
    scene = _scene(default_galaxy(), 8, supersample=2)
    target = trender.render_scene(scene, device="cpu")
    res = tfit.fit_scene(scene, target, fit_fields=("strength",), steps=0,
                         march="scan", device="cpu")
    assert res.losses[0] < 1e-5


def test_fit_scene_multiscale_and_abort(problem):
    """The resolution pyramid: every rung's losses (steps + 1 each), the
    global step index, the caller's size restored; an abort inside a rung
    stops the ladder (tests/test_fit.py:149-184,871-886)."""
    start, target = problem
    seen = []
    res = tfit.fit_scene_multiscale(
        start, target, fit_fields=("strength",), steps=2, lr=5e-2,
        schedule=(2, 1), march="frozen", device="cpu",
        on_step=lambda i, loss: seen.append(i))
    assert len(res.losses) == 6 and seen == [0, 1, 2, 3]
    assert res.scene.config.size == SIZE
    assert all(np.isfinite(res.losses))
    res = tfit.fit_scene_multiscale(
        start, target, fit_fields=("strength",), steps=4, lr=5e-2,
        schedule=(2, 1), march="frozen", device="cpu",
        on_step=lambda i, loss: i < 1)
    assert len(res.losses) == 3 and res.scene.config.size == SIZE
    with pytest.raises(ValueError, match="rung"):
        tfit.fit_scene_multiscale(start, target, schedule=(), steps=1,
                                  device="cpu")


def _two_instance_scene():
    g = default_galaxy()
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(2.5, 0.3, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=70.0),
        instances=[
            gamer_tpu.GalaxyInstance(galaxy=g, position=(0, 0, 0)),
            gamer_tpu.GalaxyInstance(galaxy=g, position=(0.5, 0.2, -0.8),
                                     intensity_scale=0.7),
        ],
        config=gamer_tpu.RenderConfig(size=8, ray_step=0.025))


def test_apply_fit_to_scene_matches_jax():
    """The write-back of every fittable family on two instances that share
    one GalaxyData (far to near order, new named spectra), against the JAX
    package's."""
    from gamer_tpu.scene.schema import scene_to_dict

    scene = _two_instance_scene()
    _, params = tprep.flatten_scene(scene)
    rng = np.random.default_rng(4)
    fitted = tuple(
        {k: (tuple({f: (v * np.float32(1.0 + 0.1 * rng.random())
                        ).astype(np.float32) for f, v in cp.items()}
                   for cp in inst["comps"]) if k == "comps"
             else (inst[k] * np.float32(1.1)).astype(np.float32))
         for k in inst}
        for inst in params)
    fields = tfit.FITTABLE_FIELDS
    a = tfit.apply_fit_to_scene(scene, fitted, fields)
    b = jfit.apply_fit_to_scene(scene, fitted, fields)
    assert scene_to_dict(a) == scene_to_dict(b)
    assert a.instances[0].galaxy is not a.instances[1].galaxy
    assert scene_to_dict(scene) != scene_to_dict(a)
