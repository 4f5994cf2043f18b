"""``fit_scene_batch`` and ``fit_scene_multiview`` of
``gamer_tpu_torch.engine.fit`` on the CPU: each batch member against the
port's own standalone ``fit_scene`` (bit for bit: scene k's graph is
fit_scene's), both families against ``gamer_tpu.engine.fit``, and their
contracts: the validation messages, the single-template frozen broadcast,
the frozen start, checkpoint resume, the fingerprints and ``mesh=``
(tests/test_fit.py:756-1171).

Tolerances (as tests/test_torch_fit_fd.py's header): 2-step trajectories
at 12^2 with preview sampling within relative 1e-4 of JAX's losses and
1e-5 of its fitted leaves; everything the port holds against itself
(batch member against fit_scene, frozen start against tensor start,
single template against explicit copies, checkpoint resume) bit-equal.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import fit as jfit  # noqa: E402
from gamer_tpu.engine.render import render_scene as jrender_scene  # noqa: E402
from gamer_tpu.scene.schema import default_galaxy  # noqa: E402

from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.utils.tree import tree_leaves  # noqa: E402

SIZE = 12
RTOL = 1e-4
KW = dict(fit_fields=("strength",), steps=2, lr=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy, size=SIZE):
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=galaxy)],
        config=gamer_tpu.RenderConfig(size=size, ray_step=0.025,
                                      is_preview=True))


@pytest.fixture(scope="module")
def batch_problem():
    """K=2 truths differing in disk strength, their targets, a common
    start with the disk at half strength (tests/test_fit.py:733-753) and
    per-scene starts (the second at 1.5 x the first)."""
    targets = []
    for s in (3.0, 6.0):
        g = default_galaxy()
        g.components[1].strength = g.components[1].strength * s / 4.0
        targets.append(jrender_scene(_scene(g)))
    start = default_galaxy()
    start.components[1].strength *= 0.5
    template = _scene(start)
    starts = [copy.deepcopy(template), copy.deepcopy(template)]
    starts[1].instances[0].galaxy.components[1].strength *= 1.5
    return template, starts, np.stack(targets)


def _fingerprints(monkeypatch, module, run):
    real = module._fit_fingerprint
    seen = []

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(module, "_fit_fingerprint", spy)
    try:
        return run(), seen
    finally:
        monkeypatch.setattr(module, "_fit_fingerprint", real)


@pytest.fixture(scope="module")
def batch_fits(batch_problem):
    template, starts, targets = batch_problem
    mp = pytest.MonkeyPatch()
    try:
        ref = _fingerprints(mp, jfit, lambda: jfit.fit_scene_batch(
            starts, targets, **KW))
        ours = _fingerprints(mp, tfit, lambda: tfit.fit_scene_batch(
            starts, targets, device="cpu", **KW))
    finally:
        mp.undo()
    return ref, ours


def test_fit_scene_batch_matches_jax(batch_fits):
    (ref, ref_fp), (ours, our_fp) = batch_fits
    assert ours.losses.shape == ref.losses.shape == (3, 2)
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ours.params[0]["comps"][1]["strength"],
                               np.asarray(ref.params[0]["comps"][1]
                                          ["strength"]), rtol=1e-5)
    assert (ours.losses[-1] < ours.losses[0]).all()
    assert our_fp == ref_fp


@pytest.mark.parametrize("march", ["tensor", "frozen"])
def test_batch_member_is_its_standalone_fit(march, batch_problem,
                                            batch_fits):
    """Scene k's losses and fitted leaves are its own fit_scene's, bit for
    bit (per-scene starts; with march='frozen' each has its own fields)."""
    template, starts, targets = batch_problem
    if march == "tensor":
        batch = batch_fits[1][0]
    else:
        batch = tfit.fit_scene_batch(starts, targets, march=march,
                                     device="cpu", **KW)
    for k in range(2):
        single = tfit.fit_scene(starts[k], targets[k], march=march,
                                device="cpu", **KW)
        assert batch.losses[:, k].tolist() == [np.float32(v) for v in
                                               single.losses]
        for a, b in zip(tree_leaves(batch.params), tree_leaves(single.params)):
            np.testing.assert_array_equal(a[k], b)
        assert dataclasses.asdict(batch.scenes[k]) == \
            dataclasses.asdict(single.scene)


def test_frozen_single_template_broadcast(batch_problem, monkeypatch):
    """One template: ONE frozen field set serves the K scenes (one
    precompute), and the trajectory is the one of K explicit copies of the
    template, each with its own fields (tests/test_fit.py:1142-1154)."""
    template, _, targets = batch_problem
    kw = dict(KW, march="frozen", device="cpu")
    from gamer_tpu_torch.engine import tensor_march

    calls = []
    real = tensor_march.precompute_frozen

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tensor_march, "precompute_frozen", spy)
    bcast = tfit.fit_scene_batch(template, targets, **kw)
    assert len(calls) == 1
    expl = tfit.fit_scene_batch(
        [copy.deepcopy(template), copy.deepcopy(template)], targets, **kw)
    assert len(calls) == 3
    np.testing.assert_array_equal(bcast.losses, expl.losses)
    # and the frozen start is the tensor march's, bit for bit
    tens = tfit.fit_scene_batch(template, targets,
                                **{**kw, "march": "tensor", "steps": 0})
    np.testing.assert_array_equal(tens.losses[0], bcast.losses[0])


def test_fit_scene_batch_checkpoint_resume(batch_problem, tmp_path):
    template, _, targets = batch_problem
    kw = dict(fit_fields=("strength",), lr=5e-2, march="frozen",
              device="cpu")
    straight = tfit.fit_scene_batch(template, targets, steps=3, **kw)
    ckpt = str(tmp_path / "batch.ckpt")
    tfit.fit_scene_batch(template, targets, steps=1, checkpoint_path=ckpt,
                         checkpoint_every=1, **kw)
    with np.load(ckpt) as z:
        assert z["__best_loss__"].shape == (2,)
        assert z["p0"].shape[0] == 2
    resumed = tfit.fit_scene_batch(template, targets, steps=3,
                                   checkpoint_path=ckpt, checkpoint_every=1,
                                   **kw)
    np.testing.assert_array_equal(resumed.losses, straight.losses)
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="different fit"):
        tfit.fit_scene_batch(template, targets[::-1], steps=3,
                             checkpoint_path=ckpt, **kw)


def test_fit_scene_batch_validation(batch_problem):
    """JAX's messages, word for word (tests/test_fit.py:779-810,
    989-1001)."""
    template, starts, targets = batch_problem
    kw = dict(steps=1, device="cpu")
    with pytest.raises(ValueError, match=r"\(K, N, N, 3\)"):
        tfit.fit_scene_batch(template, targets[0], **kw)
    with pytest.raises(ValueError, match="scenes but"):
        tfit.fit_scene_batch(starts[:1], targets, **kw)
    with pytest.raises(ValueError, match="at least one scene"):
        tfit.fit_scene_batch([], targets, **kw)
    moved = dataclasses.replace(
        copy.deepcopy(template),
        camera=dataclasses.replace(template.camera, camera=(0.6, 0, 0)))
    with pytest.raises(ValueError, match="different camera"):
        tfit.fit_scene_batch([template, moved], targets, **kw)
    other = copy.deepcopy(template)
    other.instances[0].galaxy.components[1].active = 0
    with pytest.raises(ValueError, match="different compiled structure"):
        tfit.fit_scene_batch([template, other], targets, **kw)
    for fld, val in (("exposure", 2.0), ("ray_step", 0.05)):
        odd = copy.deepcopy(template)
        odd.config = dataclasses.replace(odd.config, **{fld: val})
        with pytest.raises(ValueError, match=f"config.{fld}"):
            tfit.fit_scene_batch([template, odd], targets, **kw)
    msgs = []
    for fn, dev in ((tfit.fit_scene_batch, {"device": "cpu"}),
                    (jfit.fit_scene_batch, {})):
        with pytest.raises(ValueError) as e:
            fn([template, moved], targets, steps=1, **dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="frozen"):
        tfit.fit_scene_batch(starts, targets, fit_fields=("scale",),
                             march="frozen", **kw)
    with pytest.raises(ValueError, match="must divide the mesh"):
        tfit.fit_scene_batch(template, targets, mesh=Mesh(["cpu"] * 7),
                             **kw)


def test_fit_scene_batch_bound_covers_largest_scene(batch_problem):
    """The trip bound is the largest of every scene's: a member with 3x
    the axes marches untruncated, as its standalone fit would
    (tests/test_fit.py:1004-1021)."""
    template, _, targets = batch_problem
    big = copy.deepcopy(template)
    gp = big.instances[0].galaxy.params
    gp.axis = tuple(3.0 * a for a in gp.axis)
    batch = tfit.fit_scene_batch([template, big], targets, device="cpu",
                                 **{**KW, "steps": 0})
    single = tfit.fit_scene(big, targets[1], device="cpu",
                            **{**KW, "steps": 0})
    assert batch.losses[0, 1] == np.float32(single.losses[0])


# ---------------------------------------------------------------------------
# fit_scene_multiview
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mview_problem():
    """The default galaxy from 2 views, their targets, and a start with
    the disk at half strength (tests/test_fit.py:1045-1060). The views sit
    on the axes: on an off-axis orbit view the JAX package's marches drift
    at the galaxy's centre ray (ROADMAP.md §3: 1.2 % of this loss),
    so the JAX comparison uses on-axis views."""
    truth = _scene(default_galaxy())
    cams = [truth.camera, dataclasses.replace(truth.camera,
                                              camera=(0.0, 0.0, 0.5))]
    targets = np.stack([jrender_scene(dataclasses.replace(truth, camera=c))
                        for c in cams])
    start = default_galaxy()
    start.components[1].strength *= 0.5
    return _scene(start), cams, targets


@pytest.fixture(scope="module")
def mview_fits(mview_problem):
    start, cams, targets = mview_problem
    mp = pytest.MonkeyPatch()
    try:
        ref = _fingerprints(mp, jfit, lambda: jfit.fit_scene_multiview(
            start, targets, cams, **KW))
        ours = _fingerprints(mp, tfit, lambda: tfit.fit_scene_multiview(
            start, targets, cams, device="cpu", **KW))
    finally:
        mp.undo()
    return ref, ours


def test_fit_scene_multiview_matches_jax(mview_fits):
    (ref, ref_fp), (ours, our_fp) = mview_fits
    assert len(ours.losses) == len(ref.losses) == 3
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ours.params[0]["comps"][1]["strength"],
                               np.asarray(ref.params[0]["comps"][1]
                                          ["strength"]), rtol=1e-5)
    assert ours.losses[-1] < ours.losses[0]
    assert our_fp == ref_fp


def test_fit_scene_multiview_frozen_start_and_views(mview_problem,
                                                    mview_fits):
    """Per-view frozen fields reproduce the tensor march's first loss bit
    for bit (tests/test_fit.py:1157-1171), and the loss is the mean of the
    per-view fit_scene losses."""
    start, cams, targets = mview_problem
    ours = mview_fits[1][0]
    froz = tfit.fit_scene_multiview(start, targets, cams, march="frozen",
                                    device="cpu", **KW)
    assert froz.losses[0] == ours.losses[0]
    assert froz.losses[-1] < froz.losses[0]
    views = [tfit.fit_scene(dataclasses.replace(start, camera=c), t,
                            device="cpu", **{**KW, "steps": 0}).losses[0]
             for c, t in zip(cams, targets)]
    assert ours.losses[0] == pytest.approx(np.mean(views), rel=1e-6)


def test_fit_scene_multiview_validation(mview_problem):
    start, cams, targets = mview_problem
    kw = dict(steps=1, device="cpu")
    with pytest.raises(ValueError, match="cameras"):
        tfit.fit_scene_multiview(start, targets, cams[:1], **kw)
    with pytest.raises(ValueError, match="targets"):
        tfit.fit_scene_multiview(start, targets[0], cams, **kw)
    with pytest.raises(ValueError, match="frozen"):
        tfit.fit_scene_multiview(start, targets, cams, fit_fields=("winding",),
                                 march="frozen", **kw)
    with pytest.raises(ValueError, match="views must divide the mesh"):
        tfit.fit_scene_multiview(start, targets, cams,
                                 mesh=Mesh(["cpu"] * 7), **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tfit.fit_scene_multiview(start, targets, cams, steps=1)
        with pytest.raises(RuntimeError, match="cuda"):
            tfit.fit_scene_batch(start, targets, steps=1)
