"""Gradients through the port's differentiable marches
(``gamer_tpu_torch.engine.diff`` and ``engine.tensor_march``) on the CPU:
against ``jax.grad`` of the JAX package's ``render_rays_diff`` and
``render_rays_tensor``, and between the port's own marches (the analogs of
tests/test_fit.py:82 and tests/test_tensor_march.py).

Tolerances:
- port against jax.grad on the default fit fields: relative 1e-4 per leaf
  (the same float32 arithmetic in two libraries);
- tensor march against the scan march: the thresholds of
  tests/test_tensor_march.py:54-60 (forward median relative 3e-4, under 1 %
  of samples beyond 1e-2, L2 6e-3; gradients within 5 %; the camera
  gradient's direction cos > 0.95 and magnitude ratio in (0.7, 1.4));
- frozen march: bit-equal to the tensor march forward, gradients within
  5 % of the scan march's.

The JAX gradients run in a fresh subprocess: compiling both backward graphs
late in a long pytest process has crashed XLA:CPU (tests/test_tensor_march.py
:115-148).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine import diff as tdiff  # noqa: E402
from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.engine import tensor_march as ttm  # noqa: E402
from gamer_tpu_torch.engine.render import scene_args  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.ops.camera import ray_grid_xla  # noqa: E402
from gamer_tpu_torch.utils.tree import tree_leaves  # noqa: E402

GRAD_SIZE = 8
FIELDS = ("strength", "r0", "z0")
JAX_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy, size, **cfg):
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy)],
        config=gt.RenderConfig(size=size, ray_step=0.025, is_preview=True,
                               **cfg))


def _grad_galaxy():
    g = gt.default_galaxy()
    for comp in g.components:
        # inner == 0 is a zero-width smoothstep edge whose derivative is NaN
        # by construction (fit_scene projects it off zero)
        comp.inner = 0.01
    return g


_JAX_WORKER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import gamer_tpu
from gamer_tpu.engine import diff as gdiff
from gamer_tpu.engine.scene_prep import flatten_scene
from gamer_tpu.engine.tensor_march import render_rays_tensor
from gamer_tpu.ops import camera as cam_ops
from gamer_tpu.scene.schema import default_galaxy

size = int(sys.argv[2])
g = default_galaxy()
for c in g.components:
    c.inner = 0.01
scene = gamer_tpu.Scene(
    camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                  up=(0, 1, 0), fov=90.0),
    instances=[gamer_tpu.GalaxyInstance(galaxy=g)],
    config=gamer_tpu.RenderConfig(size=size, ray_step=0.025,
                                  is_preview=True))
static, params = flatten_scene(scene)
params = jax.tree_util.tree_map(jnp.asarray, params)
camera = jnp.asarray(scene.camera.camera, jnp.float32)
inv_vp = jnp.asarray(cam_ops.inv_view_projection_host(
    np.asarray(scene.camera.camera, np.float32), scene.camera.target,
    scene.camera.up, scene.camera.fov))
dirs = cam_ops.ray_grid(size, inv_vp)
bound = gdiff.step_bound_for_scene(scene)
f = jnp.float32
out = {}
for name, fn in (("scan", gdiff.render_rays_diff),
                 ("tensor", render_rays_tensor)):
    def loss(p):
        lin = fn(static, p, dirs, camera, f(0.025), f(0.01), bound)
        img = gdiff.post_process_float(lin, f(1.0), f(1.0), f(1.0))
        return jnp.mean(img ** 2)
    value, grads = jax.value_and_grad(loss)(params)
    out[name + "_loss"] = np.asarray(value)
    for ci, cp in enumerate(grads[0]["comps"]):
        for k in ("strength", "r0", "z0"):
            out[f"{name}_{ci}_{k}"] = np.asarray(cp[k])
np.savez(sys.argv[1], **out)
print("GRADS-OK")
"""


@pytest.fixture(scope="module")
def jax_grads(tmp_path_factory):
    """jax.grad of the scan and tensor marches' loss, from a fresh process."""
    import os

    tmp = tmp_path_factory.mktemp("jax_grads")
    worker = tmp / "worker.py"
    worker.write_text(_JAX_WORKER)
    out = tmp / "grads.npz"
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(repo) + (
        (":" + env["PYTHONPATH"]) if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, str(worker), str(out),
                           str(GRAD_SIZE)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0 and "GRADS-OK" in proc.stdout, (
        proc.stdout, proc.stderr[-4000:])
    with np.load(out) as z:
        return dict(z)


def _loss_grads(fn, scene, every_leaf=False):
    """(loss, params with .grad) of mean(post_float(linear)^2) through
    ``fn``; the default fit fields record gradients, or every leaf."""
    static, params, camera, inv_vp, rs, ms, ex, ga, sa = scene_args(scene,
                                                                     "cpu")
    if every_leaf:
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
    else:
        for cp in params[0]["comps"]:
            for k in FIELDS:
                cp[k].requires_grad_(True)
    dirs = ray_grid_xla(scene.config.size, inv_vp)
    bound = tdiff.step_bound_for_scene(scene)
    lin = fn(static, params, dirs, camera, rs, ms, bound)
    loss = torch.mean(tdiff.post_process_float(lin, ex, ga, sa) ** 2)
    loss.backward()
    return float(loss.detach()), params


@pytest.fixture(scope="module")
def port_grads():
    scene = _scene(_grad_galaxy(), GRAD_SIZE)
    return {"scan": _loss_grads(tdiff.render_rays_diff, scene,
                                every_leaf=True),
            "tensor": _loss_grads(ttm.render_rays_tensor, scene)}


def _g(leaf):
    return 0.0 if leaf.grad is None else float(leaf.grad)


def test_gradients_finite_and_nonzero(port_grads):
    """The analog of tests/test_fit.py:82: every leaf's gradient through
    the scan march is finite, and the bulge strength's is not zero."""
    _, params = port_grads["scan"]
    for leaf in tree_leaves(params):
        assert leaf.grad is None or bool(torch.isfinite(leaf.grad).all())
    assert _g(params[0]["comps"][0]["strength"]) != 0.0


@pytest.mark.parametrize("march", ["scan", "tensor"])
def test_gradients_match_jax(march, jax_grads, port_grads):
    loss, params = port_grads[march]
    want = float(jax_grads[march + "_loss"])
    assert abs(loss - want) <= JAX_RTOL * abs(want)
    for ci, cp in enumerate(params[0]["comps"]):
        for k in FIELDS:
            a = float(jax_grads[f"{march}_{ci}_{k}"])
            b = _g(cp[k])
            assert abs(a - b) <= JAX_RTOL * max(abs(a), abs(b)), \
                (march, ci, k, a, b)


def _setup(galaxy, size, **cfg):
    scene = _scene(galaxy, size, **cfg)
    static, params, camera, inv_vp, rs, ms, *_ = scene_args(scene, "cpu")
    dirs = ray_grid_xla(size, inv_vp)
    return (static, params, dirs, camera, rs, ms,
            tdiff.step_bound_for_scene(scene))


@pytest.mark.parametrize("name,kw", [("spiral_16", {}),
                                     ("dusty_disk_dither_16",
                                      {"dither": True})])
def test_tensor_forward_matches_scan(name, kw):
    galaxy = presets.dusty_disk() if "dusty" in name else presets.spiral()
    args = _setup(galaxy, 16, **kw)
    with torch.no_grad():
        lin_s = tdiff.render_rays_diff(*args).numpy()
        lin_t = ttm.render_rays_tensor(*args).numpy()
    scale = np.abs(lin_s).max() + 1e-9
    rel = np.abs(lin_s - lin_t) / scale
    assert np.median(rel) < 3e-4, f"median rel {np.median(rel)}"
    assert (rel > 1e-2).mean() < 0.01
    assert np.linalg.norm(lin_s - lin_t) / np.linalg.norm(lin_s) < 6e-3


def test_tensor_gradients_match_scan():
    """The default fit fields and the camera point, tensor against scan
    (tests/test_tensor_march.py:71-109's thresholds)."""
    grads = {}
    for name, fn in (("scan", tdiff.render_rays_diff),
                     ("tensor", ttm.render_rays_tensor)):
        static, params, dirs, camera, rs, ms, bound = _setup(
            _grad_galaxy(), 12)
        camera.requires_grad_(True)
        for cp in params[0]["comps"]:
            for k in FIELDS:
                cp[k].requires_grad_(True)
        lin = fn(static, params, dirs, camera, rs, ms, bound)
        torch.mean(lin ** 2).backward()
        grads[name] = (params, camera.grad.numpy().copy())
    (ps, cs), (pt, ct) = grads["scan"], grads["tensor"]
    for ci in range(len(ps[0]["comps"])):
        for k in FIELDS:
            a, b = _g(ps[0]["comps"][ci][k]), _g(pt[0]["comps"][ci][k])
            denom = abs(a) + abs(b)
            if denom < 1e-3:
                continue
            assert abs(a - b) / denom < 0.05, (ci, k, a, b)
    cos = float(cs @ ct / (np.linalg.norm(cs) * np.linalg.norm(ct) + 1e-12))
    assert cos > 0.95, (cs, ct)
    assert 0.7 < np.linalg.norm(ct) / (np.linalg.norm(cs) + 1e-12) < 1.4


def test_frozen_forward_bit_equal_to_tensor():
    args = _setup(presets.spiral(), 12)
    with torch.no_grad():
        lin_t = ttm.render_rays_tensor(*args)
        frozen = ttm.precompute_frozen(*args)
        lin_f = ttm.render_rays_tensor_frozen(*args, frozen)
    assert torch.equal(lin_t, lin_f)
    # the fields: (n_chunks, STEP_CHUNK, rays) per field, none for the bulge
    n_chunks = -(-args[-1] // ttm.STEP_CHUNK)
    assert frozen[0][0] == ()
    assert frozen[0][1][0].shape == (n_chunks, ttm.STEP_CHUNK, 144)


def test_frozen_gradients_match_scan():
    """The frozen gradients of the default fields within 5 % of the scan
    march's (tests/test_tensor_march.py:189-223), on a galaxy with a ridged
    dust component."""
    static, params, dirs, camera, rs, ms, bound = _setup(_grad_galaxy(), 12)
    frozen = ttm.precompute_frozen(static, params, dirs, camera, rs, ms,
                                   bound)
    with torch.no_grad():
        target = ttm.render_rays_tensor(static, params, dirs, camera, rs, ms,
                                        bound) * 1.2
    out = {}
    for name in ("scan", "frozen"):
        p = [{**params[0], "comps": tuple(
            {k: (v.detach().clone().requires_grad_(True) if k in FIELDS
                 else v) for k, v in cp.items()}
            for cp in params[0]["comps"])}]
        if name == "scan":
            lin = tdiff.render_rays_diff(static, p, dirs, camera, rs, ms,
                                         bound)
        else:
            lin = ttm.render_rays_tensor_frozen(static, p, dirs, camera, rs,
                                                ms, bound, frozen)
        torch.mean((lin - target) ** 2).backward()
        out[name] = p
    for ci in range(len(params[0]["comps"])):
        for k in FIELDS:
            a = _g(out["scan"][0]["comps"][ci][k])
            b = _g(out["frozen"][0]["comps"][ci][k])
            assert abs(a - b) / max(abs(a), 1e-3) < 0.05, (ci, k, a, b)


@pytest.mark.parametrize("bad", ["scale", "ks", "winding", "winding_b",
                                 "axis"])
def test_frozen_guard_rejects_noise_fields(bad):
    static = _setup(presets.spiral(), 4)[0]
    with pytest.raises(ValueError, match="frozen"):
        ttm.check_frozen_fields(static, (bad, "strength"))


def test_frozen_guard_ridged_and_fit_scene():
    """The spiral has a ridged component (dust2), so its offset and tilt
    feed the noise; the safe set passes; fit_scene(march='frozen')
    surfaces the guard."""
    scene = _scene(presets.spiral(), 8)
    static = _setup(presets.spiral(), 4)[0]
    with pytest.raises(ValueError, match="frozen"):
        ttm.check_frozen_fields(static, ("noise_tilt",))
    ttm.check_frozen_fields(static, ("strength", "r0", "z0", "inner",
                                     "delta"))
    target = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="frozen"):
        tfit.fit_scene(scene, target, ("scale",), steps=1, march="frozen",
                       device="cpu")
