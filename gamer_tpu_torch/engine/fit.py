"""Galaxy fitting (inverse rendering): the fits of ``gamer_tpu.engine.fit``
in torch.

Given a target image and a starting scene, the fits move selected galaxy
parameters, the camera pose, or both, until the scene's render matches the
target.

- ``fit_scene`` runs Adam on gradients taken through a differentiable
  march (``march=``): "tensor" (engine/tensor_march.py, the default),
  "frozen" (the tensor march with the raw noise fields evaluated once per
  fit; valid while the fitted fields do not feed the noise,
  ``check_frozen_fields``), or "scan" (engine/diff.py, bit-equal in value
  to the XLA march; its gradients follow the sequential linearization,
  which the winding fields need).
- ``fit_scene_multiscale`` runs fit_scene down a resolution pyramid;
  ``fit_scene_batch`` fits K scenes of one structure to K targets in one
  optimization; ``fit_scene_multiview`` fits one galaxy to K posed views.
- ``fit_pose`` refines the camera through the differentiable camera chain
  (``ops.camera.inv_view_projection_tensor``), ``fit_pose_multiscale``
  down a noise-LOD ladder; ``fit_joint`` and ``fit_joint_multiview``
  alternate pose blocks and parameter blocks for an unknown camera (or K
  unknown cameras) and unknown parameters.
- ``fit_scene_fd`` and ``fit_pose_fd`` take central differences instead:
  each step renders the current scene and a +h / -h probe per fitted
  scalar as one batch (``engine.batch.render_batch_linear``: one launch of
  the march kernel on the card) and steps Adam on the host. They are the
  paths for the chaotic structure fields (winding_b, scale, ks) and for
  poses at full octaves, whose autograd gradients read noise.

The scene structure stays fixed during a fit; only numeric leaves move.
Which leaves move is chosen by field name over flatten_scene's params
(``fit_fields``); gradients are made finite and masked, and the fields
with hard domain limits are projected after every step.
``apply_fit_to_scene`` writes fitted leaves back into a copy of the Scene.
Every fit takes ``device=`` (the card unless the caller asks for the CPU)
and checkpoints that a rerun resumes bit for bit, and ``mesh=`` (a 1-D
``parallel.Mesh``): the autograd fits shard pixel rows (fit_scene,
fit_pose and their ladders), the batch axis (fit_scene_batch) or the view
axis (fit_scene_multiview) over its entries, each entry on its device's
current stream, the params on the first device and their gradients summed
there; the FD fits spread their probe batch over it.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import math
import os
import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.camera import (
    inv_view_projection,
    inv_view_projection_batch,
    inv_view_projection_tensor,
    ray_grid_xla,
)
from ..scene.schema import Scene
from ..scene.spectra import BUILTIN_SPECTRA
from ..utils.tree import (
    leaf_name,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_unflatten_like,
)
from .diff import (
    conservative_step_bound,
    post_process_float,
    render_rays_diff,
    step_bound_for_scene,
)
from .cuda_render import _device
from .render import const, params_to_torch
from .scene_prep import COMP_FIELDS, _length32, flatten_scene

# component-level and instance/galaxy-level leaves that may be optimized
COMP_FITTABLE = COMP_FIELDS + ("spec",)
INSTANCE_FITTABLE = (
    "intensity_scale", "position", "axis", "winding_b", "winding_n", "arms",
)
FITTABLE_FIELDS = COMP_FITTABLE + INSTANCE_FITTABLE

# hard domain limits, projected after each update: these leaves divide or
# exponentiate in the shading math
_FIT_BOUNDS = {
    "z0": 1e-4,
    "r0": 1e-4,
    "winding_b": 1e-3,
    "scale": 0.0,
    # inner == 0 is a zero-width smoothstep edge (0/0): harmless forward
    # (NaN -> clamp -> 1, the oracle's value) but its derivative is NaN
    "inner": 1e-4,
    # 1/(axis*axis) in the intersector and /axis[0] in the radius
    "axis": 1e-2,
}

DEFAULT_FIT_FIELDS = ("strength", "r0", "z0")


def _to_numpy(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _ss_setup(scene: Scene, size: int):
    """(ss, pool_linear) of the differentiable forward model: ss^2 rays per
    pixel (a size*ss ray grid) box-averaged in linear space before the post
    chain, as render.render_frame_ss, so a fit against a supersampled
    target carries no sampling bias."""
    ss = int(scene.config.supersample)
    if ss <= 1:
        return 1, (lambda linear: linear)

    def pool_linear(linear):
        # (rows * ss, size * ss, 3) -> (rows, size, 3): a whole frame or a
        # row slab of one
        return linear.reshape(-1, ss, size, ss, 3).mean(dim=(1, 3))

    return ss, pool_linear


# ---------------------------------------------------------------------------
# checkpoints: the npz layout of gamer_tpu.engine.fit (leaf k of the params,
# the optimizer state and the best params under "p{k}", "o{k}", "b{k}")
# ---------------------------------------------------------------------------


def _ckpt_save(path: str, fingerprint: str, i: int, params, opt_state,
               losses, best_loss: float, best_params) -> None:
    """Persist one optimizer step boundary atomically (written to a
    temporary file, then renamed over ``path``)."""
    leaves = {}
    for tag, tree in (("p", params), ("o", opt_state), ("b", best_params)):
        for k, leaf in enumerate(tree_leaves(tree)):
            leaves[f"{tag}{k}"] = _to_numpy(leaf)
    tmp = f"{path}.tmp"
    np.savez(tmp, __fingerprint__=np.frombuffer(fingerprint.encode(),
                                                np.uint8),
             __step__=np.int64(i),
             __losses__=np.asarray(losses, np.float64),
             __best_loss__=np.asarray(best_loss, np.float64), **leaves)
    os.replace(tmp + (".npz" if not tmp.endswith(".npz") else ""), path)


def _ckpt_load(path: str, fingerprint: str, params, opt_state, best_params):
    """(step, params, opt_state, losses, best_loss, best_params) from
    ``path``, or None if it does not exist. A checkpoint written by a
    different fit setup raises. Each leaf comes back as the live leaf's
    kind: a tensor of its dtype on its device, or a numpy array."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        saved = bytes(z["__fingerprint__"]).decode()
        if saved != fingerprint:
            raise ValueError(
                f"checkpoint {path} was written by a different fit "
                f"(fields/lr/march/scene/target changed); delete it or use "
                f"another path")

        def restore(tag, tree):
            out = []
            for k, ref in enumerate(tree_leaves(tree)):
                a = z[f"{tag}{k}"]
                if torch.is_tensor(ref):
                    a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                else:
                    a = np.array(a)
                out.append(a)
            return tree_unflatten_like(tree, out)

        return (int(z["__step__"]), restore("p", params),
                restore("o", opt_state), list(z["__losses__"]),
                np.asarray(z["__best_loss__"]), restore("b", best_params))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class Adam:
    """``optax.adam`` (scale_by_adam, then the learning rate) written out in
    optax's order of operations, so trajectories compare with the JAX
    package's (``torch.optim.Adam`` orders them differently). The state is
    (count, mu, nu), the leaf order of optax's state."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.eps_root = eps, eps_root

    def init(self, params):
        device = tree_leaves(params)[0].device
        return (torch.zeros((), dtype=torch.int32, device=device),
                tree_map(torch.zeros_like, params),
                tree_map(torch.zeros_like, params))

    def update(self, grads, state, params=None):
        """(updates, new state) for ``grads``; the updates are added to the
        params."""
        count, mu, nu = state
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads, nu)
        count_inc = torch.where(count < torch.iinfo(torch.int32).max,
                                count + 1, count)
        c = count_inc.to(torch.float32)
        bc1 = 1 - torch.pow(const(c, b1), c)
        bc2 = 1 - torch.pow(const(c, b2), c)
        updates = tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2 + self.eps_root)
                                      + self.eps), mu, nu)
        updates = tree_map(lambda u: u * (-1 * self.lr), updates)
        return updates, (count_inc, mu, nu)


def _optimize(loss_fn, params, mask, *, steps, lr, optimizer, on_step,
              project_fn=None, checkpoint_path=None, checkpoint_every=1,
              fingerprint="", batch: int = 0, captures=()):
    """The masked Adam loop of every autograd fit.

    - Gradients are made finite (nan_to_num) and masked to the fitted
      leaves; only those leaves record gradients.
    - With the default optimizer each leaf's update is scaled by its
      starting magnitude max(|leaf|, 0.1) (relative steps: galaxy knobs
      span four orders of magnitude).
    - ``project_fn(params)`` applies the domain limits after each step.
    - ``on_step(i, loss)`` returning False stops after the current step.
    - ``checkpoint_path`` saves (params, optimizer state, losses) every
      ``checkpoint_every`` steps and at the last one, and resumes from it.
    - ``batch`` = K > 0: ``loss_fn`` returns a (K,) per-scene loss vector
      (fit_scene_batch). The gradient descends its SUM, whose gradient in
      scene k's leaves is scene k's own (a mean's 1/K would bend the Adam
      trajectories of scenes near their minimum); every leaf carries a
      leading K axis, each loss is a (K,) array, and the best iterate is
      kept per scene, as K independent fits would.
    - ``captures`` are large tensors the loss reads (the frozen noise
      fields), passed as ``loss_fn(p, *captures)``, detached.
    - ``loss_fn`` returns the loss, or on a mesh an iterator of its parts,
      one per mesh entry in entry order (their sum is the loss; in batch
      mode, their concatenation). Each part is differentiated as it
      comes, before the next entry's forward runs, so one entry's graph
      is alive at a time; the gradients are summed on the params' device
      in entry order, then made finite and masked.
    - Returns (best_params, losses): each step's loss belongs to the params
      before its update and the last iterate's loss is evaluated at the
      end, so the best pair is chosen over every iterate.
    """
    opt = Adam(lr) if optimizer is None else optimizer
    if optimizer is None:
        rel = tree_map(lambda l: torch.maximum(torch.abs(l), const(l, 0.1)),
                       params)
    else:
        rel = tree_map(torch.ones_like, params)
    opt_state = opt.init(params)
    caps = tuple(captures)
    masks = [float(m) for m in tree_leaves(mask)]
    dev = tree_leaves(params)[0].device

    def host(loss):
        return loss.cpu().numpy() if batch else float(loss)

    def parts_of(out):
        return (out,) if torch.is_tensor(out) else out

    def join(total, part):
        part = part.detach().to(dev)
        if total is None:
            return part
        return torch.cat([total, part]) if batch else total + part

    def step_fn(p, s):
        live = [leaf.detach().requires_grad_(m != 0.0)
                for leaf, m in zip(tree_leaves(p), masks)]
        wrt = [leaf for leaf in live if leaf.requires_grad]
        loss, summed = None, None
        for part in parts_of(loss_fn(tree_unflatten_like(p, live), *caps)):
            if wrt:
                got = torch.autograd.grad(part.sum() if batch else part,
                                          wrt, allow_unused=True)
                summed = list(got) if summed is None else [
                    g if a is None else a if g is None else a + g
                    for a, g in zip(summed, got)]
            loss = join(loss, part)
            del part
        got = iter(summed or ())
        grads = []
        for leaf, m in zip(live, masks):
            g = next(got) if leaf.requires_grad else None
            grads.append(torch.zeros_like(leaf) if g is None
                         else torch.nan_to_num(g) * m)
        with torch.no_grad():
            updates, s = opt.update(tree_unflatten_like(p, grads), s, p)
            new_p = tree_map(lambda leaf, u, r: leaf + u * r, p, updates, rel)
            if project_fn is not None:
                new_p = project_fn(new_p)
        return new_p, s, host(loss.detach())

    def improve(loss_now, params_now):
        """Fold one iterate into the running (best_loss, best_params)."""
        nonlocal best_loss, best_params
        if not batch:
            if loss_now < best_loss:
                best_loss, best_params = loss_now, params_now
            return
        imp = np.asarray(loss_now) < np.asarray(best_loss)
        if imp.any():
            sel = torch.as_tensor(imp, device=dev)
            best_params = tree_map(
                lambda b, c: torch.where(
                    sel.reshape(imp.shape + (1,) * (c.dim() - 1)), c, b),
                best_params, params_now)
            best_loss = np.where(imp, np.asarray(loss_now),
                                 np.asarray(best_loss))

    losses: List = []
    best_params = params
    best_loss = np.full((batch,), np.inf) if batch else np.inf
    start = 0
    if checkpoint_path:
        resumed = _ckpt_load(checkpoint_path, fingerprint, params, opt_state,
                             best_params)
        if resumed is not None:
            start, params, opt_state, losses, bl, best_params = resumed
            best_loss = np.asarray(bl) if batch else float(bl)
            if start > steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path} already holds {start} "
                    f"steps but only {steps} were requested — increase "
                    f"steps to extend the run, or delete the checkpoint "
                    f"to start over")
    for i in range(start, steps):
        new_params, opt_state, loss = step_fn(params, opt_state)
        losses.append(loss)
        improve(loss, params)
        params = new_params
        if checkpoint_path and ((i + 1) % max(1, checkpoint_every) == 0
                                or i + 1 == steps):
            # the last step always saves: a finished run can be extended
            _ckpt_save(checkpoint_path, fingerprint, i + 1, params,
                       opt_state, losses, best_loss, best_params)
        if on_step is not None and on_step(i, losses[-1]) is False:
            break
    # the last iterate's loss was not seen by the loop
    with torch.no_grad():
        final = None
        for part in parts_of(loss_fn(params, *caps)):
            final = join(final, part)
        final = host(final)
    losses.append(final)
    improve(final, params)
    return best_params, losses


def _block_callback(on_step, base: int, state: dict):
    """A block's on_step: the global index ``base + i``; a False from the
    caller's on_step is remembered in ``state["aborted"]``."""
    if on_step is None:
        return None

    def cb(i, loss):
        r = on_step(base + i, loss)
        if r is False:
            state["aborted"] = True
        return r
    return cb


def _fit_fingerprint(kind: str, fit_fields, lr, march, size, params,
                     target, extra: str = "", aux=()) -> str:
    """Identity of a fit setup for checkpoint resume: the fitted leaves,
    step rule and every numeric input of the loss (``aux``: camera pose,
    step sizes, post knobs, trip bound), steps excluded so a resume may
    extend a run. The same string as ``gamer_tpu.engine.fit``'s for the
    same inputs."""
    h = hashlib.sha256()
    for leaf in tree_leaves((params, list(aux))):
        h.update(np.ascontiguousarray(
            np.asarray(_to_numpy(leaf), np.float64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(target)).tobytes())
    return (f"{kind}|{','.join(sorted(fit_fields))}|{lr:g}|{march}|{size}|"
            f"{extra}|{h.hexdigest()[:16]}")


@dataclass
class FitResult:
    """Outcome of a fit: the fitted scene and the optimization trace."""

    scene: Scene   # deep copy with fitted values written back
    params: object  # fitted params (flatten_scene's tree, numpy)
    losses: List[float] = field(default_factory=list)
    fit_fields: Tuple[str, ...] = ()


def _fit_mask(params, fit_fields: Sequence[str]):
    wanted = set(fit_fields)
    unknown = wanted - set(FITTABLE_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown fit fields {sorted(unknown)}; fittable: {FITTABLE_FIELDS}")
    return tree_map_with_path(
        lambda path, _leaf: 1.0 if leaf_name(path) in wanted else 0.0, params)


def _project_bounds(params, fit_fields: Sequence[str]):
    wanted = set(fit_fields) & set(_FIT_BOUNDS)
    if not wanted:
        return params

    def project(path, leaf):
        name = leaf_name(path)
        if name not in wanted:
            return leaf
        return torch.maximum(leaf, const(leaf, _FIT_BOUNDS[name]))

    return tree_map_with_path(project, params)


def _march_fn(march: str):
    """The differentiable march: 'scan' (the fixed-trip XLA march) or
    'tensor' (the tensorized march)."""
    if march == "scan":
        return render_rays_diff
    if march == "tensor":
        from .tensor_march import render_rays_tensor

        return render_rays_tensor
    if march == "frozen":
        raise ValueError(
            "march='frozen' is only supported by fit_scene / "
            "fit_scene_multiscale / fit_scene_batch / fit_scene_multiview "
            "(fixed cameras, per-call noise precompute); fit_pose moves "
            "the camera, which moves every noise input — use "
            "march='tensor' there")
    raise ValueError(
        f"unknown march backend {march!r}; use 'scan', 'tensor' or 'frozen'")


# fields whose gradients flow through the spiral winding angle: the tensor
# march's reassociated gradients diverge from the sequential ones there
_WINDING_FIELDS = frozenset({"winding", "winding_b", "winding_n"})


def _check_march_fields(march: str, fit_fields) -> None:
    bad = _WINDING_FIELDS & set(fit_fields)
    if march == "tensor" and bad:
        warnings.warn(
            f"fitting winding-family fields {sorted(bad)} with the tensor "
            "march: their reassociated gradients diverge from the true "
            "linearization (chaotic winding sensitivity) — pass "
            "march='scan' for trustworthy winding gradients, or use "
            "fit_scene_fd (march='fd' on the CLI) for the march-kernel "
            "probe path.",
            RuntimeWarning, stacklevel=3)


def _f32(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _mesh_devices(mesh) -> list:
    """The devices of a 1-D mesh's entries, in entry order, each checked as
    a ``device=`` argument is (a CUDA entry without a card raises; a CPU
    entry runs only where the caller names one)."""
    if len(mesh.axis_names) != 1:
        raise ValueError(f"need a 1-D mesh, got axes {mesh.axis_names}")
    return [_device(d) for d in mesh.devices]


def _check_mesh_divides(n_dev: int, size: int, pool: int, who: str) -> None:
    if (size // pool) % n_dev:
        raise ValueError(
            f"{who}: pooled frame rows {size // pool} must divide the mesh "
            f"({n_dev} devices) so every device owns whole output rows")


def _check_views_divide(n_dev: int, k: int) -> None:
    if k % n_dev:
        raise ValueError(
            f"fit_scene_multiview: {k} views must divide the mesh "
            f"({n_dev} devices) so every device owns whole views")


def _per_device(make):
    """``make(device)`` once per distinct device: the constants that each
    mesh entry reads on its own device."""
    cache = {}

    def get(d):
        if d not in cache:
            cache[d] = make(d)
        return cache[d]
    return get


def _to(tree, d):
    """A params tree on device ``d``: differentiable copies, or the leaves
    themselves on their own device (the gradients cross the copies)."""
    return tree_map(lambda leaf: leaf.to(d), tree)


def _image_model(scene: Scene, size: int, pool: int, dev,
                 normalize: bool = False):
    """The differentiable forward model's image end, shared by the autograd
    fits: (ss, prep, image, image_loss). ``image(linear)`` pools the ss^2
    rays per pixel in linear space and runs the float post chain into [0,
    1]; ``prep(img)`` box-averages by ``pool`` (and with ``normalize``
    divides by the mean); ``image_loss(linear, target_prepped)`` is the
    MSE of the two in image space. Each works on a whole frame or a row
    slab of whole pooled rows."""
    ss, linear_pooled = _ss_setup(scene, size)
    cfg = scene.config
    ex, ga, sa = (_f32(cfg.exposure, dev), _f32(cfg.gamma, dev),
                  _f32(cfg.saturation, dev))
    o = size // pool

    def image(linear):
        return post_process_float(linear_pooled(linear), ex, ga,
                                  sa) / const(linear, 255.0)

    def prep(img):
        if pool > 1:
            img = img.reshape(-1, pool, o, pool, 3).mean(dim=(1, 3))
        if normalize:
            img = img / (torch.mean(img) + 1e-6)
        return img

    def image_loss(linear, target_prepped):
        return torch.mean((prep(image(linear)) - target_prepped) ** 2)

    return ss, prep, image, image_loss


def _trip_bound(scenes, max_steps, fit_fields) -> int:
    """The march's trip bound for a fit of ``scenes`` (one forward model):
    ``max_steps``, or the largest step_bound_for_scene of them, with 2x
    axis headroom when "axis" is fitted (the bound is fixed, but the chord
    grows with the fitted axis)."""
    if max_steps is not None:
        return max_steps
    cfg = scenes[0].config
    bound = max(step_bound_for_scene(sc) for sc in scenes)
    if "axis" in fit_fields:
        max_axis = max((max(gi.galaxy.params.axis)
                        for sc in scenes for gi in sc.instances), default=1.0)
        bound = conservative_step_bound(cfg.ray_step, cfg.min_ray_step,
                                        2.0 * max_axis)
    return bound


def _frozen_march():
    from .tensor_march import (
        check_frozen_fields,
        precompute_frozen,
        render_rays_tensor_frozen,
    )

    return check_frozen_fields, precompute_frozen, render_rays_tensor_frozen


def fit_scene(
    scene: Scene,
    target_image,
    fit_fields: Sequence[str] = DEFAULT_FIT_FIELDS,
    *,
    steps: int = 100,
    lr: float = 2e-2,
    max_steps: Optional[int] = None,
    optimizer=None,
    on_step: Optional[Callable[[int, float], None]] = None,
    march: str = "tensor",
    pool: int = 1,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """Fit ``fit_fields`` of ``scene`` so its render matches ``target_image``,
    on ``device``.

    target_image: (size, size, 3) uint8 or float in [0, 255], the
    post-processed image space. The loss is the mean squared error in
    [0, 1] image space; ``pool`` box-averages both images by that factor
    first. ``max_steps`` overrides the march's trip bound (by default
    step_bound_for_scene, with 2x axis headroom when "axis" is fitted).
    ``optimizer`` replaces the relative-step Adam with an object of
    ``Adam``'s init/update interface (unscaled updates).
    ``checkpoint_path`` saves the optimizer state every
    ``checkpoint_every`` steps and resumes from it when the file exists; a
    checkpoint of a different setup is rejected.

    ``mesh`` (a 1-D ``parallel.Mesh``; ``device`` is then not consulted)
    shards the pixel rows: entry i marches ray rows of pooled output rows
    i * R + [0, R), R = (size // pool) / n, on its device (on that
    device's current stream), and with march='frozen' precomputes and
    keeps its own slab's noise fields there. The params stay on the
    mesh's first device and each entry reads copies of them. An entry's
    loss is its slab's mean squared error over n, differentiated before
    the next entry runs, so a step holds one entry's graph at a time; the
    loss is the sum of the entries' and the gradients are summed on the
    first device in entry order. The pooled frame rows must divide the
    mesh. Without a mesh the fit is this path on one entry, ``device``.

    Returns a FitResult whose scene is a deep copy with the fitted values
    written back.
    """
    # without a mesh the fit is a one-entry mesh of ``device``
    devs = [_device(device)] if mesh is None else _mesh_devices(mesh)
    dev = devs[0]
    target = np.asarray(target_image, np.float32) / 255.0
    size = target.shape[0]
    if target.shape != (size, size, 3):
        raise ValueError(f"target must be (N, N, 3), got {target.shape}")
    if size != scene.config.size:
        raise ValueError(
            f"target size {size} != scene.config.size {scene.config.size}")
    if pool < 1 or size % pool != 0:
        raise ValueError(f"pool {pool} must divide the size {size}")
    _check_mesh_divides(len(devs), size, pool, "fit_scene")
    ss, prep, _image, image_loss = _image_model(scene, size, pool, dev)
    target_pooled = prep(torch.as_tensor(target, device=dev))

    cfg = scene.config
    static, params0 = flatten_scene(scene)
    params = params_to_torch(params0, dev)
    camera = _f32(scene.camera.camera, dev)
    inv_vp = _f32(inv_view_projection(
        np.asarray(scene.camera.camera, np.float32), scene.camera.target,
        scene.camera.up, scene.camera.fov), dev)
    dirs = ray_grid_xla(size * ss, inv_vp)
    trip_bound = _trip_bound([scene], max_steps, fit_fields)
    rs, ms = _f32(cfg.ray_step, dev), _f32(cfg.min_ray_step, dev)

    _check_march_fields(march, fit_fields)
    if march == "frozen":
        # the noise fields once: check_frozen_fields rejects every fitted
        # field that feeds them
        check_frozen, precompute, frozen_fn = _frozen_march()
        check_frozen(static, fit_fields)

        def march_on(p, d, c, r, m, fz):
            return frozen_fn(static, p, d, c, r, m, trip_bound, fz)
    else:
        _march = _march_fn(march)

        def march_on(p, d, c, r, m, fz):
            return _march(static, p, d, c, r, m, trip_bound)

    n = len(devs)
    rows = size // n  # output rows an entry
    consts = _per_device(lambda d: (
        image_loss if d == dev else _image_model(scene, size, pool, d)[3],
        rs.to(d), ms.to(d), camera.to(d)))
    entries = [
        (d, *consts(d), dirs[i * rows * ss:(i + 1) * rows * ss].to(d),
         target_pooled[i * rows // pool:(i + 1) * rows // pool].to(d))
        for i, d in enumerate(devs)]
    captures = ((tuple(
        precompute(static, _to(params, d), e_dirs, cam_d, rs_d, ms_d,
                   trip_bound)
        for d, _l, rs_d, ms_d, cam_d, e_dirs, _t in entries),)
        if march == "frozen" else ())

    def loss_fn(p, *cap):
        # an entry's part is its slab's mean squared error times its share
        # of the frame, 1 / n (times 1.0, exactly the mean, on one entry)
        for i, (d, loss_d, rs_d, ms_d, cam_d, e_dirs,
                e_target) in enumerate(entries):
            yield loss_d(march_on(_to(p, d), e_dirs, cam_d, rs_d, ms_d,
                                  cap[0][i] if cap else None),
                         e_target) * (1.0 / n)

    mask = _fit_mask(params, fit_fields)
    # project the start too: a field on a singular value (inner == 0)
    # would never get a usable gradient
    params = _project_bounds(params, fit_fields)
    best_params, losses = _optimize(
        loss_fn, params, mask, steps=steps, lr=lr, optimizer=optimizer,
        on_step=on_step,
        project_fn=lambda p: _project_bounds(p, fit_fields),
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        fingerprint=_fit_fingerprint(
            "scene", fit_fields, lr, march, size, params, target,
            extra=(f"pool{pool}|lod{cfg.noise_octaves}"
                   + (f"|ss{ss}" if ss > 1 else "")),
            aux=(scene.camera.camera, scene.camera.target, scene.camera.up,
                 scene.camera.fov, cfg.ray_step, cfg.min_ray_step,
                 cfg.exposure, cfg.gamma, cfg.saturation, trip_bound)),
        captures=captures,
    )
    fitted = tree_map(_to_numpy, best_params)
    return FitResult(scene=apply_fit_to_scene(scene, fitted, fit_fields),
                     params=fitted, losses=losses,
                     fit_fields=tuple(fit_fields))


# resolution divisors of the default parameter-fit pyramid: most steps on
# the quarter-resolution forward model, then half, then full
DEFAULT_SCENE_SCHEDULE: Tuple[int, ...] = (4, 2, 1)


def fit_scene_multiscale(
    scene: Scene,
    target_image,
    fit_fields: Sequence[str] = DEFAULT_FIT_FIELDS,
    *,
    steps: int = 40,
    lr: float = 2e-2,
    schedule: Sequence[int] = DEFAULT_SCENE_SCHEDULE,
    max_steps: Optional[int] = None,
    optimizer=None,
    on_step: Optional[Callable[[int, float], None]] = None,
    march: str = "tensor",
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """fit_scene down a resolution pyramid, in one call. Each ``schedule``
    entry is a divisor s: the rung fits at size/s against the
    box-downsampled target, ``steps`` steps per rung, each rung starting
    from the previous rung's values. An abort inside a rung stops the
    ladder. CLI: ``fit ... multiscale``."""
    if not schedule:
        raise ValueError("schedule must have at least one resolution rung")
    size = int(scene.config.size)
    target = np.asarray(target_image, np.float32)
    current = scene
    all_losses: List[float] = []
    result: Optional[FitResult] = None
    base = 0
    state = {"aborted": False}
    for s in schedule:
        s = int(s)
        while s > 1 and size % s:
            s -= 1  # the divisor must tile the frame
        rsize = size // s
        rung_target = (target.reshape(rsize, s, rsize, s, 3).mean(axis=(1, 3))
                       if s > 1 else target)
        rung_scene = dataclasses.replace(
            current, config=dataclasses.replace(current.config, size=rsize))
        result = fit_scene(
            rung_scene, rung_target, fit_fields, steps=steps, lr=lr,
            max_steps=max_steps, optimizer=optimizer,
            on_step=_block_callback(on_step, base, state),
            march=march, mesh=mesh,
            checkpoint_path=(f"{checkpoint_path}.rung{base // steps}"
                             if checkpoint_path else None),
            checkpoint_every=checkpoint_every, device=device)
        current = result.scene
        all_losses.extend(result.losses)
        base += steps
        if state["aborted"]:
            break
    final_scene = dataclasses.replace(
        result.scene, config=dataclasses.replace(result.scene.config,
                                                 size=size))
    return FitResult(scene=final_scene, params=result.params,
                     losses=all_losses, fit_fields=tuple(fit_fields))


def _batch_losses(cfg, target: np.ndarray, pool: int, normalize: bool):
    """The fd fits' loss of every frame of a probe batch, computed on the
    batch's device: ``losses_of(linear (B, S, S, 3)) -> (B,)`` float64 on
    the host, the MSE against ``target`` ((S, S, 3) in [0, 1]) after the
    post chain, ``pool`` and, with ``normalize``, division by the mean."""
    size = target.shape[0]
    tprep = target
    if pool > 1:
        o = size // pool
        tprep = tprep.reshape(o, pool, o, pool, 3).mean(axis=(1, 3))
    if normalize:
        tprep = tprep / (tprep.mean() + 1e-6)
    knobs = {}  # the post knobs and target on the output's device

    def losses_of(linear) -> np.ndarray:
        d = linear.device
        if d not in knobs:
            knobs[d] = (_f32(cfg.exposure, d), _f32(cfg.gamma, d),
                        _f32(cfg.saturation, d),
                        torch.as_tensor(tprep, device=d))
        ex, ga, sa, tp = knobs[d]
        with torch.no_grad():
            img = post_process_float(linear, ex, ga, sa) / const(linear,
                                                                 255.0)
            if pool > 1:
                o = size // pool
                img = img.reshape(-1, o, pool, o, pool, 3).mean(dim=(2, 4))
            if normalize:
                img = img / (torch.mean(img, dim=(1, 2, 3), keepdim=True)
                             + 1e-6)
            out = torch.mean((img - tp) ** 2, dim=(1, 2, 3))
        return out.cpu().numpy().astype(np.float64)

    return losses_of


def _host_adam(g, m, v, t: int, lr: float):
    """One step of the fd fits' host Adam: (update, m, v, t) from the
    gradient ``g``, with float32 moments (the checkpointed state)."""
    b1, b2, aeps = 0.9, 0.999, 1e-8
    t += 1
    m = (b1 * m + (1 - b1) * g).astype(np.float32)
    v = (b2 * v + (1 - b2) * g * g).astype(np.float32)
    upd = lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + aeps)
    return upd, m, v, t


@dataclass
class BatchFitResult:
    """Outcome of fit_scene_batch: K fitted scenes and per-scene traces."""

    scenes: List[Scene]     # K deep copies with fitted values written back
    params: object          # stacked params (leading K axis), numpy
    losses: "np.ndarray"    # (steps+1, K) per-scene loss trace
    fit_fields: Tuple[str, ...] = ()


def fit_scene_batch(
    scenes,
    target_images,
    fit_fields: Sequence[str] = DEFAULT_FIT_FIELDS,
    *,
    steps: int = 100,
    lr: float = 2e-2,
    max_steps: Optional[int] = None,
    optimizer=None,
    on_step: Optional[Callable[[int, object], None]] = None,
    march: str = "tensor",
    pool: int = 1,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> BatchFitResult:
    """Fit K independent scenes to K targets in one optimization, on
    ``device``: parameters gain a leading K axis, the loss is the (K,)
    vector of per-scene losses, gradients descend its sum (whose gradient
    in scene k's leaves is scene k's own), Adam runs elementwise and the
    best iterate is kept per scene. Each scene's trajectory is the one its
    standalone fit_scene gives: the forward model loops over the K scenes,
    each slicing its leaves out of the stacked ones, so scene k's graph is
    exactly fit_scene's (K times the launches of one fit).

    ``scenes``: one template Scene (every fit starts from the same values;
    with march='frozen' one noise field set then serves all K) or K Scenes
    of one structure, camera pose and render config (each starts from its
    own values and gets its own frozen fields). ``target_images``: (K, N,
    N, 3) in [0, 255]. ``on_step(i, losses)`` sees the (K,) losses.
    ``mesh`` (a 1-D ``parallel.Mesh``; ``device`` is then not consulted)
    shards the batch axis: entry i fits scenes i * K/n ... (i+1) * K/n - 1
    on its device, each reading copies of its slice of the stacked leaves
    (which stay on the mesh's first device) and its own frozen fields;
    each entry's part of the loss vector is differentiated before the
    next entry runs. Scene k's graph is the unsharded one's, so on one
    device the fit is bit-equal to the unsharded fit. K must divide the
    mesh. Checkpoints resume the whole batch bit for bit, each leaf onto
    the live leaf's device. Without a mesh the fit is this path on one
    entry, ``device``."""
    devs = [_device(device)] if mesh is None else _mesh_devices(mesh)
    dev = devs[0]
    if hasattr(scenes, "instances"):
        scene_list = None
        template = scenes
    else:
        scene_list = list(scenes)
        if not scene_list:
            raise ValueError("fit_scene_batch needs at least one scene")
        template = scene_list[0]

    targets = np.asarray(target_images, np.float32)
    if targets.ndim != 4 or targets.shape[-1] != 3 \
            or targets.shape[1] != targets.shape[2]:
        raise ValueError(
            f"target_images must be (K, N, N, 3), got {targets.shape}")
    K = targets.shape[0]
    size = targets.shape[1]
    if size != template.config.size:
        raise ValueError(
            f"target size {size} != scene.config.size {template.config.size}")
    if scene_list is not None and len(scene_list) != K:
        raise ValueError(
            f"{len(scene_list)} scenes but {K} targets")
    if pool < 1 or size % pool != 0:
        raise ValueError(f"pool {pool} must divide the size {size}")
    if K % len(devs):
        raise ValueError(
            f"fit_scene_batch: batch size {K} must divide the mesh "
            f"({len(devs)} devices) so every device owns whole scenes")
    ss, prep, _image, image_loss = _image_model(template, size, pool, dev)
    _check_march_fields(march, fit_fields)

    cfg = template.config
    static, params0 = flatten_scene(template)
    if scene_list is None:
        stacked = tree_map(lambda leaf: np.repeat(np.asarray(leaf)[None], K,
                                                  axis=0), params0)
    else:
        flats = []
        for k, sc in enumerate(scene_list):
            st_k, p_k = flatten_scene(sc)
            if st_k != static:
                raise ValueError(
                    f"scene {k} has a different compiled structure than "
                    f"scene 0 — fit_scene_batch requires one structure "
                    f"(same components/arms/LOD/dither) across the batch")
            cam, cam0 = sc.camera, template.camera
            if (tuple(cam.camera) != tuple(cam0.camera)
                    or tuple(cam.target) != tuple(cam0.target)
                    or tuple(cam.up) != tuple(cam0.up)
                    or cam.fov != cam0.fov):
                raise ValueError(
                    f"scene {k} has a different camera pose — the batch "
                    f"shares one ray grid; fit poses with fit_pose")
            for fld in ("size", "ray_step", "min_ray_step", "exposure",
                        "gamma", "saturation", "supersample"):
                if getattr(sc.config, fld) != getattr(template.config, fld):
                    raise ValueError(
                        f"scene {k} has config.{fld}="
                        f"{getattr(sc.config, fld)!r} but scene 0 has "
                        f"{getattr(template.config, fld)!r} — the batch "
                        f"shares ONE forward model (ray grid, march step, "
                        f"post chain), so render configs must match")
            flats.append(p_k)
        stacked = tree_map(lambda *leaves: np.stack([np.asarray(v)
                                                     for v in leaves]),
                           *flats)
    params = params_to_torch(stacked, dev)
    # per-scene pooled targets: scene k's is the one its fit_scene pools
    targets_pooled = [prep(torch.as_tensor(targets[k] / 255.0, device=dev))
                      for k in range(K)]

    camera = _f32(template.camera.camera, dev)
    inv_vp = _f32(inv_view_projection(
        np.asarray(template.camera.camera, np.float32),
        template.camera.target, template.camera.up, template.camera.fov),
        dev)
    dirs = ray_grid_xla(size * ss, inv_vp)
    # the bound over EVERY scene's geometry: a member whose axes exceed the
    # template's would otherwise march with too few trips
    trip_bound = _trip_bound(scene_list or [template], max_steps, fit_fields)
    rs, ms = _f32(cfg.ray_step, dev), _f32(cfg.min_ray_step, dev)

    def scene_k(p, k):
        return tree_map(lambda leaf: leaf[k], p)

    # the scenes' devices and each device's copies of the forward model's
    # constants
    n_ent = len(devs)
    per = K // n_ent
    scene_dev = [devs[k // per] for k in range(K)]
    consts = _per_device(lambda d: (
        image_loss if d == dev else _image_model(template, size, pool, d)[3],
        dirs.to(d), camera.to(d), rs.to(d), ms.to(d)))
    t_on = [targets_pooled[k].to(scene_dev[k]) for k in range(K)]

    if march == "frozen":
        check_frozen, precompute, frozen_fn = _frozen_march()
        check_frozen(static, fit_fields)
        if scene_list is None:
            # one template: the K starts are equal, so ONE field set per
            # device serves every scene instead of K x the precompute memory
            shared = _per_device(lambda d: precompute(
                static, params_to_torch(params0, d), *consts(d)[1:],
                trip_bound))
            captures = (tuple(shared(d) for d in scene_dev),)
        else:
            # the fields depend on each scene's starting values
            captures = (tuple(precompute(
                static, _to(scene_k(params, k), scene_dev[k]),
                *consts(scene_dev[k])[1:], trip_bound) for k in range(K)),)

        def march_scene(p, d, fz):
            return frozen_fn(static, p, *consts(d)[1:], trip_bound, fz)
    else:
        _march = _march_fn(march)
        captures = ()

        def march_scene(p, d, fz):
            return _march(static, p, *consts(d)[1:], trip_bound)

    def scene_losses(p, cap, ks):
        return torch.stack([
            consts(scene_dev[k])[0](
                march_scene(_to(scene_k(p, k), scene_dev[k]), scene_dev[k],
                            cap[0][k] if cap else None), t_on[k])
            for k in ks])

    def loss_fn(p, *cap):
        for i in range(n_ent):
            yield scene_losses(p, cap, range(i * per, (i + 1) * per))

    mask = _fit_mask(params, fit_fields)
    params = _project_bounds(params, fit_fields)
    best_params, losses = _optimize(
        loss_fn, params, mask, steps=steps, lr=lr, optimizer=optimizer,
        on_step=on_step,
        project_fn=lambda p: _project_bounds(p, fit_fields),
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        fingerprint=_fit_fingerprint(
            "batch", fit_fields, lr, march, size, params, targets,
            extra=(f"pool{pool}|lod{cfg.noise_octaves}|K{K}"
                   + (f"|ss{ss}" if ss > 1 else "")),
            aux=(template.camera.camera, template.camera.target,
                 template.camera.up, template.camera.fov, cfg.ray_step,
                 cfg.min_ray_step, cfg.exposure, cfg.gamma, cfg.saturation,
                 trip_bound)),
        batch=K,
        captures=captures,
    )
    fitted = tree_map(_to_numpy, best_params)
    base_scenes = scene_list if scene_list is not None else [template] * K
    return BatchFitResult(
        scenes=[apply_fit_to_scene(base_scenes[k],
                                   tree_map(lambda leaf: leaf[k], fitted),
                                   fit_fields) for k in range(K)],
        params=fitted,
        losses=np.stack([np.asarray(v) for v in losses]),
        fit_fields=tuple(fit_fields),
    )


def fit_scene_multiview(
    scene: Scene,
    targets,
    cameras: Sequence,
    fit_fields: Sequence[str] = DEFAULT_FIT_FIELDS,
    *,
    steps: int = 100,
    lr: float = 2e-2,
    max_steps: Optional[int] = None,
    optimizer=None,
    on_step: Optional[Callable[[int, float], None]] = None,
    pool: int = 1,
    march: str = "tensor",
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """Fit ONE galaxy's parameters against K views of it at once, on
    ``device``. ``targets``: (K, size, size, 3) renders of the galaxy from
    the K known poses ``cameras`` (CameraParams, held fixed). The loss is
    the mean of the per-view MSEs, so gradients triangulate the 3-D
    structure that one view cannot separate (a thicker disk from a
    brighter one). The forward model loops over the views, each with its
    own ray grid and camera origin (and with march='frozen' its own noise
    fields). The scene's own camera is not a view unless passed in
    ``cameras``. ``pool``, ``march`` and checkpoints are as in fit_scene.

    ``mesh`` (a 1-D ``parallel.Mesh``; ``device`` is then not consulted)
    shards the view axis: entry i renders views i * K/n ... (i+1) * K/n - 1
    on its device from copies of the params (which stay on the mesh's
    first device), with their frozen fields kept there; an entry's part
    of the loss is its views' mean MSE times per / K, differentiated
    before the next entry runs, and the per-view gradients are summed on
    the first device in entry order. K must divide the mesh. Without a
    mesh the fit is this path on one entry, ``device``."""
    # without a mesh the fit is a one-entry mesh of ``device``
    devs = [_device(device)] if mesh is None else _mesh_devices(mesh)
    dev = devs[0]
    targets = np.asarray(targets, np.float32) / 255.0
    size = int(scene.config.size)
    if targets.ndim != 4 or targets.shape[1:] != (size, size, 3):
        raise ValueError(
            f"targets must be (K, {size}, {size}, 3), got {targets.shape}")
    K = int(targets.shape[0])
    cameras = list(cameras)
    if len(cameras) != K:
        raise ValueError(
            f"{K} target views but {len(cameras)} cameras")
    if pool < 1 or size % pool != 0:
        raise ValueError(f"pool {pool} must divide the size {size}")
    _check_views_divide(len(devs), K)
    n_ent = len(devs)
    per = K // n_ent
    view_dev = [devs[v // per] for v in range(K)]
    ss, prep, _image, image_loss = _image_model(scene, size, pool, dev)
    losses_on = _per_device(lambda d: (
        image_loss if d == dev else _image_model(scene, size, pool, d)[3]))
    targets_pooled = [prep(torch.as_tensor(targets[v], device=dev)).to(
        view_dev[v]) for v in range(K)]

    cfg = scene.config
    static, params0 = flatten_scene(scene)
    params = params_to_torch(params0, dev)
    inv_vps = inv_view_projection_batch(
        np.asarray([c.camera for c in cameras], np.float32),
        np.asarray([c.target for c in cameras], np.float32),
        np.asarray([c.up for c in cameras], np.float32),
        np.asarray([c.fov for c in cameras], np.float32))
    dirs = [ray_grid_xla(size * ss, _f32(m, view_dev[v]))
            for v, m in enumerate(inv_vps)]
    cam_pos = [_f32(c.camera, view_dev[v]) for v, c in enumerate(cameras)]
    trip_bound = _trip_bound([scene], max_steps, fit_fields)
    steps_on = _per_device(lambda d: (_f32(cfg.ray_step, d),
                                      _f32(cfg.min_ray_step, d)))

    _check_march_fields(march, fit_fields)
    if march == "frozen":
        # per-view frozen noise: each view has its own rays and origin
        check_frozen, precompute, frozen_fn = _frozen_march()
        check_frozen(static, fit_fields)
        captures = (tuple(precompute(
            static, _to(params, view_dev[v]), dirs[v], cam_pos[v],
            *steps_on(view_dev[v]), trip_bound) for v in range(K)),)

        def march_view(p, v, fz):
            return frozen_fn(static, p, dirs[v], cam_pos[v],
                             *steps_on(view_dev[v]), trip_bound, fz)
    else:
        _march = _march_fn(march)
        captures = ()

        def march_view(p, v, fz):
            return _march(static, p, dirs[v], cam_pos[v],
                          *steps_on(view_dev[v]), trip_bound)

    def view_losses(p, cap, vs):
        return torch.stack([
            losses_on(view_dev[v])(
                march_view(_to(p, view_dev[v]), v, cap[0][v] if cap else None),
                targets_pooled[v])
            for v in vs])

    def loss_fn(p, *cap):
        # an entry's part is its views' mean MSE times their share, per / K
        # (times 1.0, exactly the mean, on one entry)
        for i in range(n_ent):
            yield torch.mean(view_losses(
                p, cap, range(i * per, (i + 1) * per))) * (per / K)

    mask = _fit_mask(params, fit_fields)
    params = _project_bounds(params, fit_fields)
    best_params, losses = _optimize(
        loss_fn, params, mask, steps=steps, lr=lr, optimizer=optimizer,
        on_step=on_step,
        project_fn=lambda p: _project_bounds(p, fit_fields),
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        fingerprint=_fit_fingerprint(
            "mview", fit_fields, lr, march, size, params, targets,
            extra=(f"pool{pool}|lod{cfg.noise_octaves}|K{K}"
                   + (f"|ss{ss}" if ss > 1 else "")),
            aux=(tuple((c.camera, c.target, c.up, c.fov) for c in cameras),
                 cfg.ray_step, cfg.min_ray_step, cfg.exposure, cfg.gamma,
                 cfg.saturation, trip_bound)),
        captures=captures,
    )
    fitted = tree_map(_to_numpy, best_params)
    return FitResult(scene=apply_fit_to_scene(scene, fitted, fit_fields),
                     params=fitted, losses=losses,
                     fit_fields=tuple(fit_fields))


POSE_FITTABLE = ("camera", "target", "fov")


def _check_pose_fields(fit_fields) -> set:
    wanted = set(fit_fields)
    unknown = wanted - set(POSE_FITTABLE)
    if unknown:
        raise ValueError(
            f"unknown pose fields {sorted(unknown)}; "
            f"fittable: {POSE_FITTABLE}")
    return wanted


def _posed(scene, pose) -> Scene:
    """A deep copy of ``scene`` with the camera, target and fov of the pose
    dict ``pose`` (the up vector is kept)."""
    new_scene = copy.deepcopy(scene)
    new_scene.camera.camera = tuple(float(v) for v in pose["camera"])
    new_scene.camera.target = tuple(float(v) for v in pose["target"])
    new_scene.camera.fov = float(pose["fov"])
    return new_scene


def fit_pose(
    scene: Scene,
    target_image,
    fit_fields: Sequence[str] = ("camera", "target"),
    *,
    steps: int = 100,
    lr: float = 2e-2,
    max_steps: Optional[int] = None,
    optimizer=None,
    on_step: Optional[Callable[[int, float], None]] = None,
    normalize: bool = True,
    pool: int = 1,
    march: str = "tensor",
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """Refine the camera pose toward the one that produced ``target_image``,
    on ``device``, holding the galaxy fixed.

    The whole camera chain is differentiable
    (``ops.camera.inv_view_projection_tensor`` and ``ray_grid_xla``), so
    gradients flow target pixels -> post -> march -> ray grid -> view
    matrix -> camera / target / fov; the 4x4 chain runs on the host on
    every device, so a pose fit's loss at a pose is fit_scene's bit for
    bit. The up vector stays fixed. Returns a
    FitResult whose scene carries the fitted camera; ``params`` is the
    fitted pose dict. ``march`` is 'tensor' or 'scan': a pose moves every
    noise input, so 'frozen' is rejected.

    Local refinement, with two cautions: full-octave noise decorrelates
    under millimetre camera moves, so fit at a noise LOD
    (``scene.config.noise_octaves`` of 2-4; fit_pose_multiscale and
    fit_pose_fd need none); and fov and camera distance trade against each
    other (dolly zoom), so fit ("camera",) alone when fov is known.
    ``normalize`` (default on) compares mean-normalized images, so a
    brightness offset between an LOD render and a full-quality target does
    not pull the pose; ``pool`` box-averages both images first.
    Checkpoints resume bit for bit.

    ``mesh`` (a 1-D ``parallel.Mesh``; ``device`` is then not consulted)
    shards the pixel rows: entry i builds the rays of pooled output rows
    i * R + [0, R), R = (size // pool) / n, from a copy of the pose's
    camera matrix and marches them on its device, so the pose gradient
    crosses the copies. The entries' images are gathered on the first
    device and the loss runs there (``normalize`` divides by the whole
    frame's mean, so no entry's share is known before every slab is
    marched); the loss's gradient in each entry's image is then carried
    back through that entry's graph alone, one entry after another, and
    the pose gradients are summed on the first device in entry order.
    The pooled frame rows must divide the mesh.
    """
    wanted = _check_pose_fields(fit_fields)
    devs = None
    if mesh is not None:
        devs = _mesh_devices(mesh)
        dev = devs[0]
    else:
        dev = _device(device)
    target = np.asarray(target_image, np.float32) / 255.0
    size = target.shape[0]
    if target.shape != (size, size, 3) or size != scene.config.size:
        raise ValueError(
            f"target must be ({scene.config.size}, {scene.config.size}, 3), "
            f"got {target.shape}")
    if pool < 1 or size % pool != 0:
        raise ValueError(f"pool {pool} must divide the size {size}")
    if devs is not None:
        _check_mesh_divides(len(devs), size, pool, "fit_pose")
    ss, prep, _image, image_loss = _image_model(scene, size, pool, dev,
                                                normalize)
    target_prepped = prep(torch.as_tensor(target, device=dev))

    cfg = scene.config
    static, gal_params = flatten_scene(scene)
    gal = params_to_torch(gal_params, dev)
    host = torch.device("cpu")
    up = _f32(scene.camera.up, host)
    pose = {"camera": _f32(scene.camera.camera, dev),
            "target": _f32(scene.camera.target, dev),
            "fov": _f32(scene.camera.fov, dev)}
    trip_bound = (max_steps if max_steps is not None
                  else step_bound_for_scene(scene))
    rs, ms = _f32(cfg.ray_step, dev), _f32(cfg.min_ray_step, dev)
    march_fn = _march_fn(march)

    def inv_vp_on(p, d):
        # the 4x4 chain runs on the host, as fit_scene's host matrix does,
        # so a pose fit sees the same bits on the card as fit_scene; the
        # gradient crosses the copies
        return inv_view_projection_tensor(
            p["camera"].to(host), p["target"].to(host), up,
            p["fov"].to(host)).to(d)

    def loss_fn(p):
        if devs is None:
            dirs = ray_grid_xla(size * ss, inv_vp_on(p, dev))
            return image_loss(march_fn(static, gal, dirs, p["camera"], rs,
                                       ms, trip_bound), target_prepped)
        return mesh_parts(p)

    # each device's image end, galaxy and step sizes
    entry = _per_device(lambda d: (
        _image_model(scene, size, pool, d, normalize)[2], _to(gal, d),
        _f32(cfg.ray_step, d), _f32(cfg.min_ray_step, d)))

    def mesh_parts(p):
        """The loss on the mesh as one part per entry. Every entry builds
        its own chain and slab of rays from the pose (a row slab of the
        grid is the same rows of the whole grid) and marches it on its
        device; the loss runs on the gathered frame (``normalize`` reads
        its mean), and its gradient in entry i's image, carried back
        through entry i's own graph, is entry i's part: sum(img_i * g_i)
        has the gradient of that share and adds 0 to the value (the first
        part carries the loss's value)."""
        rows = size // len(devs)  # output rows an entry
        imgs = []
        for i, d in enumerate(devs):
            dirs = ray_grid_xla(size * ss, inv_vp_on(p, d), i * rows * ss,
                                rows * ss)
            image_d, gal_d, rs_d, ms_d = entry(d)
            imgs.append(image_d(march_fn(static, gal_d, dirs,
                                         p["camera"].to(d), rs_d, ms_d,
                                         trip_bound)))
        gathered = [img.detach().to(dev).requires_grad_() for img in imgs]
        loss = torch.mean((prep(torch.cat(gathered)) - target_prepped) ** 2)
        value = loss.detach()
        if not torch.is_grad_enabled():
            yield value
            return
        shares = torch.autograd.grad(loss, gathered)
        for i, img in enumerate(imgs):
            s = torch.sum(img * shares[i].to(img.device))
            base = value.to(img.device) if i == 0 else torch.zeros_like(s)
            yield base + (s - s.detach())

    mask = {k: 1.0 if k in wanted else 0.0 for k in pose}

    def project(p):
        # constrain only fitted fields: clipping an unfitted fov would move
        # a parameter the caller asked to hold
        if "fov" in wanted:
            p = dict(p, fov=torch.clamp(p["fov"], 5.0, 170.0))
        return p

    best_pose, losses = _optimize(
        loss_fn, pose, mask, steps=steps, lr=lr, optimizer=optimizer,
        on_step=on_step, project_fn=project,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        fingerprint=_fit_fingerprint(
            "pose", fit_fields, lr, march, size,
            # the held galaxy IS the pose loss surface: a checkpoint of
            # another .gax must not resume
            {"pose": pose, "galaxy": gal_params}, target,
            extra=(f"pool{pool}|lod{cfg.noise_octaves}"
                   f"|norm{int(normalize)}"
                   + (f"|ss{ss}" if ss > 1 else "")),
            aux=(scene.camera.up, cfg.ray_step, cfg.min_ray_step,
                 cfg.exposure, cfg.gamma, cfg.saturation, trip_bound)),
    )
    fitted = tree_map(_to_numpy, best_pose)
    return FitResult(scene=_posed(scene, fitted), params=fitted,
                     losses=losses, fit_fields=tuple(fit_fields))


def fit_pose_fd(
    scene: Scene,
    target_image,
    fit_fields: Sequence[str] = ("camera",),
    *,
    steps: int = 60,
    lr: float = 1e-2,
    eps: float = 1.0,
    on_step: Optional[Callable[[int, float], None]] = None,
    normalize: bool = True,
    pool: int = 1,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """Pose refinement by central differences through the march kernel, on
    ``device`` (or with its probe frames spread over ``mesh``).

    Every fitted pose scalar is probed at +-eps where eps is ONE PIXEL of
    image motion (``eps`` scales it): far above the noise correlation
    length, so the difference reads the slope of the structure's alignment
    rather than the noise, at full octaves and with no differentiable
    march. The current pose and its 2K probes render as one
    ``render_batch_linear`` call (one K4 launch on the card: 7 frames for
    the camera alone); their losses are computed on the device and only
    the 2K+1 numbers come back. Host Adam (float32 moments, float64 pose
    scalars) steps with relative steps max(|θ0|, 0.1). Checkpoints resume
    bit for bit (the moments are in the file).
    """
    from .batch import render_batch_linear

    wanted = _check_pose_fields(fit_fields)
    dev = _device(device) if mesh is None else None
    target = np.asarray(target_image, np.float32) / 255.0
    size = target.shape[0]
    if target.shape != (size, size, 3) or size != scene.config.size:
        raise ValueError(
            f"target must be ({scene.config.size}, {scene.config.size}, 3), "
            f"got {target.shape}")
    if pool < 1 or size % pool != 0:
        raise ValueError(f"pool {pool} must divide the size {size}")

    cfg = scene.config
    # all persisted state is float32, which the checkpoint round-trips
    # exactly, so a resumed run replays the uninterrupted one bit for bit
    pose = {
        "camera": np.asarray(scene.camera.camera, np.float32),
        "target": np.asarray(scene.camera.target, np.float32),
        "fov": np.asarray(float(scene.camera.fov), np.float32),
    }
    # a fixed probe order: the fingerprint and the gradient layout key on it
    dims = [(f_, i) for f_, n in (("camera", 3), ("target", 3), ("fov", 1))
            if f_ in wanted for i in range(n)]
    K = len(dims)

    # eps = one pixel of image motion: a transverse move of
    # dist * (2 tan(fov/2) / size) for positions, 2 * (2 tan(fov/2) / size)
    # of field angle for fov (one pixel of edge zoom)
    dist = float(np.linalg.norm(pose["camera"] - pose["target"]))
    px_angle = 2.0 * math.tan(math.radians(float(pose["fov"])) / 2.0) / size
    eps_pos = float(eps) * max(dist, 1e-3) * px_angle
    eps_fov = float(eps) * math.degrees(2.0 * px_angle)

    def _eps(field_name: str) -> float:
        return eps_fov if field_name == "fov" else eps_pos

    losses_of = _batch_losses(cfg, target, pool, normalize)

    def probe_scenes(p):
        cams = [p]
        for field_name, i in dims:
            for sgn in (1.0, -1.0):
                q = {k: v.copy() for k, v in p.items()}
                if field_name == "fov":
                    q["fov"] = q["fov"] + sgn * eps_fov
                else:
                    q[field_name][i] += sgn * eps_pos
                cams.append(q)
        return [dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera,
            camera=tuple(float(v) for v in q["camera"]),
            target=tuple(float(v) for v in q["target"]),
            fov=float(q["fov"]))) for q in cams]

    def render(p):
        return losses_of(render_batch_linear(probe_scenes(p), device=dev,
                                             mesh=mesh))

    def project(p):
        if "fov" in wanted:
            p["fov"] = np.asarray(np.clip(p["fov"], 5.0, 170.0), np.float32)
        return p

    def _theta(p):
        return np.array([float(p[f_]) if f_ == "fov" else p[f_][i]
                         for f_, i in dims], np.float64)

    # host Adam with relative steps (pose scalars span ~0.01..90)
    rel = np.maximum(np.abs(_theta(pose)), 0.1)
    m = np.zeros(K, np.float32)
    v = np.zeros(K, np.float32)
    t = 0

    _, gal_params = flatten_scene(scene)
    fingerprint = _fit_fingerprint(
        "posefd", fit_fields, lr, "fd", size,
        {"pose": pose, "galaxy": gal_params}, target,
        extra=(f"pool{pool}|norm{int(normalize)}"
               f"|eps{eps_pos:g},{eps_fov:g}|ss{cfg.supersample}"),
        aux=(scene.camera.up, cfg.ray_step, cfg.min_ray_step,
             cfg.exposure, cfg.gamma, cfg.saturation))

    losses: List[float] = []
    best_loss = np.inf
    best_pose = {k: np.asarray(v_).copy() for k, v_ in pose.items()}
    start = 0
    if checkpoint_path:
        resumed = _ckpt_load(checkpoint_path, fingerprint, pose,
                             {"m": m, "t": np.int64(t), "v": v}, best_pose)
        if resumed is not None:
            start, pose_j, opt_j, losses, bl, best_j = resumed
            pose = {k: np.array(v_, np.float32) for k, v_ in pose_j.items()}
            m = np.array(opt_j["m"], np.float32)
            v = np.array(opt_j["v"], np.float32)
            t = int(opt_j["t"])
            best_loss = float(bl)
            best_pose = {k: np.array(v_, np.float32)
                         for k, v_ in best_j.items()}
            if start > steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path} already holds {start} "
                    f"steps but only {steps} were requested — increase "
                    f"steps to extend the run, or delete the checkpoint "
                    f"to start over")

    aborted = False
    for i in range(start, steps):
        L = render(pose)
        losses.append(float(L[0]))
        if L[0] < best_loss:
            best_loss = float(L[0])
            best_pose = {k: v_.copy() for k, v_ in pose.items()}
        g = np.array([(L[1 + 2 * k] - L[2 + 2 * k]) / (2.0 * _eps(dims[k][0]))
                      for k in range(K)])
        g = np.nan_to_num(g)
        upd, m, v, t = _host_adam(g, m, v, t, lr)
        theta = _theta(pose) - upd * rel
        for k, (f_, ax) in enumerate(dims):
            if f_ == "fov":
                pose["fov"] = np.asarray(theta[k], np.float32)
            else:
                pose[f_][ax] = np.float32(theta[k])
        pose = project(pose)
        if checkpoint_path and ((i + 1) % max(1, checkpoint_every) == 0
                                or i + 1 == steps):
            _ckpt_save(checkpoint_path, fingerprint, i + 1, pose,
                       {"m": m, "t": np.int64(t), "v": v}, losses,
                       best_loss, best_pose)
        if on_step is not None and on_step(i, losses[-1]) is False:
            aborted = True
            break
    if not aborted:
        # the last iterate's loss, from a batch of the same shape
        L = render(pose)
        losses.append(float(L[0]))
        if L[0] < best_loss:
            best_pose = {k: v_.copy() for k, v_ in pose.items()}

    fitted = {k: np.asarray(v_, np.float32) for k, v_ in best_pose.items()}
    return FitResult(scene=_posed(scene, fitted), params=fitted,
                     losses=losses, fit_fields=tuple(fit_fields))


# vector-valued fittable leaves and their lengths (every other is a scalar)
_FD_VECTOR_FIELDS = {"position": 3, "axis": 3, "arms": 4, "spec": 3}

# leaves whose nonzero-ness is compiled structure (scene_prep.CompStatic's
# arm_enabled / winding_enabled): probes and updates keep their sign
_FD_SIGN_STATIC = frozenset({"winding", "arm"})


def fit_scene_fd(
    scene: Scene,
    target_image,
    fit_fields: Sequence[str] = ("winding_b", "winding_n"),
    *,
    steps: int = 60,
    lr: float = 2e-2,
    eps: float = 0.05,
    sweep: int = 0,
    sweep_span: float = 0.5,
    sweep_rounds: int = 3,
    sweep_groups: Optional[Sequence[Sequence[str]]] = None,
    on_step: Optional[Callable[[int, float], None]] = None,
    normalize: bool = False,
    pool: int = 1,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """Scene-parameter fitting by central differences through the march
    kernel, on ``device`` (or spread over ``mesh``).

    Every fitted scalar (a per-component field once per component, a
    vector field once per lane) is probed at +-h with h =
    ``eps``·max(|θ|, 0.1), and the current scene and its 2K probes render
    as one ``render_batch_linear`` call (one K4 launch on the card). The
    loss of each frame is computed on the device; only the 2K+1 losses
    come back, and host Adam (float32 moments) steps θ with relative steps
    max(|θ0|, 0.1). Bounded fields (_FIT_BOUNDS) keep probes and updates
    above the bound (the difference divides by the realized probe spread);
    winding and arm keep their starting sign, and dims that start at
    exactly 0 are dropped with a warning (the structure flag is off).

    ``sweep`` > 0 runs a staged global search first: with
    ``sweep_groups``, a joint grid over groups of fields moved by one
    common relative multiplier (``sweep`` points per group, capped at 1024
    frames); then ``sweep_rounds`` zooming per-dim sweeps of ``sweep``
    points over +-``sweep_span``, a move accepted only if it beats the
    current point. ``normalize`` divides each image by its mean before the
    loss; ``pool`` box-averages both images.
    """
    from .batch import render_batch_linear

    wanted = set(fit_fields)
    unknown = wanted - set(FITTABLE_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown fit fields {sorted(unknown)}; fittable: {FITTABLE_FIELDS}")
    dev = _device(device) if mesh is None else None

    target = np.asarray(target_image, np.float32) / 255.0
    size = target.shape[0]
    if target.shape != (size, size, 3) or size != scene.config.size:
        raise ValueError(
            f"target must be ({scene.config.size}, {scene.config.size}, 3), "
            f"got {target.shape}")
    if pool < 1 or size % pool != 0:
        raise ValueError(f"pool {pool} must divide the size {size}")

    cfg = scene.config
    _, params0 = flatten_scene(scene)
    params0 = tree_map(lambda a: np.array(a, np.float64), params0)

    # probe dimensions, in a fixed order (checkpoints and the gradient
    # layout key on it): (instance, field, component | None, lane | None)
    dims: List[tuple] = []
    dropped = []
    for k, pr in enumerate(params0):
        for fld in INSTANCE_FITTABLE:
            if fld not in wanted:
                continue
            n = _FD_VECTOR_FIELDS.get(fld)
            dims += ([(k, fld, None, i) for i in range(n)] if n
                     else [(k, fld, None, None)])
        for j, cp in enumerate(pr["comps"]):
            for fld in COMP_FITTABLE:
                if fld not in wanted:
                    continue
                if fld in _FD_SIGN_STATIC and float(cp[fld]) == 0.0:
                    dropped.append((k, j, fld))
                    continue
                n = _FD_VECTOR_FIELDS.get(fld)
                dims += ([(k, fld, j, i) for i in range(n)] if n
                         else [(k, fld, j, None)])
    if dropped:
        warnings.warn(
            f"fit_scene_fd: dropping zero-valued structure-flag dims "
            f"{dropped} — winding/arm nonzero-ness is compiled structure "
            f"and the render is insensitive to a disabled flag's value",
            RuntimeWarning, stacklevel=2)
    K = len(dims)
    if K == 0:
        raise ValueError("no probe dimensions: fit_fields matched nothing")

    def _get(params, dim) -> float:
        k, fld, j, i = dim
        node = params[k]["comps"][j][fld] if j is not None else params[k][fld]
        return float(node if i is None else node[i])

    def _set(params, dim, val: float) -> None:
        k, fld, j, i = dim
        tgt = params[k]["comps"][j] if j is not None else params[k]
        if i is None:
            tgt[fld] = np.float64(val)
        else:
            tgt[fld][i] = val

    def _theta(params):
        return np.array([_get(params, d) for d in dims], np.float64)

    def _clamp(dim, val: float) -> float:
        fld = dim[1]
        lo = _FIT_BOUNDS.get(fld)
        if lo is not None:
            val = max(val, lo)
        if fld in _FD_SIGN_STATIC:
            s = np.sign(_get(params0, dim)) or 1.0
            val = s * max(s * val, 1e-4)  # stay on the starting sign
        return val

    theta = _theta(params0)

    def params_of(th):
        p = tree_map(np.array, params0)
        for d, v in zip(dims, th):
            _set(p, d, v)
        return p

    losses_of = _batch_losses(cfg, target, pool, normalize)

    def render(scenes):
        return losses_of(render_batch_linear(scenes, device=dev, mesh=mesh))

    def _h(th):
        return float(eps) * np.maximum(np.abs(th), 0.1)

    def probe_scenes(th):
        """[current, then +h / -h per dim] as Scenes of one structure."""
        h = _h(th)
        out = [apply_fit_to_scene(scene, params_of(th), fit_fields)]
        spreads = np.empty(K, np.float64)
        for kd, d in enumerate(dims):
            vp = _clamp(d, th[kd] + h[kd])
            vm = _clamp(d, th[kd] - h[kd])
            spreads[kd] = vp - vm
            for v in (vp, vm):
                tq = th.copy()
                tq[kd] = v
                out.append(apply_fit_to_scene(scene, params_of(tq),
                                              fit_fields))
        return out, spreads

    # host Adam with relative steps
    rel = np.maximum(np.abs(theta), 0.1)
    m = np.zeros(K, np.float32)
    v = np.zeros(K, np.float32)
    t = 0

    fingerprint = _fit_fingerprint(
        "scenefd", fit_fields, lr, "fd", size, params0, target,
        extra=(f"pool{pool}|norm{int(normalize)}|eps{eps:g}"
               f"|sw{sweep}x{sweep_span:g}r{sweep_rounds}"
               f"g{'/'.join(','.join(sorted(g)) for g in (sweep_groups or ()))}"
               f"|ss{cfg.supersample}"),
        aux=(scene.camera.camera, scene.camera.target, scene.camera.up,
             scene.camera.fov, cfg.ray_step, cfg.min_ray_step,
             cfg.exposure, cfg.gamma, cfg.saturation))

    losses: List[float] = []
    best_loss = np.inf
    best_theta = theta.copy()
    start = 0
    if checkpoint_path:
        resumed = _ckpt_load(checkpoint_path, fingerprint, {"th": theta},
                             {"m": m, "t": np.int64(t), "v": v},
                             {"th": best_theta})
        if resumed is not None:
            start, th_j, opt_j, losses, bl, best_j = resumed
            theta = np.array(th_j["th"], np.float64)
            m = np.array(opt_j["m"], np.float32)
            v = np.array(opt_j["v"], np.float32)
            t = int(opt_j["t"])
            best_loss = float(bl)
            best_theta = np.array(best_j["th"], np.float64)
            if start > steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path} already holds {start} "
                    f"steps but only {steps} were requested — increase "
                    f"steps to extend the run, or delete the checkpoint "
                    f"to start over")

    if sweep and start == 0:
        # the staged search runs on a fresh fit only: a resumed checkpoint
        # already holds the trajectory after it (and `rel` stays anchored
        # to the starting theta, so a resume replays bit for bit)
        if sweep_groups:
            import itertools

            group_dims = []
            for grp in sweep_groups:
                gd = [kd for kd, d in enumerate(dims) if d[1] in set(grp)]
                if not gd:
                    raise ValueError(
                        f"sweep group {tuple(grp)} matches no probe dims")
                group_dims.append(gd)
            g = len(group_dims)
            pts = int(sweep)
            while pts > 2 and pts ** g > 1024:
                pts -= 1
            mults = np.linspace(1.0 - float(sweep_span),
                                1.0 + float(sweep_span), pts)
            combos = list(itertools.product(range(pts), repeat=g))
            grid_scenes = []
            for combo in combos:
                tq = theta.copy()
                for gi, mi in enumerate(combo):
                    for kd in group_dims[gi]:
                        tq[kd] = _clamp(dims[kd], theta[kd] * mults[mi])
                grid_scenes.append(apply_fit_to_scene(
                    scene, params_of(tq), fit_fields))
            L = render(grid_scenes)
            best = combos[int(np.argmin(L))]
            for gi, mi in enumerate(best):
                for kd in group_dims[gi]:
                    theta[kd] = _clamp(dims[kd], theta[kd] * mults[mi])

        span_r = float(sweep_span)
        for _round in range(int(sweep_rounds)):
            for kd, d in enumerate(dims):
                span = span_r * max(abs(theta[kd]), 0.1)
                vals = [_clamp(d, x) for x in np.linspace(
                    theta[kd] - span, theta[kd] + span, int(sweep))]
                ladder = [apply_fit_to_scene(scene, params_of(theta),
                                             fit_fields)]
                for x in vals:
                    tq = theta.copy()
                    tq[kd] = x
                    ladder.append(apply_fit_to_scene(
                        scene, params_of(tq), fit_fields))
                L = render(ladder)
                j = int(np.argmin(L[1:]))
                if L[1 + j] < L[0]:  # only ever improve on the base
                    theta[kd] = vals[j]
            # the next round resolves 2x finer than this round's spacing
            span_r = 4.0 * span_r / max(int(sweep) - 1, 1)

    aborted = False
    for i in range(start, steps):
        scenes, spreads = probe_scenes(theta)
        L = render(scenes)
        losses.append(float(L[0]))
        if L[0] < best_loss:
            best_loss = float(L[0])
            best_theta = theta.copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            g = np.where(spreads > 0, (L[1::2] - L[2::2]) / spreads, 0.0)
        g = np.nan_to_num(g)
        upd, m, v, t = _host_adam(g, m, v, t, lr)
        theta = theta - upd * rel
        theta = np.array([_clamp(d, th) for d, th in zip(dims, theta)],
                         np.float64)
        if checkpoint_path and ((i + 1) % max(1, checkpoint_every) == 0
                                or i + 1 == steps):
            _ckpt_save(checkpoint_path, fingerprint, i + 1, {"th": theta},
                       {"m": m, "t": np.int64(t), "v": v}, losses,
                       best_loss, {"th": best_theta})
        if on_step is not None and on_step(i, losses[-1]) is False:
            aborted = True
            break
    if not aborted:
        # the last iterate's loss, from a batch of the same shape
        scenes, _ = probe_scenes(theta)
        L = render(scenes)
        losses.append(float(L[0]))
        if L[0] < best_loss:
            best_theta = theta.copy()

    fitted = tree_map(lambda a: np.asarray(a, np.float32),
                      params_of(best_theta))
    return FitResult(scene=apply_fit_to_scene(scene, fitted, fit_fields),
                     params=fitted, losses=losses,
                     fit_fields=tuple(fit_fields))


# (noise LOD, loss pool) rungs of the default pose ladder: coarse noise and
# a pooled loss first (a wide, smooth basin), then sharper rungs; LOD 0 is
# the exact full-octave rung
DEFAULT_POSE_SCHEDULE = ((3, 4), (5, 2), (0, 1))


def fit_pose_multiscale(
    scene: Scene,
    target_image,
    fit_fields: Sequence[str] = ("camera",),
    *,
    steps: int = 40,
    lr: float = 1e-2,
    schedule: Sequence[Tuple[int, int]] = DEFAULT_POSE_SCHEDULE,
    max_steps: Optional[int] = None,
    optimizer=None,
    on_step: Optional[Callable[[int, float], None]] = None,
    normalize: bool = True,
    march: str = "tensor",
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """fit_pose down a ladder of (noise LOD, loss pool) rungs, in one call,
    each rung starting from the previous rung's pose: coarse, pooled rungs
    align the gross structure across large displacements, the exact rung
    (LOD 0) removes the LOD's bias. ``steps`` applies per rung, and each
    rung has its own checkpoint file (``<checkpoint_path>.rung<n>``);
    ``on_step`` sees a global step index, and an abort inside a rung stops
    the ladder. The returned scene keeps the caller's noise_octaves.
    ``mesh`` shards every rung's pixel rows (fit_pose), so each rung's
    pooled rows must divide it. CLI: ``fitpose ... multiscale``."""
    if not schedule:
        raise ValueError("schedule must have at least one (lod, pool) rung")
    size = int(scene.config.size)
    current = scene
    all_losses: List[float] = []
    result: Optional[FitResult] = None
    base = 0
    state = {"aborted": False}
    for lod, pool in schedule:
        pool = int(pool)
        while pool > 1 and size % pool:
            pool -= 1  # the pool must divide the frame
        # LOD 0 in a schedule is the exact rung: noise_octaves=None
        rung_scene = dataclasses.replace(
            current, config=dataclasses.replace(
                current.config,
                noise_octaves=int(lod) if int(lod) >= 1 else None))
        result = fit_pose(
            rung_scene, target_image, fit_fields, steps=steps, lr=lr,
            max_steps=max_steps, optimizer=optimizer,
            on_step=_block_callback(on_step, base, state),
            normalize=normalize, pool=pool, march=march, mesh=mesh,
            # a finished rung's file already holds step == steps, so a
            # restarted ladder skips it
            checkpoint_path=(f"{checkpoint_path}.rung{base // steps}"
                             if checkpoint_path else None),
            checkpoint_every=checkpoint_every, device=device)
        current = result.scene
        all_losses.extend(result.losses)
        base += steps
        if state["aborted"]:
            break
    final_scene = dataclasses.replace(
        result.scene, config=dataclasses.replace(
            result.scene.config, noise_octaves=scene.config.noise_octaves))
    return FitResult(scene=final_scene, params=result.params,
                     losses=all_losses, fit_fields=tuple(fit_fields))


def fit_joint(
    scene: Scene,
    target_image,
    scene_fields: Sequence[str] = DEFAULT_FIT_FIELDS,
    *,
    rounds: int = 2,
    pose_steps: int = 30,
    scene_steps: int = 60,
    pose_lr: float = 1e-2,
    scene_lr: float = 2e-2,
    pose_schedule: Sequence[Tuple[int, int]] = DEFAULT_POSE_SCHEDULE,
    pose_method: str = "multiscale",
    march: str = "frozen",
    optimizer=None,
    on_step: Optional[Callable[[int, float], None]] = None,
    normalize: bool = True,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> FitResult:
    """An unknown camera AND unknown galaxy parameters, in one call, on
    ``device``: block-coordinate descent. Each round runs (a) a pose block
    holding the galaxy, fit_pose_multiscale over ``pose_schedule``
    (``pose_method='multiscale'``) or one fit_pose_fd run through the
    march kernel (``'fd'``), with ``normalize`` making it blind to the
    not-yet-fitted brightness; then (b) fit_scene at the fitted pose,
    holding it (``march='frozen'`` is valid inside the block, whose camera
    is fixed; the fields are frozen anew each round). A truly joint
    gradient step is ill-conditioned: pose gradients need a noise LOD,
    brightness gradients are biased at one.

    ``on_step(i, loss)`` sees a global index over rounds * (pose block +
    scene_steps) steps and may return False to stop every later block.
    ``checkpoint_path`` writes per-block files (``.r<k>.pose``,
    ``.r<k>.scene``); a finished block is skipped on restart. Returns a
    FitResult whose scene carries both fits and whose ``params`` is
    {"pose": pose dict, "scene": params}. ``mesh`` goes to both blocks:
    fit_pose_fd spreads its probe frames over it, fit_pose_multiscale and
    fit_scene shard their pixel rows over it."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if pose_method not in ("multiscale", "fd"):
        raise ValueError(
            f"unknown pose_method {pose_method!r}; use 'multiscale' or 'fd'")
    _check_march_fields(march if march != "frozen" else "tensor",
                        scene_fields)  # frozen is checked per block
    if mesh is not None:
        # the parameter block's rows, checked before any pose block runs
        _check_mesh_divides(len(_mesh_devices(mesh)), scene.config.size, 1,
                            "fit_scene")
    pose_block = (pose_steps * len(pose_schedule)
                  if pose_method == "multiscale" else pose_steps)
    current = scene
    all_losses: List[float] = []
    pose_params = None
    scene_params = None
    base = 0
    state = {"aborted": False}
    for r in range(rounds):
        pose_ckpt = f"{checkpoint_path}.r{r}.pose" if checkpoint_path else None
        if pose_method == "fd":
            pres = fit_pose_fd(
                current, target_image, ("camera",), steps=pose_steps,
                lr=pose_lr, on_step=_block_callback(on_step, base, state),
                normalize=normalize, mesh=mesh, checkpoint_path=pose_ckpt,
                checkpoint_every=checkpoint_every, device=device)
        else:
            pres = fit_pose_multiscale(
                current, target_image, ("camera",), steps=pose_steps,
                lr=pose_lr, schedule=pose_schedule, optimizer=optimizer,
                on_step=_block_callback(on_step, base, state),
                normalize=normalize, march="tensor", mesh=mesh,
                checkpoint_path=pose_ckpt,
                checkpoint_every=checkpoint_every, device=device)
        current = pres.scene
        pose_params = pres.params
        all_losses.extend(pres.losses)
        base += pose_block
        if state["aborted"]:
            break
        sres = fit_scene(
            current, target_image, scene_fields, steps=scene_steps,
            lr=scene_lr, optimizer=optimizer,
            on_step=_block_callback(on_step, base, state), march=march,
            mesh=mesh,
            checkpoint_path=(f"{checkpoint_path}.r{r}.scene"
                             if checkpoint_path else None),
            checkpoint_every=checkpoint_every, device=device)
        current = sres.scene
        scene_params = sres.params
        all_losses.extend(sres.losses)
        base += scene_steps
        if state["aborted"]:
            break
    return FitResult(
        scene=current,
        params={"pose": pose_params, "scene": scene_params},
        losses=all_losses,
        fit_fields=("camera",) + tuple(scene_fields),
    )


@dataclass
class JointMultiviewResult:
    """Outcome of fit_joint_multiview: the fitted scene and the per-view
    cameras."""

    scene: Scene                # fitted galaxy (the scene's own camera)
    cameras: List               # fitted per-view CameraParams
    params: object              # {"poses": [...], "scene": params}
    losses: List[float] = field(default_factory=list)
    fit_fields: Tuple[str, ...] = ()


def fit_joint_multiview(
    scene: Scene,
    targets,
    cameras: Sequence,
    scene_fields: Sequence[str] = DEFAULT_FIT_FIELDS,
    *,
    rounds: int = 2,
    pose_steps: int = 30,
    scene_steps: int = 60,
    pose_lr: float = 1e-2,
    scene_lr: float = 2e-2,
    march: str = "frozen",
    on_step: Optional[Callable[[int, float], None]] = None,
    normalize: bool = True,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device="cuda",
) -> JointMultiviewResult:
    """K views with unknown per-view cameras AND shared unknown galaxy
    parameters, in one call, on ``device``. Each round refines every
    view's camera by one fit_pose_fd run against its own target (K4 probe
    launches, galaxy held), then fits the galaxy by one
    fit_scene_multiview block at the K refined poses (``march='frozen'``
    is valid there; the fields are frozen anew each round). ``cameras``
    are the K starting guesses, each within fit_pose_fd's secant basin
    (tens of pixels of image motion); ``targets`` is (K, size, size, 3).
    ``on_step`` sees a global index over rounds * (K * pose_steps +
    scene_steps); ``checkpoint_path`` writes per-block files
    (``.r<k>.pose<v>``, ``.r<k>.scene``), a finished block skipped on
    restart. ``mesh`` shards the view axis of the parameter blocks
    (fit_scene_multiview); the pose blocks run on its first device."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    targets = np.asarray(targets)
    K = len(list(cameras))
    if targets.shape[0] != K:
        raise ValueError(
            f"{targets.shape[0]} targets for {K} cameras")
    pose_device = device
    if mesh is not None:
        # the parameter blocks' views, checked before any pose block runs
        devs = _mesh_devices(mesh)
        _check_views_divide(len(devs), K)
        pose_device = devs[0]
    cams = list(cameras)
    current = scene
    all_losses: List[float] = []
    scene_params = None
    base = 0
    state = {"aborted": False}
    for r in range(rounds):
        for v in range(K):
            pres = fit_pose_fd(
                dataclasses.replace(current, camera=cams[v]), targets[v],
                ("camera",), steps=pose_steps, lr=pose_lr,
                on_step=_block_callback(on_step, base, state),
                normalize=normalize,
                checkpoint_path=(f"{checkpoint_path}.r{r}.pose{v}"
                                 if checkpoint_path else None),
                checkpoint_every=checkpoint_every, device=pose_device)
            cams[v] = pres.scene.camera
            all_losses.extend(pres.losses)
            base += pose_steps
            if state["aborted"]:
                break
        if state["aborted"]:
            break
        sres = fit_scene_multiview(
            current, targets, cams, scene_fields, steps=scene_steps,
            lr=scene_lr, on_step=_block_callback(on_step, base, state),
            march=march, mesh=mesh,
            checkpoint_path=(f"{checkpoint_path}.r{r}.scene"
                             if checkpoint_path else None),
            checkpoint_every=checkpoint_every, device=device)
        current = sres.scene
        scene_params = sres.params
        all_losses.extend(sres.losses)
        base += scene_steps
        if state["aborted"]:
            break
    return JointMultiviewResult(
        scene=current, cameras=cams,
        params={"poses": [{"camera": c.camera, "target": c.target,
                           "fov": c.fov} for c in cams],
                "scene": scene_params},
        losses=all_losses,
        fit_fields=("camera",) + tuple(scene_fields),
    )


def apply_fit_to_scene(scene: Scene, params, fit_fields: Sequence[str]) -> Scene:
    """Write fitted params back into a deep copy of ``scene``: the inverse
    of flatten_scene's traversal (instances far to near from the camera,
    components through the same active/known/deterministic filter). A
    fitted ``spec`` becomes a new named spectrum ``fit:<instance>:<comp>``
    in the scene's spectra table."""
    new_scene = copy.deepcopy(scene)
    # instances sharing one GalaxyData must not get each other's values
    for gi in new_scene.instances:
        gi.galaxy = copy.deepcopy(gi.galaxy)

    wanted = set(fit_fields)
    cam32 = np.asarray(scene.camera.camera, np.float32)
    order = sorted(
        range(len(new_scene.instances)),
        key=lambda i: -float(_length32(
            (np.asarray(new_scene.instances[i].position, np.float32) - cam32
             ).astype(np.float32))))
    if "spec" in wanted and new_scene.spectra is None:
        new_scene.spectra = dict(BUILTIN_SPECTRA)

    for k, inst_idx in enumerate(order):
        pr = params[k]
        gi = new_scene.instances[inst_idx]
        gp = gi.galaxy.params
        if "intensity_scale" in wanted:
            gi.intensity_scale = float(pr["intensity_scale"])
        if "position" in wanted:
            gi.position = tuple(float(x) for x in pr["position"])
        if "axis" in wanted:
            gp.axis = tuple(float(x) for x in pr["axis"])
        if "winding_b" in wanted:
            gp.winding_b = float(pr["winding_b"])
        if "winding_n" in wanted:
            gp.winding_n = float(pr["winding_n"])
        if "arms" in wanted:
            gp.arm1, gp.arm2, gp.arm3, gp.arm4 = (float(x) for x in pr["arms"])

        fitted_comps = [
            cp for cp in gi.galaxy.components
            if cp.active == 1 and cp.cid >= 0
            and not (cp.cid == 6 and scene.config.deterministic)
        ]
        if len(fitted_comps) != len(pr["comps"]):
            raise ValueError(
                "scene structure changed between flatten and write-back")
        for j, (cp, cpp) in enumerate(zip(fitted_comps, pr["comps"])):
            for fname in COMP_FIELDS:
                if fname in wanted:
                    setattr(cp, fname, float(cpp[fname]))
            if "spec" in wanted:
                name = f"fit:{inst_idx}:{j}"
                new_scene.spectra[name] = tuple(float(x) for x in cpp["spec"])
                cp.spectrum = name
    return new_scene
