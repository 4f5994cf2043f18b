"""Galaxy fitting (inverse rendering): the scene-parameter fits of
``gamer_tpu.engine.fit`` in torch.

Given a target image and a starting scene, the fits move selected galaxy
parameters until the scene's render matches the target.

- ``fit_scene`` runs Adam on gradients taken through a differentiable
  march (``march=``): "tensor" (engine/tensor_march.py, the default),
  "frozen" (the tensor march with the raw noise fields evaluated once per
  fit; valid while the fitted fields do not feed the noise,
  ``check_frozen_fields``), or "scan" (engine/diff.py, bit-equal in value
  to the XLA march; its gradients follow the sequential linearization,
  which the winding fields need).
- ``fit_scene_multiscale`` runs fit_scene down a resolution pyramid.
- ``fit_scene_fd`` takes central differences instead: each step renders
  the current scene and a +h / -h probe per fitted scalar as one batch
  (``engine.batch.render_batch_linear``: one launch of the march kernel on
  the card) and steps Adam on the host. It is the path for the chaotic
  structure fields (winding_b, scale, ks) whose autograd gradients read
  noise.

The scene structure stays fixed during a fit; only numeric leaves move.
Which leaves move is chosen by field name over flatten_scene's params
(``fit_fields``); gradients are made finite and masked, and the fields
with hard domain limits are projected after every step.
``apply_fit_to_scene`` writes fitted leaves back into a copy of the Scene.
Every fit takes ``device=`` (the card unless the caller asks for the CPU)
and checkpoints that a rerun resumes bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.camera import inv_view_projection, ray_grid_xla
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
        return linear.reshape(size, ss, size, ss, 3).mean(dim=(1, 3))

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
              fingerprint="", captures=()):
    """The masked Adam loop of fit_scene.

    - Gradients are made finite (nan_to_num) and masked to the fitted
      leaves; only those leaves record gradients.
    - With the default optimizer each leaf's update is scaled by its
      starting magnitude max(|leaf|, 0.1) (relative steps: galaxy knobs
      span four orders of magnitude).
    - ``project_fn(params)`` applies the domain limits after each step.
    - ``on_step(i, loss)`` returning False stops after the current step.
    - ``checkpoint_path`` saves (params, optimizer state, losses) every
      ``checkpoint_every`` steps and at the last one, and resumes from it.
    - ``captures`` are large tensors the loss reads (the frozen noise
      fields), passed as ``loss_fn(p, *captures)``, detached.
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

    def step_fn(p, s):
        live = [leaf.detach().requires_grad_(m != 0.0)
                for leaf, m in zip(tree_leaves(p), masks)]
        loss = loss_fn(tree_unflatten_like(p, live), *caps)
        wrt = [leaf for leaf in live if leaf.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True)
                   if wrt else ())
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
        return new_p, s, float(loss.detach())

    losses: List[float] = []
    best_params = params
    best_loss = np.inf
    start = 0
    if checkpoint_path:
        resumed = _ckpt_load(checkpoint_path, fingerprint, params, opt_state,
                             best_params)
        if resumed is not None:
            start, params, opt_state, losses, bl, best_params = resumed
            best_loss = float(bl)
            if start > steps:
                raise ValueError(
                    f"checkpoint {checkpoint_path} already holds {start} "
                    f"steps but only {steps} were requested — increase "
                    f"steps to extend the run, or delete the checkpoint "
                    f"to start over")
    for i in range(start, steps):
        new_params, opt_state, loss = step_fn(params, opt_state)
        losses.append(loss)
        if loss < best_loss:
            best_loss, best_params = loss, params
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
        final = float(loss_fn(params, *caps))
    losses.append(final)
    if final < best_loss:
        best_params = params
    return best_params, losses


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
            "march='frozen' takes fixed cameras and a per-call noise "
            "precompute (fit_scene, fit_scene_multiscale)")
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
    checkpoint of a different setup is rejected. ``mesh`` (pixel-row data
    parallelism) is not ported yet and raises.

    Returns a FitResult whose scene is a deep copy with the fitted values
    written back.
    """
    if mesh is not None:
        raise NotImplementedError(
            "fit_scene(mesh=...) is not ported: pixel-row data parallelism "
            "of the fits is queued in ROADMAP.md §1")
    dev = _device(device)
    target = np.asarray(target_image, np.float32) / 255.0
    size = target.shape[0]
    if target.shape != (size, size, 3):
        raise ValueError(f"target must be (N, N, 3), got {target.shape}")
    if size != scene.config.size:
        raise ValueError(
            f"target size {size} != scene.config.size {scene.config.size}")
    if pool < 1 or size % pool != 0:
        raise ValueError(f"pool {pool} must divide the size {size}")
    ss, _linear_pooled = _ss_setup(scene, size)

    def _pooled(img):
        if pool > 1:
            o = size // pool
            img = img.reshape(o, pool, o, pool, 3).mean(dim=(1, 3))
        return img

    target_pooled = _pooled(torch.as_tensor(target, device=dev))

    cfg = scene.config
    static, params0 = flatten_scene(scene)
    params = params_to_torch(params0, dev)
    camera = _f32(scene.camera.camera, dev)
    inv_vp = _f32(inv_view_projection(
        np.asarray(scene.camera.camera, np.float32), scene.camera.target,
        scene.camera.up, scene.camera.fov), dev)
    dirs = ray_grid_xla(size * ss, inv_vp)
    if max_steps is not None:
        trip_bound = max_steps
    else:
        trip_bound = step_bound_for_scene(scene)
        if "axis" in fit_fields:
            # the trip bound is fixed but the chord scales with the fitted
            # axis: reserve 2x headroom
            max_axis = max((max(gi.galaxy.params.axis)
                            for gi in scene.instances), default=1.0)
            trip_bound = conservative_step_bound(
                cfg.ray_step, cfg.min_ray_step, 2.0 * max_axis)
    rs, ms = _f32(cfg.ray_step, dev), _f32(cfg.min_ray_step, dev)
    ex, ga, sa = (_f32(cfg.exposure, dev), _f32(cfg.gamma, dev),
                  _f32(cfg.saturation, dev))

    _check_march_fields(march, fit_fields)
    if march == "frozen":
        # the noise fields once: check_frozen_fields rejects every fitted
        # field that feeds them
        from .tensor_march import (
            check_frozen_fields,
            precompute_frozen,
            render_rays_tensor_frozen,
        )

        check_frozen_fields(static, fit_fields)
        captures = (precompute_frozen(static, params, dirs, camera, rs, ms,
                                      trip_bound),)

        def march_fn(p, fz):
            return render_rays_tensor_frozen(static, p, dirs, camera, rs, ms,
                                             trip_bound, fz)
    else:
        _march = _march_fn(march)
        captures = ()

        def march_fn(p, fz):
            return _march(static, p, dirs, camera, rs, ms, trip_bound)

    def loss_fn(p, *cap):
        linear = _linear_pooled(march_fn(p, cap[0] if cap else None))
        img = post_process_float(linear, ex, ga, sa) / const(linear, 255.0)
        return torch.mean((_pooled(img) - target_pooled) ** 2)

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
    aborted = False
    for s in schedule:
        s = int(s)
        while s > 1 and size % s:
            s -= 1  # the divisor must tile the frame
        rsize = size // s
        rung_target = (target.reshape(rsize, s, rsize, s, 3).mean(axis=(1, 3))
                       if s > 1 else target)
        rung_scene = dataclasses.replace(
            current, config=dataclasses.replace(current.config, size=rsize))
        rung_cb = None
        if on_step is not None:
            def rung_cb(i, loss, b=base):
                nonlocal aborted
                r = on_step(b + i, loss)
                if r is False:
                    aborted = True
                return r
        result = fit_scene(
            rung_scene, rung_target, fit_fields, steps=steps, lr=lr,
            max_steps=max_steps, optimizer=optimizer, on_step=rung_cb,
            march=march, mesh=mesh,
            checkpoint_path=(f"{checkpoint_path}.rung{base // steps}"
                             if checkpoint_path else None),
            checkpoint_every=checkpoint_every, device=device)
        current = result.scene
        all_losses.extend(result.losses)
        base += steps
        if aborted:
            break
    final_scene = dataclasses.replace(
        result.scene, config=dataclasses.replace(result.scene.config,
                                                 size=size))
    return FitResult(scene=final_scene, params=result.params,
                     losses=all_losses, fit_fields=tuple(fit_fields))


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

    # the loss of every frame of a batch, on the device
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
    b1, b2, aeps = 0.9, 0.999, 1e-8

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
        t += 1
        m = (b1 * m + (1 - b1) * g).astype(np.float32)
        v = (b2 * v + (1 - b2) * g * g).astype(np.float32)
        upd = lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + aeps)
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
