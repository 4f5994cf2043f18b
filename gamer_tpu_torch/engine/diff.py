"""The differentiable march: a fixed-trip form of the XLA march and the float
post chain, the counterpart of ``gamer_tpu.engine.diff``.

The XLA march (engine/render.py) loops until every ray is done. Here the
same trip body (``render._march_step``, with ``pow_fn=safe_pow``) runs a
fixed number of trips, ``max_steps``, bounded by the closed form of the
adaptive step schedule (``conservative_step_bound``). A trip after a ray is
done leaves its state as it is, so for any bound at or above the realized
trip count the radiance is bit-equal to the XLA march. Each trip runs
under ``torch.utils.checkpoint``: the backward pass keeps only the small
per-trip carries and evaluates each trip's body again, as
``jax.checkpoint`` does.

A few reference expressions produce NaN on purpose and the forward math
masks those lanes away: pow(1-v, arm*15) with v > 1 relies on std::max's
NaN order (galaxycomponent.h:120-137), and pow(x, tilt) sees x == 0.
``safe_pow`` keeps torch.pow's value and zeroes every partial that is not
finite, so no NaN reaches the gradients from a masked lane; the fits also
replace non-finite gradients by finite ones.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.camera import ray_grid_xla
from ..ops.math3d import qt_clamp
from .render import _march_start, _march_step, const
from .scene_prep import InstanceStatic, SceneStatic


def _sum_to(g, ref):
    """A broadcast gradient ``g`` summed back to ``ref``'s shape."""
    if g.shape == ref.shape:
        return g
    if ref.dim() == 0:
        return g.sum()
    return g.sum_to_size(ref.shape)


class _SafePow(torch.autograd.Function):
    """torch.pow with the partials of ``gamer_tpu.engine.diff.safe_pow``'s
    JVP: e * x^(e-1) and x^e * log(x), each set to 0 where not finite."""

    @staticmethod
    def forward(ctx, x, e):
        y = torch.pow(x, e)
        ctx.save_for_backward(x, e, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, e, y = ctx.saved_tensors
        gx = ge = None
        if ctx.needs_input_grad[0]:
            dydx = e * torch.pow(x, e - 1.0)
            dydx = torch.where(torch.isfinite(dydx), dydx, 0.0)
            gx = _sum_to(g * dydx, x)
        if ctx.needs_input_grad[1]:
            dyde = y * torch.log(x)
            dyde = torch.where(torch.isfinite(dyde), dyde, 0.0)
            ge = _sum_to(g * dyde, e)
        return gx, ge


def safe_pow(x, e):
    """``torch.pow(x, e)`` whose partials are 0 wherever the true derivative
    is not finite (x <= 0, or a non-finite value): exactly the lanes that
    the forward math masks away. The value is torch.pow's, NaN for a
    negative base included (the reference's NaN ordering relies on it)."""
    if not torch.is_tensor(e):
        e = torch.as_tensor(e, dtype=x.dtype, device=x.device)
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=e.dtype, device=e.device)
    return _SafePow.apply(x, e)


def conservative_step_bound(ray_step: float, min_step: float,
                            max_axis: float = 1.0, slack: float = 1.15) -> int:
    """A trip bound >= the march's trip count for any ray. The step is
    clamp(dist*ray_step, min_step, 0.01) and a chord is <= 2*max(axis):
    below d1 = min_step/ray_step the step is min_step, between d1 and
    d2 = 0.01/ray_step it grows geometrically (<= ln(d2/d1)/ray_step trips
    on each side of the camera), beyond d2 it is 0.01. The three regions'
    worst cases are summed, with slack."""
    chord = 2.0 * max_axis
    d1 = min_step / ray_step
    d2 = 0.01 / ray_step
    trips = min(chord, 2.0 * d1) / min_step
    rem = chord - min(chord, 2.0 * d1)
    if rem > 0 and d2 > d1:
        trips += 2.0 * math.log(d2 / d1) / ray_step
        rem -= min(rem, 2.0 * (d2 - d1))
    if rem > 0:
        trips += rem / 0.01
    return int(trips * slack) + 16


def step_bound_for_scene(scene) -> int:
    """conservative_step_bound at a Scene's knobs."""
    max_axis = max(
        (max(gi.galaxy.params.axis) for gi in scene.instances), default=1.0)
    return conservative_step_bound(scene.config.ray_step,
                                   scene.config.min_ray_step, max_axis)


def _march_instance_scan(st: InstanceStatic, pr, dirs, camera, I, winding,
                         ray_step, min_step, max_steps: int,
                         remat: bool = True, dither: bool = False):
    """render._march_instance with ``max_steps`` trips of the same body
    (``pow_fn=safe_pow``); with ``remat`` each trip is checkpointed while
    gradients are recorded."""
    o, origin, length, dir_m, alive = _march_start(pr, dirs, camera,
                                                   ray_step, min_step, dither)
    state = (origin, I, winding, torch.full_like(length, 1.0) * ray_step,
             ~alive)

    def body(*s):
        return _march_step(st, pr, s, o, origin, length, dir_m, ray_step,
                           min_step, pow_fn=safe_pow)

    use_ckpt = remat and torch.is_grad_enabled()
    for _ in range(int(max_steps)):
        if use_ckpt:
            state = checkpoint(body, *state, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = body(*state)
    return state[1], state[2]


def render_rays_diff(static: SceneStatic, params, dirs, camera, ray_step,
                     min_step, max_steps: int, remat: bool = True):
    """The differentiable twin of render.render_rays. dirs: (..., 3) ->
    (..., 3) linear radiance."""
    shape = dirs.shape[:-1]
    dirs_f = dirs.reshape(-1, 3)
    n = dirs_f.shape[0]
    I = torch.zeros((n, 3), dtype=dirs.dtype, device=dirs.device)
    winding = torch.zeros((n,), dtype=dirs.dtype, device=dirs.device)
    for st, pr in zip(static.instances, params):
        I, winding = _march_instance_scan(
            st, pr, dirs_f, camera, I, winding, ray_step, min_step,
            max_steps, remat, dither=static.dither)
    I = I * (const(ray_step, 0.01) / ray_step)
    return I.reshape(*shape, 3)


def post_process_float(linear, exposure, gamma, saturation):
    """buffer2d.cpp:106-126 without the uint8 cast: float RGB in [0, 255],
    the space the fits compare images in."""
    v = linear * (1.0 / exposure)
    v = safe_pow(v, gamma)
    center = ((v[..., 0] + v[..., 1]) + v[..., 2]) / const(v, 3.0)
    tmp = center[..., None] - v
    v = center[..., None] - saturation * tmp
    return qt_clamp(v * 10.0, 0.0, 255.0)


def render_frame_diff(static: SceneStatic, size: int, max_steps: int,
                      params, camera, inv_vp, ray_step, min_step, exposure,
                      gamma, saturation):
    """One differentiable frame: rays -> fixed-trip march -> float post, as
    (float image in [0, 255], linear radiance); differentiable in the
    params, the camera, inv_vp and the post knobs."""
    dirs = ray_grid_xla(size, inv_vp)
    linear = render_rays_diff(static, params, dirs, camera, ray_step,
                              min_step, max_steps)
    return post_process_float(linear, exposure, gamma, saturation), linear
