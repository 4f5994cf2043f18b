"""The tensorized differentiable march, the counterpart of
``gamer_tpu.engine.tensor_march``.

Every per-step update of the march is affine in the accumulator,

    I_{k+1} = exp(E_k) * I_k + B_k,

because emissions never depend on I and absorptions are exponentials
(render._component_sample's contract). So the march splits into

  1. a per-ray scalar recursion for the step schedule t_k (a few small ops
     per step),
  2. the per-sample effects (E_k, B_k) over whole (step chunk x rays)
     grids at once: all of the noise math as wide elementwise ops, one
     ``torch.utils.checkpoint`` per chunk, and
  3. their composition: inside a chunk I = I_in * exp(sum E) +
     sum_k B_k * exp(suffix_k) (suffix sums by one reversed cumulative
     sum), and the chunks compose in sequence as affine maps, STEP_CHUNK
     steps each, so the backward pass holds O(chunk x rays) at a time.

The values match the sequential marches to rounding (the camera distance
uses the incremental form ``dist0 - t``, as the kernel does); a NaN
emission on an active lane zeroes only that step's contribution, where
the sequential marches' floor zeroes the whole accumulator, which differs
only for parameters whose render is already NaN. Within a step the
components compose in list order: B collects each emitter and is
attenuated again by every later absorber, the (((I + e1) * a2) + e3)
bracketing of the reference.

Frozen noise: for the usual fitted fields (strength, r0, z0, inner,
delta, arm, ...) the parameters reach the raw fractal noise only through
discrete gate selections, so the noise fields are constants of the fit.
``precompute_frozen`` evaluates them once, and ``render_rays_tensor_frozen``
takes them as an explicit, detached argument; ``check_frozen_fields``
rejects the fields for which that does not hold.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.camera import ray_grid_xla
from ..ops.math3d import intersect_ellipsoid, norm3, qt_clamp
from ..scene.schema import CID_BULGE, CID_DUST2, CID_DUST_POSITIVE
from .diff import post_process_float, safe_pow
from .render import (
    _component_noise,
    _component_sample,
    _dither01,
    _is_absorber,
    _sample_gates,
    const,
)
from .scene_prep import InstanceStatic, SceneStatic

# steps per checkpointed chunk of the effects evaluation: the backward pass
# holds O(STEP_CHUNK x rays) temporaries, while the work inside a chunk
# stays one wide evaluation
STEP_CHUNK = 64


def _schedule(pr, dirs, camera, ray_step, min_step, max_steps: int,
              dither: bool, step_chunk: int):
    """Each ray's march geometry and step schedule: (origin, dir_m, ts,
    actives, weights, n_chunks), the step arrays shaped
    (n_chunks * step_chunk, N). Padded steps past ``max_steps`` are done,
    so their effects are exact zeros."""
    o = camera - pr["position"]
    hit, isp1, isp2, t0, t1 = intersect_ellipsoid(o, dirs, pr["axis"])
    isp2 = torch.where((t1 > 0)[..., None], o, isp2)
    alive = hit & ~((t0 > 0) & (t1 > 0))

    origin = isp1
    # the camera distance is affine along the march: dist0 - t
    dist_origin = norm3(origin - o)
    if dither:
        step0 = qt_clamp(dist_origin * ray_step, min_step, 0.01)
        diff0 = origin - isp2
        len0 = norm3(diff0)
        safe0 = torch.where(len0 == 0, 1.0, len0)
        delta = torch.minimum(step0 * _dither01(dirs), len0)
        origin = origin - (diff0 / safe0[..., None]) * delta[..., None]
        dist_origin = dist_origin - delta
    diff = origin - isp2
    length = norm3(diff)
    safe = torch.where(length == 0, 1.0, length)
    dir_m = diff / safe[..., None]

    n_chunks = max(1, -(-int(max_steps) // step_chunk))
    t = torch.zeros_like(length)
    step_prev = torch.full_like(length, 1.0) * ray_step
    done = ~alive
    ts, actives, weights = [], [], []
    for _ in range(n_chunks * step_chunk):
        done = done | (t >= length + step_prev)
        active = ~done
        step = qt_clamp((dist_origin - t) * ray_step, min_step, 0.01)
        ts.append(t)
        actives.append(active)
        weights.append(step * 200.0)
        t = t + step * active.to(t.dtype)
        step_prev = torch.where(active, step, step_prev)
    return (origin, dir_m, torch.stack(ts), torch.stack(actives),
            torch.stack(weights), n_chunks)


def _step_effects(st: InstanceStatic, pr, P, actives, weights, ray_step,
                  noise_c=None):
    """(E, B): the log attenuation and in-step emission of every sample of
    a chunk, components in list order."""
    E = torch.zeros(P.shape[:-1] + (3,), dtype=P.dtype, device=P.device)
    B = torch.zeros_like(E)
    winding = torch.zeros(P.shape[:-1], dtype=P.dtype, device=P.device)
    for ci, (cs, cp) in enumerate(zip(st.comps, pr["comps"])):
        noise = None if noise_c is None else noise_c[ci]
        emit, att_e, winding = _component_sample(
            cs, st, pr, cp, P, actives, weights, ray_step, winding,
            pow_fn=safe_pow, noise=noise)
        if _is_absorber(cs):
            B = B * torch.exp(att_e)
            E = E + att_e
        else:
            B = B + emit
    # a NaN effect would poison the whole composition sum; zero it as the
    # sequential marches' floor zeroes a NaN accumulator
    return torch.nan_to_num(E), torch.nan_to_num(B)


def _march_instance_tensor(st: InstanceStatic, pr, dirs, camera, I,
                           ray_step, min_step, max_steps: int,
                           dither: bool = False,
                           step_chunk: int = STEP_CHUNK, frozen_noise=None):
    """One instance's march as schedule + per-chunk effects + affine
    composition. dirs: (N, 3) unit rays; I: (N, 3). ``frozen_noise``: per
    component, the tuple of its noise fields shaped (n_chunks, step_chunk,
    N) from precompute_frozen, used detached in place of the noise."""
    origin, dir_m, ts, actives, weights, n_chunks = _schedule(
        pr, dirs, camera, ray_step, min_step, max_steps, dither, step_chunk)
    sizes = ([len(f) for f in frozen_noise] if frozen_noise is not None
             else None)

    def chunk_body(I, t_c, act_c, w_c, *flat):
        noise_c = None
        if sizes is not None:
            it = iter(flat)
            noise_c = tuple(tuple(next(it) for _ in range(k)) for k in sizes)
        P = origin[None] - dir_m[None] * t_c[..., None]
        E, B = _step_effects(st, pr, P, act_c, w_c, ray_step, noise_c)
        incl = torch.flip(torch.cumsum(torch.flip(E, (0,)), 0), (0,))
        suffix = incl - E
        return I * torch.exp(incl[0]) + torch.sum(B * torch.exp(suffix), 0)

    use_ckpt = torch.is_grad_enabled()
    for c in range(n_chunks):
        sl = slice(c * step_chunk, (c + 1) * step_chunk)
        flat = ()
        if frozen_noise is not None:
            flat = tuple(f[c].detach() for comp in frozen_noise
                         for f in comp)
        args = (I, ts[sl], actives[sl], weights[sl], *flat)
        if use_ckpt:
            I = checkpoint(chunk_body, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            I = chunk_body(*args)
    return I


def render_rays_tensor(static: SceneStatic, params, dirs, camera, ray_step,
                       min_step, max_steps: int):
    """The differentiable twin of render.render_rays on the tensorized
    march. dirs: (..., 3) -> (..., 3) linear radiance."""
    return render_rays_tensor_frozen(static, params, dirs, camera, ray_step,
                                     min_step, max_steps, None)


# leaves that move the frozen fields: march geometry (positions, schedule)
# or raw-noise inputs (frequency, persistence, twirl angle)
_FROZEN_UNSAFE_ALWAYS = frozenset({
    "axis", "position", "orientation", "twirl_axis", "rotmat",
    "scale", "ks", "winding", "winding_b", "winding_n",
})
# ridged fractals take offset and tilt inside the octave loop
# (noise.cpp:81-128), so for dust2 / "dust positive" they are noise inputs
_FROZEN_UNSAFE_RIDGED = frozenset({"noise_offset", "noise_tilt"})


def check_frozen_fields(static: SceneStatic, fit_fields) -> None:
    """Raise if ``fit_fields`` would move the frozen noise fields."""
    fields = set(fit_fields)
    bad = fields & _FROZEN_UNSAFE_ALWAYS
    if any(cs.cid in (CID_DUST2, CID_DUST_POSITIVE)
           for st in static.instances for cs in st.comps):
        bad |= fields & _FROZEN_UNSAFE_RIDGED
    if bad:
        raise ValueError(
            f"march='frozen' cannot fit {sorted(bad)}: these fields feed "
            "the raw fractal noise (or the march geometry), which the "
            "frozen path precomputes once. Use march='tensor' instead.")


@torch.no_grad()
def precompute_frozen(static: SceneStatic, params, dirs, camera, ray_step,
                      min_step, max_steps: int, step_chunk: int = STEP_CHUNK):
    """Every component's raw noise fields at every sample of the march
    schedule, once: per instance, per component, a tuple of fields shaped
    (n_chunks, step_chunk, N) (the ``frozen`` argument of
    render_rays_tensor_frozen). The gates and winding carry run the march's
    own expressions (render._sample_gates), so the fields equal what the
    live march computes at these parameters bit for bit."""
    dirs_f = dirs.reshape(-1, 3)
    out = []
    for st, pr in zip(static.instances, params):
        origin, dir_m, ts, actives, _w, n_chunks = _schedule(
            pr, dirs_f, camera, ray_step, min_step, max_steps,
            static.dither, step_chunk)
        chunks = []
        for c in range(n_chunks):
            sl = slice(c * step_chunk, (c + 1) * step_chunk)
            P = origin[None] - dir_m[None] * ts[sl][..., None]
            winding = torch.zeros(P.shape[:-1], dtype=P.dtype,
                                  device=P.device)
            fields = []
            for cs, cp in zip(st.comps, pr["comps"]):
                if cs.cid == CID_BULGE:
                    fields.append(())
                    continue
                _g, _z, _r, _i, _P, winding = _sample_gates(
                    cs, pr, cp, P, actives[sl], winding)
                fields.append(_component_noise(cs, pr, cp, P, winding))
            chunks.append(fields)
        out.append(tuple(
            tuple(torch.stack([ch[ci][k] for ch in chunks])
                  for k in range(len(chunks[0][ci])))
            for ci in range(len(st.comps))))
    return tuple(out)


def render_rays_tensor_frozen(static: SceneStatic, params, dirs, camera,
                              ray_step, min_step, max_steps: int, frozen):
    """render_rays_tensor with the precomputed noise fields ``frozen`` (None
    computes them inline): bit-equal to the tensor march at the parameters
    the fields were computed at, and exact for every fitted field set that
    passes check_frozen_fields."""
    shape = dirs.shape[:-1]
    dirs_f = dirs.reshape(-1, 3)
    I = torch.zeros((dirs_f.shape[0], 3), dtype=dirs.dtype,
                    device=dirs.device)
    for k, (st, pr) in enumerate(zip(static.instances, params)):
        # instances compose far to near (rasterizer.cpp:190-201), each an
        # affine map of I
        I = _march_instance_tensor(
            st, pr, dirs_f, camera, I, ray_step, min_step, max_steps,
            dither=static.dither,
            frozen_noise=None if frozen is None else frozen[k])
    I = I * (const(ray_step, 0.01) / ray_step)
    return I.reshape(*shape, 3)


def render_frame_tensor(static: SceneStatic, size: int, max_steps: int,
                        params, camera, inv_vp, ray_step, min_step, exposure,
                        gamma, saturation):
    """One differentiable frame on the tensorized march, as (float image in
    [0, 255], linear radiance): the drop-in for diff.render_frame_diff."""
    dirs = ray_grid_xla(size, inv_vp)
    linear = render_rays_tensor(static, params, dirs, camera, ray_step,
                                min_step, max_steps)
    return post_process_float(linear, exposure, gamma, saturation), linear
