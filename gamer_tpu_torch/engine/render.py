"""The torch form of ``gamer_tpu.engine.render``: the XLA march, the shared
integer hash (dither and sparkle), the post chain (buffer2d.cpp:106-126)
and supersample pooling in linear space.

The XLA march (``render_rays``, ``render_frame``, ``render_frame_ss``,
``render_scene``) is the JAX package's conformance march in torch ops:
every ray steps in lockstep through a Python loop whose body is vectorized
over rays, with per-ray masks as selects, until every ray is done (on the
card the loop replays one CUDA graph of a trip, ``_march_graphed``). Its
arithmetic is the XLA march's: a per-step camera distance ``norm3(p - o)``
(render.py:395-400 of the JAX package; csrc/march.cu takes the same
reference recurrence), the library atan/atan2 where the kernel takes a
minimax one, and the literal ``pow`` arm ladder in std::max order. It is
the forward that the
differentiable marches (engine/diff.py, engine/tensor_march.py) reuse: the
component math takes a ``pow_fn`` (``safe_pow`` there) and a ``noise``
hook (the frozen noise fields). Parameters are torch tensors
(``params_to_torch``); scalars that the JAX march takes as float32 arrays
(ray step, post knobs) are float32 tensors here too. ``render_rows`` marches
a row slab of a frame, which equals the same rows of the whole frame: the
sharded frame (``render_scene(mesh=...)``, behind
``render_scene_sharded(method="xla")``) and the queue's progressive chunks
(``engine/queue.py``) are slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import noise as tnoise
from ..ops.camera import inv_view_projection, ray_grid_xla
from ..ops.math3d import (
    PI,
    dot3,
    floor0,
    intersect_ellipsoid_qt,
    norm3,
    norm3_qt,
    normalize3_qt,
    qt_clamp,
    qt_smoothstep,
    quat_from_axis_angle_rad,
    quat_rotate_v,
    wrap_i32,
)
from ..scene.schema import (
    CID_BULGE,
    CID_DISK,
    CID_DUST,
    CID_DUST2,
    CID_DUST_POSITIVE,
    CID_STARS,
    CID_STARS_SMALL,
)
from ..utils.tree import tree_map
from .scene_prep import CompStatic, InstanceStatic, SceneStatic, flatten_scene

_INT32_MIN = -(1 << 31)


def hash3_i32(bx, by, bz):
    """``gamer_tpu.engine.render.hash3_i32``: int32 wrapping multiplies,
    xor, and an arithmetic shift. Inputs are int32 (or int64 holding int32
    values); the result is an int64 tensor holding the int32 value."""
    bx, by, bz = bx.long(), by.long(), bz.long()
    h = wrap_i32((bx * -1640531527) ^ (by * 97) ^ (bz * 1013904223))
    return h ^ (h >> 13)


def abs_i32(h):
    """int32 abs: |INT_MIN| stays INT_MIN, as jnp.abs on int32 does."""
    return torch.where(h == _INT32_MIN, h, torch.abs(h))


def post_process(linear, exposure, gamma, saturation):
    """buffer2d.cpp:106-126 -> uint8 RGB. The scalars are float32 values."""
    v = linear * float(np.float32(1.0) / np.float32(exposure))
    v = torch.pow(v, float(gamma))
    csum = (v[..., 0] + v[..., 1]) + v[..., 2]
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its rounded reciprocal, which is not the f32 quotient
    center = csum / torch.full_like(csum, 3.0)
    tmp = center[..., None] - v
    v = center[..., None] - float(saturation) * tmp
    c = qt_clamp(v * 10.0, 0.0, 255.0)
    return c.to(torch.int32).to(torch.uint8)


def pool_linear(lin, pool: int):
    """Box-average (..., H, W, 3) radiance by ``pool`` in linear space
    (supersampling, pallas_render.py:1116-1118). The pool x pool samples
    are summed in one fixed order and divided by their count, element by
    element, so a row band or a batch frame pools bit-equal to the same
    rows of a single whole frame."""
    if pool == 1:
        return lin
    *lead, h, w, c = lin.shape
    v = lin.reshape(*lead, h // pool, pool, w // pool, pool, c)
    acc = None
    for i in range(pool):
        for j in range(pool):
            x = v[..., i, :, j, :]
            acc = x if acc is None else acc + x
    # a tensor divisor, as in post_process: the f32 quotient on every device
    return acc / torch.full_like(acc, float(pool * pool))


# ---------------------------------------------------------------------------
# the XLA march
# ---------------------------------------------------------------------------


def const(x, c: float):
    """``c`` as a float32 0-d tensor on ``x``'s device (made once per device).
    Dividing by it gives the f32 quotient on every device, where CUDA turns
    a division by a Python scalar into a multiply by its reciprocal, and
    ``c / x`` on tensors is a reciprocal times ``c``."""
    return tnoise.device_table(f"const:{float(c)!r}", float(c), x.device,
                               x.dtype)


def params_to_torch(params, device, dtype=torch.float32):
    """flatten_scene's params (numpy) as tensors on ``device``, same tree."""
    return tree_map(lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                              device=device), params)


def _get_winding(rad, winding_b, winding_n):
    """galaxycomponent.h:156-165."""
    r = rad + 0.05
    return (torch.atan(torch.exp(-0.25 / (0.5 * r)) / winding_b) * 2.0
            * winding_n)


def _find_difference(t1, t2):
    """galaxycomponent.h:103-118 — min |t1-t2| over 0, +-2pi, +-4pi shifts."""
    d = t1 - t2
    v = torch.abs(d)
    v = torch.minimum(v, torch.abs(d - 2 * PI))
    v = torch.minimum(v, torch.abs(d + 2 * PI))
    v = torch.minimum(v, torch.abs(d - 4 * PI))
    v = torch.minimum(v, torch.abs(d + 4 * PI))
    return v


def _twirl(p, t, orientation):
    """Rotate p about the instance orientation by t*180deg
    (galaxycomponent.h:86-90)."""
    return quat_rotate_v(quat_from_axis_angle_rad(orientation, t * PI), p)


def octave_noise_3d(octaves: int, persistence, scale, x, y, z, raw_fn=None):
    """noise.cpp:162-180 with tensor ``persistence`` / ``scale`` (the XLA
    march's traced scalars, differentiable here): frequency doubling,
    persistence amplitudes, normalized by the total amplitude, with the
    frequency and amplitude recurrences in float32 as the JAX scan carries
    them. Every octave's raw noise is one batched call; the sum runs octave
    by octave in the reference's order."""
    raw_fn = tnoise.raw_noise_3d if raw_fn is None else raw_fn
    freq, amp = scale, torch.ones_like(scale)
    max_amp = torch.zeros_like(scale)
    freqs, amps = [], []
    for _ in range(int(octaves)):
        freqs.append(freq)
        amps.append(amp)
        freq = freq * 2.0
        max_amp = max_amp + amp
        amp = amp * persistence
    total = torch.zeros_like(x)
    if freqs:
        fr = torch.stack(freqs).reshape((-1,) + (1,) * x.dim())
        raw = raw_fn(x * fr, y * fr, z * fr)
        for k, a in enumerate(amps):
            total = total + raw[k] * a
    return total / max_amp


def ridged_mf(px, py, pz, frequency, octaves: int, lacunarity: float, offset,
              gain, raw_fn=None):
    """noise.cpp:81-128 with tensor ``frequency`` / ``offset`` / ``gain``:
    the ridged multifractal with weight feedback and the spectral weight
    pow(frequency, -0.05) of each octave's frequency."""
    raw_fn = tnoise.raw_noise_3d if raw_fn is None else raw_fn
    value = torch.zeros_like(px)
    weight = torch.ones_like(px)
    if int(octaves) == 0:
        return value * 1.25 - 1.0
    coords, freqs = [(px, py, pz)], [frequency]
    for _ in range(int(octaves) - 1):
        vx, vy, vz = coords[-1]
        coords.append((vx * lacunarity, vy * lacunarity, vz * lacunarity))
        freqs.append(freqs[-1] * lacunarity)
    raw = raw_fn(*(torch.stack(c) for c in zip(*coords)))
    zero, one = const(px, 0.0), const(px, 1.0)
    for k, freq in enumerate(freqs):
        signal = offset - torch.abs(raw[k])
        signal = signal * signal
        signal = signal * weight
        weight = torch.minimum(torch.maximum(signal * gain, zero), one)
        value = value + signal * torch.pow(freq, -0.05)
    return value * 1.25 - 1.0


def _perlin_cloud(p, t, octaves, ks, pers, orientation, raw_fn=None):
    """galaxycomponent.h:93-98 — octave noise of the twirled point at
    frequency ks*0.1."""
    r = _twirl(p, t, orientation)
    # a Python ks (the star clouds' 2.0 and 4.0) is rounded as jnp does
    scale = (ks * 0.1 if torch.is_tensor(ks)
             else const(p, float(np.float32(ks * 0.1))))
    if not torch.is_tensor(pers):
        pers = const(p, pers)
    return octave_noise_3d(octaves, pers, scale, r[..., 0], r[..., 1],
                           r[..., 2], raw_fn=raw_fn)


def _arm_value(st: InstanceStatic, pr, cp, radius, P, pow_fn=torch.pow):
    """galaxycomponent.h:120-146 — max over the arm equality-ladder count,
    with std::max NaN ordering (a NaN candidate never wins)."""
    rot = quat_rotate_v(pr["rotmat"], P)
    theta = torch.atan2(rot[..., 0], rot[..., 2]) + cp["delta"]
    ww = _get_winding(radius, pr["winding_b"], pr["winding_n"])
    val = None
    for a in range(st.max_arms):
        v = torch.abs(_find_difference(ww, -theta + pr["arms"][a]))
        v = v / const(radius, PI)
        arm_v = pow_fn(1.0 - v, cp["arm"] * 15.0)
        val = arm_v if val is None else torch.where(arm_v > val, arm_v, val)
    return val


def _is_absorber(cs: CompStatic) -> bool:
    """dust / dust2 multiply the accumulator; every other class adds."""
    return cs.cid in (CID_DUST, CID_DUST2)


def _sample_gates(cs: CompStatic, pr, cp, p, active, winding):
    """The per-sample geometry and gates of a non-bulge component, up to and
    including the winding carry (rasterizer.cpp:460-462,
    galaxycomponent.cpp:45-88): (gates, z, radius, intensity, P, winding').
    The frozen-noise precompute (engine/tensor_march.py) replays these same
    expressions, so its fields match the live march's."""
    orientation = pr["orientation"]
    dott = dot3(p, orientation)
    P = p - orientation * dott[..., None]
    radius = norm3(P) / pr["axis"][0]
    h = torch.abs(dott / cp["z0"])
    # sech on min(h, 3): the same value on every lane the h > 2 cutoff
    # keeps, while exp cannot overflow on the discarded lanes (inf -> NaN
    # derivatives)
    hs = torch.minimum(h, const(h, 3.0))
    sech = 1.0 / ((torch.exp(hs) + torch.exp(-hs)) / 2.0)
    z = torch.where(h > 2.0, 0.0, sech * sech)

    ri = torch.exp(-radius / (cp["r0"] * 0.5))
    intensity = qt_clamp(ri - 0.01, 0.0, 1.0)
    intensity = torch.where(intensity > 0.1, 0.1, intensity)
    gates = active & (z > 0.01) & (intensity > 0.001)

    if cs.arm_enabled and cs.winding_enabled:
        new_wind = (_get_winding(radius, pr["winding_b"], pr["winding_n"])
                    * cp["winding"])
    else:
        new_wind = torch.zeros_like(radius)
    winding = torch.where(gates, new_wind, winding)
    return gates, z, radius, intensity, P, winding


def _component_noise(cs: CompStatic, pr, cp, p, winding):
    """The component's raw fractal field(s) at ``p`` with the updated
    winding carry, as a tuple (empty for classes without noise) that
    _component_sample consumes positionally. The shaping after them (abs,
    pow, offset) stays in _component_sample, differentiable."""
    twirl_axis = pr["twirl_axis"]
    raw = tnoise.resolve_raw(cs.noise_kind)
    if cs.cid == CID_DISK:
        return (_perlin_cloud(p, winding, cs.oct(10), cp["scale"], cp["ks"],
                              twirl_axis, raw_fn=raw),)
    if cs.cid == CID_DUST:
        return (_perlin_cloud(p, winding, cs.oct(9), cp["scale"], cp["ks"],
                              twirl_axis, raw_fn=raw),)
    if cs.cid in (CID_DUST2, CID_DUST_POSITIVE):
        r = _twirl(p, winding, twirl_axis) * cp["scale"]
        return (ridged_mf(r[..., 0], r[..., 1], r[..., 2], cp["ks"],
                          cs.oct(9), 2.5, cp["noise_offset"],
                          cp["noise_tilt"], raw_fn=raw),)
    if cs.cid == CID_STARS:
        freq = (0.01 * cp["scale"]) * 100.0
        base = octave_noise_3d(cs.oct(10), cp["ks"], freq, p[..., 0],
                               p[..., 1], p[..., 2], raw_fn=raw)
        if cs.star_extra:
            c1 = _perlin_cloud(p, winding, cs.oct(4), 2.0, -2.0, twirl_axis,
                               raw_fn=raw)
            c2 = _perlin_cloud(p, winding * 0.5, cs.oct(4), 4.0, -2.0,
                               twirl_axis, raw_fn=raw)
            return (base, c1, c2)
        return (base,)
    return ()


def _sparkle_hash(p, scale):
    """The seeded stand-in for the rand() sparkle: hash the sample
    position's bits to (emit?, digit), P(emit) = 1/scale, digit in [0, 10).
    Piecewise constant: no derivative flows through it."""
    bits = p.detach().contiguous().view(torch.int32)
    hu = abs_i32(hash3_i32(bits[..., 0], bits[..., 1], bits[..., 2]))
    scale_i = torch.clamp(scale.detach().to(torch.int32), min=1).long()
    sel = torch.remainder(hu, scale_i) == 0
    dval = torch.remainder(hu >> 8, 10).to(p.dtype)
    return sel, dval


def _dither01(dirs):
    """Per-ray offset in [0, 1) from the direction bits' hash, for
    RenderConfig.dither (galaxy_shadertoy.glsl:564-589). No derivative
    flows through it."""
    bits = dirs.detach().contiguous().view(torch.int32)
    h = hash3_i32(bits[..., 0], bits[..., 1], bits[..., 2])
    return torch.remainder(abs_i32(h), 8192).to(dirs.dtype) * (1.0 / 8192.0)


def _component_sample(cs: CompStatic, st: InstanceStatic, pr, cp, p, active,
                      weight, ray_step, winding, pow_fn=torch.pow,
                      noise=None):
    """One component's action on the accumulator at samples ``p``,
    ``I -> I * exp(att_exp) + emit``, as (emit_rgb, att_exp_rgb, winding):
    absorbers have emit == 0, emitters att_exp == 0, and masked lanes give
    exact zeros, so _apply_component's composition reproduces the
    reference's masked updates bit for bit. GalaxyComponent::
    calculateIntensity (galaxycomponent.cpp:45-88) and the class kernels
    (galaxycomponents.cpp). ``pow_fn`` is torch.pow here and
    diff.safe_pow on the differentiable paths; ``noise`` supplies the
    _component_noise tuple (the frozen fields), None computes it inline."""
    iscale = pr["intensity_scale"]
    zero3 = torch.zeros(p.shape[:-1] + (3,), dtype=p.dtype, device=p.device)

    if cs.cid == CID_BULGE:
        # no gating (galaxycomponents.cpp:5-39)
        pos = quat_rotate_v(pr["rotmat"], p)
        rad = (norm3(pos) + 0.01) * cp["r0"] + 0.01
        ival = (cp["strength"] * weight) * (
            torch.pow(rad, -0.855) * torch.exp(-torch.pow(rad, 0.25)) - 0.05
        ) * iscale
        ival = torch.where(ival < 0, 0.0, ival)
        add = cp["spec"] * (ival * ray_step)[..., None]
        return torch.where(active[..., None], add, 0.0), zero3, winding

    gates, z, radius, intensity, P, winding = _sample_gates(
        cs, pr, cp, p, active, winding)
    if noise is None:
        noise = _component_noise(cs, pr, cp, p, winding)

    scale_inner = torch.pow(qt_smoothstep(0.0, 1.0 * cp["inner"], radius), 4.0)
    if cs.arm_enabled:
        arm_val = _arm_value(st, pr, cp, radius, P, pow_fn)
    else:
        arm_val = torch.ones_like(radius)

    val = cp["strength"] * scale_inner * arm_val * z * intensity * iscale
    emit = gates & (val * weight > 0.0005)
    ival = val * weight
    spec = cp["spec"]

    if cs.cid == CID_DISK:
        p2 = torch.abs(noise[0])
        p2 = torch.maximum(p2, const(p2, 0.01))
        p2 = pow_fn(p2, cp["noise_tilt"])
        p2 = p2 + cp["noise_offset"]
        add = spec * (ival * p2 * ray_step)[..., None]
        keep = emit & (p2 >= 0)
        return torch.where(keep[..., None], add, 0.0), zero3, winding
    if cs.cid == CID_DUST:
        p2 = noise[0]
        p2 = torch.maximum(p2 - cp["noise_offset"], const(p2, 0.0))
        p2 = qt_clamp(pow_fn(5.0 * p2, cp["noise_tilt"]), -10.0, 10.0)
        e = -p2[..., None] * ival[..., None] * spec * 0.01
        return zero3, torch.where(emit[..., None], e, 0.0), winding
    if cs.cid in (CID_DUST2, CID_DUST_POSITIVE):
        p2 = torch.maximum(noise[0], const(noise[0], 0.0))
        if cs.cid == CID_DUST2:
            e = -p2[..., None] * ival[..., None] * spec * 0.01
            return zero3, torch.where(emit[..., None], e, 0.0), winding
        add = spec * (ival * p2 * ray_step)[..., None]
        return torch.where(emit[..., None], add, 0.0), zero3, winding
    if cs.cid == CID_STARS:
        perlin = torch.abs(noise[0])
        add_n = 0.0
        if cs.star_extra:
            add_n = cp["noise_offset"] * noise[1]
            add_n = add_n + 0.5 * cp["noise_offset"] * noise[2]
        v = torch.abs(pow_fn(perlin + 1.0 + add_n, cp["noise_tilt"]))
        add = spec * (ival * v * ray_step)[..., None]
        return torch.where(emit[..., None], add, 0.0), zero3, winding
    if cs.cid == CID_STARS_SMALL:
        # the reference draws unseeded rand() (galaxycomponents.cpp:159-170);
        # a position-hash draw with the same statistics, reproducible
        sel, dval = _sparkle_hash(p, cp["scale"])
        v = pow_fn(dval, cp["noise_tilt"])
        add = spec * (ival * v * ray_step)[..., None]
        return torch.where((emit & sel)[..., None], add, 0.0), zero3, winding
    return zero3, zero3, winding  # unknown class: no-op (reference skips)


def _apply_component(cs: CompStatic, st: InstanceStatic, pr, cp, p, active,
                     weight, I, winding, ray_step, pow_fn=torch.pow):
    """One component applied to the accumulator in sequence: the
    composition of _component_sample. Returns the updated (I, winding)."""
    emit, att_e, winding = _component_sample(
        cs, st, pr, cp, p, active, weight, ray_step, winding, pow_fn)
    if _is_absorber(cs):
        return I * torch.exp(att_e), winding
    return I + emit, winding


def _march_start(pr, dirs, camera, ray_step, min_step, dither: bool):
    """Intersect one instance and lay out each ray's chord
    (rasterizer.cpp:379-403): (o, origin, length, dir_m, alive), the ray
    origin in the galaxy frame, the march start, the chord length, the
    unit march direction and which rays march at all. The chord's
    bookkeeping is the reference's: the quadratic in float64, the length
    and direction as QVector3D's; a chord too short to have a direction
    is not marched."""
    o = camera - pr["position"]
    hit, isp1, isp2, t0, t1 = intersect_ellipsoid_qt(o, dirs, pr["axis"])
    # behind-camera rules (rasterizer.cpp:396-403): reversed-lookAt rays
    # point backward, visible geometry has negative t
    isp2 = torch.where((t1 > 0)[..., None], o, isp2)
    alive = hit & ~((t0 > 0) & (t1 > 0))

    origin = isp1
    if dither:
        step0 = qt_clamp(norm3(origin - o) * ray_step, min_step, 0.01)
        diff0 = origin - isp2
        len0 = norm3(diff0)
        safe0 = torch.where(len0 == 0, 1.0, len0)
        # jitter the start toward the camera by a sub-step fraction, clamped
        # to the chord so grazing rays cannot overshoot isp2
        delta = torch.minimum(step0 * _dither01(dirs), len0)
        origin = origin - (diff0 / safe0[..., None]) * delta[..., None]
    diff = origin - isp2
    length = norm3_qt(diff)
    dir_m = normalize3_qt(diff)
    return o, origin, length, dir_m, alive & (length > 1e-5)


def first_step_prev(length, ray_step):
    """The step before the first (rasterizer.cpp:437: the ray step), the
    float64 ``step_prev`` of a march's state."""
    return torch.full_like(length, 1.0, dtype=torch.float64) * \
        ray_step.double()


def _march_step(st: InstanceStatic, pr, state, o, origin, length, dir_m,
                ray_step, min_step, pow_fn=torch.pow):
    """One lockstep trip of the march: the loop condition, the adaptive
    step, every component in list order, advance and floor
    (rasterizer.cpp:447-470). ``state`` is (p, I, winding, step_prev,
    done); rays that are done keep their state. The step's bookkeeping is
    the reference's, in float64 (``step_prev`` too): the exit on the
    sample's distance along the chord against the chord and the last
    step, the step from the sample's QVector3D distance to the camera and
    the ray step and least step as float64 (``scene_args`` gives the
    scene's own)."""
    p, I, w, step_prev, done = state
    d_along = dot3(p - origin, -dir_m)
    done = done | (d_along.double() >= length.double() + step_prev)
    active = ~done

    step_d = qt_clamp(norm3_qt(p - o).double() * ray_step.double(),
                      min_step.double(), 0.01)
    step = step_d.to(p.dtype)
    weight = (step_d * 200.0).to(p.dtype)

    I_s, w_s = I, w
    for cs, cp in zip(st.comps, pr["comps"]):
        I_s, w_s = _apply_component(cs, st, pr, cp, p, active, weight, I_s,
                                    w_s, ray_step, pow_fn)

    p_new = p - dir_m * step[..., None]
    return (torch.where(active[..., None], p_new, p),
            torch.where(active[..., None], floor0(I_s), I),
            torch.where(active, w_s, w),
            torch.where(active, step_d, step_prev),
            done)


def _march_instance(st: InstanceStatic, pr, dirs, camera, I, winding,
                    ray_step, min_step, dither: bool = False):
    """March all rays through one galaxy instance, back to front, until
    every ray is done (rasterizer.cpp:379-483). dirs: (N, 3); I: (N, 3);
    winding: (N,)."""
    o, origin, length, dir_m, alive = _march_start(pr, dirs, camera,
                                                   ray_step, min_step, dither)
    state = (origin, I, winding, first_step_prev(length, ray_step), ~alive)

    def step(s):
        return _march_step(st, pr, s, o, origin, length, dir_m, ray_step,
                           min_step)

    if dirs.is_cuda:
        return _march_graphed(step, state)
    while bool((~state[4]).any()):
        state = step(state)
    return state[1], state[2]


# trips replayed between two checks of "every ray is done" on the card
GRAPH_TRIPS = 8


def _march_graphed(step, state):
    """The lockstep loop on the card as one CUDA graph of a trip, replayed
    GRAPH_TRIPS times between checks. A trip is ~10^3 small kernels that
    the host issues one by one (the loop is launch-bound); a replay
    issues them at once. The kernels and their inputs are the eager
    trip's, and a trip leaves a done ray's state as it was, so the trips
    past the last ray's end change nothing: the result is the eager
    loop's bit for bit. The first trip runs eagerly on a side stream (it
    fills the per-device constant caches before the capture). The graph is
    captured anew on every call from that call's tensors, and the caches
    are keyed on device and dtype, so a float64 march replays a float64
    graph: nothing is shared between dtypes."""
    dev = state[0].device
    with torch.no_grad(), torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            state = step(state)
        torch.cuda.current_stream(dev).wait_stream(side)
        if not bool((~state[4]).any()):
            return state[1], state[2]
        live = tuple(t.clone() for t in state)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the service's worker threads may use the card
        # while this thread captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for t, new in zip(live, step(live)):
                t.copy_(new)
        while bool((~live[4]).any()):
            for _ in range(GRAPH_TRIPS):
                graph.replay()
        return live[1], live[2]


def render_rays(static: SceneStatic, params, dirs, camera, ray_step,
                min_step):
    """Linear radiance of a batch of rays. dirs: (..., 3) -> (..., 3)."""
    shape = dirs.shape[:-1]
    dirs_f = dirs.reshape(-1, 3)
    n = dirs_f.shape[0]
    I = torch.zeros((n, 3), dtype=dirs.dtype, device=dirs.device)
    winding = torch.zeros((n,), dtype=dirs.dtype, device=dirs.device)
    for st, pr in zip(static.instances, params):
        I, winding = _march_instance(st, pr, dirs_f, camera, I, winding,
                                     ray_step, min_step, dither=static.dither)
    # final scale (rasterizer.cpp:409), in the march's float type
    rs = ray_step.to(I.dtype)
    I = I * (const(rs, 0.01) / rs)
    return I.reshape(*shape, 3)


def _post_uint8(linear, exposure, gamma, saturation):
    """``post_process`` with tensor knobs (the XLA march's float32 scalars)."""
    return post_process(linear, np.float32(exposure.item()),
                        np.float32(gamma.item()), np.float32(saturation.item()))


def render_rows(static: SceneStatic, size: int, ss: int, params, camera,
                inv_vp, ray_step, min_step, row0: int = 0,
                rows: int | None = None):
    """Linear radiance of ``rows`` output rows (default all) of a size x
    size frame from row ``row0`` on, as (rows, size, 3): the rays of rows
    [row0 * ss, (row0 + rows) * ss) of the size * ss grid, with ss^2 rays
    per pixel box-averaged in linear space (RenderConfig.supersample). A
    done ray's state no longer changes, so a row slab equals the same rows
    of the whole frame: the sharded and progressive XLA forms are slabs."""
    rows = size if rows is None else rows
    dirs = ray_grid_xla(size * ss, inv_vp, row0 * ss, rows * ss)
    linear = render_rays(static, params, dirs, camera, ray_step, min_step)
    if ss > 1:
        linear = linear.reshape(rows, ss, size, ss, 3).mean(dim=(1, 3))
    return linear


def render_rows_mesh(static: SceneStatic, size: int, ss: int, mesh, params,
                     camera, inv_vp, ray_step, min_step):
    """``render_rows`` of the whole frame over a 1-D ``mesh``: entry i
    marches output rows i * size/n + [0, size/n) on its device, on that
    device's current stream, from copies of the arguments there; the slabs
    are gathered on the mesh's first device. The size must divide the
    mesh. Every ray marches element-wise, so the result is bit-equal to
    the unsharded ``render_rows`` on the same device."""
    if len(mesh.axis_names) != 1:
        raise ValueError(f"need a 1-D mesh, got axes {mesh.axis_names}")
    if size % mesh.size != 0:
        raise ValueError(
            f"size {size} not divisible by mesh size {mesh.size}; choose a "
            "size that tiles over the mesh")
    out = mesh.devices[0]
    rows = size // mesh.size
    slabs = []
    for i, d in enumerate(mesh.devices):
        args = tree_map(lambda t, d=d: t.to(d),
                        (params, camera, inv_vp, ray_step, min_step))
        slabs.append(render_rows(static, size, ss, *args, i * rows,
                                 rows).to(out))
    return torch.cat(slabs)


def render_frame(static: SceneStatic, size: int, params, camera, inv_vp,
                 ray_step, min_step, exposure, gamma, saturation):
    """One frame: rays -> march -> post, as (uint8 image, linear)."""
    linear = render_rows(static, size, 1, params, camera, inv_vp, ray_step,
                         min_step)
    return _post_uint8(linear, exposure, gamma, saturation), linear


def render_frame_ss(static: SceneStatic, size: int, ss: int, params, camera,
                    inv_vp, ray_step, min_step, exposure, gamma, saturation):
    """Supersampled frame: ss^2 rays per pixel, box-averaged in linear space
    before the post chain (RenderConfig.supersample)."""
    linear = render_rows(static, size, ss, params, camera, inv_vp, ray_step,
                         min_step)
    return _post_uint8(linear, exposure, gamma, saturation), linear


def scene_args(scene, device, dtype=torch.float32):
    """(static, params, camera, inv_vp, ray step, min step, exposure,
    gamma, saturation) of a Scene as tensors of ``dtype`` on ``device``:
    the arguments of render_frame and of the differentiable frames. The
    values are cast from the scene's numbers to ``dtype``, as
    ``gamer_tpu.engine.render.render_scene`` casts them, but for the ray
    step and the least step: float64 0-d tensors of the scene's own values
    (the reference's doubles; against a ``dtype`` tensor they act as
    ``dtype`` values); the 4x4 inverse view-projection is the host's
    float32 one in every dtype."""
    cfg = scene.config
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    static, params = flatten_scene(scene, np_dtype)
    camera = np.asarray(scene.camera.camera, np.float32)
    inv_vp = inv_view_projection(camera, scene.camera.target, scene.camera.up,
                                 scene.camera.fov)

    def t(v):
        return torch.as_tensor(np.asarray(v, np_dtype), device=device,
                               dtype=dtype)

    def d(v):  # the reference's double: the march's step bookkeeping
        return torch.tensor(float(v), dtype=torch.float64, device=device)

    return (static, params_to_torch(params, device, dtype),
            t(scene.camera.camera),
            t(inv_vp), d(cfg.ray_step), d(cfg.min_ray_step), t(cfg.exposure),
            t(cfg.gamma), t(cfg.saturation))


def assemble(linear, cfg, exposure, gamma, saturation):
    """The frame's epilogue on the radiance buffer's device: the star
    overlay added to the radiance (rasterizer.cpp:320-321), then the post
    chain -> (uint8 image, linear with stars)."""
    if cfg.no_stars > 0:
        from .cuda_render import _star_overlay

        linear = linear + _star_overlay(cfg, linear.device).to(linear.dtype)
    return _post_uint8(linear, exposure, gamma, saturation), linear


def render_scene(scene, device="cuda", return_linear: bool = False,
                 mesh=None, dtype=torch.float32):
    """Render a Scene with the XLA march on ``device`` (the card unless the
    caller asks for the CPU): a (size, size, 3) uint8 numpy array, and the
    linear radiance buffer with ``return_linear``. The star overlay is
    added to the radiance buffer and the post chain runs again
    (rasterizer.cpp:320-321). The package's ``render_scene`` is the march
    kernel's path (engine/cuda_render.py); this one is the conformance
    march that the fits differentiate.

    With ``mesh`` (a 1-D ``parallel.Mesh``; ``device`` is then not
    consulted) entry i marches output rows i * size/n + [0, size/n) on its
    device, on that device's current stream; the slabs are gathered on the
    mesh's first device, where the epilogue runs. The size must divide the
    mesh. The frame is bit-equal to the unsharded one on the same device:
    every ray's march is element-wise. ``dtype`` is the march's float
    type."""
    from .cuda_render import _device, mesh_device

    cfg = scene.config
    with torch.no_grad():
        dev = _device(device) if mesh is None else mesh_device(mesh)
        (static, params, camera, inv_vp, rs, ms, ex, ga,
         sa) = scene_args(scene, dev, dtype)
        if mesh is None:
            linear = render_rows(static, cfg.size, cfg.supersample, params,
                                 camera, inv_vp, rs, ms)
        else:
            linear = render_rows_mesh(static, cfg.size, cfg.supersample,
                                      mesh, params, camera, inv_vp, rs, ms)
        img, linear = assemble(linear, cfg, ex, ga, sa)
    if return_linear:
        return img.cpu().numpy(), linear.cpu().numpy()
    return img.cpu().numpy()
