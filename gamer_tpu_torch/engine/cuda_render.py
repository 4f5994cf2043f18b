"""The still-frame, row-band and ray-list paths: scene -> scalar page +
structure table -> march kernel (csrc/march.cu) -> torch epilogue (pooling,
stars, post) -> uint8.

The counterpart of ``gamer_tpu.engine.pallas_render``'s
``render_scene_pallas`` (one fused frame), ``render_progressive_pallas``
(row bands with progress and abort) and ``render_dirs_pallas`` (an explicit
list of ray directions, the all-sky work list). The host side packs the
scene's numbers into one float32 page (``_build_layout`` /
``_pack_scalars``, as the TPU kernel's SMEM row) and its structure into a
small int32 table (``_build_table``) that the precompiled CUDA kernel walks
at run time. The table's header names the scene's raw-noise backend
(simplex, perlin or iq), which picks the kernel's instantiation.

The kernel's wrappers are ``march`` (K1, a whole frame),
``march_progressive`` (K5, the progressive frame in one launch that flags
each finished row band while it runs; ``render_progressive``),
``march_band`` (a row band: S1's launch per mesh entry), ``march_batch``
(K4, a stack of frames; used by engine/batch.py) and ``march_rays`` (K6, a
ray list; used by engine/allsky.py). The sharded launches
``march_rowshard``, ``march_batch_rowshard`` and ``march_rays_rowshard`` run
those wrappers
once per entry of a device mesh (parallel/sharding.py), each on its entry's
device and stream, and gather the outputs on the mesh's first device: the
counterparts of ``_compiled_rowshard``, ``_compiled_batch_rowshard`` and
``_compiled_dirs_rowshard``. A tensor on the CPU runs the plain version,
``march_plain`` and its band, progressive, batch and ray-list forms: the
lockstep torch version with the kernel's arithmetic (the reference's
march bookkeeping, as the spec oracle takes it: each step from the
sample's distance to the camera, the exit on its distance along the
chord, in double where the reference keeps doubles, where
pallas_render.py:428-434,578 accumulates the path length in float32; the
minimax atan); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch

from ..ops.camera import inv_view_projection, ray_grid
from ..ops.math3d import (PI, atan2_f32, atan_f32, floor0, norm3_qt,
                          normalize3_qt, qt_clamp, quat_rotate)
from ..ops.noise import (
    NOISE_KINDS,
    noise_table,
    octave_noise_3d,
    resolve_raw,
    ridged_mf,
    ridged_weights,
)
from ..post.stars import pad_star_rows, star_field_device, star_params
from ..scene.schema import (
    CID_BULGE,
    CID_DISK,
    CID_DUST,
    CID_DUST2,
    CID_DUST_POSITIVE,
    CID_STARS,
    CID_STARS_SMALL,
    Scene,
)
from .diff import conservative_step_bound
from .render import abs_i32, hash3_i32, pool_linear, post_process
from .scene_prep import COMP_FIELDS, SceneStatic, flatten_scene

f32 = np.float32

# Band height quantum by frame size (pallas_render.py:59-64): progressive
# bands, progress ticks and abort rows follow the JAX package's geometry.
TILE_R, TILE_R_LARGE = 32, 64

# Hard safety cap on march substeps per instance (pallas_render.py:67-73):
# guards against a non-terminating loop if the exit test goes NaN.
MAX_ITERS = 131072
RIDGED_OCTAVES = 9

# Page offsets the kernel reads (csrc/march.cu): globals, then per instance
# relative to "i{gi}.pos", per component relative to its first field.
G_INV_VP, G_CAMERA, G_RAY_STEP, G_MIN_STEP, G_ROW0 = 0, 16, 19, 20, 21
I_POS, I_AXIS_INV, I_AXIS_X, I_WINDING_B, I_WINDING_N = 0, 3, 6, 7, 8
I_ARMS, I_ROTMAT, I_TWIRL, I_ORIENT, I_ISCALE = 9, 13, 17, 20, 23
C_SPEC, C_RIDGED_W = 11, 14
C_FIELD = {f: k for k, f in enumerate(COMP_FIELDS)}

# Structure table: a header (instance count, dither flag, index of the
# noise kind in NOISE_KINDS), one row per instance, one row per component.
T_N_INST, T_DITHER, T_KIND, T_HDR = 0, 1, 2, 3
T_INST = 4   # n_comps, max_arms, page_off, comp_row
T_COMP = 9   # cid, arm_en, wind_en, star_extra, oct10, oct9, oct4, n_ridged,
             # page_off


def _tile_rows(size: int) -> int:
    return TILE_R_LARGE if size >= 1024 else TILE_R


def band_geometry(size: int, supersample: int, bands: int):
    """(band_rows, n_bands) of a progressive render, as
    ``render_progressive_pallas`` cuts it (pallas_render.py:1552-1558):
    bands are whole multiples of the tile height and the pool factor, in
    march rows, and the last band may reach past the frame."""
    S = size * supersample
    tr = _tile_rows(S)
    granule = tr * supersample // math.gcd(tr, supersample)
    rows = -(-S // granule) * granule
    n_bands = max(1, min(bands, rows // granule))
    band_rows = -(-(rows // granule) // n_bands) * granule
    return band_rows, -(-S // band_rows)


def _scene_noise_kind(static: SceneStatic) -> str:
    """The one raw-noise backend of a scene's components (simplex for a
    scene without components). A kernel launch is one instantiation, so an
    unknown kind, or two kinds in one scene, raises ValueError."""
    kinds = {cs.noise_kind for inst in static.instances for cs in inst.comps}
    bad = kinds - set(NOISE_KINDS)
    if bad:
        raise ValueError(f"unknown noise_kind(s) {sorted(bad)!r}: expected "
                         f"one of {NOISE_KINDS}")
    if len(kinds) > 1:
        raise ValueError(f"one noise kind per scene, got {sorted(kinds)!r}")
    return kinds.pop() if kinds else "simplex"


class _Layout:
    """Scalar packing: names -> offsets into one flat float32 page."""

    def __init__(self):
        self.names = []
        self.sizes = {}
        self.offsets = {}
        self.n = 0
        self.kind = "simplex"  # the scene's raw-noise backend

    def add(self, name: str, k: int) -> int:
        self.offsets[name] = self.n
        self.sizes[name] = k
        self.names.append(name)
        self.n += k
        return self.offsets[name]


# the page's last entries: the ray step's and the least step's low words
STEP_LO = ("ray_step_lo", "min_step_lo")


def _build_layout(static: SceneStatic) -> _Layout:
    """pallas_render._build_layout (same names, same order, so the page's
    first entries equal the TPU page's for every noise kind; the kind's
    lookup table is not part of the page), then the low words of the ray
    step and the least step (STEP_LO), the page's last two entries."""
    lay = _Layout()
    lay.kind = _scene_noise_kind(static)
    lay.add("inv_vp", 16)
    lay.add("camera", 3)
    lay.add("ray_step", 1)
    lay.add("min_step", 1)
    # global row offset of the rendered rows (0 for whole frames)
    lay.add("row0", 1)
    for gi, inst in enumerate(static.instances):
        p = f"i{gi}."
        lay.add(p + "pos", 3)
        lay.add(p + "axis_inv", 3)   # 1/axis^2
        lay.add(p + "axis_x", 1)
        lay.add(p + "winding_b", 1)
        lay.add(p + "winding_n", 1)
        lay.add(p + "arms", 4)
        lay.add(p + "rotmat", 4)
        lay.add(p + "twirl_axis", 3)
        lay.add(p + "orientation", 3)
        lay.add(p + "iscale", 1)
        for ci, cs in enumerate(inst.comps):
            cp = f"{p}c{ci}."
            for f in COMP_FIELDS:
                lay.add(cp + f, 1)
            lay.add(cp + "spec", 3)
            if cs.cid in (CID_DUST2, CID_DUST_POSITIVE):
                lay.add(cp + "ridged_w", cs.oct(RIDGED_OCTAVES))
    for name in STEP_LO:
        lay.add(name, 1)
    return lay


def _low_word(x) -> np.float32:
    """x - float32(x), rounded to float32: with float32(x) it carries the
    double the scene gave (to 2^-48 of it), as the reference's double
    ray step."""
    return np.float32(float(x) - float(np.float32(x)))


def _pack_scalars(static: SceneStatic, lay: _Layout, params, camera, inv_vp,
                  ray_step, min_step) -> np.ndarray:
    """The scene's numbers as one flat float32 page of ``lay.n`` entries.
    ``ray_step`` and ``min_step`` are the scene's values: floats beyond
    float32 leave their low words on the page (``STEP_LO``), float32
    values a low word of 0."""
    row = np.zeros(lay.n, np.float32)

    def put(name, v):
        off = lay.offsets[name]
        flat = np.asarray(v, np.float32).reshape(-1)
        row[off:off + flat.shape[0]] = flat

    put("inv_vp", inv_vp)
    put("camera", camera)
    put("ray_step", ray_step)
    put("min_step", min_step)
    put("ray_step_lo", _low_word(ray_step))
    put("min_step_lo", _low_word(min_step))
    put("row0", 0.0)
    for gi, (inst, pr) in enumerate(zip(static.instances, params)):
        p = f"i{gi}."
        axis = np.asarray(pr["axis"], np.float32)
        put(p + "pos", pr["position"])
        # 1 / axis^2 in double, rounded to float (util.h:66-98)
        put(p + "axis_inv", 1.0 / (axis.astype(np.float64) ** 2))
        put(p + "axis_x", axis[0])
        put(p + "winding_b", pr["winding_b"])
        put(p + "winding_n", pr["winding_n"])
        put(p + "arms", pr["arms"])
        put(p + "rotmat", pr["rotmat"])
        put(p + "twirl_axis", pr["twirl_axis"])
        put(p + "orientation", pr["orientation"])
        put(p + "iscale", pr["intensity_scale"])
        for ci, (cs, cp) in enumerate(zip(inst.comps, pr["comps"])):
            cpre = f"{p}c{ci}."
            for f in COMP_FIELDS:
                put(cpre + f, cp[f])
            put(cpre + "spec", cp["spec"])
            if cs.cid in (CID_DUST2, CID_DUST_POSITIVE):
                # pow(ks * 2.5^k, -0.05) per octave (noise.cpp:122), numpy f32
                put(cpre + "ridged_w",
                    ridged_weights(float(cp["ks"]), cs.oct(RIDGED_OCTAVES)))
    return row


def _build_table(static: SceneStatic, lay: _Layout) -> np.ndarray:
    """The scene's structure as int32 rows the kernel walks at run time."""
    n_inst = len(static.instances)
    comp_row = T_HDR + n_inst * T_INST
    rows = [n_inst, int(static.dither), NOISE_KINDS.index(lay.kind)]
    comp_rows = []
    for gi, inst in enumerate(static.instances):
        p = f"i{gi}."
        base = lay.offsets[p + "pos"]
        if lay.offsets[p + "iscale"] - base != I_ISCALE:
            raise RuntimeError("page layout disagrees with the kernel's offsets")
        rows += [len(inst.comps), inst.max_arms, base,
                 comp_row + len(comp_rows)]
        for ci, cs in enumerate(inst.comps):
            comp_rows += [cs.cid, int(cs.arm_enabled), int(cs.winding_enabled),
                          int(cs.star_extra), cs.oct(10), cs.oct(9), cs.oct(4),
                          cs.oct(RIDGED_OCTAVES),
                          lay.offsets[f"{p}c{ci}.{COMP_FIELDS[0]}"]]
    return np.asarray(rows + comp_rows, np.int32)


def _check_march_cap(scene: Scene) -> None:
    """Warn when a scene's worst-case march (a closed-form bound on the
    step schedule) exceeds MAX_ITERS per instance: rays needing more would
    lose their camera-near segment."""
    cfg = scene.config
    max_axis = max(
        (max(gi.galaxy.params.axis) for gi in scene.instances), default=1.0)
    bound = conservative_step_bound(cfg.ray_step, cfg.min_ray_step, max_axis)
    if bound > MAX_ITERS:
        warnings.warn(
            f"scene's worst-case march length (~{bound} substeps/instance, "
            f"axis {max_axis:g}, min step {cfg.min_ray_step:g}) exceeds the "
            f"kernel cap MAX_ITERS={MAX_ITERS}; rays needing more substeps "
            "would truncate their camera-near segment. Use a larger "
            "min_ray_step or smaller ellipsoid axes.",
            RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# the plain version of the march kernel
# ---------------------------------------------------------------------------


def _twirl(axis, t, vx, vy, vz):
    """Rotate by angle t*pi about the unit twirl axis (galaxycomponent.h:86-90)."""
    half = t * (PI * 0.5)
    s = torch.sin(half)
    ax, ay, az = axis
    return quat_rotate((torch.cos(half), ax * s, ay * s, az * s), vx, vy, vz)


def _get_winding(rad, wb, wn):
    """galaxycomponent.h:156-165 (atan via the minimax polynomial)."""
    r = rad + 0.05
    return atan_f32(torch.exp(-0.25 / (0.5 * r)) / wb) * 2.0 * wn


def _find_difference(t1, t2):
    d = t1 - t2
    v = torch.abs(d)
    for k in (-2 * PI, 2 * PI, -4 * PI, 4 * PI):
        v = torch.minimum(v, torch.abs(d + k))
    return v


def _arm_value(inst, cp, max_arms, radius, Px, Py, Pz):
    """galaxycomponent.h:120-146: the literal pow ladder, std::max NaN order."""
    rx, _, rz = quat_rotate(inst["rotmat"], Px, Py, Pz)
    theta = atan2_f32(rx, rz) + cp["delta"]
    ww = _get_winding(radius, inst["winding_b"], inst["winding_n"])
    arm15 = float(f32(cp["arm"]) * f32(15.0))
    val = None
    for a in range(max_arms):
        v = torch.abs(_find_difference(ww, -theta + inst["arms"][a])) / PI
        arm_v = torch.pow(1.0 - v, arm15)
        val = arm_v if val is None else torch.where(arm_v > val, arm_v, val)
    return val


def _cloud(inst, octaves, t, ks_, pers_, px, py, pz):
    """octave noise of the twirled sample at frequency ks_*0.1, with the
    call sites' (scale, persistence) argument order (pallas_render.py:835)."""
    tx, ty, tz = _twirl(inst["twirl_axis"], t, px, py, pz)
    return octave_noise_3d(octaves, pers_, f32(ks_) * f32(0.1), tx, ty, tz,
                           inst["raw_fn"])


def _count(stats, key: str, n) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _component(st, inst, cp, max_arms, px, py, pz, Px, Py, Pz, dott, radius,
               weight, ray_step, I, stats=None):
    """One non-bulge component on the current active rays (all tensors are
    per active ray); I is the list [I0, I1, I2], updated in place."""
    z0, r0 = cp["z0"], cp["r0"]
    h = torch.abs(dott / z0)
    r_thr = float(f32(r0) * f32(2.2552)) if r0 > 0 else float(f32(3.4e38))
    trig = (h <= 2.0) & (radius < r_thr)
    _count(stats, "triggers", trig.numel())
    if not bool(trig.any()):
        return
    s = trig.nonzero().squeeze(1)
    h, radius, w_s = h[s], radius[s], weight[s]

    eh = torch.exp(h)
    sech = 2.0 / (eh + 1.0 / eh)
    z = torch.where(h > 2.0, 0.0, sech * sech)
    ri = torch.exp(-radius / float(f32(r0) * f32(0.5)))
    intensity = qt_clamp(ri - 0.01, 0.0, 1.0)
    intensity = torch.where(intensity > 0.1, 0.1, intensity)
    gates = (z > 0.01) & (intensity > 0.001)
    if stats is not None:
        n_gated = int(gates.sum())
        _count(stats, "triggered", s.numel())
        _count(stats, "gated", n_gated)
        _count(stats, "arm_gated", n_gated if st["arm_en"] else 0)

    t_s = qt_clamp(radius / cp["inner"], 0.0, 1.0)
    sib = t_s * t_s * (3.0 - 2.0 * t_s)
    scale_inner = (sib * sib) * (sib * sib)
    if st["arm_en"]:
        arm_val = _arm_value(inst, cp, max_arms, radius, Px[s], Py[s], Pz[s])
        if st["wind_en"]:
            winding = _get_winding(radius, inst["winding_b"],
                                   inst["winding_n"]) * cp["winding"]
        else:
            winding = torch.zeros_like(radius)
    else:
        arm_val = torch.ones_like(radius)
        winding = torch.zeros_like(radius)
    val = cp["strength"] * scale_inner * arm_val * z * intensity * inst["iscale"]
    ival = val * w_s
    emit = gates & (ival > 0.0005)
    if not bool(emit.any()):
        return
    e = emit.nonzero().squeeze(1)
    if stats is not None:
        # the kernel's noise work on the emitting samples (raw noise calls)
        n_raw = {CID_DUST: st["oct9"], CID_DUST2: st["n_ridged"],
                 CID_DUST_POSITIVE: st["n_ridged"], CID_DISK: st["oct10"],
                 CID_STARS: st["oct10"] + (2 * st["oct4"] if st["star_extra"]
                                           else 0)}.get(st["cid"], 0)
        _count(stats, "emitting", e.numel())
        _count(stats, "raw_noise", e.numel() * n_raw)
    se = s[e]
    ival, winding = ival[e], winding[e]
    ex, ey, ez = px[se], py[se], pz[se]
    ks, cscale = cp["ks"], cp["scale"]
    noff, ntilt = cp["noise_offset"], cp["noise_tilt"]
    spec = cp["spec"]
    cid = st["cid"]

    keep = None  # rows of `se` that emit, where a class has a second gate
    if cid == CID_DUST:
        contrib = _cloud(inst, st["oct9"], winding, cscale, ks, ex, ey, ez)
        contrib = torch.clamp(contrib - noff, min=0.0)
        contrib = qt_clamp(torch.pow(5.0 * contrib, ntilt), -10.0, 10.0)
    elif cid in (CID_DUST2, CID_DUST_POSITIVE):
        tx, ty, tz = _twirl(inst["twirl_axis"], winding, ex, ey, ez)
        contrib = torch.clamp(ridged_mf(tx * cscale, ty * cscale, tz * cscale,
                                        cp["ridged_w"], 2.5, noff, ntilt,
                                        inst["raw_fn"]),
                              min=0.0)
    elif cid == CID_DISK:
        contrib = torch.abs(_cloud(inst, st["oct10"], winding, cscale, ks,
                                   ex, ey, ez))
        contrib = torch.pow(torch.clamp(contrib, min=0.01), ntilt) + noff
        keep = contrib >= 0
    elif cid == CID_STARS:
        freq = (f32(0.01) * f32(cscale)) * f32(100.0)
        perlin = torch.abs(octave_noise_3d(st["oct10"], ks, freq, ex, ey, ez,
                                           inst["raw_fn"]))
        add_n = torch.zeros_like(perlin)
        if st["star_extra"]:
            add_n = noff * _cloud(inst, st["oct4"], winding, 2.0, -2.0,
                                  ex, ey, ez)
            add_n = add_n + float(f32(0.5) * f32(noff)) * _cloud(
                inst, st["oct4"], winding * 0.5, 4.0, -2.0, ex, ey, ez)
        contrib = torch.abs(torch.pow(perlin + 1.0 + add_n, ntilt))
    elif cid == CID_STARS_SMALL:
        # seeded position-hash sparkle (engine.render._sparkle_hash)
        hu = abs_i32(hash3_i32(ex.view(torch.int32), ey.view(torch.int32),
                               ez.view(torch.int32)))
        scale_i = max(int(np.float32(cscale).astype(np.int32)), 1)
        keep = torch.remainder(hu, scale_i) == 0
        dval = torch.remainder(hu >> 8, 10).to(torch.float32)
        contrib = torch.pow(dval, ntilt)
    else:
        return  # unknown class: no-op (the reference skips it)
    if cid in (CID_DUST, CID_DUST2):
        # absorbers multiply the accumulator
        ea = -contrib * ival * 0.01
        for k in range(3):
            I[k][se] = I[k][se] * torch.exp(ea * spec[k])
        return
    add = ival * contrib * ray_step
    if keep is not None:
        k_idx = keep.nonzero().squeeze(1)
        se, add = se[k_idx], add[k_idx]
    for k in range(3):
        I[k][se] = I[k][se] + spec[k] * add


def _bulge(inst, cp, px, py, pz, weight, ray_step, I):
    """Bulge (galaxycomponents.cpp:5-39): no gating, every active sample."""
    bx, by, bz = quat_rotate(inst["rotmat"], px, py, pz)
    rad = (torch.sqrt(bx * bx + by * by + bz * bz) + 0.01) * cp["r0"] + 0.01
    ival = (cp["strength"] * weight) * (
        torch.pow(rad, -0.855) * torch.exp(-torch.sqrt(torch.sqrt(rad))) - 0.05
    ) * inst["iscale"]
    ival = torch.where(ival < 0, 0.0, ival)
    add = ival * ray_step
    for k in range(3):
        I[k] = I[k] + cp["spec"][k] * add


def _checked_kind(kind: int) -> int:
    if not 0 <= kind < len(NOISE_KINDS):
        raise ValueError(f"the table names noise kind {kind}, expected an "
                         f"index into {NOISE_KINDS}")
    return kind


def _read_scene(pg: np.ndarray, tb: np.ndarray):
    """Decode the page and table into per-instance dicts of float32 values
    (as Python floats), per-component structure rows and the scene's raw
    noise function."""
    insts = []
    n_inst = int(tb[T_N_INST])
    raw_fn = resolve_raw(NOISE_KINDS[_checked_kind(int(tb[T_KIND]))])
    for gi in range(n_inst):
        n_comps, max_arms, base, crow = (int(v) for v in
                                         tb[T_HDR + gi * T_INST:][:T_INST])
        v = [float(x) for x in pg[base:base + I_ISCALE + 1]]
        inst = {
            "pos": v[I_POS:I_POS + 3],
            "axis_inv": v[I_AXIS_INV:I_AXIS_INV + 3],
            "axis_x": v[I_AXIS_X],
            "winding_b": v[I_WINDING_B],
            "winding_n": v[I_WINDING_N],
            "arms": v[I_ARMS:I_ARMS + 4],
            "rotmat": v[I_ROTMAT:I_ROTMAT + 4],
            "twirl_axis": v[I_TWIRL:I_TWIRL + 3],
            "orientation": v[I_ORIENT:I_ORIENT + 3],
            "iscale": v[I_ISCALE],
            "max_arms": max_arms,
            "raw_fn": raw_fn,
            "comps": [],
        }
        for ci in range(n_comps):
            r = [int(x) for x in tb[crow + ci * T_COMP:][:T_COMP]]
            st = dict(cid=r[0], arm_en=bool(r[1]), wind_en=bool(r[2]),
                      star_extra=bool(r[3]), oct10=r[4], oct9=r[5], oct4=r[6],
                      n_ridged=r[7])
            off = r[8]
            cp = {f: float(pg[off + C_FIELD[f]]) for f in COMP_FIELDS}
            cp["spec"] = [float(x) for x in pg[off + C_SPEC:off + C_SPEC + 3]]
            cp["ridged_w"] = pg[off + C_RIDGED_W:off + C_RIDGED_W + r[7]].copy()
            inst["comps"].append((st, cp))
        insts.append(inst)
    return insts


def _march_instance_plain(inst, dirs, valid, camera, ray_step, min_step,
                          steps, dither, I_out, stats=None):
    """Intersect and march one instance for all rays in lockstep; rays are
    dropped from the working set as they finish, so every op runs only on
    rays that are still marching. ``stats`` (a dict) counts the samples
    and the component work the data needs."""
    cx = float(f32(camera[0]) - f32(inst["pos"][0]))
    cy = float(f32(camera[1]) - f32(inst["pos"][1]))
    cz = float(f32(camera[2]) - f32(inst["pos"][2]))
    ivx, ivy, ivz = inst["axis_inv"]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    # the ellipsoid (util.h:66-98): float products, the quadratic in double
    rox, roy, roz = (float(f32(c) * f32(v)) for c, v in
                     ((cx, ivx), (cy, ivy), (cz, ivz)))
    A = ((dx * (dx * ivx) + dy * (dy * ivy)) + dz * (dz * ivz)).double()
    B = 2.0 * ((dx * rox + dy * roy) + dz * roz).double()
    C = float((f32(cx) * f32(rox) + f32(cy) * f32(roy))
              + f32(cz) * f32(roz)) - 1.0
    Sdisc = B * B - 4.0 * A * C
    hit = Sdisc > 0.0
    sq = torch.sqrt(torch.where(hit, Sdisc, 0.0))
    t0 = (-B - sq) / (2.0 * A)
    t1 = (-B + sq) / (2.0 * A)
    # behind-camera rules (rasterizer.cpp:396-403)
    alive = hit & ~((t0 > 0) & (t1 > 0)) & valid
    idx = alive.nonzero().squeeze(1)
    if idx.numel() == 0:
        return
    dx, dy, dz, t0, t1 = dx[idx], dy[idx], dz[idx], t0[idx], t1[idx]
    t0f, t1f, near_cam = t0.float(), t1.float(), t1 > 0

    o1x, o1y, o1z = cx + dx * t0f, cy + dy * t0f, cz + dz * t0f
    fx = o1x - torch.where(near_cam, cx, cx + dx * t1f)
    fy = o1y - torch.where(near_cam, cy, cy + dy * t1f)
    fz = o1z - torch.where(near_cam, cz, cz + dz * t1f)
    length = norm3_qt(torch.stack([fx, fy, fz], dim=-1))
    # a chord too short to have a direction is not marched
    marched = (length > 1e-5).nonzero().squeeze(1)
    if marched.numel() < idx.numel():
        (idx, dx, dy, dz, t0f, o1x, o1y, o1z, fx, fy, fz, length) = (
            v[marched] for v in (idx, dx, dy, dz, t0f, o1x, o1y, o1z, fx, fy,
                                 fz, length))
        if idx.numel() == 0:
            return
    mdx, mdy, mdz = normalize3_qt(torch.stack([fx, fy, fz], dim=-1)).unbind(-1)
    if dither:
        hsh = hash3_i32(dx.view(torch.int32), dy.view(torch.int32),
                        dz.view(torch.int32))
        h01 = torch.remainder(abs_i32(hsh), 8192).to(torch.float32) * (1.0 / 8192.0)
        delta = torch.minimum(
            qt_clamp(-t0f * ray_step, min_step, 0.01) * h01, length)
        px, py, pz = o1x - mdx * delta, o1y - mdy * delta, o1z - mdz * delta
    else:
        px, py, pz = o1x, o1y, o1z
    # the step's bookkeeping in double, as the reference's: ``steps`` is
    # the scene's (ray step, least step) as doubles
    rs, ms = steps
    length_d = length.double()
    steppr = torch.full_like(length_d, rs)
    I = [I_out[idx, k] for k in range(3)]

    ox, oy, oz = inst["orientation"]
    axis_x = inst["axis_x"]
    it = 0
    while it < MAX_ITERS:
        # loop exit (rasterizer.cpp:447): the sample's distance along the
        # chord (from the far point toward the camera side) vs the chord
        # and the last step
        along = ((px - o1x) * -mdx + (py - o1y) * -mdy) + (pz - o1z) * -mdz
        stop = along.double() >= length_d + steppr
        if bool(stop.any()):
            I_out[idx[stop]] = torch.stack([v[stop] for v in I], dim=1)
            keep = (~stop).nonzero().squeeze(1)
            if keep.numel() == 0:
                return
            (idx, px, py, pz, o1x, o1y, o1z, steppr, length_d, mdx, mdy,
             mdz, I0, I1, I2) = (v[keep] for v in (
                idx, px, py, pz, o1x, o1y, o1z, steppr, length_d, mdx, mdy,
                mdz, *I))
            I = [I0, I1, I2]
        _count(stats, "samples", idx.numel())
        # the step from the sample's distance to the camera
        # (rasterizer.cpp:449)
        step_d = qt_clamp(norm3_qt(torch.stack(
            [px - cx, py - cy, pz - cz], dim=-1)).double() * rs, ms, 0.01)
        step = step_d.float()
        weight = (step_d * 200.0).float()
        dott = px * ox + py * oy + pz * oz
        Px, Py, Pz = px - ox * dott, py - oy * dott, pz - oz * dott
        radius = torch.sqrt(Px * Px + Py * Py + Pz * Pz) / axis_x
        # strictly in list order: emission adds, absorption multiplies
        for st, cp in inst["comps"]:
            if st["cid"] == CID_BULGE:
                _count(stats, "bulge", idx.numel())
                _bulge(inst, cp, px, py, pz, weight, ray_step, I)
            else:
                _component(st, inst, cp, inst["max_arms"], px, py, pz,
                           Px, Py, Pz, dott, radius, weight, ray_step, I,
                           stats)
        # advance (rasterizer.cpp:467-470), then floor: negatives/NaN to 0
        px, py, pz = px - mdx * step, py - mdy * step, pz - mdz * step
        steppr = step_d
        I = [floor0(v) for v in I]
        it += 1
    I_out[idx] = torch.stack(I, dim=1)


def march_plain(page: torch.Tensor, table: torch.Tensor, frame_size: int,
                rows: int | None = None, stats: dict | None = None):
    """The march kernel's function in torch ops, on the page's device:
    (rows, frame_size, 3) float32 linear radiance scaled by 0.01/ray_step
    for the rays of rows row0 + [0, rows) of a frame_size x frame_size
    frame (row0 from the page; ``rows`` defaults to the whole frame). Rows
    past the frame's last row are 0. A ``stats`` dict gets the counts of
    the work these inputs need (march samples, bulge samples, component
    trigger tests, triggered, gated and emitting samples, raw noise calls),
    from which a lower bound of the kernel's time follows."""
    rows = frame_size if rows is None else int(rows)
    dev = page.device
    pg = page.detach().to("cpu", torch.float32).numpy()
    tb = table.detach().to("cpu").numpy()
    row0 = float(pg[G_ROW0])
    dirs = ray_grid(frame_size, pg[G_INV_VP:G_INV_VP + 16], row0,
                    device=dev, rows=rows).reshape(-1, 3)
    jrow = row0 + torch.arange(rows, dtype=torch.float32, device=dev)
    valid = (jrow < float(frame_size))[:, None].expand(
        rows, frame_size).reshape(-1)
    return _march_dirs_plain(pg, tb, dirs, valid, stats).reshape(
        rows, frame_size, 3)


def _march_dirs_plain(pg: np.ndarray, tb: np.ndarray, dirs: torch.Tensor,
                      valid: torch.Tensor, stats: dict | None):
    """(n, 3) radiance, scaled by 0.01/ray_step, of the rays ``dirs`` (n, 3)
    from the page's camera point through every instance; rays outside
    ``valid`` stay 0."""
    ray_step, min_step = float(pg[G_RAY_STEP]), float(pg[G_MIN_STEP])
    # each its float plus its low word (the page's last two entries)
    steps = (ray_step + float(pg[-2]), min_step + float(pg[-1]))
    I = torch.zeros((dirs.shape[0], 3), dtype=torch.float32,
                    device=dirs.device)
    camera = pg[G_CAMERA:G_CAMERA + 3]
    for inst in _read_scene(pg, tb):
        _march_instance_plain(inst, dirs, valid, camera, ray_step, min_step,
                              steps, bool(tb[T_DITHER]), I, stats)
    return I * float(f32(0.01) / f32(ray_step))


def march_rays_plain(page: torch.Tensor, table: torch.Tensor,
                     dirs: torch.Tensor, stats: dict | None = None):
    """K6's function: (N, 3) radiance of the rays ``dirs`` (N, 3) float32,
    used as given (not normalised), from the page's camera point. There is
    no frame mask; a zero direction never hits and gives 0. ``stats``
    counts the work as in ``march_plain``."""
    pg = page.detach().to("cpu", torch.float32).numpy()
    tb = table.detach().to("cpu").numpy()
    valid = torch.ones(dirs.shape[0], dtype=torch.bool, device=dirs.device)
    return _march_dirs_plain(pg, tb, dirs, valid, stats)


def _with_row0(page: torch.Tensor, row0: int) -> torch.Tensor:
    """A copy of the page (or of a stack of pages) with the row0 slot set to
    ``row0``, the band's global row offset (``_set_row0``,
    pallas_render.py:996-1000). An integer
    below 2^24 is exact in f32, so the band's rays are the whole frame's."""
    if int(row0) != row0 or not 0 <= int(row0) < (1 << 24):
        raise ValueError(f"row0 must be an integer in [0, 2^24), got {row0}")
    out = page.clone()
    out[..., G_ROW0] = float(row0)
    return out


def march_band_plain(page: torch.Tensor, table: torch.Tensor,
                     frame_size: int, band_rows: int, row0: int,
                     stats: dict | None = None):
    """K5's function: (band_rows, frame_size, 3) radiance of the band of
    rows row0 + [0, band_rows) of the frame."""
    return march_plain(_with_row0(page, row0), table, frame_size, band_rows,
                       stats)


def march_batch_plain(pages: torch.Tensor, table: torch.Tensor,
                      frame_size: int, stats: dict | None = None,
                      rows: int | None = None, row0: int = 0):
    """K4's function: (B, rows, frame_size, 3) radiance, the rows
    row0 + [0, rows) of one frame per page of the (B, n) stack (the whole
    frame by default), all of one structure table."""
    if rows is not None:
        pages = _with_row0(pages, row0)
    return torch.stack([march_plain(p, table, frame_size, rows, stats)
                        for p in pages])


def _on_cpu(pages: torch.Tensor, table: torch.Tensor, page_dim: int) -> bool:
    """Check a wrapper's inputs; True when both lie on the CPU (the plain
    version runs), False when both lie on one CUDA device (the kernel
    launches). Anything else raises."""
    if pages.dtype != torch.float32 or table.dtype != torch.int32:
        raise TypeError(f"pages must be float32 and the table int32, got "
                        f"{pages.dtype} and {table.dtype}")
    if pages.dim() != page_dim or table.dim() != 1:
        raise ValueError(f"pages must be {page_dim}-D and the table 1-D, got "
                         f"{pages.dim()}-D and {table.dim()}-D")
    if pages.device.type == "cpu" and table.device.type == "cpu":
        return True
    if pages.device.type != "cuda" or table.device != pages.device:
        raise ValueError(
            f"pages and table must both be on one CUDA device or both on the "
            f"CPU, got {pages.device} and {table.device}")
    if not (pages.is_contiguous() and table.is_contiguous()):
        raise ValueError("pages and table must be contiguous")
    return False


# Launch geometry of csrc/march.cu's persistent kernels: each warp takes
# tiles of 32 rays, one per lane, from a per-launch counter; a frame tile is
# TILE_W x TILE_H pixels, enumerated over (frame, tile row, tile col), a
# ray-list tile 32 consecutive rays.
TILE_W, TILE_H, WARP = 8, 4, 32


def frame_tiles(frame_size: int, rows: int, n_frames: int = 1) -> int:
    """Tiles of a launch of n_frames frames of ``rows`` rows (the last tile
    row and column may reach past the rows and the frame)."""
    return -(-frame_size // TILE_W) * -(-rows // TILE_H) * n_frames


def ray_tiles(n_rays: int) -> int:
    """Tiles of a ray-list launch (the last one may be short)."""
    return -(-n_rays // WARP)


def persistent_grid(blocks_per_sm: int, n_sms: int, n_tiles: int,
                    block_warps: int, spare: int = 0) -> int:
    """Blocks of a launch: all the card holds at once less ``spare``, but
    no more than give each warp one tile."""
    return max(1, min(blocks_per_sm * n_sms - spare,
                      -(-n_tiles // block_warps)))


# The kernels of csrc/march.cu by their occupancy query's form argument.
FORM_FRAMES, FORM_RAYS, FORM_PROGRESSIVE = 0, 1, 2

_OCCUPANCY: dict = {}


def occupancy(device: torch.device, kind: int, form: int) -> tuple:
    """(resident blocks per SM, SMs, warps per block) of the frame
    (``form`` FORM_FRAMES), ray-list (FORM_RAYS) or progressive
    (FORM_PROGRESSIVE) kernel of noise kind ``kind`` on a CUDA device, from
    the kernel library's occupancy query; kept per device."""
    from ..kernels import library

    key = (device.index, kind, int(form))
    got = _OCCUPANCY.get(key)
    if got is None:
        lib = library()
        with torch.cuda.device(device):
            blocks = lib.gamer_march_occupancy(kind, int(form))
        if blocks <= 0:
            raise RuntimeError(f"march occupancy query failed: {blocks}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        got = _OCCUPANCY[key] = (blocks, sms,
                                 lib.gamer_march_block_threads() // WARP)
    return got


def _grid_and_counter(device: torch.device, kind: int, form: int,
                      n_tiles: int, spare: int = 0, n_counters: int = 1):
    """The persistent grid of a launch and its counters: ``n_counters``
    int32 zeros on the launch's device and current stream, of this launch
    alone (the tile counter first)."""
    blocks, sms, warps = occupancy(device, kind, form)
    return (persistent_grid(blocks, sms, n_tiles, warps, spare),
            torch.zeros(n_counters, dtype=torch.int32, device=device))


def _launch(pages: torch.Tensor, table: torch.Tensor, frame_size: int,
            rows: int) -> torch.Tensor:
    """One launch of csrc/march.cu over a (B, n) page stack:
    (B, rows, frame_size, 3) radiance on the pages' device."""
    from ..kernels import library

    if int(frame_size) <= 0 or int(rows) <= 0:
        raise ValueError(f"frame_size and rows must be positive, got "
                         f"{frame_size} and {rows}")
    n_frames, n_page = pages.shape
    lib = library()
    out = torch.empty((n_frames, rows, frame_size, 3), dtype=torch.float32,
                      device=pages.device)
    kind = _table_kind(table)
    noise = noise_table(NOISE_KINDS[kind], pages.device)
    grid, counter = _grid_and_counter(
        pages.device, kind, FORM_FRAMES,
        frame_tiles(frame_size, rows, n_frames))
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    with torch.cuda.device(pages.device):
        rc = lib.gamer_march_batch(pages.data_ptr(), n_page, n_page, n_frames,
                                   table.data_ptr(), table.numel(),
                                   noise.data_ptr(), out.data_ptr(),
                                   int(frame_size), int(rows), kind, grid,
                                   counter.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {rc} "
                           f"({lib.gamer_error_string(rc).decode()})")
    KIND_LAUNCHES[NOISE_KINDS[kind]] += 1
    return out


def upload_table(table: np.ndarray, device) -> torch.Tensor:
    """The structure table as an int32 tensor on ``device``, with its noise
    kind noted on the tensor so that a launch need not read it back."""
    t = torch.as_tensor(table, device=device)
    t.noise_kind = int(table[T_KIND])
    return t


def _table_kind(table: torch.Tensor) -> int:
    """The table's noise kind (an index into NOISE_KINDS), which picks the
    kernel's instantiation on the host: the note ``upload_table`` left, else
    one read of the header from the device, kept on the tensor."""
    kind = getattr(table, "noise_kind", None)
    if kind is None:
        kind = table.noise_kind = _checked_kind(int(table[T_KIND]))
    return kind


def march(page: torch.Tensor, table: torch.Tensor, size: int) -> torch.Tensor:
    """K1: linear radiance (size, size, 3) float32 of one whole frame for a
    scalar page and its structure table, on their device. CPU tensors run
    ``march_plain``; CUDA tensors launch the kernel (counted in
    ``march.launch_count``) or raise."""
    if _on_cpu(page, table, 1):
        return march_plain(page, table, size)
    out = _launch(page[None], table, size, size)[0]
    march.launch_count += 1
    return out


def march_band(page: torch.Tensor, table: torch.Tensor, frame_size: int,
               band_rows: int, row0: int) -> torch.Tensor:
    """A row band (K5's ``_compiled_band``): linear radiance (band_rows,
    frame_size, 3) of the rows row0 + [0, band_rows) of a frame_size frame;
    rows past the frame are 0. S1's launch per mesh entry; the progressive
    frame is one ``march_progressive`` launch instead. Bit-equal on the
    card to those rows of ``march``'s whole frame. CPU
    tensors run ``march_band_plain``; CUDA tensors launch the kernel
    (counted in ``march_band.launch_count``) or raise."""
    if _on_cpu(page, table, 1):
        return march_band_plain(page, table, frame_size, band_rows, row0)
    out = _launch(_with_row0(page, row0)[None], table, frame_size,
                  band_rows)[0]
    march_band.launch_count += 1
    return out


def march_batch(pages: torch.Tensor, table: torch.Tensor, frame_size: int,
                rows: int | None = None, row0: int = 0) -> torch.Tensor:
    """K4: linear radiance (B, frame_size, frame_size, 3) of B frames of
    one structure, one page each ((B, n) float32), in one launch. Each
    frame is bit-equal on the card to ``march`` of its page. With ``rows``,
    the launch covers the row band row0 + [0, rows) of every frame
    ((B, rows, frame_size, 3): a row slab of a batch). CPU tensors run
    ``march_batch_plain``; CUDA tensors launch the kernel (counted in
    ``march_batch.launch_count``) or raise."""
    if _on_cpu(pages, table, 2):
        return march_batch_plain(pages, table, frame_size, rows=rows,
                                 row0=row0)
    if not 1 <= pages.shape[0] <= 65535:
        raise ValueError(f"a launch takes 1 to 65535 frames, got "
                         f"{pages.shape[0]}")
    if rows is None:
        out = _launch(pages, table, frame_size, frame_size)
    else:
        out = _launch(_with_row0(pages, row0), table, frame_size, rows)
    march_batch.launch_count += 1
    return out


def march_rays(page: torch.Tensor, table: torch.Tensor,
               dirs: torch.Tensor) -> torch.Tensor:
    """K6: linear radiance (N, 3) float32 of an explicit list of ray
    directions ``dirs`` (N, 3) float32, used as given, from the page's
    camera point, on the page's device. On the card a ray is bit-equal to
    the frame ray of the same direction bits. CPU tensors run
    ``march_rays_plain``; CUDA tensors launch the kernel (counted in
    ``march_rays.launch_count``) or raise."""
    if dirs.dtype != torch.float32 or dirs.dim() != 2 or dirs.shape[1] != 3:
        raise ValueError(f"dirs must be an (N, 3) float32 tensor, got "
                         f"{tuple(dirs.shape)} {dirs.dtype}")
    if dirs.device != page.device:
        raise ValueError(f"dirs must be on the page's device {page.device}, "
                         f"got {dirs.device}")
    if _on_cpu(page, table, 1):
        return march_rays_plain(page, table, dirs)
    if not dirs.is_contiguous():
        raise ValueError("dirs must be contiguous")
    if dirs.shape[0] >= (1 << 31):
        raise ValueError(f"a launch takes fewer than 2^31 rays, got "
                         f"{dirs.shape[0]}")
    from ..kernels import library

    lib = library()
    out = torch.empty_like(dirs)
    kind = _table_kind(table)
    noise = noise_table(NOISE_KINDS[kind], page.device)
    grid, counter = _grid_and_counter(page.device, kind, FORM_RAYS,
                                      ray_tiles(dirs.shape[0]))
    stream = torch.cuda.current_stream(page.device).cuda_stream
    with torch.cuda.device(page.device):
        rc = lib.gamer_march_rays(page.data_ptr(), page.numel(),
                                  table.data_ptr(), table.numel(),
                                  noise.data_ptr(), dirs.data_ptr(),
                                  dirs.shape[0], out.data_ptr(), kind, grid,
                                  counter.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {rc} "
                           f"({lib.gamer_error_string(rc).decode()})")
    KIND_LAUNCHES[NOISE_KINDS[kind]] += 1
    march_rays.launch_count += 1
    return out


# Blocks the progressive launch leaves out of the card's full residency:
# with every SM full of march blocks (3 x 256 threads x 80 registers of
# 65,536), the small kernels of a band's epilogue, on a side stream, could
# start only as march blocks retire; a spare block leaves an SM room for
# them, at ~1/396 of the march's rate a block (PERF.md).
PROGRESS_SPARE_BLOCKS = 2
# gamer_progress_wait's own results (csrc/march.cu), and its time limit.
WAIT_ENDED, WAIT_TIMEOUT = -1000000, -1000001
PROGRESS_WAIT_MS = 600_000


class ProgressiveLaunch:
    """A progressive frame in flight, as ``march_progressive`` returns it.
    ``out``: its radiance, (n_bands * band_rows, frame_size, 3); ``flags``:
    one int32 word a band, 1 once the band's rows are stored; ``abort``: an
    int32 word that stops the launch within a tile of each warp once set;
    ``counters``: the launch's int32 device counters (tiles taken, then
    each band's finished tiles); ``end``: an event on the launch's stream
    after the launch. On the card the words are pinned host memory that the
    kernel writes and reads while it runs, so they belong to this object:
    ``stop()``, and dropping the object, wait for ``end``. From the plain
    version (CPU) every flag is set, and ``counters`` and ``end`` are
    None."""

    def __init__(self, out, band_rows: int, flags, abort, counters=None,
                 end=None):
        self.out, self.band_rows = out, band_rows
        self.flags, self.abort = flags, abort
        self.counters, self.end = counters, end

    def wait(self, next_band: int) -> int:
        """How many consecutive bands from ``next_band`` on have finished:
        waits (other Python threads run meanwhile) until flags[next_band]
        is set. Raises RuntimeError when the launch ends with the band unset
        (an aborted or failed launch), on a CUDA error, or after
        PROGRESS_WAIT_MS."""
        if self.end is None:
            return self.flags.numel() - next_band
        from ..kernels import library

        lib = library()
        with torch.cuda.device(self.out.device):
            n = lib.gamer_progress_wait(self.flags.data_ptr(),
                                        self.flags.numel(), int(next_band),
                                        self.end.cuda_event, PROGRESS_WAIT_MS)
        if n > 0:
            return n
        if n == WAIT_ENDED:
            why = "the launch ended with the band unfinished"
        elif n == WAIT_TIMEOUT:
            why = f"no flag within {PROGRESS_WAIT_MS} ms"
        else:
            why = f"CUDA error {-n} ({lib.gamer_error_string(-n).decode()})"
        raise RuntimeError(f"progressive march, band {next_band}: {why}")

    def bands(self, b: int, n: int) -> torch.Tensor:
        """The radiance of bands b .. b + n - 1."""
        return self.out[b * self.band_rows:(b + n) * self.band_rows]

    def stop(self) -> None:
        """Abort what is left of the launch and wait for its end."""
        self.abort[0] = 1
        if self.end is not None:
            self.end.synchronize()

    def __del__(self):
        if self.end is not None:
            self.end.synchronize()


def march_progressive_plain(page: torch.Tensor, table: torch.Tensor,
                            frame_size: int, band_rows: int, n_bands: int,
                            stats: dict | None = None) -> torch.Tensor:
    """The progressive launch's radiance: (n_bands * band_rows, frame_size,
    3) of the frame from row 0, the rows past the frame 0. Every band is
    marched: the abort word only stops the kernel, whose unfinished bands
    the caller never reads."""
    return march_plain(_with_row0(page, 0), table, frame_size,
                       n_bands * band_rows, stats)


def _check_progress_args(frame_size, band_rows, n_bands) -> None:
    if int(frame_size) <= 0 or int(n_bands) <= 0 or int(band_rows) <= 0:
        raise ValueError(f"frame_size, band_rows and n_bands must be "
                         f"positive, got {frame_size}, {band_rows}, "
                         f"{n_bands}")
    if band_rows % TILE_H:
        raise ValueError(f"band_rows must be a multiple of {TILE_H}, got "
                         f"{band_rows}")
    if band_rows * n_bands >= (1 << 24):
        raise ValueError(f"{n_bands} bands of {band_rows} rows reach past "
                         f"2^24 rows")


def march_progressive(page: torch.Tensor, table: torch.Tensor,
                      frame_size: int, band_rows: int,
                      n_bands: int) -> ProgressiveLaunch:
    """K5 as one launch: the frame from row 0 in n_bands bands of band_rows
    rows (a multiple of TILE_H), rows past the frame 0. On the card every
    ray is bit-equal to ``march``'s; the call returns once the launch is
    queued, with the launch's own band flags and abort word (a band whose
    flag is 0 when the launch ends holds no defined values). CPU tensors
    run ``march_progressive_plain`` (every flag set); CUDA tensors launch
    the kernel (counted in ``march_progressive.launch_count``) or raise."""
    on_cpu = _on_cpu(page, table, 1)
    _check_progress_args(frame_size, band_rows, n_bands)
    if on_cpu:
        return ProgressiveLaunch(
            march_progressive_plain(page, table, frame_size, band_rows,
                                    n_bands), band_rows,
            torch.ones(n_bands, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    launch = _launch_progressive(page, table, frame_size, band_rows, n_bands)
    march_progressive.launch_count += 1
    return launch


def _launch_progressive(page, table, frame_size: int, band_rows: int,
                        n_bands: int) -> ProgressiveLaunch:
    """One launch of csrc/march.cu's progressive kernel (checked inputs) on
    the current stream of the page's device. The flag and abort words are
    pinned host memory, which unified addressing maps for the device."""
    from ..kernels import library

    lib = library()
    dev = page.device
    rows = n_bands * band_rows
    flags = torch.zeros(n_bands, dtype=torch.int32, pin_memory=True)
    abort = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    out = torch.empty((rows, frame_size, 3), dtype=torch.float32, device=dev)
    kind = _table_kind(table)
    noise = noise_table(NOISE_KINDS[kind], dev)
    grid, counters = _grid_and_counter(
        dev, kind, FORM_PROGRESSIVE, frame_tiles(frame_size, rows),
        spare=PROGRESS_SPARE_BLOCKS, n_counters=1 + n_bands)
    page0 = _with_row0(page, 0)
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        rc = lib.gamer_march_progressive(
            page0.data_ptr(), page0.numel(), table.data_ptr(), table.numel(),
            noise.data_ptr(), out.data_ptr(), int(frame_size), int(band_rows),
            int(n_bands), kind, grid, counters.data_ptr(), flags.data_ptr(),
            abort.data_ptr(), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"progressive march launch failed: CUDA error "
                           f"{rc} ({lib.gamer_error_string(rc).decode()})")
    end = torch.cuda.Event()
    end.record(stream)
    KIND_LAUNCHES[NOISE_KINDS[kind]] += 1
    return ProgressiveLaunch(out, band_rows, flags, abort, counters, end)


march.launch_count = 0
march_band.launch_count = 0
march_batch.launch_count = 0
march_rays.launch_count = 0
march_progressive.launch_count = 0
# launches of each kind's instantiation, over all five wrappers
KIND_LAUNCHES = dict.fromkeys(NOISE_KINDS, 0)


# ---------------------------------------------------------------------------
# the sharded launches: one launch per mesh entry, then a gather
# ---------------------------------------------------------------------------


def slab_rows(size: int, n: int) -> int:
    """Rows of one of ``n`` row slabs of a ``size``-row frame, as
    ``_compiled_rowshard`` cuts them (pallas_render.py:1157-1160): every
    entry gets the same whole number of tile heights, so a slab here is the
    same set of rows as a slab there."""
    tr = _tile_rows(size)
    return -(-size // (n * tr)) * tr


def _check_mesh(mesh, dims: tuple) -> None:
    if len(mesh.axis_names) not in dims:
        raise ValueError(f"need a {'- or '.join(str(d) for d in dims)}-D "
                         f"mesh, got axes {mesh.axis_names}")


def _replicas(mesh, pages: torch.Tensor, table: torch.Tensor) -> list:
    """(pages, table) on each mesh entry's device: one copy per distinct
    device, shared by the entries that repeat it. The table keeps the note
    of its noise kind, so that no launch reads it back. The kind's lookup
    table is brought to each device here, on the caller's stream, which
    every entry's stream waits for before it launches."""
    kind = _table_kind(table)
    per_device = {}
    for dev in mesh.devices:
        if dev not in per_device:
            tb = table.to(dev)
            tb.noise_kind = kind
            noise_table(NOISE_KINDS[kind], dev)
            per_device[dev] = (pages.to(dev), tb)
    return [per_device[dev] for dev in mesh.devices]


@contextlib.contextmanager
def _on_entry(mesh, i: int):
    """Run the body on mesh entry i's device and stream, after the work the
    caller's stream on that device has queued so far (the uploads)."""
    stream = mesh.stream(i)
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


def _gather(dst: torch.Tensor, src: torch.Tensor, mesh, i: int) -> None:
    """Copy entry i's output into its place in the assembled tensor, on the
    caller's streams, after entry i's stream: the output gather XLA inserts
    around a ``shard_map``."""
    stream = mesh.stream(i)
    if stream is not None:
        current = torch.cuda.current_stream(stream.device)
        current.wait_stream(stream)
        src.record_stream(current)
    dst.copy_(src, non_blocking=True)


def _rowshard(band_fn, page, table, size: int, mesh) -> torch.Tensor:
    _check_mesh(mesh, (1,))
    rows_local = slab_rows(size, mesh.size)
    out = torch.empty((size, size, 3), dtype=torch.float32,
                      device=mesh.devices[0])
    slabs = []
    for i, (pg, tb) in enumerate(_replicas(mesh, page, table)):
        row0 = i * rows_local
        if row0 >= size:
            break  # this entry and the ones after it own no row
        rows = min(rows_local, size - row0)
        with _on_entry(mesh, i):
            slabs.append((i, row0, band_fn(pg, tb, size, rows, row0)))
    for i, row0, slab in slabs:
        _gather(out[row0:row0 + slab.shape[0]], slab, mesh, i)
    return out


def march_rowshard_plain(page: torch.Tensor, table: torch.Tensor, size: int,
                         mesh) -> torch.Tensor:
    """S1's function: ``march_band_plain`` per mesh entry on its slab of
    rows, then the same assembly."""
    return _rowshard(march_band_plain, page, table, size, mesh)


def march_rowshard(page: torch.Tensor, table: torch.Tensor, size: int,
                   mesh) -> torch.Tensor:
    """S1, the counterpart of ``_compiled_rowshard``: linear radiance
    (size, size, 3) of one frame whose row slabs are spread over a 1-D
    mesh. Entry i launches ``march_band`` over the rows
    i * slab_rows + [0, slab_rows) on its own device and stream (the last
    slab clipped to the frame, entries past the last row launching
    nothing); the slabs are copied into one frame on the mesh's first
    device. On the card the frame is bit-equal to ``march``'s. CPU tensors
    run ``march_rowshard_plain``; CUDA tensors launch the kernel (each
    launch counted in ``march_rowshard.launch_count``) or raise."""
    if _on_cpu(page, table, 1):
        return march_rowshard_plain(page, table, size, mesh)

    def band(*args):
        out = march_band(*args)
        march_rowshard.launch_count += 1
        return out

    return _rowshard(band, page, table, size, mesh)


def batch_mesh_shape(mesh) -> tuple:
    """(batch entries, row entries) of a mesh that shards a batch: a 1-D
    mesh is all batch; a 2-D mesh must be named ('batch', 'rows')."""
    _check_mesh(mesh, (1, 2))
    if len(mesh.axis_names) == 1:
        return mesh.size, 1
    if set(mesh.axis_names) != {"batch", "rows"}:
        raise ValueError(
            f"2-D batch mesh must have axes ('batch', 'rows'), got "
            f"{mesh.axis_names} — use parallel.pixel_tile_mesh_2d")
    return mesh.axis_size("batch"), mesh.axis_size("rows")


def _batch_rowshard(batch_fn, pages, table, size: int, mesh) -> torch.Tensor:
    n_b, n_r = batch_mesh_shape(mesh)
    if len(mesh.axis_names) == 2:
        entry = mesh.index
    else:
        def entry(batch, rows):
            return batch
    n_frames = pages.shape[0]
    if n_frames % n_b:
        raise ValueError(f"{n_frames} pages do not tile the mesh's {n_b} "
                         f"batch entries: pad the stack")
    per = n_frames // n_b
    rows_local = slab_rows(size, n_r) if n_r > 1 else size
    out = torch.empty((n_frames, size, size, 3), dtype=torch.float32,
                      device=mesh.devices[0])
    replicas = _replicas(mesh, pages, table)
    slabs = []
    for b in range(n_b):
        for r in range(n_r):
            row0 = r * rows_local
            if row0 >= size:
                break
            rows = min(rows_local, size - row0)
            i = entry(batch=b, rows=r)
            pg, tb = replicas[i]
            with _on_entry(mesh, i):
                slabs.append((i, b, row0, batch_fn(
                    pg[b * per:(b + 1) * per], tb, size, rows=rows,
                    row0=row0)))
    for i, b, row0, slab in slabs:
        _gather(out[b * per:(b + 1) * per, row0:row0 + slab.shape[1]], slab,
                mesh, i)
    return out


def march_batch_rowshard_plain(pages: torch.Tensor, table: torch.Tensor,
                               size: int, mesh) -> torch.Tensor:
    """S2's function: ``march_batch_plain`` per mesh entry on its frames
    (and row slab), then the same assembly."""
    return _batch_rowshard(march_batch_plain, pages, table, size, mesh)


def march_batch_rowshard(pages: torch.Tensor, table: torch.Tensor, size: int,
                         mesh) -> torch.Tensor:
    """S2, the counterpart of ``_compiled_batch_rowshard`` and of the 1-D
    batch ``shard_map`` of ``engine/batch.py``: linear radiance
    (B, size, size, 3) of a page stack spread over a mesh. On a 1-D mesh of
    n entries, entry i launches ``march_batch`` on the pages
    i * B/n + [0, B/n); on a ('batch', 'rows') mesh each batch entry's
    frames are also cut into row slabs over 'rows', the row offset written
    into every page of the entry's stack. B must be a multiple of the batch
    entries (the caller pads). On the card every frame is bit-equal to
    ``march_batch``'s. CPU tensors run ``march_batch_rowshard_plain``; CUDA
    tensors launch the kernel (each launch counted in
    ``march_batch_rowshard.launch_count``) or raise."""
    if _on_cpu(pages, table, 2):
        return march_batch_rowshard_plain(pages, table, size, mesh)

    def batch(*args, **kwargs):
        out = march_batch(*args, **kwargs)
        march_batch_rowshard.launch_count += 1
        return out

    return _batch_rowshard(batch, pages, table, size, mesh)


def _rays_rowshard(rays_fn, page, table, dirs, mesh) -> torch.Tensor:
    _check_mesh(mesh, (1,))
    n_rays = dirs.shape[0]
    block = -(-n_rays // mesh.size)
    out = torch.empty((n_rays, 3), dtype=torch.float32,
                      device=mesh.devices[0])
    blocks = []
    for i, (pg, tb) in enumerate(_replicas(mesh, page, table)):
        start = i * block
        if start >= n_rays:
            break
        with _on_entry(mesh, i):
            d = dirs[start:start + block].to(mesh.devices[i])
            blocks.append((i, start, rays_fn(pg, tb, d)))
    for i, start, lin in blocks:
        _gather(out[start:start + lin.shape[0]], lin, mesh, i)
    return out


def march_rays_rowshard_plain(page: torch.Tensor, table: torch.Tensor,
                              dirs: torch.Tensor, mesh) -> torch.Tensor:
    """S3's function: ``march_rays_plain`` per mesh entry on its block of
    rays, then the same assembly."""
    return _rays_rowshard(march_rays_plain, page, table, dirs, mesh)


def march_rays_rowshard(page: torch.Tensor, table: torch.Tensor,
                        dirs: torch.Tensor, mesh) -> torch.Tensor:
    """S3, the counterpart of ``_compiled_dirs_rowshard``: linear radiance
    (N, 3) of a ray list spread over a 1-D mesh in contiguous blocks of
    ceil(N / n) rays, the tail block short (the kernel's ``i < N`` guard
    stands where the TPU form pads with zero vectors). Entry i launches
    ``march_rays`` on its block, on its own device and stream. On the card
    every ray is bit-equal to ``march_rays``'s. CPU tensors run
    ``march_rays_rowshard_plain``; CUDA tensors launch the kernel (each
    launch counted in ``march_rays_rowshard.launch_count``) or raise."""
    if _on_cpu(page, table, 1):
        return march_rays_rowshard_plain(page, table, dirs, mesh)

    def rays(*args):
        out = march_rays(*args)
        march_rays_rowshard.launch_count += 1
        return out

    return _rays_rowshard(rays, page, table, dirs, mesh)


march_rowshard.launch_count = 0
march_batch_rowshard.launch_count = 0
march_rays_rowshard.launch_count = 0


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch march")
    return dev


def prepare(scene: Scene, device):
    """(page, table, march size, pool factor) for a scene, with page and
    table on ``device``."""
    cfg = scene.config
    _check_march_cap(scene)
    static, params = flatten_scene(scene)
    camera = np.asarray(scene.camera.camera, np.float32)
    inv_vp = inv_view_projection(camera, scene.camera.target, scene.camera.up,
                                 scene.camera.fov)
    lay = _build_layout(static)
    page = _pack_scalars(static, lay, params, camera, inv_vp,
                         cfg.ray_step, cfg.min_ray_step)
    table = _build_table(static, lay)
    ss = cfg.supersample
    return (torch.as_tensor(page, device=device),
            upload_table(table, device), cfg.size * ss, ss)


def mesh_device(mesh) -> torch.device:
    """The device a mesh's output is assembled on: its first entry, checked
    as ``_device`` checks a device argument."""
    return _device(mesh.devices[0])


def render_linear(scene: Scene, device="cuda", mesh=None) -> torch.Tensor:
    """Linear radiance (size, size, 3) float32 on ``device`` (supersampled
    frames pooled in linear space). With ``mesh`` (1-D) the frame's row
    slabs are spread over its entries (S1) and assembled, then pooled, on
    its first device; ``device`` is then not consulted."""
    dev = _device(device) if mesh is None else mesh_device(mesh)
    page, table, size, ss = prepare(scene, dev)
    if mesh is None:
        return pool_linear(march(page, table, size), ss)
    return pool_linear(march_rowshard(page, table, size, mesh), ss)


def render_scene(scene: Scene, device="cuda", device_out: bool = False,
                 mesh=None):
    """A full frame -> (size, size, 3) uint8: march, star overlay and post
    chain, as ``render_scene_pallas``. With ``device_out`` the uint8 tensor
    stays on ``device``; otherwise a numpy array is returned. With ``mesh``
    (a 1-D device mesh) the frame's row slabs are spread over its entries
    and the epilogue runs on its first device; on the card the frame is
    bit-equal to the unsharded one."""
    dev = _device(device) if mesh is None else mesh_device(mesh)
    cfg = scene.config
    lin = render_linear(scene, dev, mesh)
    if cfg.no_stars > 0:
        lin = lin + _star_overlay(cfg, dev)
    img = post_process(lin, f32(cfg.exposure), f32(cfg.gamma),
                       f32(cfg.saturation))
    if device_out:
        return img
    return img.cpu().numpy()


def render_dirs(scene: Scene, dirs, device="cuda", device_out: bool = False,
                mesh=None):
    """Linear radiance (N, 3) float32 for an arbitrary (N, 3) list of ray
    directions from the scene's camera point, in one ray-list launch (K6):
    the counterpart of ``render_dirs_pallas``. The directions are cast to
    float32 and used as given. With ``device_out`` the tensor stays on
    ``device``; otherwise a numpy array is returned. With ``mesh`` (a 1-D
    device mesh) the rays are spread over its entries in contiguous blocks
    (S3) and gathered on its first device."""
    dev = _device(device) if mesh is None else mesh_device(mesh)
    page, table, _, _ = prepare(scene, dev)
    d = torch.as_tensor(
        np.ascontiguousarray(np.asarray(dirs, np.float32).reshape(-1, 3)),
        device=dev)
    if mesh is None:
        lin = march_rays(page, table, d)
    else:
        lin = march_rays_rowshard(page, table, d, mesh)
    if device_out:
        return lin
    return lin.cpu().numpy()


def _star_overlay(cfg, device):
    """The (size, size, 3) star field of a config on ``device``."""
    star_p = pad_star_rows(
        star_params(cfg.size, cfg.no_stars, cfg.star_size,
                    cfg.star_size_spread, cfg.star_strength, cfg.star_seed))
    return star_field_device(star_p, cfg.size, device=device)


class _BandDownload:
    """Brings a finished uint8 frame to the host (the service's fused
    singles). On a CUDA device the copy runs on a side stream into pinned
    memory, after an event on the frame, so that the caller's stream can
    take the next launch meanwhile."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def start(self, band: torch.Tensor):
        if self.stream is None:
            return band, None
        host = torch.empty(band.shape, dtype=band.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(band.device))
        with torch.cuda.stream(self.stream):
            host.copy_(band, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        band.record_stream(self.stream)
        return host, done

    @staticmethod
    def finish(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream of the progressive frames' epilogues on a CUDA device,
    one per device: the caching allocator keeps its blocks between frames,
    where a new stream would allocate anew while the march runs."""
    key = device.index if device.index is not None else (
        torch.cuda.current_device())
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[key]


class _Bands:
    """One scene's progressive frame: its page, table and band geometry, and
    the epilogue of a run of consecutive bands (pooling, their slice of the
    star overlay and the post chain on the device, then the download of
    their uint8 rows). On a CUDA device the epilogue and the download run on
    a side stream into one pinned frame, so they overlap the march."""

    def __init__(self, scene: Scene, bands: int, device: torch.device):
        cfg = scene.config
        self.size = cfg.size
        self.page, self.table, self.S, self.ss = prepare(scene, device)
        self.band_rows, self.n_bands = band_geometry(cfg.size, self.ss, bands)
        self.band_out = self.band_rows // self.ss
        self.post = (f32(cfg.exposure), f32(cfg.gamma), f32(cfg.saturation))
        shape = (self.n_bands * self.band_out, cfg.size, 3)
        self.side = self.staging = None
        if device.type == "cuda":
            self.side = _side_stream(device)
            self.staging = torch.empty(shape, dtype=torch.uint8,
                                       pin_memory=True)
        self.overlay = None
        if cfg.no_stars > 0:
            self.overlay = torch.zeros(shape, dtype=torch.float32,
                                       device=device)
            self.overlay[:cfg.size] = _star_overlay(cfg, device)
            if self.side is not None:
                self.overlay.record_stream(self.side)

    def rows(self, b: int, n: int = 1) -> slice:
        """The output rows of bands b .. b + n - 1."""
        return slice(b * self.band_out, (b + n) * self.band_out)

    def epilogue(self, b: int, n: int, lin: torch.Tensor):
        """Start the epilogue of bands b .. b + n - 1 on their radiance
        ``lin`` (n * band_rows, S, 3); ``finish`` of the result gives their
        uint8 rows. Pooling windows and the post chain are elementwise
        within a band, so a run of bands is bit-equal to its bands one by
        one."""
        if self.side is None:
            return self._uint8(b, n, lin), None
        with torch.cuda.stream(self.side):
            img = self._uint8(b, n, lin)
            host = self.staging[self.rows(b, n)]
            host.copy_(img, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        return host, done

    def _uint8(self, b, n, lin):
        lin = pool_linear(lin, self.ss)
        if self.overlay is not None:
            lin = lin + self.overlay[self.rows(b, n)]
        return post_process(lin, *self.post)

    @staticmethod
    def finish(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()


class _PlainBands:
    """The bands of a frame on the CPU, one after another through the plain
    march: band b is marched when the host asks for it."""

    def __init__(self, bands: _Bands):
        self.plan = bands
        self.lin = None

    def wait(self, b: int) -> int:
        p = self.plan
        self.lin = march_band_plain(p.page, p.table, p.S, p.band_rows,
                                    b * p.band_rows)
        return 1

    def bands(self, b: int, n: int) -> torch.Tensor:
        return self.lin

    def stop(self) -> None:
        pass


def _launch_bands(plan: _Bands) -> ProgressiveLaunch:
    """The plan's frame as one progressive launch on the current stream of
    its device. The side stream waits for an event recorded on that stream
    just before the launch (the page, the star overlay), never for the
    launch itself."""
    stream = torch.cuda.current_stream(plan.page.device)
    before = torch.cuda.Event()
    before.record(stream)
    launch = march_progressive(plan.page, plan.table, plan.S,
                               plan.band_rows, plan.n_bands)
    try:
        plan.side.wait_event(before)
        launch.out.record_stream(plan.side)
    except BaseException:
        launch.stop()
        raise
    return launch


def _band_loop(plan: _Bands, source, on_progress) -> np.ndarray:
    """render_progressive's host side over a source of finished bands
    (``wait(b)``: how many consecutive bands from b on are finished, at
    least 1; ``bands(b, n)``: the radiance of bands b .. b + n - 1;
    ``stop()``: end the march and wait for it). Each run of finished bands
    gets one epilogue; then the bands tick in order, one
    ``on_progress((b + 1) / n_bands, partial)`` each, however many finished
    between two waits. ``False`` from on_progress returns the partial frame
    (bands 0..b, black below). The source is stopped on every exit."""
    n_bands, size = plan.n_bands, plan.size
    out = np.zeros((n_bands * plan.band_out, size, 3), np.uint8)
    try:
        b = 0
        while b < n_bands:
            n = source.wait(b)
            out[plan.rows(b, n)] = plan.finish(
                plan.epilogue(b, n, source.bands(b, n)))
            for k in range(b, b + n):
                if on_progress is not None:
                    partial = out[:size].copy()
                    partial[plan.rows(k + 1, n_bands)] = 0  # later bands
                    if on_progress((k + 1) / n_bands, partial) is False:
                        return partial
            b += n
        return out[:size]
    finally:
        source.stop()


def render_progressive(scene: Scene, bands: int = 16, on_progress=None,
                       device="cuda") -> np.ndarray:
    """The frame in row bands with percent-done callbacks and cooperative
    abort: the counterpart of ``render_progressive_pallas`` (the reference's
    progress and abort, rasterizer.cpp:283-313, rasterizer.h:91-98).

    ``on_progress(frac, partial_uint8) -> False`` aborts; the partially
    filled frame (rows not yet rendered are black) is returned. Each band is
    pooled, gets its slice of the star overlay and runs the post chain on
    the device, so only uint8 rows come down. On the card the whole frame
    is one progressive launch (``march_progressive``, K5): each band's
    epilogue and tick follow its flag while later bands are marched, in
    band order, one tick per band; an abort stops the launch within a tile.
    On the CPU the bands run one after another through the plain march. On
    the card the frame is bit-equal to ``render_scene``'s."""
    dev = _device(device)
    plan = _Bands(scene, bands, dev)
    source = (_PlainBands(plan) if dev.type == "cpu"
              else _launch_bands(plan))
    return _band_loop(plan, source, on_progress)
