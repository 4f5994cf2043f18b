"""Galaxy morphing: parameter interpolation between two galaxies.

The scene architecture separates compile-time STRUCTURE (component class
ids, arm ladder, noise flags — scene_prep.SceneStatic) from traced numeric
parameters, so any two galaxies with the same structure live on a common
parameter manifold and every point between them is renderable by the SAME
compiled kernel. A morph is therefore just a batch of interpolated
parameter rows — one Pallas launch for the whole animation
(engine/batch.render_batch), something the reference could only do as a
sequence of full re-renders through its frame queue (renderqueue.cpp:63-87).

Spectra are by-name in the schema; a morph resolves both endpoints' colors
and interpolates in RGB, registering per-component ``morph:<i>`` entries in
each frame's spectra table.

A copy of ``gamer_tpu.scene.morph``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

from .schema import CID_STARS_SMALL, GalaxyData, Scene
from .spectra import find_spectrum

# ComponentParams / GalaxyParams numeric fields that interpolate. `active`
# and the structural flags must match between endpoints instead.
_COMP_LERP = ("strength", "arm", "z0", "r0", "inner", "delta", "winding",
              "scale", "noise_offset", "noise_tilt", "ks")
_GAL_LERP = ("winding_b", "winding_n", "arm1", "arm2", "arm3", "arm4",
             "bulge_dust", "inner_twirl", "warp_amplitude", "warp_scale")


def _morph_comps(g: GalaxyData, deterministic: bool = False):
    """The components scene_prep.flatten_scene would compile: active, known
    class, and — in deterministic mode — no 'stars small' (which
    flatten_scene drops, so it cannot block morph compatibility there)."""
    return [
        c for c in g.components
        if c.active == 1 and c.cid >= 0
        and not (deterministic and c.cid == CID_STARS_SMALL)
    ]


def _structure_error(a: GalaxyData, b: GalaxyData,
                     deterministic: bool = False) -> Optional[str]:
    """Why a and b cannot share one compiled kernel (None if they can).

    Mirrors the static fields of scene_prep.CompStatic/_arm_ladder_count:
    anything that changes the compiled component dispatch must agree.
    """
    ca = _morph_comps(a, deterministic)
    cb = _morph_comps(b, deterministic)
    if len(ca) != len(cb):
        return f"component counts differ ({len(ca)} vs {len(cb)})"
    for i, (x, y) in enumerate(zip(ca, cb)):
        if x.cid != y.cid:
            return f"component {i} class differs ({x.class_name} vs {y.class_name})"
        # On/off AND sign must agree: a sign change interpolates through
        # exactly 0 mid-animation (e.g. 0.2 -> -0.2 at t=0.5), which would
        # flip the compiled structure flag for that frame.
        if (x.arm > 0) != (y.arm > 0) or (x.arm < 0) != (y.arm < 0):
            return f"component {i} arm modulation on/off or sign differs"
        if (x.winding > 0) != (y.winding > 0) or (x.winding < 0) != (y.winding < 0):
            return f"component {i} winding on/off or sign differs"
        if x.cid == 5 and ((x.noise_offset > 0) != (y.noise_offset > 0)
                           or (x.noise_offset < 0) != (y.noise_offset < 0)):
            return f"component {i} star extra-cloud on/off or sign differs"
    la = 1 if a.params.no_arms == 1 else 2 if a.params.no_arms == 2 else \
        3 if a.params.no_arms == 3 else 4
    lb = 1 if b.params.no_arms == 1 else 2 if b.params.no_arms == 2 else \
        3 if b.params.no_arms == 3 else 4
    if la != lb:
        return f"arm ladder counts differ ({la} vs {lb})"
    return None


def lerp_galaxy(a: GalaxyData, b: GalaxyData, t: float,
                deterministic: bool = False) -> GalaxyData:
    """Interpolate every numeric knob of two structure-compatible galaxies.

    t=0 returns a's values exactly, t=1 b's. Spectrum names are kept from
    ``a`` (use morph_scenes for RGB-interpolated colors). With
    ``deterministic``, 'stars small' components are ignored for
    compatibility and interpolation, matching flatten_scene's exclusion.
    """
    err = _structure_error(a, b, deterministic)
    if err is not None:
        raise ValueError(f"galaxies are not morph-compatible: {err}")
    out = copy.deepcopy(a)
    t = float(t)

    def lerp(x, y):
        return x + t * (y - x)

    for f in _GAL_LERP:
        setattr(out.params, f, lerp(getattr(a.params, f), getattr(b.params, f)))
    out.params.axis = tuple(
        lerp(x, y) for x, y in zip(a.params.axis, b.params.axis)
    )
    ca = _morph_comps(a, deterministic)
    cb = _morph_comps(b, deterministic)
    co = _morph_comps(out, deterministic)
    for x, y, o in zip(ca, cb, co):
        for f in _COMP_LERP:
            setattr(o, f, lerp(getattr(x, f), getattr(y, f)))
    return out


def morph_scenes(scene: Scene, target: GalaxyData, frames: int,
                 ease: str = "smoothstep") -> List[Scene]:
    """Scenes interpolating scene's (single) galaxy toward ``target``.

    Returns ``frames`` scenes from t=0 (the scene's galaxy) to t=1
    (``target``), each with per-component RGB-interpolated spectra, all
    sharing one compiled structure — feed directly to
    engine.batch.render_batch for a one-launch animation.
    """
    if len(scene.instances) != 1:
        raise ValueError("morph_scenes expects a single-instance scene")
    if frames < 2:
        raise ValueError("need at least 2 frames")
    deterministic = bool(scene.config.deterministic)
    a = scene.instances[0].galaxy
    err = _structure_error(a, target, deterministic)
    if err is not None:
        raise ValueError(f"galaxies are not morph-compatible: {err}")

    ca = _morph_comps(a, deterministic)
    cb = _morph_comps(target, deterministic)
    spec_a = [find_spectrum(c.spectrum, scene.spectra) for c in ca]
    spec_b = [find_spectrum(c.spectrum, scene.spectra) for c in cb]

    out: List[Scene] = []
    for k in range(frames):
        t = k / (frames - 1)
        if ease == "smoothstep":
            t = t * t * (3.0 - 2.0 * t)
        elif ease != "linear":
            raise ValueError(f"unknown ease {ease!r}")
        g = lerp_galaxy(a, target, t, deterministic)
        spectra = dict(scene.spectra) if scene.spectra else {}
        gc = _morph_comps(g, deterministic)
        for i, (c, sa, sb) in enumerate(zip(gc, spec_a, spec_b)):
            spectra[f"morph:{i}"] = tuple(
                x + t * (y - x) for x, y in zip(sa, sb)
            )
            c.spectrum = f"morph:{i}"
        out.append(dataclasses.replace(
            scene,
            instances=[dataclasses.replace(scene.instances[0], galaxy=g)],
            spectra=spectra,
        ))
    return out
