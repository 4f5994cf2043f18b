"""Parametric galaxy families over the reference's component vocabulary:
the seven recipes of ``gamer_tpu.models.presets``, value for value, and
its loader of the reference's bundled ``.gax`` galaxies.

  spiral / barred_spiral / elliptical / irregular / dusty_disk / ring /
  flocculent
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import List

from ..scene import gax
from ..scene.schema import ComponentParams, GalaxyData, GalaxyParams

# where the reference's publish/data/galaxies/*.gax are, when a checkout of
# the reference is at hand: $GAMER_FIXTURE_DIR, else the path below relative
# to the working directory
FIXTURE_DIR = Path(os.environ.get("GAMER_FIXTURE_DIR",
                                  "reference/publish/data/galaxies"))


def fixture_names() -> List[str]:
    if not FIXTURE_DIR.is_dir():
        return []
    return sorted(p.stem for p in FIXTURE_DIR.glob("*.gax"))


def fixture(name: str) -> GalaxyData:
    """Load one of the reference's bundled galaxies (when at hand)."""
    path = FIXTURE_DIR / f"{name}.gax"
    if not path.exists():
        raise FileNotFoundError(f"fixture {name!r} not found under {FIXTURE_DIR}")
    return gax.load(path)


def spiral(arms: int = 2, winding_n: float = 4.0, winding_b: float = 0.5,
           arm_tightness: float = 0.3, dust: float = 1.0,
           name: str = "Spiral") -> GalaxyData:
    """A grand-design spiral: yellow bulge, blue arms, dust lanes along the
    arms and a stellar speckle layer."""
    params = GalaxyParams(
        name=name, winding_b=winding_b, winding_n=winding_n,
        no_arms=float(arms),
        arm1=0.0, arm2=math.pi, arm3=math.pi / 2, arm4=3 * math.pi / 2,
    )
    comps = [
        ComponentParams(class_name="bulge", spectrum="Yellow", name="bulge",
                        strength=25.0, r0=5.0),
        ComponentParams(class_name="disk", spectrum="Blue", name="arms",
                        strength=900.0, r0=0.4, z0=0.02, arm=arm_tightness,
                        winding=1.0, scale=1.0, ks=0.5, noise_tilt=0.3),
        ComponentParams(class_name="disk", spectrum="Yellow", name="inner disk",
                        strength=350.0, r0=0.3, z0=0.03, arm=0.08,
                        winding=1.0, scale=0.7, ks=0.5, noise_tilt=0.4),
        ComponentParams(class_name="dust2", spectrum="Blue", name="dust lanes",
                        strength=250.0 * dust, r0=0.45, z0=0.02,
                        arm=arm_tightness * 0.8, winding=1.0, scale=3.0,
                        ks=1.0, noise_offset=1.0, noise_tilt=1.0),
        ComponentParams(class_name="stars", spectrum="White", name="speckle",
                        strength=80.0, r0=0.5, z0=0.05, arm=0.1, winding=1.0,
                        scale=2.0, ks=0.6, noise_tilt=2.0),
    ]
    return GalaxyData(display_name=name, params=params, components=comps)


def barred_spiral(name: str = "BarredSpiral") -> GalaxyData:
    """An elongated inner bar plus two loosely wound arms."""
    g = spiral(arms=2, winding_n=2.5, winding_b=0.8, arm_tightness=0.45,
               name=name)
    g.components.insert(1, ComponentParams(
        class_name="disk", spectrum="Red", name="bar",
        strength=600.0, r0=0.18, z0=0.035, arm=0.9, winding=0.15,
        scale=0.8, ks=0.5, noise_tilt=0.5))
    return g


def elliptical(name: str = "Elliptical", extent: float = 4.0) -> GalaxyData:
    """A smooth spheroid: bulge light and faint halo speckle only."""
    params = GalaxyParams(name=name, no_arms=1.0)
    comps = [
        ComponentParams(class_name="bulge", spectrum="Red", name="core",
                        strength=45.0, r0=extent),
        ComponentParams(class_name="bulge", spectrum="Yellow", name="halo",
                        strength=12.0, r0=extent * 2.0),
        ComponentParams(class_name="stars", spectrum="Yellow", name="halo stars",
                        strength=25.0, r0=0.8, z0=0.8, arm=0.0,
                        scale=2.5, ks=0.6, noise_tilt=2.5),
    ]
    return GalaxyData(display_name=name, params=params, components=comps)


def irregular(name: str = "Irregular", seed_phase: float = 1.3) -> GalaxyData:
    """A clumpy irregular: no coherent arms, patchy emission, ragged dust."""
    params = GalaxyParams(
        name=name, winding_b=0.25, winding_n=6.0, no_arms=4.0,
        arm1=seed_phase, arm2=seed_phase + 2.0, arm3=seed_phase + 3.5,
        arm4=seed_phase + 5.2,
    )
    comps = [
        ComponentParams(class_name="disk", spectrum="Cyan", name="clumps",
                        strength=1100.0, r0=0.5, z0=0.07, arm=0.12,
                        winding=0.6, scale=1.6, ks=0.65, noise_tilt=0.25),
        ComponentParams(class_name="bulge", spectrum="White", name="glow",
                        strength=8.0, r0=6.0),
        ComponentParams(class_name="dust2", spectrum="Cyan", name="ragged dust",
                        strength=200.0, r0=0.5, z0=0.06, arm=0.1, winding=0.5,
                        scale=2.2, ks=1.2, noise_offset=1.0, noise_tilt=1.0),
        ComponentParams(class_name="stars", spectrum="Blue", name="ob stars",
                        strength=140.0, r0=0.5, z0=0.1, arm=0.05, winding=0.3,
                        scale=1.2, ks=0.7, noise_tilt=3.0),
    ]
    return GalaxyData(display_name=name, params=params, components=comps)


def dusty_disk(name: str = "DustyDisk") -> GalaxyData:
    """Sombrero-like: bright spheroid and a thin disk under an opaque dust
    lane, with a 'dust positive' rim glow."""
    params = GalaxyParams(name=name, winding_b=0.9, winding_n=1.5, no_arms=1.0)
    comps = [
        ComponentParams(class_name="bulge", spectrum="Yellow", name="spheroid",
                        strength=40.0, r0=4.0),
        ComponentParams(class_name="disk", spectrum="Yellow", name="thin disk",
                        strength=500.0, r0=0.45, z0=0.012, arm=0.0,
                        scale=1.0, ks=0.5, noise_tilt=0.4),
        ComponentParams(class_name="dust2", spectrum="White", name="lane",
                        strength=800.0, r0=0.5, z0=0.012, arm=0.0,
                        scale=2.5, ks=1.5, noise_offset=1.0, noise_tilt=1.2),
        ComponentParams(class_name="dust positive", spectrum="Red", name="rim",
                        strength=60.0, r0=0.5, z0=0.02, arm=0.0,
                        scale=2.5, ks=1.5, noise_offset=1.0, noise_tilt=1.0),
    ]
    return GalaxyData(display_name=name, params=params, components=comps)


def ring(name: str = "Ring") -> GalaxyData:
    """A Hoag-type ring galaxy: a compact core inside a luminous ring cut
    by the ``inner`` cutoff."""
    params = GalaxyParams(name=name, winding_b=0.7, winding_n=1.0, no_arms=1.0)
    comps = [
        ComponentParams(class_name="bulge", spectrum="Yellow", name="core",
                        strength=35.0, r0=7.0),
        ComponentParams(class_name="disk", spectrum="Blue", name="ring",
                        strength=1200.0, r0=1.4, z0=0.03, arm=0.0,
                        inner=0.55, scale=1.2, ks=0.55, noise_tilt=0.35),
        ComponentParams(class_name="dust2", spectrum="Blue", name="ring dust",
                        strength=180.0, r0=1.2, z0=0.03, arm=0.0,
                        inner=0.5, scale=2.0, ks=1.0, noise_offset=1.0,
                        noise_tilt=1.0),
        ComponentParams(class_name="stars", spectrum="White", name="knots",
                        strength=150.0, r0=1.2, z0=0.05, arm=0.0,
                        inner=0.55, scale=1.8, ks=0.7, noise_tilt=3.0),
    ]
    return GalaxyData(display_name=name, params=params, components=comps)


def flocculent(name: str = "Flocculent") -> GalaxyData:
    """A flocculent spiral: four loose arm fragments, strong noise."""
    params = GalaxyParams(
        name=name, winding_b=0.35, winding_n=5.0, no_arms=4.0,
        arm1=0.4, arm2=1.9, arm3=3.5, arm4=5.1,
    )
    comps = [
        ComponentParams(class_name="bulge", spectrum="Yellow", name="bulge",
                        strength=18.0, r0=6.0),
        ComponentParams(class_name="disk", spectrum="Cyan", name="fleece",
                        strength=950.0, r0=0.45, z0=0.025, arm=0.15,
                        winding=0.8, scale=1.8, ks=0.7, noise_tilt=0.22),
        ComponentParams(class_name="dust", spectrum="Cyan", name="haze",
                        strength=120.0, r0=0.5, z0=0.03, arm=0.1,
                        winding=0.6, scale=1.5, ks=0.9, noise_offset=0.3,
                        noise_tilt=1.1),
        ComponentParams(class_name="stars", spectrum="Blue", name="associations",
                        strength=110.0, r0=0.45, z0=0.06, arm=0.08,
                        winding=0.5, scale=1.5, ks=0.65, noise_tilt=2.6),
    ]
    return GalaxyData(display_name=name, params=params, components=comps)


GALLERY = {
    "spiral": spiral,
    "barred_spiral": barred_spiral,
    "elliptical": elliptical,
    "irregular": irregular,
    "dusty_disk": dusty_disk,
    "ring": ring,
    "flocculent": flocculent,
}
