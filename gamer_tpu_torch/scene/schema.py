"""Scene / parameter model: the dataclasses a scene is made of, and their
JSON-friendly dict form.

Field for field the model of ``gamer_tpu.scene.schema`` (the reference's
Qt parameter classes: galaxyparams.h:10-43, componentparams.h:7-59,
galaxyinstance.h, gamercamera.h:25-28, renderingparams.h:19-39), with the
same defaults, the same validation and the same dict layout, so a scene
dict renders identically in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Vec3 = Tuple[float, float, float]

# Component class ids, in reference registry order (galaxy.cpp:15-42).
CID_BULGE = 0
CID_DISK = 1
CID_DUST = 2
CID_DUST2 = 3
CID_DUST_POSITIVE = 4
CID_STARS = 5
CID_STARS_SMALL = 6
CID_NONE = -1

CLASS_NAME_TO_CID: Dict[str, int] = {
    "bulge": CID_BULGE,
    "disk": CID_DISK,
    "dust": CID_DUST,
    "dust2": CID_DUST2,
    "dust positive": CID_DUST_POSITIVE,
    "stars": CID_STARS,
    "stars small": CID_STARS_SMALL,
}


def class_name_to_cid(name: str) -> int:
    """Integer id of a component class name; unknown names give CID_NONE
    (the reference skips classes it does not know)."""
    return CLASS_NAME_TO_CID.get(name.lower(), CID_NONE)


@dataclass
class GalaxyParams:
    """Galaxy-wide shape: the winding law theta(r) = atan(exp(-0.25 /
    (0.5 (r + 0.05))) / winding_b) * 2 winding_n, the arm count (exactly
    1, 2 or 3, anything else enables all 4), per-arm phases and the
    ellipsoid semi-axes. bulge_dust, bulge_axis, inner_twirl and warp_*
    are carried for .gax parity and unused by the shading."""

    name: str = "NewGalaxy"
    axis: Vec3 = (1.0, 1.0, 1.0)
    bulge_dust: float = 0.025
    bulge_axis: Vec3 = (1.0, 1.0, 1.0)
    winding_b: float = 0.5
    winding_n: float = 4.0
    no_arms: float = 2.0
    arm1: float = 0.0
    arm2: float = math.pi
    arm3: float = 2.0 * math.pi
    arm4: float = 3.0 * math.pi
    inner_twirl: float = 0.0
    warp_amplitude: float = 0.0
    warp_scale: float = 0.0


@dataclass
class ComponentParams:
    """One component: emission (bulge, disk, stars, stars small) or
    absorption (dust, dust2; dust positive emits). ``active == 1`` renders
    it; ``arm == 0`` and ``winding == 0`` switch off arm modulation and
    noise twirl."""

    class_name: str = "bulge"
    spectrum: str = "White"
    name: str = "New component"
    strength: float = 1.0
    arm: float = 1.0
    z0: float = 0.02
    r0: float = 0.5
    inner: float = 0.0
    active: float = 1.0
    delta: float = 0.0
    winding: float = 0.1
    scale: float = 1.0
    noise_offset: float = 0.0
    noise_tilt: float = 1.0
    ks: float = 1.0

    @property
    def cid(self) -> int:
        return class_name_to_cid(self.class_name)


@dataclass
class GalaxyData:
    """A galaxy definition: params and the ordered component list."""

    display_name: str = ""
    params: GalaxyParams = field(default_factory=GalaxyParams)
    components: List[ComponentParams] = field(default_factory=list)


@dataclass
class GalaxyInstance:
    """A galaxy placed in the scene (``redshift`` is kept, unused)."""

    galaxy: GalaxyData
    position: Vec3 = (0.0, 0.0, 0.0)
    orientation: Vec3 = (0.0, 1.0, 0.0)
    intensity_scale: float = 1.0
    redshift: float = 0.0
    name: str = ""


@dataclass
class CameraParams:
    """Camera position, target, up vector and vertical fov in degrees."""

    camera: Vec3 = (0.0, 0.0, -5.0)
    target: Vec3 = (0.0, 0.0, 0.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    fov: float = 70.0


@dataclass
class RenderConfig:
    """Rendering knobs. ``no_stars > 0`` adds the seeded star overlay;
    ``deterministic`` drops 'stars small'; ``noise_octaves`` caps every
    fractal's octaves (None: the reference's counts); ``supersample``
    renders at size*supersample and pools the linear radiance; ``dither``
    offsets each ray's march start by a hash of its direction;
    ``noise_kind`` picks the raw noise (this package marches simplex)."""

    size: int = 128
    ray_step: float = 0.001
    exposure: float = 1.0
    gamma: float = 1.0
    saturation: float = 1.0
    is_preview: bool = False
    no_stars: int = 0
    star_size: float = 1.0
    star_size_spread: float = 1.0
    star_strength: float = 1.0
    star_seed: int = 0
    deterministic: bool = True
    noise_octaves: Optional[int] = None
    supersample: int = 1
    dither: bool = False
    noise_kind: str = "simplex"

    def __post_init__(self):
        if self.noise_kind not in ("simplex", "perlin", "iq"):
            raise ValueError(
                f"noise_kind must be 'simplex', 'perlin' or 'iq', "
                f"got {self.noise_kind!r}"
            )
        if self.noise_octaves is not None:
            if self.noise_octaves != int(self.noise_octaves) \
                    or int(self.noise_octaves) < 1:
                raise ValueError(
                    f"noise_octaves must be an int >= 1 or None, "
                    f"got {self.noise_octaves!r}"
                )
            self.noise_octaves = int(self.noise_octaves)
        if self.supersample != int(self.supersample) or int(self.supersample) < 1:
            raise ValueError(
                f"supersample must be an int >= 1, got {self.supersample!r}"
            )
        self.supersample = int(self.supersample)

    @property
    def min_ray_step(self) -> float:
        """0.01 for previews, 0.001 for full renders (rasterizer.cpp:437-442)."""
        return 0.01 if self.is_preview else 0.001


@dataclass
class Scene:
    """Camera, instances and render config; ``spectra`` None: built-ins."""

    camera: CameraParams = field(default_factory=CameraParams)
    instances: List[GalaxyInstance] = field(default_factory=list)
    config: RenderConfig = field(default_factory=RenderConfig)
    spectra: Optional[Dict[str, Vec3]] = None


# ---------------------------------------------------------------------------
# dict <-> dataclass
# ---------------------------------------------------------------------------


def _to_dict(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_dict(v) for k, v in obj.items()}
    return obj


def scene_to_dict(scene: Scene) -> dict:
    return _to_dict(scene)


def galaxy_to_dict(galaxy: GalaxyData) -> dict:
    return _to_dict(galaxy)


def _vec3(v: Sequence[float]) -> Vec3:
    return (float(v[0]), float(v[1]), float(v[2]))


# coercion of a dict value by its field's annotation
_COERCE = {
    "float": float,
    "int": int,
    "bool": bool,
    "str": str,
    "Vec3": _vec3,
    "Optional[int]": lambda v: None if v is None else int(v),
}


def _scalars(cls, d: dict) -> dict:
    """Keyword arguments for ``cls`` from the scalar fields present in
    ``d``, each coerced to its annotated type; absent fields keep the
    dataclass default."""
    return {f.name: _COERCE[f.type](d[f.name])
            for f in dataclasses.fields(cls)
            if f.type in _COERCE and f.name in d}


def galaxy_from_dict(d: dict) -> GalaxyData:
    return GalaxyData(
        display_name=d.get("display_name", ""),
        params=GalaxyParams(**_scalars(GalaxyParams, d.get("params", {}))),
        components=[ComponentParams(**_scalars(ComponentParams, c))
                    for c in d.get("components", [])],
    )


def scene_from_dict(d: dict) -> Scene:
    spectra = d.get("spectra")
    return Scene(
        camera=CameraParams(**_scalars(CameraParams, d.get("camera", {}))),
        instances=[
            GalaxyInstance(galaxy=galaxy_from_dict(i["galaxy"]),
                           **_scalars(GalaxyInstance, i))
            for i in d.get("instances", [])
        ],
        config=RenderConfig(**_scalars(RenderConfig, d.get("config", {}))),
        spectra={k: _vec3(v) for k, v in spectra.items()} if spectra else None,
    )


def default_galaxy(component_count: int = 3) -> GalaxyData:
    """The reference's default galaxy template (galaxy.cpp:111-154)."""
    comps: List[ComponentParams] = [
        ComponentParams(class_name="bulge", strength=30.0, r0=5.0,
                        spectrum="Yellow", name="Yellow bulge")
    ]
    if component_count > 1:
        comps.append(ComponentParams(
            class_name="disk", strength=900.0, r0=0.4, arm=0.3,
            noise_tilt=0.3, spectrum="Blue", scale=1.0, name="Blue disk"))
    if component_count > 2:
        comps.append(ComponentParams(
            class_name="dust2", strength=250.0, r0=0.45, arm=0.25, z0=0.02,
            noise_tilt=1.0, noise_offset=1.0, spectrum="Blue", scale=3.0,
            name="Red dust"))
    return GalaxyData(display_name="NewGalaxy", params=GalaxyParams(),
                      components=comps)
