"""RenderParams.dat reader/writer — RenderingParams persistence parity.

QDataStream Qt_5_6 layout (renderingparams.h:41-63, gamercamera.h:31-40,
spectrum.h:23-31,74-93):

  camera (3x QVector3D + perspective double)
  size i32, previewSize i32, exposure f64, gamma f64, saturation f64,
  detailLevel f64, noiseDetail f64, noStars i32, starSize f64,
  starSizeSpread f64, starStrength f64, rayStep f64,
  galaxyDirectory QString, sceneDirectory QString, currentGalaxy QString,
  sceneMode QString, imageDirectory QString,
  spectra: QVector<ComponentSpectrum {name QString, spectrum QVector3D}>,
  nside i32, renderType QString

Maps to the scene-dict world: camera -> CameraParams, knobs -> RenderConfig,
spectra -> the scene spectra table, directories kept verbatim.

A copy of ``gamer_tpu.io.renderparams``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Tuple, Union

from ..scene.gax import _Reader, _Writer
from ..scene.schema import CameraParams, RenderConfig

Vec3 = Tuple[float, float, float]


@dataclass
class RenderParamsFile:
    camera: CameraParams = field(default_factory=CameraParams)
    size: int = 128
    preview_size: int = 64
    exposure: float = 1.0
    gamma: float = 1.0
    saturation: float = 1.0
    detail_level: float = 0.01
    noise_detail: float = 1.0
    no_stars: int = 0
    star_size: float = 1.0
    star_size_spread: float = 1.0
    star_strength: float = 1.0
    ray_step: float = 0.001
    galaxy_directory: str = "galaxies/"
    scene_directory: str = "scenes/"
    current_galaxy: str = ""
    scene_mode: str = "galaxy"
    image_directory: str = "images/"
    spectra: Dict[str, Vec3] = field(default_factory=dict)
    nside: int = 32
    render_type: str = ""

    # -- conversion -------------------------------------------------------

    def to_render_config(self, size: int = 0, is_preview: bool = False) -> RenderConfig:
        return RenderConfig(
            size=size or self.size,
            ray_step=self.ray_step,
            exposure=self.exposure,
            gamma=self.gamma,
            saturation=self.saturation,
            is_preview=is_preview,
            no_stars=self.no_stars,
            star_size=self.star_size,
            star_size_spread=self.star_size_spread,
            star_strength=self.star_strength,
        )

    # -- QDataStream codec --------------------------------------------------

    @classmethod
    def loads(cls, data: bytes) -> "RenderParamsFile":
        r = _Reader(data)
        cam = CameraParams(camera=r.vec3(), target=r.vec3(), up=r.vec3(), fov=r.f64())
        out = cls(camera=cam)
        out.size = r.i32()
        out.preview_size = r.i32()
        out.exposure = r.f64()
        out.gamma = r.f64()
        out.saturation = r.f64()
        out.detail_level = r.f64()
        out.noise_detail = r.f64()
        out.no_stars = r.i32()
        out.star_size = r.f64()
        out.star_size_spread = r.f64()
        out.star_strength = r.f64()
        out.ray_step = r.f64()
        out.galaxy_directory = r.qstring()
        out.scene_directory = r.qstring()
        out.current_galaxy = r.qstring()
        out.scene_mode = r.qstring()
        out.image_directory = r.qstring()
        n = r.u32()
        if n > 4096:
            raise ValueError(f"implausible spectra count {n}")
        for _ in range(n):
            name = r.qstring()
            out.spectra[name] = r.vec3()
        # nside/renderType were appended later; older files end at spectra
        # (the reference's operator>> would zero-fill on a short read).
        if not r.exhausted:
            out.nside = r.i32()
            out.render_type = r.qstring()
        return out

    def dumps(self) -> bytes:
        w = _Writer()
        w.vec3(self.camera.camera)
        w.vec3(self.camera.target)
        w.vec3(self.camera.up)
        w.f64(self.camera.fov)
        w.i32(self.size)
        w.i32(self.preview_size)
        w.f64(self.exposure)
        w.f64(self.gamma)
        w.f64(self.saturation)
        w.f64(self.detail_level)
        w.f64(self.noise_detail)
        w.i32(self.no_stars)
        w.f64(self.star_size)
        w.f64(self.star_size_spread)
        w.f64(self.star_strength)
        w.f64(self.ray_step)
        w.qstring(self.galaxy_directory)
        w.qstring(self.scene_directory)
        w.qstring(self.current_galaxy)
        w.qstring(self.scene_mode)
        w.qstring(self.image_directory)
        w.i32(len(self.spectra))
        for name, vec in self.spectra.items():
            w.qstring(name)
            w.vec3(vec)
        w.i32(self.nside)
        w.qstring(self.render_type)
        return w.getvalue()

    @classmethod
    def load(cls, path: Union[str, Path]) -> "RenderParamsFile":
        return cls.loads(Path(path).read_bytes())

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_bytes(self.dumps())
