"""Scene / parameter model: schema dataclasses and their dict form."""

from .schema import (  # noqa: F401
    CameraParams,
    ComponentParams,
    GalaxyData,
    GalaxyInstance,
    GalaxyParams,
    RenderConfig,
    Scene,
    default_galaxy,
    galaxy_from_dict,
    scene_from_dict,
    scene_to_dict,
)
