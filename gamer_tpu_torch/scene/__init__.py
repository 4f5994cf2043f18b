"""Scene / parameter model: schema dataclasses, their dict form, .gax IO
and spectra."""

from . import gax  # noqa: F401
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
    galaxy_to_dict,
    scene_from_dict,
    scene_to_dict,
)
from .spectra import (  # noqa: F401
    BUILTIN_SPECTRA,
    DEFAULT_SPECTRUM,
    find_spectrum,
    verify_spectra,
)
