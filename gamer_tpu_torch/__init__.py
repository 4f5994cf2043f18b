"""gamer_tpu_torch — the galaxy renderer in PyTorch, with a hand-written
CUDA march kernel for NVIDIA Hopper (sm_90a).

The port of ``gamer_tpu``'s still-frame path: ``render_scene(scene,
device=...)`` returns the same uint8 frame as
``gamer_tpu.engine.pallas_render.render_scene_pallas``. On a CUDA device the
march runs in csrc/march.cu (built with nvcc at first use); on the CPU it
runs the kernel's plain torch version. The package stands alone: it has its
own copy of the scene model, the presets and the star draws, and imports
neither jax nor ``gamer_tpu``.
"""

from .engine.cuda_render import render_linear, render_scene  # noqa: F401
from .scene import (  # noqa: F401
    CameraParams,
    ComponentParams,
    GalaxyData,
    GalaxyInstance,
    GalaxyParams,
    RenderConfig,
    Scene,
    default_galaxy,
    scene_from_dict,
    scene_to_dict,
)

__version__ = "0.1.0"
