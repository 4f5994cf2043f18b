"""gamer_tpu_torch — the galaxy renderer in PyTorch, with a hand-written
CUDA march kernel for NVIDIA Hopper (sm_90a).

The port of ``gamer_tpu``'s still-frame, band, batch and all-sky paths:
``render_scene(scene, device=...)`` returns the same uint8 frame as
``gamer_tpu.engine.pallas_render.render_scene_pallas``;
``render_progressive`` renders it in row bands with progress and abort;
``render_batch`` / ``render_flythrough`` render many frames in one launch
per scene structure, and ``DatasetJob`` renders resumable dataset chunks;
``render_dirs`` marches an explicit list of ray directions, and
``render_allsky_map`` / ``render_allsky_image`` the HEALPix sky around the
camera. Every path takes the three raw-noise backends of
``RenderConfig.noise_kind`` (simplex, perlin, iq), and a ``mesh=`` of
devices (``parallel.Mesh``) over which a frame's row slabs, a batch's
frames or a ray list's blocks are spread. ``RenderService`` / ``serve``
put the paths behind a job queue and an HTTP API. ``engine.fit`` fits
galaxy parameters and camera poses through the XLA-form march in torch
ops (``engine.render``), on a device or a mesh; ``oracle`` is the numpy
spec oracle.
On a CUDA device the march runs in csrc/march.cu (built with nvcc at first
use); on the CPU it runs the kernel's plain torch version. The package
stands alone: it has its own copy of the scene model, the presets, the star
draws and the other JAX-free modules it needs, and imports neither jax nor
``gamer_tpu``.
"""

from .engine.batch import (  # noqa: F401
    render_batch,
    render_batch_linear,
    render_flythrough,
)
from .engine.allsky import (  # noqa: F401
    render_allsky_image,
    render_allsky_map,
)
from .engine.cuda_render import (  # noqa: F401
    render_dirs,
    render_linear,
    render_progressive,
    render_scene,
)
from .engine.jobs import DatasetJob  # noqa: F401
from .parallel import (  # noqa: F401
    HostTopology,
    Mesh,
    global_batch_mesh,
    host_shard,
    init_distributed,
    make_pixel_mesh,
    pixel_tile_mesh_2d,
    render_scene_sharded,
)
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
from .serve import RenderService, serve  # noqa: F401

__version__ = "0.1.0"
