"""Mesh sharding for multi-GPU rendering and multi-host initialization."""

from .distributed import (  # noqa: F401
    HostTopology,
    global_batch_mesh,
    host_shard,
    init_distributed,
    pixel_tile_mesh_2d,
)
from .sharding import (  # noqa: F401
    Mesh,
    make_pixel_mesh,
    render_scene_sharded,
    sharded_render_fn,
)
