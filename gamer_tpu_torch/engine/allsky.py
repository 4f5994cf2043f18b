"""All-sky (HEALPix) rendering — HPXRasterizer parity
(source/galaxy/hpxrasterizer.cpp:61-140), the counterpart of
``gamer_tpu.engine.allsky``.

The work list is the 12*nside^2 RING pixels; each pixel's ray direction is
its HEALPix centre vector turned 90 degrees about +X
(fromEulerAngles((90,0,0)), hpxrasterizer.cpp:82); the stored value is the
luminance mean(I) of the marched radiance, with the 0.01/rayStep final
scale (the reference calls the same renderPixel). Assembly is the Mollweide
projection of the map and the standard post chain.

All sky pixels march in one ray-list launch (K6,
``cuda_render.march_rays``), or over a device mesh in one launch per entry
(``march_rays_rowshard``, the list's 32-ray tiles dealt across the entries
so that each card gets the same mix of the sky), or through the XLA-form
march (``kernel="xla"``). Within a launch no shuffle is needed: the
kernel's warps take tiles from a counter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..post.healpix import npix, pix2vec_ring
from ..post.mollweide import mollweide_image
from ..scene.schema import Scene
from .cuda_render import _device, mesh_device, render_dirs
from .render import post_process, render_rays, scene_args

f32 = np.float32


def allsky_dirs(nside: int, dtype=np.float32) -> np.ndarray:
    """(12*nside^2, 3) ray directions of the RING pixel centres, turned 90
    degrees about +X: (x, y, z) -> (x, -z, y). Centres and turn are
    float64; the cast to ``dtype`` comes last."""
    d = pix2vec_ring(nside, np.arange(npix(nside)))
    return np.stack([d[:, 0], -d[:, 2], d[:, 1]], axis=-1).astype(dtype)


def render_allsky_map(scene: Scene, nside: int, device="cuda",
                      mesh=None, kernel: str = "pallas",
                      dtype=torch.float32) -> np.ndarray:
    """Render the scene into a RING HEALPix luminance map of 12*nside^2
    float64 values, the channel mean taken on ``device`` in the march's
    float type and then cast. ``kernel="pallas"`` (the JAX package's name
    for its kernel; here the CUDA march, float32 whatever ``dtype`` says,
    as in JAX) is one ray-list launch, or with a 1-D ``mesh`` one per mesh
    entry on its dealt tiles of pixels. ``kernel="xla"`` marches the ray list
    through the XLA-form march (``render.render_rays``) in ``dtype`` on
    ``device``; it takes no mesh."""
    if kernel == "pallas":
        linear = render_dirs(scene, allsky_dirs(nside), device=device,
                             device_out=True, mesh=mesh)
    elif kernel == "xla":
        if mesh is not None:
            raise ValueError("mesh sharding needs the pallas kernel")
        (static, params, camera, _inv_vp, rs, ms, _ex, _ga,
         _sa) = scene_args(scene, _device(device), dtype)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        dirs = torch.as_tensor(allsky_dirs(nside, np_dtype),
                               device=camera.device)
        with torch.no_grad():
            linear = render_rays(static, params, dirs, camera, rs, ms)
    else:
        raise ValueError(f"unknown all-sky kernel {kernel!r}")
    # numpy's order of the three-term sum, and a tensor divisor: the f32
    # quotient on every device (see render.post_process)
    csum = (linear[:, 0] + linear[:, 1]) + linear[:, 2]
    lum = csum / torch.full_like(csum, 3.0)
    return lum.cpu().numpy().astype(np.float64)


def render_allsky_image(scene: Scene, nside: int, size: int, device="cuda",
                        mesh=None, dtype=torch.float32) -> np.ndarray:
    """All-sky map -> Mollweide -> post chain -> uint8 (size, size, 3).
    ``dtype`` is passed to ``render_allsky_map``, whose kernel path it
    leaves at float32 (the JAX package passes it the same way)."""
    dev = _device(device) if mesh is None else mesh_device(mesh)
    hpx = render_allsky_map(scene, nside, device=dev, mesh=mesh, dtype=dtype)
    buf = mollweide_image(hpx, nside, size)
    cfg = scene.config
    img = post_process(torch.as_tensor(buf, device=dev), f32(cfg.exposure),
                       f32(cfg.gamma), f32(cfg.saturation))
    return img.cpu().numpy()
