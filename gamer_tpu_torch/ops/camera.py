"""Camera — the Qt-convention view/projection chain (gamercamera.cpp:185-217).

  proj = perspective(fov, aspect=1, near=1, far=100)
  view = lookAt(target, camera, up)        # NOTE reversed eye/center!
  inv_vp = (proj @ view)^-1
  ray(i, j) = normalize((inv_vp @ (i/(w/2)-1, -(j/(w/2)-1), 1, 1)).xyz)

Because of the reversed lookAt, rays point AWAY from the scene; visible
geometry sits at negative ray parameters (rasterizer.cpp:396-403). The
inverse is the closed form inv(V) @ inv(P) of ``gamer_tpu.ops.camera``,
evaluated on the host in float32. Rays use the march kernel's expression
(row sums left-associated, then ``w * (1/sqrt(|w|^2))``), so the plain
march and the kernel see the same directions.
"""

from __future__ import annotations

import numpy as np
import torch

from .math3d import dot3
from .noise import device_table


def const(x, c: float):
    """``c`` as a 0-d tensor of ``x``'s dtype on its device (made once per
    device), as ``engine.render.const``."""
    return device_table(f"const:{float(c)!r}", float(c), x.device, x.dtype)


def inv_view_projection_tensor(camera, target, up, fov_deg, near=1.0,
                               far=100.0):
    """Closed-form (perspective(fov,1,near,far) @ lookAt(target, camera, up))^-1
    as a (4, 4) float32 tensor, differentiable in every input: camera,
    target and up are (3,) float32 tensors and fov_deg a 0-d float32 tensor,
    all on one device. The fits of the camera pose take gradients through
    it; ``inv_view_projection`` is this function on the host."""
    f = camera.dtype

    # lookAt(eye=target, center=camera, up) basis (Qt convention, reversed)
    eye, center = target, camera
    fwd = center - eye
    fwd = fwd / torch.sqrt(dot3(fwd, fwd))
    side = torch.linalg.cross(fwd, up)
    side = side / torch.sqrt(dot3(side, side))
    upv = torch.linalg.cross(side, fwd)

    # V^-1 = [[side upv -fwd] (columns), eye; 0 0 0 1]
    zero = torch.zeros((), dtype=f, device=camera.device)
    one = torch.ones((), dtype=f, device=camera.device)
    vinv = torch.stack([
        torch.stack([side[r], upv[r], -fwd[r], eye[r]]) for r in range(3)
    ] + [torch.stack([zero, zero, zero, one])])

    # P^-1 for perspective(fov, aspect=1, near, far):
    #   P^-1 = [[1/c,0,0,0],[0,1/c,0,0],[0,0,0,-1],[0,0,1/m23,m22/m23]]
    # (fov / 2 and 1 / cotan divide by float32 tensors: on CUDA a division
    # by a Python scalar becomes a multiply by its reciprocal)
    radians = (fov_deg / const(fov_deg, 2.0)) * (np.pi / 180.0)
    cotan = torch.cos(radians) / torch.sin(radians)
    clip = far - near
    m22 = -(near + far) / clip
    m23 = -(2.0 * near * far) / clip
    inv_c = const(cotan, 1.0) / cotan
    pinv = torch.stack([
        torch.stack([inv_c, zero, zero, zero]),
        torch.stack([zero, inv_c, zero, zero]),
        torch.stack([zero, zero, zero, -one]),
        torch.stack([zero, zero, const(zero, 1.0 / m23),
                     const(zero, m22 / m23)]),
    ])
    return torch.matmul(vinv, pinv)


def inv_view_projection(camera, target, up, fov_deg, near=1.0, far=100.0):
    """Closed-form (perspective(fov,1,near,far) @ lookAt(target, camera, up))^-1
    as a (4, 4) float32 numpy array, computed on the host in float32
    (``inv_view_projection_tensor`` on CPU tensors)."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), dtype=torch.float32)

    return inv_view_projection_tensor(t(camera), t(target), t(up),
                                      t(np.float32(fov_deg)), near,
                                      far).numpy()


def inv_view_projection_batch(cameras, targets, ups, fov_degs) -> np.ndarray:
    """(B, 4, 4) float32 ``inv_view_projection`` for B poses, the
    counterpart of ``gamer_tpu.ops.camera.inv_view_projection_host_batch``
    without its pose cache. It is a loop over the scalar function, so each
    frame of a batch gets the matrix bit-equal to its single frame's (a
    vectorized form may differ in the last ulp, as the JAX note on the CPU
    backend records)."""
    return np.stack([inv_view_projection(c, t, u, f)
                     for c, t, u, f in zip(cameras, targets, ups, fov_degs)])


def coord2ray(i, j, width: int, inv_vp):
    """Pixel (i, j) -> normalized world ray (gamercamera.cpp:210-217).

    i, j: float32 tensors of pixel coordinates; inv_vp: (4, 4) float32
    tensor or array. Returns (..., 3) float32. The w component of the
    transformed NDC point is dropped before normalization (toVector3D)."""
    m = [float(v) for v in np.asarray(inv_vp, np.float32).reshape(-1)]
    half = float(width) * 0.5
    xx = i / half - 1.0
    yy = j / half - 1.0
    w = [m[4 * r] * xx - m[4 * r + 1] * yy + m[4 * r + 2] + m[4 * r + 3]
         for r in range(3)]
    inv_n = 1.0 / torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    return torch.stack([w[0] * inv_n, w[1] * inv_n, w[2] * inv_n], dim=-1)


def ray_grid(size: int, inv_vp, row0: float = 0.0, device="cpu",
             rows: int | None = None):
    """The rays of ``rows`` rows (default ``size``) of a size x size frame
    as (rows, size, 3), indexed [row j, col i] (the reference's
    idx = j*size + i layout). ``row0`` is the global index of the first
    row, as the kernel's page slot gives it for row bands."""
    rows = size if rows is None else rows
    ii = torch.arange(size, dtype=torch.float32, device=device)
    jj = row0 + torch.arange(rows, dtype=torch.float32, device=device)
    j_g, i_g = torch.meshgrid(jj, ii, indexing="ij")
    return coord2ray(i_g, j_g, size, inv_vp)


def ray_grid_xla(size: int, inv_vp, row0: int = 0, rows: int | None = None):
    """The rays of ``rows`` rows (default all) of a size x size frame from
    row ``row0`` on, as (rows, size, 3) [row j, col i], in the expression of
    the XLA march (``gamer_tpu.ops.camera.ray_grid``): the screen point
    (xx, -yy, 1, 1) dotted with the rows of ``inv_vp`` in index order, then
    ``v / |v|``. Each ray is an element-wise function of its (i, j), so a
    row slab equals the same rows of the whole grid. ``inv_vp`` is a (4, 4)
    float tensor, and the rays are differentiable in it."""
    dt, dev = inv_vp.dtype, inv_vp.device
    rows = size if rows is None else rows
    half = torch.tensor(float(size), dtype=dt, device=dev) * 0.5
    ii = torch.arange(size, dtype=dt, device=dev)
    jj = torch.arange(row0, row0 + rows, dtype=dt, device=dev)
    j_g, i_g = torch.meshgrid(jj, ii, indexing="ij")
    xx = i_g / half - 1.0
    yy = j_g / half - 1.0
    w = [((xx * inv_vp[r, 0] + (-yy) * inv_vp[r, 1]) + inv_vp[r, 2])
         + inv_vp[r, 3] for r in range(3)]
    v = torch.stack(w, dim=-1)
    n = torch.sqrt(dot3(v, v))
    return v / n[..., None]
