"""3-D math primitives with the reference's numeric conventions, as torch
ops — the subset of ``gamer_tpu.ops.math3d`` the march paths use, plus the
minimax atan/atan2 the march kernel evaluates
(``gamer_tpu.ops.pallas_noise.atan_f32/atan2_f32``).

Python scalars mixed into these ops are cast to the tensor's float32, so
``x * 0.5`` rounds the constant to f32 first — JAX's weak-type rule, which
the kernel's ``0.5f`` literals mirror.
"""

from __future__ import annotations

import torch

PI = 3.141592653589793


def qt_clamp(val, lo, hi):
    """max(lo, min(hi, val)) with std::min/max ordering: clamp(NaN) == hi."""
    r = torch.where(val < hi, val, hi)
    return torch.where(lo < r, r, lo)


def floor0(v):
    """RasterPixel::Floor — negatives and NaN to 0 (rasterpixel.cpp:34-38)."""
    return torch.where(v >= 0, v, 0.0)


def wrap_i32(v):
    """Two's-complement wrap of an int64 tensor to the int32 range: int32
    multiplies run in int64 (a product of two int32 values fits) and wrap
    by hand, since signed overflow is not defined underneath torch's own
    int32 multiply."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def dot3(a, b):
    """Dot product over the trailing axis of size 3."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def quat_rotate(q, vx, vy, vz):
    """Rotate vectors (vx, vy, vz) by the quaternion q = (w, x, y, z): the
    expanded sandwich product v + 2 (w uv + u x uv), u = (x, y, z). The
    components of q may be floats or tensors broadcasting with v."""
    qw, qx, qy, qz = q
    uvx = qy * vz - qz * vy
    uvy = qz * vx - qx * vz
    uvz = qx * vy - qy * vx
    uuvx = qy * uvz - qz * uvy
    uuvy = qz * uvx - qx * uvz
    uuvz = qx * uvy - qy * uvx
    return (vx + 2.0 * (qw * uvx + uuvx),
            vy + 2.0 * (qw * uvy + uuvy),
            vz + 2.0 * (qw * uvz + uuvz))


def atan_f32(x):
    """Minimax float32 arctangent, range-reduced, max error ~2 ulp."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095   # tan(3*pi/8)
    mid = ax > 0.4142135623730950  # tan(pi/8)
    safe = torch.where(ax == 0, 1.0, ax)
    z = torch.where(big, -1.0 / safe, torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    base = torch.where(big, PI / 2, torch.where(mid, PI / 4, 0.0)).to(x.dtype)
    z2 = z * z
    p = ((8.05374449538e-2 * z2 - 1.38776856032e-1) * z2
         + 1.99777106478e-1) * z2 - 3.33329491539e-1
    r = base + (z + z * z2 * p)
    return torch.where(x < 0, -r, r)


def atan2_f32(y, x):
    """float32 atan2 built on atan_f32 with full quadrant handling."""
    safe_x = torch.where(x == 0, 1.0, x)
    r = atan_f32(y / safe_x)
    # x < 0: shift by +-pi toward y's sign (atan2 convention, y==0 -> +pi)
    shift = torch.where(y < 0, -PI, PI).to(y.dtype)
    r = torch.where(x < 0, r + shift, r)
    # x == 0: +-pi/2 by y's sign; (0, 0) -> 0
    vert = torch.where(y > 0, PI / 2, torch.where(y < 0, -PI / 2, 0.0)).to(y.dtype)
    return torch.where(x == 0, vert, r)


# ---------------------------------------------------------------------------
# (..., 3) forms of the XLA march (gamer_tpu.engine.render) and its
# differentiable twins: the same expressions as gamer_tpu.ops.math3d, with
# its guards that keep reverse-mode derivatives finite on masked lanes
# ---------------------------------------------------------------------------


def norm3(v):
    """Euclidean norm over the trailing axis of size 3. sqrt runs on a
    positive stand-in for zero-norm lanes and 0 is selected back, so the
    value is sqrt(dot(v, v)) everywhere and the derivative at v == 0 is 0,
    not inf."""
    n2 = dot3(v, v)
    nz = n2 > 0
    n = torch.sqrt(torch.where(nz, n2, 1.0))
    return torch.where(nz, n, 0.0)


def norm3_qt(v):
    """QVector3D::length over the trailing axis of size 3: the float64 norm
    of the components, rounded to their float type (with ``norm3``'s
    stand-in for zero-norm lanes)."""
    d = v.double()
    n2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    nz = n2 > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, n2, 1.0)),
                       0.0).to(v.dtype)


def normalize3_qt(v):
    """QVector3D::normalized over the trailing axis of size 3: v / length,
    v itself where the length is within 1e-5 of 1, 0 where it is within
    1e-5 of 0."""
    n = norm3_qt(v)
    null = n.abs() <= 1e-5
    keep = null | ((n - 1.0).abs() <= 1e-5)
    out = v / torch.where(keep, 1.0, n)[..., None]
    return torch.where(null[..., None], 0.0, out)


def intersect_ellipsoid_qt(origin, direction, axis):
    """``intersect_ellipsoid`` as the reference computes it: the products in
    the float type of the rays, the quadratic in float64 (util.h:66-98),
    1 / axis^2 rounded from float64. (hit, isp1, isp2, t0, t1) with t0, t1
    float64 and the points in the rays' float type."""
    inv = (1.0 / (axis.double() * axis.double())).to(direction.dtype)
    rd = direction * inv
    ro = origin * inv
    A = dot3(direction, rd).double()
    B = 2.0 * dot3(direction, ro).double()
    C = dot3(origin, ro).double() - 1.0
    S = B * B - 4.0 * A * C
    hit = S > 0.0
    sq = torch.where(hit, torch.sqrt(torch.where(hit, S, 1.0)), 0.0)
    t0 = (-B - sq) / (2.0 * A)
    t1 = (-B + sq) / (2.0 * A)
    isp1 = origin + direction * t0.to(direction.dtype)[..., None]
    isp2 = origin + direction * t1.to(direction.dtype)[..., None]
    return hit, isp1, isp2, t0, t1


def normalize3(v, eps=0.0):
    """``v / |v|`` over the trailing axis of size 3; a zero vector stays
    zero. ``eps`` is unused, as in ``gamer_tpu.ops.math3d.normalize3``."""
    n = norm3(v)
    safe = torch.where(n == 0, 1.0, n)
    return v / safe[..., None]


def quat_mul(q1, q2):
    """Hamilton product of (..., 4) quaternions (w, x, y, z)."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
    ], dim=-1)


def quat_rotation_to_y(orientation):
    """The shortest-arc quaternion (..., 4) from (0, 1, 0) to
    ``orientation`` (QQuaternion::rotationTo as GalaxyInstance uses it,
    galaxyinstance.cpp:69-71). Antiparallel orientations take Qt's
    fallback, a half turn about (0, 0, 1). Host-side scene prep uses the
    oracle's exact Qt float32 form instead (oracle/qtmath.py)."""
    v1 = normalize3(orientation)
    d = v1[..., 1] + 1.0  # dot((0,1,0), v1) + 1
    near_pi = torch.abs(d) <= 1e-5
    dd = torch.sqrt(2.0 * torch.where(near_pi, 1.0, d))
    # cross((0,1,0), v1) = (z, 0, -x)
    axis = torch.stack([v1[..., 2], torch.zeros_like(d), -v1[..., 0]],
                       dim=-1) / dd[..., None]
    q = torch.cat([(dd * 0.5)[..., None], axis], dim=-1)
    qn = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    flip = torch.zeros_like(qn)
    flip[..., 3] = 1.0  # (w, x, y, z) = (0, 0, 0, 1)
    return torch.where(near_pi[..., None], flip, qn)


def qt_smoothstep(edge0, edge1, x):
    """Util::smoothstep; 0/0 -> NaN -> clamp -> 1 (the oracle's value). A
    zero-width edge keeps that value but carries no derivative; the other
    lanes divide by a guarded denominator."""
    d = edge1 - edge0
    nz = d != 0
    t_safe = qt_clamp((x - edge0) / torch.where(nz, d, 1.0), 0.0, 1.0)
    t_exact = qt_clamp((x - edge0) / d, 0.0, 1.0)
    t = torch.where(nz, t_safe, t_exact.detach())
    return t * t * (3.0 - 2.0 * t)


def quat_rotate_v(q, v):
    """``quat_rotate`` of (..., 3) vectors by (..., 4) quaternions
    (w, x, y, z) on the trailing axes."""
    return torch.stack(quat_rotate((q[..., 0], q[..., 1], q[..., 2],
                                    q[..., 3]),
                                   v[..., 0], v[..., 1], v[..., 2]), dim=-1)


def quat_from_axis_angle_rad(axis, angle_rad):
    """Quaternion (..., 4) of a turn by ``angle_rad`` about a unit axis (3,)."""
    half = angle_rad * 0.5
    s = torch.sin(half)
    c = torch.cos(half)
    return torch.stack([c, axis[0] * s, axis[1] * s, axis[2] * s], dim=-1)


def intersect_ellipsoid(origin, direction, axis):
    """Util::IntersectSphere (util.h:66-98) on the unit sphere scaled by
    ``axis``: (hit, isp1, isp2, t0, t1) for rays origin + t * direction.
    Missing rays take sqrt of a positive stand-in, so their masked lanes
    have finite derivatives."""
    inv = 1.0 / (axis * axis)
    rd = direction * inv
    ro = origin * inv
    A = dot3(direction, rd)
    B = 2.0 * dot3(direction, ro)
    C = dot3(origin, ro) - 1.0
    S = B * B - 4.0 * A * C
    hit = S > 0.0
    sq = torch.where(hit, torch.sqrt(torch.where(hit, S, 1.0)), 0.0)
    t0 = (-B - sq) / (2.0 * A)
    t1 = (-B + sq) / (2.0 * A)
    isp1 = origin + direction * t0[..., None]
    isp2 = origin + direction * t1[..., None]
    return hit, isp1, isp2, t0, t1
