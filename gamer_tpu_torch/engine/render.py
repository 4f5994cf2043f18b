"""The torch pieces of ``gamer_tpu.engine.render`` that the march and its
epilogue use: the shared integer hash (dither and sparkle), the post chain
(buffer2d.cpp:106-126) and supersample pooling in linear space."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.math3d import qt_clamp, wrap_i32

_INT32_MIN = -(1 << 31)


def hash3_i32(bx, by, bz):
    """``gamer_tpu.engine.render.hash3_i32``: int32 wrapping multiplies,
    xor, and an arithmetic shift. Inputs are int32 (or int64 holding int32
    values); the result is an int64 tensor holding the int32 value."""
    bx, by, bz = bx.long(), by.long(), bz.long()
    h = wrap_i32((bx * -1640531527) ^ (by * 97) ^ (bz * 1013904223))
    return h ^ (h >> 13)


def abs_i32(h):
    """int32 abs: |INT_MIN| stays INT_MIN, as jnp.abs on int32 does."""
    return torch.where(h == _INT32_MIN, h, torch.abs(h))


def post_process(linear, exposure, gamma, saturation):
    """buffer2d.cpp:106-126 -> uint8 RGB. The scalars are float32 values."""
    v = linear * float(np.float32(1.0) / np.float32(exposure))
    v = torch.pow(v, float(gamma))
    csum = (v[..., 0] + v[..., 1]) + v[..., 2]
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its rounded reciprocal, which is not the f32 quotient
    center = csum / torch.full_like(csum, 3.0)
    tmp = center[..., None] - v
    v = center[..., None] - float(saturation) * tmp
    c = qt_clamp(v * 10.0, 0.0, 255.0)
    return c.to(torch.int32).to(torch.uint8)


def pool_linear(lin, pool: int):
    """Box-average (..., H, W, 3) radiance by ``pool`` in linear space
    (supersampling, pallas_render.py:1116-1118). The pool x pool samples
    are summed in one fixed order and divided by their count, element by
    element, so a row band or a batch frame pools bit-equal to the same
    rows of a single whole frame."""
    if pool == 1:
        return lin
    *lead, h, w, c = lin.shape
    v = lin.reshape(*lead, h // pool, pool, w // pool, pool, c)
    acc = None
    for i in range(pool):
        for j in range(pool):
            x = v[..., i, :, j, :]
            acc = x if acc is None else acc + x
    # a tensor divisor, as in post_process: the f32 quotient on every device
    return acc / torch.full_like(acc, float(pool * pool))
