"""The star-field overlay (Buffer2D::RenderStars / RenderGaussian parity,
buffer2d.cpp:140-173, 224-243): seeded per-star draws on the host
(``star_params``), splatted on the device (``star_field_device``, the
counterpart of ``gamer_tpu.post.stars.star_field_device``)."""

from __future__ import annotations

import numpy as np
import torch


def star_params(size: int, no_stars: int, star_size: float,
                star_size_spread: float, strength: float,
                seed: int = 0) -> np.ndarray:
    """The seeded per-star draws as (K, 6) float32 rows [x, y, w, cs_r,
    cs_g, cs_b]: a uniform position, a warm-biased colour, a gaussian size
    floored at star_size/3 and a strength sz*|N(strength, strength)|.
    Stars narrower than 2 pixels are dropped, as the reference skips them.
    The reference draws from unseeded rand(); here an MT19937 generator
    seeded with ``seed`` (0: 5489, mt19937's default)."""
    rows = []
    if no_stars > 0:
        g = np.random.Generator(np.random.MT19937(seed if seed else 5489))
        for _ in range(int(no_stars)):
            x = int(g.integers(0, size))
            y = int(g.integers(0, size))
            cx = min(float(g.uniform(0.0, 1.0)) + 0.6, 1.0)
            cy = min(float(g.uniform(0.0, 1.0)) + 0.6, cx)
            cz = min(float(g.uniform(0.0, 1.0)) + 0.6, 1.0)
            sz = max(float(g.normal(star_size, star_size_spread)),
                     star_size / 3.0)
            w = int(int(sz * size) / 245.0)
            ss = sz * abs(float(g.normal(strength, strength)))
            if w < 2:
                continue
            rows.append([x, y, w, cx * ss, cy * ss, cz * ss])
    return np.asarray(rows, np.float32).reshape(-1, 6)


def pad_star_rows(rows: np.ndarray) -> np.ndarray:
    """Pad (K, 6) star rows with zero rows (w = 0 splats nothing) to the
    next power of two >= 64, so the overlay sees a few stable shapes."""
    K = rows.shape[0]
    if K == 0:
        return rows
    bucket = 64
    while bucket < K:
        bucket *= 2
    if bucket > K:
        rows = np.concatenate([rows, np.zeros((bucket - K, 6), np.float32)])
    return rows


def star_field_device(params, size: int, device="cpu"):
    """(size, size, 3) float32 overlay: per pixel, the max over stars of the
    windowed gaussian splat. ``params`` is star_params' (K, 6) rows
    [x, y, w, cs_r, cs_g, cs_b]; w = 0 rows splat nothing. The running max
    is taken over chunks of 8 stars, so peak memory is 8 frames, not K."""
    params = torch.as_tensor(np.asarray(params, np.float32), device=device)
    K = params.shape[0]
    out = torch.zeros((size, size, 3), dtype=torch.float32, device=device)
    if K == 0:
        return out
    CHUNK = 8
    pad = (-K) % CHUNK
    if pad:
        params = torch.cat([params, params.new_zeros((pad, 6))])
    col = torch.arange(size, dtype=torch.float32, device=device)
    for pc in params.reshape(-1, CHUNK, 6):
        xs, ys, ws, cs = pc[:, 0], pc[:, 1], pc[:, 2], pc[:, 3:6]
        wsafe = torch.where(ws == 0, 1.0, ws)
        ox = col[None, :] - xs[:, None]
        oy = col[None, :] - ys[:, None]
        half = torch.floor(ws * 0.5)
        # window = arange(-(w//2), w//2): inclusive low, exclusive high
        in_x = (ox >= -half[:, None]) & (ox < half[:, None])
        in_y = (oy >= -half[:, None]) & (oy < half[:, None])
        # separable: exp(-(dx^2+dy^2)/.01) == exp(-dx^2/.01)*exp(-dy^2/.01)
        gx = torch.exp(-((ox / wsafe[:, None]) ** 2) / 0.01) * in_x
        gy = torch.exp(-((oy / wsafe[:, None]) ** 2) / 0.01) * in_y
        v = gy[:, :, None] * gx[:, None, :]          # (C, y, x)
        field = v[..., None] * cs[:, None, None, :]  # (C, y, x, 3)
        out = torch.maximum(out, field.amax(dim=0))
    return out
