"""The star-field overlay (Buffer2D::RenderStars / RenderGaussian parity,
buffer2d.cpp:140-173, 224-243): seeded per-star draws on the host
(``star_params``), splatted on the device (``star_field_device``, the
counterpart of ``gamer_tpu.post.stars.star_field_device``) or on the host
in numpy (``render_star_field``, a copy of the JAX package's)."""

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


def render_star_field(size: int, no_stars: int, star_size: float,
                      star_size_spread: float, strength: float,
                      seed: int = 0) -> np.ndarray:
    """(size, size, 3) float32 star overlay splatted on the host, star by
    star, each max-combined into the buffer (rasterizer.cpp:320-321 adds it
    to the radiance)."""
    buf = np.zeros((size, size, 3), dtype=np.float32)
    for row in star_params(size, no_stars, star_size, star_size_spread,
                           strength, seed):
        x, y, w = int(row[0]), int(row[1]), int(row[2])
        _splat_gaussian(buf, x, y, w, row[3:6].astype(np.float32))
    return buf


def _splat_gaussian(buf: np.ndarray, i: int, j: int, w: int,
                    cs: np.ndarray) -> None:
    """Max-combine a gaussian splat of width w at column i, row j: the
    reference's per-texel loop (buffer2d.cpp:224-243) over the window
    [-(w//2), w//2) in both axes, clipped to the buffer."""
    size = buf.shape[0]
    xs = np.arange(-(w // 2), w // 2)
    if xs.size == 0:
        return
    dx = xs / float(w)
    d2 = dx[:, None] ** 2 + dx[None, :] ** 2
    v = np.exp(-d2 / 0.01).astype(np.float32)
    xi = i + xs
    yj = j + xs
    mx = (xi >= 0) & (xi < size)
    my = (yj >= 0) & (yj < size)
    # the buffer is indexed [y, x]; v is symmetric in (dx, dy)
    sub = buf[np.ix_(yj[my], xi[mx])]
    splat = v[np.ix_(my.nonzero()[0], mx.nonzero()[0])][..., None] * cs
    buf[np.ix_(yj[my], xi[mx])] = np.maximum(sub, splat.astype(np.float32))


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
