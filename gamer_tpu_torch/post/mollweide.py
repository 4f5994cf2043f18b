"""Mollweide all-sky projection — Util::Mollweide + Buffer2D::
MollweideProjection parity (source/util/util.h:179-195,
source/util/buffer2d.cpp:186-203).

The inverse projection maps output-image pixel (i, j) to sky angles using
the reference's exact (idiosyncratic) formulation: x spans 4*R*sqrt(2), the
vertical coordinate is pre-scaled by 2 and offset by size/2, the colatitude
gets +pi/2 and the longitude is negated and halved; pixels whose longitude
falls outside (-pi, pi) stay black.
"""

from __future__ import annotations

import numpy as np

from .healpix import ang2pix_ring


def mollweide_lookup(size: int, l0: float = 0.0, R: float = 1.0):
    """Per-pixel (theta, phi, valid) arrays of shape (size, size).

    Follows util.h:179-195 with (i, j) the reference's loop order: the
    buffer is written Set(i, j) -> column i, row j; returned arrays are
    indexed [j, i] (row-major image convention).
    """
    i = np.arange(size, dtype=np.float64)[None, :]  # columns
    j = np.arange(size, dtype=np.float64)[:, None]  # rows
    r2 = R * np.sqrt(2.0)

    x = 4.0 * R * np.sqrt(2.0) * (2.0 * i / size - 1.0)
    yy = j * 2.0 - size / 2.0
    y = r2 * (2.0 * yy / size - 1.0)

    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.arcsin(y / r2)
        theta = np.arcsin((2.0 * t + np.sin(2.0 * t)) / np.pi) + np.pi / 2.0
        phi = -(l0 + np.pi * x / (2.0 * r2 * np.cos(t))) * 0.5

    valid = np.isfinite(theta) & np.isfinite(phi) & (phi > -np.pi) & (phi < np.pi)
    theta = np.broadcast_to(theta, (size, size))
    phi = np.broadcast_to(phi, (size, size))
    return theta, phi, valid


def mollweide_image(hpx_map: np.ndarray, nside: int, size: int) -> np.ndarray:
    """Project a RING HEALPix map to a (size, size, 3) float32 luminance
    buffer (gray), black outside the projection ellipse."""
    theta, phi, valid = mollweide_lookup(size)
    out = np.zeros((size, size), np.float64)
    t = np.where(valid, theta, 0.0)
    p = np.where(valid, phi, 0.0)
    # clamp poles into the valid colatitude domain
    t = np.clip(t, 1e-9, np.pi - 1e-9)
    pix = ang2pix_ring(nside, t, p)
    out[valid] = hpx_map[pix[valid]]
    return np.repeat(out[:, :, None], 3, axis=2).astype(np.float32)
