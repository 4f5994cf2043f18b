"""Minimal HEALPix RING-scheme pixelization (numpy, no external deps).

The reference links the healpix C++ library for its all-sky mode
(source/galaxy/hpxrasterizer.cpp, compiled under USE_HEALPIX). Only two
primitives are needed here: pix2vec (ray directions for every sky pixel)
and ang2pix (Mollweide assembly lookup). These implement the standard RING
scheme (Gorski et al. 2005) directly, vectorized.
"""

from __future__ import annotations

import numpy as np


def npix(nside: int) -> int:
    return 12 * nside * nside


def pix2ang_ring(nside: int, ipix: np.ndarray):
    """RING pixel index -> (theta, phi) at pixel centers."""
    ipix = np.asarray(ipix, dtype=np.int64)
    ncap = 2 * nside * (nside - 1)
    ntot = npix(nside)

    theta = np.empty(ipix.shape, np.float64)
    phi = np.empty(ipix.shape, np.float64)

    # North polar cap: pixels [0, ncap); ring i from the closed form
    # i = floor(sqrt((p+1)/2 - sqrt(floor((p+1)/2)))) + 1
    cap = ipix < ncap
    if cap.any():
        p = ipix[cap]
        ph = (p + 1) / 2.0
        ring = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        pinring = p - 2 * ring * (ring - 1)
        theta[cap] = np.arccos(1.0 - ring * ring / (3.0 * nside * nside))
        phi[cap] = (pinring + 0.5) * np.pi / (2.0 * ring)

    # Equatorial belt: [ncap, npix - ncap)
    eq = (ipix >= ncap) & (ipix < ntot - ncap)
    if eq.any():
        ip = ipix[eq] - ncap
        ring = ip // (4 * nside) + nside  # nside <= ring <= 3*nside
        pinring = ip % (4 * nside)
        # phase offset alternates ring by ring: +0.5 on even (ring-nside)
        shift = np.where(((ring - nside) & 1) == 0, 0.5, 0.0)
        theta[eq] = np.arccos((2.0 * nside - ring) * (2.0 / (3.0 * nside)))
        phi[eq] = (pinring + shift) * np.pi / (2.0 * nside)

    # South polar cap: mirror of the north
    south = ipix >= ntot - ncap
    if south.any():
        p = ntot - 1 - ipix[south]
        ph = (p + 1) / 2.0
        ring = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        pinring = p - 2 * ring * (ring - 1)
        theta[south] = np.pi - np.arccos(1.0 - ring * ring / (3.0 * nside * nside))
        phi[south] = 2.0 * np.pi - (pinring + 0.5) * np.pi / (2.0 * ring)

    return theta, phi


def pix2vec_ring(nside: int, ipix: np.ndarray) -> np.ndarray:
    """RING pixel index -> unit direction (..., 3)."""
    theta, phi = pix2ang_ring(nside, ipix)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=-1)


def ang2pix_ring(nside: int, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """(theta, phi) -> RING pixel index (Gorski et al. 2005, Sec. 4.1)."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) * (2.0 / np.pi)  # in [0, 4)

    out = np.empty(theta.shape, np.int64)

    eq = za <= 2.0 / 3.0
    if eq.any():
        t = tt[eq]
        zz = z[eq]
        temp1 = nside * (0.5 + t)
        temp2 = nside * zz * 0.75
        jp = np.floor(temp1 - temp2).astype(np.int64)  # ascending-edge line
        jm = np.floor(temp1 + temp2).astype(np.int64)  # descending-edge line
        ir = nside + 1 + jp - jm  # ring counted from z = 2/3
        kshift = 1 - (ir & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = np.mod(ip, 4 * nside)
        out[eq] = 2 * nside * (nside - 1) + (ir - 1) * 4 * nside + ip

    pole = ~eq
    if pole.any():
        t = tt[pole]
        zp = z[pole]
        tp = t - np.floor(t)
        tmp = nside * np.sqrt(3.0 * (1.0 - za[pole]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1  # ring from the nearest pole
        ip = np.floor(t * ir).astype(np.int64)
        ip = np.mod(ip, 4 * ir)
        pix_n = 2 * ir * (ir - 1) + ip
        pix_s = npix(nside) - 2 * ir * (ir + 1) + ip
        out[pole] = np.where(zp > 0, pix_n, pix_s)

    return out
