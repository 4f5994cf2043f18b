"""FITS export of the linear radiance buffer, one image per channel
(FitsIO::Savedouble, fitsio.h:18-56, as standard big-endian FITS: the
reference's 4-byte flip of 8-byte values is not reproduced), and a reader
of simple primary-HDU images (the renderhpx command's input)."""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

BLOCK = 2880
CARD = 80


def _card(key: str, value: str) -> bytes:
    return f"{key:<8}= {value:>20}".ljust(CARD).encode("ascii")


def _header(size1: int, size2: int, bitpix: int = -64) -> bytes:
    cards = [
        _card("SIMPLE", "T"),
        _card("BITPIX", str(bitpix)),
        _card("NAXIS", "2"),
        _card("NAXIS1", str(size1)),
        _card("NAXIS2", str(size2)),
        "END".ljust(CARD).encode("ascii"),
    ]
    h = b"".join(cards)
    return h.ljust(((len(h) + BLOCK - 1) // BLOCK) * BLOCK, b" ")


def write_fits_image(path: Union[str, Path], image: np.ndarray) -> None:
    """A 2-D image as a single-HDU float64 FITS file, rows flipped like the
    reference's export (buffer2d.cpp:175-185)."""
    img = np.asarray(image, np.float64)
    if img.ndim != 2:
        raise ValueError(f"expected 2-D channel image, got shape {img.shape}")
    data = img[::-1].astype(">f8").tobytes()
    pad = (-len(data)) % BLOCK
    Path(path).write_bytes(_header(img.shape[1], img.shape[0]) + data + b"\0" * pad)


def write_fits_channels(basepath: Union[str, Path], linear: np.ndarray) -> list:
    """<base>_r.fits, <base>_g.fits, <base>_b.fits from an (S, S, 3)
    radiance buffer; returns the paths written."""
    base = Path(basepath)
    paths = []
    for i, ch in enumerate("rgb"):
        p = base.with_name(base.name + f"_{ch}.fits")
        write_fits_image(p, np.asarray(linear)[..., i])
        paths.append(p)
    return paths


def read_fits_image(path: Union[str, Path]) -> np.ndarray:
    """Read a simple primary-HDU FITS image (1-D or 2-D, any BITPIX) as
    float64, in file order (``write_fits_image`` flips rows on export; the
    reader does not flip them back)."""
    raw = Path(path).read_bytes()
    pos = 0
    hdr = {}
    end = False
    while not end:
        block = raw[pos:pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        for c in range(0, BLOCK, CARD):
            card = block[c:c + CARD].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                end = True
                break
            if "=" in card:
                hdr[key] = card.split("=", 1)[1].split("/")[0].strip()
        pos += BLOCK
    bitpix = int(hdr["BITPIX"])
    naxis = int(hdr["NAXIS"])
    dims = [int(hdr[f"NAXIS{i + 1}"]) for i in range(naxis)]
    count = int(np.prod(dims)) if dims else 0
    dt = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4",
          -64: ">f8"}[bitpix]
    arr = np.frombuffer(raw, dtype=dt, count=count,
                        offset=pos).astype(np.float64)
    return arr.reshape(dims[::-1]) if naxis >= 2 else arr
