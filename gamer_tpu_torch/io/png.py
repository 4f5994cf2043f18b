"""An 8-bit RGB PNG writer on the standard library alone (zlib + struct):
the card's machine has no PIL."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as the bytes of an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    # filter type 0 (None) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (zlib + struct)."""
    Path(path).write_bytes(encode_png(img))
