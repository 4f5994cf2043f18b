"""An 8-bit RGB PNG writer and an 8-bit PNG reader on the standard library
alone (zlib + struct): the card's machine has no PIL."""

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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: greyscale, RGB, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth) of
    ``h`` rows of ``stride`` bytes, ``bpp`` bytes per pixel."""
    rows = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride,
                             y * (stride + 1) + 1).astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # each byte depends on the byte bpp to its left: a byte loop
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + int(prev[x])) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pred = _paeth(a, int(prev[x]), c)
                cur[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}; "
                             "expected 0-4")
        rows[y] = cur
        prev = cur
    return rows


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a non-interlaced 8-bit greyscale, RGB or RGBA PNG as an
    (H, W, 3) uint8 RGB array (greyscale is repeated over the channels,
    alpha is dropped). Any other PNG raises ValueError naming what it
    has."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or no IDAT chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8 only)")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported "
                         "(0 greyscale, 2 RGB, 6 RGBA only)")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    ch = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (w * ch + 1):
        raise ValueError("PNG image data is truncated")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path) -> np.ndarray:
    """``decode_png`` of a file."""
    return decode_png(Path(path).read_bytes())
