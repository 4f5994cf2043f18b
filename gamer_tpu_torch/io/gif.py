"""An animated GIF89a writer on the standard library and numpy (the card's
machine has no PIL): one 256-colour palette for every frame (median cut
over the frames' 15-bit colours), LZW-coded frames, a frame delay, and the
NETSCAPE2.0 loop count (0: for ever). The counterpart of the PIL call
``Image.save(..., save_all=True, duration=..., loop=0)`` with which
``gamer_tpu.cli`` writes its fly-through and morph GIFs.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

COLOURS = 256
_BINS = 1 << 15  # 5 bits a channel


def _bins(img: np.ndarray) -> np.ndarray:
    """Each pixel's 15-bit colour bin, (r >> 3) << 10 | (g >> 3) << 5 | b >> 3."""
    c = img.astype(np.int32) >> 3
    return (c[..., 0] << 10) | (c[..., 1] << 5) | c[..., 2]


def quantize(frames) -> tuple:
    """One palette for all ``frames`` ((H, W, 3) uint8 each) and each
    frame's palette indices: (palette (256, 3) uint8, [(H, W) uint8, ...]).
    The palette is a median cut of the frames' 15-bit colour bins, weighted
    by their pixel counts, each entry the mean colour of its pixels; a
    pixel takes the entry nearest its bin's mean colour."""
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    bins = [_bins(f).ravel() for f in frames]
    flat = np.concatenate(bins)
    pix = np.concatenate([f.reshape(-1, 3) for f in frames]).astype(np.float64)
    count = np.bincount(flat, minlength=_BINS).astype(np.float64)
    sums = np.stack([np.bincount(flat, pix[:, k], minlength=_BINS)
                     for k in range(3)], axis=1)
    used = np.flatnonzero(count)
    mean = sums[used] / count[used, None]

    def span(box):
        return np.ptp(mean[box], axis=0) if len(box) > 1 else np.zeros(3)

    boxes = [np.arange(len(used))]
    spans = [span(boxes[0])]
    while len(boxes) < COLOURS:
        k = int(np.argmax([s.max() for s in spans]))
        if spans[k].max() == 0:
            break  # every box is one colour
        box, axis = boxes.pop(k), int(np.argmax(spans.pop(k)))
        box = box[np.argsort(mean[box, axis], kind="stable")]
        w = np.cumsum(count[used[box]])
        cut = int(np.clip(np.searchsorted(w, w[-1] / 2), 0, len(box) - 2)) + 1
        boxes += [box[:cut], box[cut:]]
        spans += [span(box[:cut]), span(box[cut:])]
    palette = np.zeros((COLOURS, 3), np.uint8)
    for i, b in enumerate(boxes):
        palette[i] = np.round(sums[used[b]].sum(0) / count[used[b]].sum())
    # every used bin to the entry nearest its mean colour
    d = ((mean[:, None, :] - palette[None, :len(boxes)].astype(np.float64))
         ** 2).sum(-1)
    lut = np.zeros(_BINS, np.uint8)
    lut[used] = np.argmin(d, axis=1)
    return palette, [lut[b].reshape(f.shape[:2]) for b, f in zip(bins, frames)]


def _lzw(indices: np.ndarray, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW (LSB first, codes up to 12 bits, a clear
    code when the table is full), as Unix compress writes it: a code is
    written at the current width, which grows once the next free code no
    longer fits."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    size, free = min_size + 1, end + 1
    table: dict = {}

    def emit(code: int) -> None:
        nonlocal acc, nacc, size
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
        if code == clear:
            size = min_size + 1
        elif free > (1 << size) - 1 and size < 12:
            size += 1

    emit(clear)
    data = indices.ravel().tolist()
    prefix = data[0]
    for sym in data[1:]:
        key = (prefix << 8) | sym
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if free < 4096:
            table[key] = free
            free += 1
        else:
            free = end + 1
            table.clear()
            emit(clear)
        prefix = sym
    emit(prefix)
    emit(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    """Data sub-blocks of at most 255 bytes, then the block terminator."""
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
             for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def encode_gif(frames, duration_ms: int, loop: int = 0) -> bytes:
    """(H, W, 3) uint8 frames as the bytes of an animated GIF89a: one global
    palette (``quantize``), ``duration_ms`` a frame (stored in hundredths
    of a second), ``loop`` repeats (0: for ever)."""
    frames = list(frames)
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError("every frame must be (H, W, 3) of one size")
    palette, indices = quantize(frames)
    head = (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
            + palette.tobytes()
            + b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
            + struct.pack("<H", loop) + b"\x00")
    delay = int(round(duration_ms / 10))
    body = b"".join(
        b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        + b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        + b"\x08" + _blocks(_lzw(idx)) for idx in indices)
    return head + body + b"\x3b"


def write_gif(path, frames, duration_ms: int, loop: int = 0) -> Path:
    """``encode_gif`` into ``path``; returns the path."""
    path = Path(path)
    path.write_bytes(encode_gif(frames, duration_ms, loop))
    return path

