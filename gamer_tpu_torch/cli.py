"""Headless CLI for the port: render a JSON scene dict.

  python -m gamer_tpu_torch.cli render <scene.json> <outfile> [--device cuda|cpu]

An outfile ending in .fits writes one FITS image per channel of the linear
radiance buffer (io/fits.py); anything else writes
an 8-bit RGB PNG with a standard-library encoder.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np


def write_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (zlib + struct)."""
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
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def cmd_render(args) -> int:
    from .engine.cuda_render import render_linear, render_scene
    from .scene.schema import scene_from_dict

    scene = scene_from_dict(json.loads(Path(args.scene).read_text()))
    outfile = args.outfile
    t0 = time.perf_counter()
    if outfile.endswith(".fits"):
        from .io.fits import write_fits_channels

        linear = render_linear(scene, device=args.device).cpu().numpy()
        paths = write_fits_channels(outfile[:-5], linear)
    else:
        out = outfile if outfile.endswith(".png") else outfile + ".png"
        write_png(out, render_scene(scene, device=args.device))
        paths = [out]
    print(f"Rendering: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for p in paths:
        print(f"Image saved to file {p}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gamer_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    r = sub.add_parser("render", help="render a JSON scene dict")
    r.add_argument("scene")
    r.add_argument("outfile")
    r.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return cmd_render(args)


if __name__ == "__main__":
    sys.exit(main())
