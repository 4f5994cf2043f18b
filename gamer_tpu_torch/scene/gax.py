"""Pure-Python reader/writer for GAMER ``.gax`` galaxy files.

The reference serializes galaxies with Qt's ``QDataStream`` (version Qt_5_6):
big-endian, ``QString`` as a u32 byte length followed by UTF-16BE code units
(``0xFFFFFFFF`` marks a null string), and all floating-point fields as 64-bit
doubles (``QDataStream`` defaults to double precision since Qt 4.6).
``QVector3D`` streams as three such doubles.

Field layout mirrors the reference serializers:
  - Galaxy:          source/galaxy/galaxy.h (operator<< / >>)
  - GalaxyParams:    source/galaxy/galaxyparams.h:31-43
  - ComponentParams: source/galaxy/componentparams.h:32-44

This module has no Qt (or JAX) dependency; it is plain ``struct`` decoding.
The JAX package's optional C++ codec (``gamer_tpu.native``) is not used.

A copy of ``gamer_tpu.scene.gax``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

from .schema import ComponentParams, GalaxyData, GalaxyParams

_NULL_QSTRING = 0xFFFFFFFF


class _Reader:
    """Big-endian cursor over a bytes buffer (QDataStream-compatible)."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise ValueError(
                f"Truncated .gax stream: wanted {n} bytes at offset {self._pos}, "
                f"have {len(self._data) - self._pos}"
            )
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def f64(self) -> float:
        return struct.unpack(">d", self._take(8))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def qstring(self) -> str:
        n = self.u32()
        if n == _NULL_QSTRING:
            return ""
        if n % 2 != 0:
            raise ValueError(f"QString byte length {n} is not even")
        return self._take(n).decode("utf-16-be")

    def vec3(self) -> tuple:
        return (self.f64(), self.f64(), self.f64())

    @property
    def exhausted(self) -> bool:
        return self._pos == len(self._data)


class _Writer:
    def __init__(self) -> None:
        self._parts: list = []

    def f64(self, v: float) -> None:
        self._parts.append(struct.pack(">d", float(v)))

    def i32(self, v: int) -> None:
        self._parts.append(struct.pack(">i", int(v)))

    def qstring(self, s: str) -> None:
        enc = s.encode("utf-16-be")
        self._parts.append(struct.pack(">I", len(enc)))
        self._parts.append(enc)

    def vec3(self, v) -> None:
        self.f64(v[0])
        self.f64(v[1])
        self.f64(v[2])

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


def loads(data: bytes) -> GalaxyData:
    """Decode a .gax byte stream into a :class:`GalaxyData`."""
    r = _Reader(data)
    display_name = r.qstring()
    gp = GalaxyParams(
        name=r.qstring(),
        axis=r.vec3(),
        bulge_dust=r.f64(),
        bulge_axis=r.vec3(),
        winding_b=r.f64(),
        winding_n=r.f64(),
        no_arms=r.f64(),
        arm1=r.f64(),
        arm2=r.f64(),
        arm3=r.f64(),
        arm4=r.f64(),
        inner_twirl=r.f64(),
        warp_amplitude=r.f64(),
        warp_scale=r.f64(),
    )
    count = r.i32()
    if count < 0 or count > 4096:
        raise ValueError(f"Implausible component count {count}")
    comps = []
    for _ in range(count):
        comps.append(
            ComponentParams(
                class_name=r.qstring(),
                strength=r.f64(),
                spectrum=r.qstring(),
                arm=r.f64(),
                z0=r.f64(),
                r0=r.f64(),
                active=r.f64(),
                delta=r.f64(),
                winding=r.f64(),
                scale=r.f64(),
                noise_offset=r.f64(),
                noise_tilt=r.f64(),
                ks=r.f64(),
                inner=r.f64(),
                name=r.qstring(),
            )
        )
    return GalaxyData(display_name=display_name, params=gp, components=comps)


def dumps(galaxy: GalaxyData) -> bytes:
    """Encode a :class:`GalaxyData` as a .gax byte stream (round-trips loads)."""
    w = _Writer()
    w.qstring(galaxy.display_name)
    gp = galaxy.params
    w.qstring(gp.name)
    w.vec3(gp.axis)
    w.f64(gp.bulge_dust)
    w.vec3(gp.bulge_axis)
    w.f64(gp.winding_b)
    w.f64(gp.winding_n)
    w.f64(gp.no_arms)
    w.f64(gp.arm1)
    w.f64(gp.arm2)
    w.f64(gp.arm3)
    w.f64(gp.arm4)
    w.f64(gp.inner_twirl)
    w.f64(gp.warp_amplitude)
    w.f64(gp.warp_scale)
    w.i32(len(galaxy.components))
    for cp in galaxy.components:
        w.qstring(cp.class_name)
        w.f64(cp.strength)
        w.qstring(cp.spectrum)
        w.f64(cp.arm)
        w.f64(cp.z0)
        w.f64(cp.r0)
        w.f64(cp.active)
        w.f64(cp.delta)
        w.f64(cp.winding)
        w.f64(cp.scale)
        w.f64(cp.noise_offset)
        w.f64(cp.noise_tilt)
        w.f64(cp.ks)
        w.f64(cp.inner)
        w.qstring(cp.name)
    return w.getvalue()


def load(path: Union[str, Path]) -> GalaxyData:
    """Load a galaxy from a ``.gax`` file."""
    return loads(Path(path).read_bytes())


def save(galaxy: GalaxyData, path: Union[str, Path]) -> None:
    """Save a galaxy to a ``.gax`` file (byte-compatible with the reference)."""
    Path(path).write_bytes(dumps(galaxy))
