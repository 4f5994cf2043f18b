"""A stored reference frame the port is checked against on the card.

``data/oracle_spiral_48.npz`` holds the spec oracle's frame
(``gamer_tpu.oracle.reference.render_oracle``, float64 numpy) of the
spiral preset seen from (0.5, 0, 0) at 48x48, with the oracle's count of
component samples. The port itself never runs the oracle;
tests/test_torch_golden.py checks the file against a fresh oracle run and
rewrites it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .models import presets
from .scene.schema import CameraParams, GalaxyInstance, RenderConfig, Scene

ORACLE_GOLDEN = Path(__file__).resolve().parent / "data" / "oracle_spiral_48.npz"


def golden_scene(size: int = 48) -> Scene:
    """The reference's canonical still frame (camera (0.5, 0, 0), target 0,
    up y, fov 90, ray step 0.025) of ``presets.spiral()``."""
    return Scene(
        camera=CameraParams(camera=(0.5, 0.0, 0.0), target=(0.0, 0.0, 0.0),
                            up=(0.0, 1.0, 0.0), fov=90.0),
        instances=[GalaxyInstance(galaxy=presets.spiral())],
        config=RenderConfig(size=size, ray_step=0.025),
    )


def load_oracle_golden() -> dict:
    """{"image": (48, 48, 3) uint8, "samples": int, "pixels": int}."""
    with np.load(ORACLE_GOLDEN) as z:
        return {"image": z["image"], "samples": int(z["samples"]),
                "pixels": int(z["pixels"])}
