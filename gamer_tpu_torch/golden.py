"""Stored reference frames the port is checked against on the card.

``data/oracle_spiral_48.npz`` holds the spec oracle's frame
(``oracle.reference.render_oracle``, float64 numpy) of the spiral preset
seen from (0.5, 0, 0) at 48x48, with the oracle's count of component
samples. ``data/oracle_<preset>_512.npz`` holds the same still at 512x512
for each preset of ``models.presets.GALLERY``, with the scene's dict. The
port's kernels never run the oracle; tests/test_torch_golden.py and
tests/test_torch_conformance_512.py check the files against a fresh oracle
run. Rewrite the 512^2 frames (10-25 min of one CPU core each) with

    python -m gamer_tpu_torch.golden [PRESET ...]

which runs one process per preset in parallel.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from .models import presets
from .scene.schema import (CameraParams, GalaxyData, GalaxyInstance,
                           RenderConfig, Scene, scene_to_dict)

DATA = Path(__file__).resolve().parent / "data"
ORACLE_GOLDEN = DATA / "oracle_spiral_48.npz"
ORACLE_SIZE = 512
PRESETS = tuple(presets.GALLERY)


def canonical_scene(galaxy: GalaxyData, size: int) -> Scene:
    """The reference's canonical still frame of one galaxy
    (``singleGalaxy.sh``: camera (0.5, 0, 0), target 0, up y, fov 90, ray
    step 0.025; no stars, supersample 1, simplex)."""
    return Scene(
        camera=CameraParams(camera=(0.5, 0.0, 0.0), target=(0.0, 0.0, 0.0),
                            up=(0.0, 1.0, 0.0), fov=90.0),
        instances=[GalaxyInstance(galaxy=galaxy)],
        config=RenderConfig(size=size, ray_step=0.025),
    )


def oracle_scene(preset: str = "spiral", size: int = 48) -> Scene:
    """``canonical_scene`` of ``presets.GALLERY[preset]()``."""
    return canonical_scene(presets.GALLERY[preset](), size)


def load_oracle_golden() -> dict:
    """{"image": (48, 48, 3) uint8, "samples": int, "pixels": int}."""
    with np.load(ORACLE_GOLDEN) as z:
        return {"image": z["image"], "samples": int(z["samples"]),
                "pixels": int(z["pixels"])}


def oracle_path(preset: str, size: int = ORACLE_SIZE) -> Path:
    return DATA / f"oracle_{preset}_{size}.npz"


def load_oracle_frame(preset: str, size: int = ORACLE_SIZE) -> dict:
    """{"image": (size, size, 3) uint8, "samples": int, "pixels": int,
    "scene": the dict of the scene it was rendered from}."""
    with np.load(oracle_path(preset, size)) as z:
        return {"image": z["image"], "samples": int(z["samples"]),
                "pixels": int(z["pixels"]),
                "scene": json.loads(str(z["scene"]))}


def diff_record(want: np.ndarray, got: np.ndarray) -> dict:
    """Two uint8 frames' difference in ``scripts/conformance_512.py``'s
    form: the largest channel difference in LSB, the mean over channels,
    and the pixels (count and share) with any difference, with more than
    1 and with more than 2 LSB."""
    if want.shape != got.shape:
        raise ValueError(f"frames of shapes {want.shape} and {got.shape}")
    d = np.abs(want.astype(np.int16) - got.astype(np.int16))
    px = d.max(-1)
    return {"max_lsb": int(d.max()), "mean_abs": float(d.mean()),
            "mismatch_px": int((px > 0).sum()),
            "mismatch_frac": float((px > 0).mean()),
            "gt1_px": int((px > 1).sum()), "gt2_px": int((px > 2).sum())}


def oracle_gate(rec: dict) -> bool:
    """The spec-oracle gate of a kernel frame: <= 3 LSB and under 5 % of
    the pixels differing."""
    return rec["max_lsb"] <= 3 and rec["mismatch_frac"] < 0.05


def write_oracle_frame(preset: str, size: int = ORACLE_SIZE) -> Path:
    """Render ``oracle_scene(preset, size)`` with the spec oracle and store
    the frame, its sample count and the scene at ``oracle_path``."""
    from .oracle.reference import render_oracle

    scene = oracle_scene(preset, size)
    img, tim = render_oracle(scene)
    out = oracle_path(preset, size)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out, image=img, samples=np.int64(tim.samples),
        pixels=np.int64(tim.pixels),
        scene=np.array(json.dumps(scene_to_dict(scene), sort_keys=True)))
    return out


def _write_all(names: list[str], size: int) -> None:
    import subprocess
    import time

    t0 = time.perf_counter()
    procs = {p: subprocess.Popen(
        [sys.executable, "-m", "gamer_tpu_torch.golden", "--one", p,
         str(size)], cwd=Path(__file__).resolve().parent.parent)
        for p in names}
    bad = [p for p, pr in procs.items() if pr.wait() != 0]
    print(f"{len(names) - len(bad)}/{len(names)} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        raise SystemExit(f"failed: {bad}")


def main(argv: list[str]) -> None:
    if argv[:1] == ["--one"]:
        import time

        t0 = time.perf_counter()
        out = write_oracle_frame(argv[1], int(argv[2]))
        print(f"wrote {out} in {time.perf_counter() - t0:.1f} s", flush=True)
        return
    names = argv or list(PRESETS)
    unknown = sorted(set(names) - set(PRESETS))
    if unknown:
        raise SystemExit(f"unknown presets {unknown}; known: {PRESETS}")
    _write_all(names, ORACLE_SIZE)


if __name__ == "__main__":
    main(sys.argv[1:])
