"""What one cell of BENCHMARK.json names, found by name: its
configuration file, its traffic mix, its generator and its per-layer metric
readers. Nothing here imports the program."""

from __future__ import annotations

import importlib.util
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    mix: dict             # the traffic mix file's contents
    end_to_end: list      # the manifest's end-to-end metrics of this cell
    per_layer: list       # the manifest's per-layer metrics of this cell


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest_path: Path = MANIFEST) -> Cell:
    """The cell called ``name`` with its configuration, mix and metrics;
    raises KeyError for a name the manifest does not hold."""
    manifest = json.loads(manifest_path.read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path.name}; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    layer = [m for m in manifest["per_layer"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, mix, e2e, layer)


def load_module(path: Path):
    """A module from a file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(cell: Cell):
    return load_module(BENCH / "generators" / f"{cell.mix['generator']}.py")


def reader(metric_name: str):
    return load_module(BENCH / "metrics" / f"{metric_name}.py")


# ---------------------------------------------------------------------------
# scenes and cameras: plain descriptions, handed to both sides
# ---------------------------------------------------------------------------


def scene_dict(config: dict, camera: dict, size: int) -> dict:
    """The scene as a plain dict in the program's dict layout, which the
    reference reads too."""
    return {"camera": camera, "instances": config["instances"],
            "config": dict(config["config"], size=int(size))}


def turned(camera: dict, degrees: float) -> dict:
    """The camera's position and target turned about the y axis (the
    galaxy's axis) by ``degrees``."""
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)

    def rot(v):
        x, y, z = (float(t) for t in v)
        return [c * x + s * z, y, -s * x + c * z]

    return dict(camera, camera=rot(camera["camera"]),
                target=rot(camera["target"]))


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each use of the seed (arrivals, cameras,
    checked pixels), so that one use does not shift another."""
    key = [int(b) for b in stream.encode()]
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *key])
