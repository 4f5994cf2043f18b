"""Production-size conformance of the port: the CUDA kernel's 512^2 frame
against the spec oracle's, the counterpart of scripts/conformance_512.py for
gamer_tpu_torch (it imports nothing of gamer_tpu, so it runs where jax is
installed too).

A NAME is a preset of ``gamer_tpu_torch.models.presets.GALLERY`` (spiral,
barred_spiral, elliptical, irregular, dusty_disk, ring, flocculent) or a
``.gax`` fixture of the reference (Spiral, TonsOfArms, Irregular, ...) under
``$GAMER_FIXTURE_DIR`` (``presets.FIXTURE_DIR``), each in the canonical
still (``golden.canonical_scene``: camera (0.5, 0, 0), fov 90, ray step
0.025). Each mode runs in a process of its own:

  python scripts/torch_conformance_512.py oracle NAME [SIZE] OUT.npz
  python scripts/torch_conformance_512.py card   NAME [SIZE] OUT.npz
  python scripts/torch_conformance_512.py diff   ORACLE.npz CARD.npz
  python scripts/torch_conformance_512.py all    [NAME ...]

``oracle`` runs the port's copy of the spec oracle (numpy, one CPU core,
~10-25 min a 512^2 frame); ``card`` renders with ``render_scene`` on the
card; ``diff`` prints one JSON record: {"name", "size", "max_lsb",
"mean_abs", "mismatch_px", "mismatch_frac", "gt1_px", "gt2_px", "gate"},
the gate being chip_smoke.py's (<= 3 LSB, < 5 % of pixels). ``all`` (by
default every preset, then the fixtures Spiral, TonsOfArms and Irregular
where they are mounted) takes a preset's oracle frame at 512^2 from the
port's stored frames (gamer_tpu_torch/data/oracle_<preset>_512.npz) and runs
every other oracle leg, one process a frame in parallel; it writes the
records to $CONF_OUTDIR/summary.json (default artifacts/conf512 under the
working directory) and exits 1 when a frame fails the gate. SIZE defaults
to 512 ($CONF_SIZE for ``all``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DEFAULT_SIZE = 512
FIXTURES = ("Spiral", "TonsOfArms", "Irregular")


def _scene(name: str, size: int):
    from gamer_tpu_torch.golden import PRESETS, canonical_scene, oracle_scene
    from gamer_tpu_torch.models import presets

    if name in PRESETS:
        return oracle_scene(name, size)
    return canonical_scene(presets.fixture(name), size)


def _save(out: Path, img, name: str, size: int, seconds: float,
          **extra) -> None:
    import numpy as np

    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, image=img, name=name, size=size,
                        seconds=seconds, **extra)


def cmd_oracle(name: str, size: int, out: Path) -> None:
    from gamer_tpu_torch.oracle.reference import render_oracle

    scene = _scene(name, size)
    t0 = time.perf_counter()
    img, tim = render_oracle(scene)
    dt = time.perf_counter() - t0
    _save(out, img, name, size, dt, samples=tim.samples, pixels=tim.pixels)
    print(f"[oracle] {name} {size}^2: {dt:.1f} s "
          f"({tim.samples / dt / 1e6:.2f} Msamples/s)", flush=True)


def cmd_card(name: str, size: int, out: Path) -> None:
    import torch

    import gamer_tpu_torch as gt

    scene = _scene(name, size)
    gt.render_scene(scene, device="cuda")  # the kernels' build, warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = gt.render_scene(scene, device="cuda")
    dt = time.perf_counter() - t0
    _save(out, img, name, size, dt)
    print(f"[card] {name} {size}^2: {dt * 1e3:.1f} ms with download "
          f"({torch.cuda.get_device_name(0)})", flush=True)


def _frame(path: Path):
    import numpy as np

    with np.load(path) as z:
        img = z["image"]
        name = str(z["name"]) if "name" in z else path.stem
        return img, name, int(z["size"]) if "size" in z else img.shape[0]


def cmd_diff(oracle: Path, card: Path) -> dict:
    from gamer_tpu_torch.golden import diff_record, oracle_gate

    want, name, size = _frame(oracle)
    got, _, _ = _frame(card)
    rec = {"name": name, "size": size, **diff_record(want, got)}
    rec["gate"] = oracle_gate(rec)
    print(json.dumps(rec), flush=True)
    return rec


def _child(mode: str, name: str, size: int, out: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, mode, name, str(size),
                             str(out)])


def cmd_all(names: list[str], size: int, outdir: Path) -> bool:
    """Every card leg (one process each, in turn), the oracle legs (in
    parallel), then the diffs."""
    import numpy as np

    from gamer_tpu_torch.golden import (PRESETS, load_oracle_frame,
                                        oracle_path)

    outdir.mkdir(parents=True, exist_ok=True)
    oracle, card = {}, {}
    for name in names:
        card[name] = outdir / f"{name}.{size}.card.npz"
        if _child("card", name, size, card[name]).wait() != 0:
            raise SystemExit(f"[all] {name}: the card leg failed")
        oracle[name] = outdir / f"{name}.{size}.oracle.npz"
        if name in PRESETS and oracle_path(name, size).exists():
            gold = load_oracle_frame(name, size)
            np.savez_compressed(oracle[name], image=gold["image"], name=name,
                                size=size, samples=gold["samples"],
                                pixels=gold["pixels"])
    legs = {n: _child("oracle", n, size, p) for n, p in oracle.items()
            if not p.exists()}
    failed = [n for n, proc in legs.items() if proc.wait() != 0]
    if failed:
        raise SystemExit(f"[all] oracle legs failed: {failed}")
    rows = [cmd_diff(oracle[n], card[n]) for n in names]
    (outdir / "summary.json").write_text(json.dumps(rows, indent=1))
    passed = sum(r["gate"] for r in rows)
    print(f"[all] {passed}/{len(rows)} frames pass the oracle gate -> "
          f"{outdir}/summary.json", flush=True)
    return passed == len(rows)


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    mode, args = sys.argv[1], sys.argv[2:]
    if mode in ("oracle", "card"):
        size = int(args[1]) if len(args) == 3 else DEFAULT_SIZE
        (cmd_oracle if mode == "oracle" else cmd_card)(
            args[0], size, Path(args[-1]))
        return 0
    if mode == "diff":
        return 0 if cmd_diff(Path(args[0]), Path(args[1]))["gate"] else 1
    if mode == "all":
        from gamer_tpu_torch.golden import PRESETS
        from gamer_tpu_torch.models import presets

        names = args or [*PRESETS, *(f for f in FIXTURES
                                     if f in presets.fixture_names())]
        size = int(os.environ.get("CONF_SIZE", DEFAULT_SIZE))
        outdir = Path(os.environ.get("CONF_OUTDIR", "artifacts/conf512"))
        return 0 if cmd_all(names, size, outdir) else 1
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main())
