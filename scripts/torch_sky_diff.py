"""The all-sky map of the ray-list kernel (K6) against the XLA-form march's,
and the rays where they differ most against the spec oracle.

    python3 scripts/torch_sky_diff.py card [OUT.npz]    # on a CUDA card
    python3 scripts/torch_sky_diff.py oracle [OUT.npz]  # on the CPU, after

``card`` renders chip_smoke.py's all-sky scene at nside 512 three ways:
K6 (``render_allsky_map``), the XLA-form march in float32 and in float64
(``kernel="xla"``); it prints each pair's largest difference as a share of
K6's largest value (chip_smoke.py's gate, 1.5e-3 for float32 against K6)
and the 24 rays where float32 differs most from K6, and stores the maps and
those rays in OUT.npz (default artifacts/sky_diff.npz). ``oracle`` marches
those rays through the spec oracle (``oracle.reference.render_oracle_rays``,
numpy), the plain ray-list march (K6's function) and the XLA-form march on
the CPU, and prints each ray's luminance from each beside the card's.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
NSIDE = 512
TOP = 24


def _lum(linear):
    """render_allsky_map's luminance: the channel mean in numpy's order."""
    return ((linear[:, 0] + linear[:, 1]) + linear[:, 2]) / np.float32(3.0)


def card(out: Path) -> None:
    import torch

    import chip_smoke
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine.allsky import allsky_dirs

    dev = torch.device("cuda", 0)
    sky = chip_smoke.allsky_scene()
    t = time.time()
    k6 = gt.render_allsky_map(sky, NSIDE, device=dev)
    x32 = gt.render_allsky_map(sky, NSIDE, device=dev, kernel="xla")
    x64 = gt.render_allsky_map(sky, NSIDE, device=dev, kernel="xla",
                               dtype=torch.float64)
    print(f"{chip_smoke.card_line()}: maps in {time.time() - t:.1f} s",
          flush=True)
    m = np.abs(k6).max()
    for name, a, b in (("xla32-k6", x32, k6), ("xla64-k6", x64, k6),
                       ("xla32-xla64", x32, x64)):
        d = np.abs(a - b) / m
        print(name, "max/m", d.max(), "n>1e-3", int((d > 1e-3).sum()),
              "n>5e-4", int((d > 5e-4).sum()), "n>1e-4",
              int((d > 1e-4).sum()), flush=True)
    top = np.argsort(-np.abs(x32 - k6))[:TOP]
    for i in top:
        print(json.dumps({"i": int(i), "k6": float(k6[i]),
                          "x32": float(x32[i]), "x64": float(x64[i]),
                          "rel32": float(abs(x32[i] - k6[i]) / m)}))
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, top=top, dirs=allsky_dirs(NSIDE)[top],
                        k6=k6.astype(np.float32), x32=x32.astype(np.float32),
                        x64=x64.astype(np.float32), m=m)


def oracle(src: Path) -> None:
    import torch

    import chip_smoke
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine import render as xr
    from gamer_tpu_torch.oracle.reference import render_oracle_rays

    z = np.load(src)
    top, m = z["top"], float(z["m"])
    dirs = z["dirs"].astype(np.float32)
    sky = chip_smoke.allsky_scene()
    orc = _lum(render_oracle_rays(sky, dirs))
    page, table, _, _ = cr.prepare(sky, "cpu")
    plain = _lum(cr.march_rays_plain(page, table,
                                     torch.as_tensor(dirs)).numpy())
    static, params, camera, _, rs, ms, *_ = xr.scene_args(sky, "cpu")
    with torch.no_grad():
        xla = _lum(xr.render_rays(static, params, torch.as_tensor(dirs),
                                  camera, rs, ms).numpy())
    for k, i in enumerate(top):
        k6, x32 = float(z["k6"][i]), float(z["x32"][i])
        print(json.dumps({
            "i": int(i), "oracle": float(orc[k]), "plain": float(plain[k]),
            "xla_cpu": float(xla[k]), "k6_card": k6, "xla32_card": x32,
            "k6_vs_oracle": abs(k6 - float(orc[k])) / m,
            "xla32_card_vs_oracle": abs(x32 - float(orc[k])) / m,
            "xla_cpu_vs_oracle": abs(float(xla[k]) - float(orc[k])) / m}))


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("card", "oracle"):
        raise SystemExit(__doc__)
    path = Path(sys.argv[2] if len(sys.argv) > 2
                else "artifacts/sky_diff.npz")
    (card if sys.argv[1] == "card" else oracle)(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
