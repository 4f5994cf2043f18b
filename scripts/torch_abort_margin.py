"""How late an abort may come and still stop gamer_tpu_torch's progressive
launch before it took every tile, on one CUDA card.

For each frame size (the spiral from (0.5, 0, 0), 16 bands), runs
``render_progressive`` and aborts it at the first tick
(``chip_smoke.progressive_ticks``): ``--runs`` times at once, then once
after each host delay of ``--delays`` ms (a sleep in the tick, as a busy or
descheduled host would give). Prints the tiles the launch took against the
frame's tiles (``chip_smoke.log_abort``) and checks the rows of every abort:
band 0 equal to the still, black below.

    python3 scripts/torch_abort_margin.py [--sizes 512 1024] [--runs 12]
        [--delays 2 4 6 10 20]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--delays", type=float, nargs="*",
                    default=[2.0, 4.0, 6.0, 10.0, 20.0])
    args = ap.parse_args()

    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import cuda_render as cr

    print(cs.card_line(), flush=True)
    for size in args.sizes:
        scene = cs.spiral_scene(size)
        frame = gt.render_scene(scene, device="cuda")
        rows, n_bands = cr.band_geometry(size, 1, cs.BANDS)
        n_tiles = cr.frame_tiles(size, n_bands * rows)
        gt.render_progressive(scene, bands=cs.BANDS, device="cuda")
        took = []
        for delay in [0.0] * args.runs + list(args.delays):
            def tick(frac, delay=delay):
                time.sleep(delay / 1e3)
                return False
            ab = cs.progressive_ticks(scene, cs.BANDS, on_tick=tick)
            cs.check(np.array_equal(ab["img"][:rows], frame[:rows])
                     and int(ab["img"][rows:].sum()) == 0,
                     f"abort at {size}^2 after {delay} ms: wrong rows")
            if delay == 0.0:
                cs.log_abort(ab, size, rows, n_bands, n_tiles)
                took.append(ab["tiles"][0])
            else:
                cs.log(f"{size}^2, abort {delay:g} ms after the first tick "
                       f"(host sleep): the launch took {ab['tiles'][0]} of "
                       f"{n_tiles} tiles")
        cs.log(f"{size}^2, {args.runs} aborts at the first tick: the launch "
               f"took {min(took)}-{max(took)} of {n_tiles} tiles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
