"""The precision control of the comparison that decides ``correct``: the
plain reference computed with its state in bfloat16 (``lower=True``) put
in the program's place, compared with the reference on the views a run of
the cell checks (the cell's frame size, its cameras and checked pixels
drawn from the seed by the cell's own generator, its number of checked
rays), for each seed. Prints one JSON line per cell and seed: the numbers
``correct`` compares, for the control and, as a check of the tool, for the
reference against itself.

    python3 benchmark/tools/control.py --workload spiral-galaxy.still4096 \
        --units 25 --seeds 1 2 3

``--units``: frames or skyboxes of a run's window (the checked rays are
spread over them as a run spreads them). The cell's generator has to draw
pixels (``plan`` and ``groups``, as ``generators/stills.py``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import pixels  # noqa: E402
from harness.cell import generator, load_cell  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--units", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = generator(cell).Run(cell, seed, ["cpu"] * cell.chips)
        run.plan(args.units)
        groups = run.groups(int(cell.mix["check_rays"]))
        want = pixels.reference(groups)
        low = pixels.reference(groups, lower=True)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "rays": int(len(want)),
                          "control": pixels.compare(low, want),
                          "reference_vs_itself": pixels.compare(want, want),
                          "limits": cell.config["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
