"""The port's giant frame on one CUDA card: the counterpart of
scripts/render_16k.py for gamer_tpu_torch.

Renders ``presets.spiral()`` from the reference's canonical camera (0.5, 0,
0), target 0, up y, fov 90, ray step 0.025, at SIZE^2 (default 16384^2)
through ``gamer_tpu_torch.render_progressive(scene, bands=BANDS,
on_progress=...)`` (one progressive launch over the whole frame, a tick a
band), then the same frame through ``render_scene``, and prints:

- each band's tick (host clock, after the call began, and since the last);
- the progressive frame's wall time, the still's wall time and its device
  time (CUDA events around ``render_scene(..., device_out=True)``);
- march Msamples/s of each, from the spec oracle's samples per pixel of
  the stored 512^2 spiral frame (gamer_tpu_torch/data/oracle_spiral_512.npz);
- peak device memory of each (``torch.cuda.max_memory_allocated``), the
  pinned host memory the progressive frame holds (its staging frame), and
  the process's peak resident host memory;
- whether the progressive frame is bit-equal to the still.

    python3 scripts/torch_render_16k.py [size=16384] [bands=16] [out=PNG]

``out`` writes a 2048^2 preview (every size/2048-th pixel). Needs one CUDA
card. The last line is ``RESULT {json}``; the exit code is 1 when the two
frames differ.
"""

from __future__ import annotations

import json
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    kw = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    size = int(kw.get("size", 16384))
    bands = int(kw.get("bands", 16))
    out = kw.get("out", "")

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_render_16k: needs a CUDA card", file=sys.stderr)
        return 2
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.golden import load_oracle_frame, oracle_scene

    gold = load_oracle_frame("spiral")
    spp = gold["samples"] / gold["pixels"]
    scene = oracle_scene("spiral", size)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"card: {card[0] if card else torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}", flush=True)
    # build the kernels and warm up on a small frame of the same scene
    gt.render_progressive(oracle_scene("spiral", 256), bands=bands)

    plans = []
    launch_bands = cr._launch_bands

    def keep_plan(plan):
        plans.append(plan)
        return launch_bands(plan)

    ticks = []

    def on_progress(frac, _partial):
        ticks.append((frac, time.perf_counter()))
        t = ticks[-1][1]
        prev = ticks[-2][1] if len(ticks) > 1 else t0
        print(f"  band {len(ticks)}: {frac * 100:5.1f}% at "
              f"{(t - t0) * 1e3:.1f} ms (+{(t - prev) * 1e3:.1f} ms)",
              flush=True)
        return True

    print(f"rendering {size}^2 in {bands} bands ...", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cr._launch_bands = keep_plan
    try:
        t0 = time.perf_counter()
        prog = gt.render_progressive(scene, bands=bands,
                                     on_progress=on_progress)
        prog_s = time.perf_counter() - t0
    finally:
        cr._launch_bands = launch_bands
    torch.cuda.synchronize()
    prog_peak = torch.cuda.max_memory_allocated(dev)
    staging = plans[0].staging
    pinned = staging.numel() * staging.element_size()
    del plans, staging

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    still = gt.render_scene(scene)
    still_s = time.perf_counter() - t
    still_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    gt.render_scene(scene, device_out=True)
    e1.record()
    torch.cuda.synchronize()
    still_ms = e0.elapsed_time(e1)

    same = bool(np.array_equal(prog, still))
    fracs = [f for f, _ in ticks]
    in_order = fracs == [(b + 1) / len(fracs) for b in range(len(fracs))]
    px = size * size
    gaps = np.diff([t0] + [t for _, t in ticks]) * 1e3
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = {
        "size": size, "bands": len(ticks), "ticks_in_order": in_order,
        "tick_ms": [round((t - t0) * 1e3, 3) for _, t in ticks],
        "tick_gap_ms": {"min": round(float(gaps.min()), 3),
                        "median": round(float(np.median(gaps)), 3),
                        "max": round(float(gaps.max()), 3)},
        "progressive_wall_s": round(prog_s, 3),
        "progressive_msamples_per_s": round(spp * px / prog_s / 1e6, 1),
        "still_wall_s": round(still_s, 3),
        "still_device_ms": round(still_ms, 3),
        "still_msamples_per_s": round(spp * px / (still_ms * 1e-3) / 1e6, 1),
        "samples_per_px": round(spp, 3),
        "peak_device_gib_progressive": round(prog_peak / 2 ** 30, 3),
        "peak_device_gib_still": round(still_peak / 2 ** 30, 3),
        "pinned_host_gib": round(pinned / 2 ** 30, 3),
        "peak_host_rss_gib": round(rss / 2 ** 30, 3),
        "bit_equal_to_render_scene": same,
        "nonzero_px": float((prog.max(-1) > 0).mean()),
    }
    print(f"{size}^2: progressive {prog_s:.2f} s wall ({len(ticks)} ticks"
          f"{' in order' if in_order else ', OUT OF ORDER'}), still "
          f"{still_s:.2f} s wall, {still_ms:.1f} ms device; "
          f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
    if out:
        from gamer_tpu_torch.io.png import encode_png

        step = max(1, size // 2048)
        Path(out).write_bytes(encode_png(np.ascontiguousarray(
            prog[::step, ::step])))
        print(f"saved a {prog[::step].shape[0]}^2 preview to {out}")
    print("RESULT " + json.dumps(rec), flush=True)
    return 0 if same and in_order else 1


if __name__ == "__main__":
    sys.exit(main())
