"""Lane efficiency and tail of the march kernel's work distribution, on the
CPU, from the march's step counts.

The kernel's loop exit (tacc >= length + step_prev) depends only on a ray's
geometry, not on its radiance, so the number of march steps of every ray
of the 512^2 spiral still (chip_smoke.py's main scene) is replayed here with
the plain version's float32 recurrence (cuda_render._march_instance_plain)
without its components. From those counts:

- the lane efficiency of the step loop: the steps the rays take over the
  steps their warps run (32 x the warp's longest ray), for warps of 16 x 2
  pixels (the 16 x 16 blocks of the one-thread-per-pixel grid) and of
  8 x 4 pixels (the persistent kernels' tiles);
- the spread of a block's cost (the sum of its warps' longest rays: a
  proxy that leaves out the component work, which varies along a ray);
- the makespan of the fixed grid (1024 blocks, greedy in launch order on
  132 SMs x B resident blocks) and of the persistent launch (8 x 4 tiles
  taken in order by 132 x B x 8 warps), each over the ideal (the total cost
  over the slots), with step counts as the cost.

    python3 scripts/torch_march_lanes.py [--size 512] [--blocks 2 3]
"""

from __future__ import annotations

import argparse
import heapq
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.ops.camera import ray_grid  # noqa: E402
from gamer_tpu_torch.ops.math3d import qt_clamp  # noqa: E402

f32 = np.float32
SMS = 132


def step_counts(size: int) -> np.ndarray:
    """(size, size) march steps of each ray of the spiral still (one
    instance), by the plain march's geometry and step recurrence."""
    page, table, _, _ = cr.prepare(cs.spiral_scene(size), "cpu")
    pg, tb = page.numpy(), table.numpy()
    (inst,) = cr._read_scene(pg, tb)
    ray_step, min_step = float(pg[cr.G_RAY_STEP]), float(pg[cr.G_MIN_STEP])
    camera = pg[cr.G_CAMERA:cr.G_CAMERA + 3]
    dirs = ray_grid(size, pg[cr.G_INV_VP:cr.G_INV_VP + 16], 0.0,
                    device="cpu", rows=size).reshape(-1, 3)
    cx, cy, cz = (float(f32(camera[k]) - f32(inst["pos"][k]))
                  for k in range(3))
    ivx, ivy, ivz = inst["axis_inv"]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    A = dx * dx * ivx + dy * dy * ivy + dz * dz * ivz
    B = 2.0 * (dx * cx * ivx + dy * cy * ivy + dz * cz * ivz)
    C = float((f32(cx) * f32(cx) * f32(ivx) + f32(cy) * f32(cy) * f32(ivy)
               + f32(cz) * f32(cz) * f32(ivz)) - f32(1.0))
    Sdisc = B * B - 4.0 * A * C
    hit = Sdisc > 0.0
    sq = torch.sqrt(torch.where(hit, Sdisc, 0.0))
    t0 = (-B - sq) / (2.0 * A)
    t1 = (-B + sq) / (2.0 * A)
    near_t = torch.where(t1 > 0, 0.0, t1)
    alive = hit & ~((t0 > 0) & (t1 > 0))
    fx = (cx + dx * t0) - (cx + dx * near_t)
    fy = (cy + dy * t0) - (cy + dy * near_t)
    fz = (cz + dz * t0) - (cz + dz * near_t)
    length = torch.sqrt(fx * fx + fy * fy + fz * fz)
    dist0 = -t0
    tacc = torch.zeros_like(length)
    steppr = torch.full_like(length, ray_step)
    steps = torch.zeros(length.shape, dtype=torch.int64)
    while True:
        alive = alive & ~(tacc >= length + steppr)
        if not bool(alive.any()):
            break
        step = qt_clamp((dist0 - tacc) * ray_step, min_step, 0.01)
        tacc = torch.where(alive, tacc + step, tacc)
        steppr = torch.where(alive, step, steppr)
        steps += alive
    return steps.reshape(size, size).numpy()


def warp_max(steps: np.ndarray, w: int, h: int) -> np.ndarray:
    """(rows/h, cols/w) the longest ray of each w x h-pixel warp."""
    n = steps.shape[0]
    return steps.reshape(n // h, h, n // w, w).max(axis=(1, 3))


def greedy_makespan(costs, slots: int) -> float:
    """Items taken in order, each by the first slot to come free."""
    heap = [0.0] * slots
    for c in costs:
        heapq.heapreplace(heap, heap[0] + c)
    return max(heap)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--blocks", type=int, nargs="+", default=[2, 3])
    args = ap.parse_args()
    torch.set_num_threads(1)
    steps = step_counts(args.size)
    total = float(steps.sum())
    print(f"{args.size}^2 spiral: {total:.0f} steps, mean "
          f"{steps[steps > 0].mean():.1f} per ray that hits, "
          f"{(steps > 0).mean():.4f} of rays hit")
    old_warps = warp_max(steps, 16, 2)          # 16 x 16 blocks: 8 warps
    new_tiles = warp_max(steps, 8, 4)
    for name, wm in (("16 x 2 warps (fixed grid)", old_warps),
                     ("8 x 4 tiles (persistent)", new_tiles)):
        print(f"lane efficiency of the step loop, {name}: "
              f"{total / (32.0 * wm.sum()):.4f}")
    n = args.size
    blocks = old_warps.reshape(n // 16, 8, n // 16).sum(axis=1).reshape(-1)
    print(f"block cost (sum of its warps' longest rays) over the mean: min "
          f"{blocks.min() / blocks.mean():.3f}, max "
          f"{blocks.max() / blocks.mean():.3f}")
    tiles = new_tiles.reshape(-1)
    for b in args.blocks:
        fixed = greedy_makespan(blocks, SMS * b) / (blocks.sum() / (SMS * b))
        slots = SMS * b * 8
        pers = greedy_makespan(tiles, slots) / (tiles.sum() / slots)
        print(f"{b} resident blocks of 8 warps per SM: fixed grid makespan "
              f"{fixed:.3f} x ideal; persistent tiles {pers:.3f} x ideal "
              f"({tiles.size / slots:.2f} tiles per warp)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
