"""The sharded autograd fits and the sharded XLA-form frame of
gamer_tpu_torch on a mesh of several cards, beside the same calls on one
card: the results held to the same gates as chip_smoke.py's (JAX's
tolerances for its own sharded fits, the batch and the XLA-form frame bit
for bit), the step times and peak memory printed for each.

    python3 scripts/torch_mesh_cards.py            # every visible card
    python3 scripts/torch_mesh_cards.py --cpu 4    # 4 CPU entries, tiny sizes

Prints one line per case and, last, a JSON object of the readings; exits
non-zero if a gate fails. With one card it compares the card named n
times with itself.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the smoke's gates and scenes, so the two hold the fits to one standard
from chip_smoke import (  # noqa: E402
    FIT_STEPS as STEPS,
    MESH_FIT_RTOL as RTOL,
    POSE_START,
    _rel as rel,
    card_line,
    scaled,
    spiral_scene,
)


def main() -> int:
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import fit as tfit
    from gamer_tpu_torch.engine import render as trender
    from gamer_tpu_torch.parallel import Mesh
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.utils.tree import tree_leaves

    args = sys.argv[1:]
    cuda = "--cpu" not in args
    if cuda:
        n = torch.cuda.device_count()
        if n < 1:
            print("torch_mesh_cards: no CUDA card", file=sys.stderr)
            return 2
        cards = Mesh([f"cuda:{i}" for i in range(n)])
        one = Mesh(["cuda:0"] * n)
        dev = torch.device("cuda", 0)
        fit_size, pose_size, frame_size, cfg = 128, 64, 512, {}
    else:
        n = int(args[args.index("--cpu") + 1])
        cards = one = Mesh(["cpu"] * n)
        dev = torch.device("cpu")
        fit_size, pose_size, frame_size = 16, 16, 16
        cfg = {"is_preview": True, "noise_octaves": 2}
    card = card_line() if cuda else "CPU"

    def sync():
        if cuda:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def peak_reset():
        if cuda:
            for i in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(i)

    def peak():
        if not cuda:
            return 0.0
        return max(torch.cuda.max_memory_allocated(i)
                   for i in range(torch.cuda.device_count())) / 2 ** 30

    def timed_fit(run):
        """(result, median ms of steps 2-4, peak GiB over every card)."""
        marks = []

        def on_step(i, loss):
            sync()
            marks.append(time.perf_counter())
            return None

        peak_reset()
        sync()
        marks.append(time.perf_counter())
        res = run(on_step)
        sync()
        d = np.diff(marks) * 1e3
        return res, float(np.median(d[2:5])), peak()

    def scene(size, factor=1.0):
        return scaled(spiral_scene(size, **cfg), "strength", factor)

    readings, failed = {}, []

    def case(name, runs, gate, bit=False):
        base = runs["unsharded"][0]
        out = {}
        for label, (res, ms, gib) in runs.items():
            err = max([rel(res.losses, base.losses)]
                      + [rel(x, y) for x, y in zip(tree_leaves(res.params),
                                                   tree_leaves(base.params))])
            ok = err == 0.0 if bit else err <= gate
            out[label] = {"step_ms": ms, "peak_gib": gib, "max_rel": err,
                          "ok": ok}
            if not ok:
                failed.append(f"{name} {label}: max rel {err}")
        readings[name] = out
        print(f"[{card}] {name} (step ms, median of steps 2-4): " + "; ".join(
            f"{k} {v['step_ms']:.1f} ms, peak {v['peak_gib']:.2f} GiB, max "
            f"rel {v['max_rel']:.3g}" for k, v in out.items())
            + (" (bit-equal)" if bit else f" (limit {gate:g})"), flush=True)

    meshes = {"unsharded": None, f"{n} entries of card 0": one,
              f"{n} cards": cards}
    if not cuda:
        meshes.pop(f"{n} cards")

    # fit_scene, tensor march, pixel rows
    truth = scene(fit_size)
    target = gt.render_scene(truth, device=dev)
    start = scene(fit_size, 1.5)
    case("fit_scene tensor", {
        label: timed_fit(lambda cb, m=m: tfit.fit_scene(
            start, target, steps=STEPS, march="tensor", mesh=m, device=dev,
            on_step=cb)) for label, m in meshes.items()},
        RTOL["fit_scene"])

    # fit_pose, LOD 3, pixel rows
    ptruth = scene(pose_size)
    ptarget = gt.render_scene(ptruth, device=dev)
    lod3 = dataclasses.replace(
        ptruth, camera=dataclasses.replace(ptruth.camera,
                                           camera=POSE_START),
        config=dataclasses.replace(ptruth.config, noise_octaves=3))
    case("fit_pose LOD 3", {
        label: timed_fit(lambda cb, m=m: tfit.fit_pose(
            lod3, ptarget, ("camera",), steps=STEPS, lr=1e-2, mesh=m,
            device=dev, on_step=cb)) for label, m in meshes.items()},
        RTOL["fit_pose"])

    # fit_scene_batch, frozen, K = 2n scenes: the batch axis, bit-equal
    k = 2 * n
    factors = np.linspace(0.6, 1.4, k)
    btargets = np.stack([gt.render_scene(scene(pose_size, f), device=dev)
                         for f in factors])
    bstarts = [scene(pose_size, 1.5 * f) for f in factors]
    case(f"fit_scene_batch K={k} frozen", {
        label: timed_fit(lambda cb, m=m: tfit.fit_scene_batch(
            bstarts, btargets, steps=STEPS, march="frozen", mesh=m,
            device=dev, on_step=cb)) for label, m in meshes.items()},
        0.0, bit=True)

    # fit_scene_multiview, frozen, K = n views: the view axis
    cams = orbit_path(ptruth.camera, n, 120.0)
    vtargets = np.stack([gt.render_scene(dataclasses.replace(ptruth,
                                                             camera=c),
                                         device=dev) for c in cams])
    mstart = scene(pose_size, 1.5)
    case(f"fit_scene_multiview K={n} frozen", {
        label: timed_fit(lambda cb, m=m: tfit.fit_scene_multiview(
            mstart, vtargets, cams, steps=STEPS, march="frozen", mesh=m,
            device=dev, on_step=cb)) for label, m in meshes.items()},
        RTOL["fit_scene_multiview"])

    # the XLA-form frame: row slabs, bit-equal
    frame = scene(frame_size)
    frames = {}
    for label, m in meshes.items():
        sync()
        t = time.perf_counter()
        frames[label] = (trender.render_scene(frame, device=dev) if m is None
                         else trender.render_scene(frame, mesh=m))
        sync()
        frames[label] = (frames[label], (time.perf_counter() - t) * 1e3)
    base = frames["unsharded"][0]
    same = {k: bool(np.array_equal(v[0], base)) for k, v in frames.items()}
    readings["xla frame"] = {k: {"ms": v[1], "bit_equal": same[k]}
                             for k, v in frames.items()}
    failed += [f"xla frame {k}" for k, v in same.items() if not v]
    print(f"[{card}] XLA-form frame {frame_size}^2 (host clock): " + "; ".join(
        f"{k} {v[1]:.1f} ms, bit-equal {same[k]}" for k, v in frames.items()),
        flush=True)

    print(json.dumps({"card": card, "entries": n, "readings": readings,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
