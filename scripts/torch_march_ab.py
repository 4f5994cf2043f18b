"""A/B of gamer_tpu_torch's march kernels on one CUDA card.

Builds the march kernels of an earlier source tree (``--old DIR``, holding
that tree's ``march.cu``, ``noise.cuh`` and ``noise_probe.cu``, with the
persistent kernels' C interface for frames and ray lists: a grid and a tile
counter per launch) beside variants of the package's kernels (``--variant
NAME=[DIR]@THREADS:MIN_BLOCKS``, each a copy of DIR, by default the
package's csrc/, with BLOCK_THREADS and MIN_BLOCKS replaced in march.cu; by
default one variant, csrc/ as it is). Then, on the same inputs:

- code: each variant's ptxas registers and spills per kernel and its SASS
  per function (``kernels.ptxas_report``, ``kernels.sass_functions``)
  against the old build's (registers, spills and static shared memory):
  which of the old build's functions changed, the static instruction count
  of ``march_kernel<0>``, each new function's and how many of its
  instructions differ from the same kind's frame kernel (difflib over the
  two instruction lists), the SASS mix of the perlin
  and iq frame kernels, and the resident blocks per SM of every kernel
  form;
- the iq hash table: its fill time and bytes, and its exhaustive check
  (``chip_smoke.iq_table_check``) under the first variant; the perlin
  gradient table's check (``chip_smoke.perlin_grad_check``) there too;
- holds every variant's radiance against the old kernels' bit for bit: the
  512^2 spiral still for each noise kind, its 16 row bands through the
  frame kernel (``k1_band``), the same bands through the variant's
  ``march_band`` (the dealt kernel's contiguous runs) against the old
  build's frame-kernel bands, the progressive
  launch of those 16 bands for each noise kind (one launch on the variant,
  against the old build's 16 frame-kernel bands; every band flag set,
  the tile counter at its end), the perlin progressive launch on both
  builds, the 8-frame orbit batch, the nside-512 all-sky ray list and the
  still as 2 slabs one after another, each for simplex, perlin and iq
  (S1 against an earlier tree: ``torch_mesh_cards.py --tree``); card 0
  of four's dealt share (``march_dealt``, every fourth tile row) of 8, 5
  and 3 orbit frames, S2's launch on four cards, against those rows of
  the old build's K4 frames (timed on the variants; the old build's time
  there is K4's whole frames); the iq
  scene whose hash arguments pass the table
  (``chip_smoke.iq_far_scene``: still and progressive launch), two
  instances at 64^2, dusty_disk with dither at 256^2, odd shapes (size
  100, a band past the frame's last row, 3 frames, 1000 rays);
- times K1 (each kind), the 16 bands (both forms), the progressive launch
  (simplex; perlin on both builds), the batch and the ray list (each kind)
  and the simplex slabs: CUDA events, median of the samples of two
  rounds taken in turns (old, variants..., variants reversed, old);
- ``--code-only``: the code report alone, no case run;
- ``--ablate``: the progressive launch and K1 on copies of csrc/ without
  the abort read and without the band flags, in turns with csrc/;
- for each count of spare blocks in ``--spare``, on the first variant:
  ``--tick-runs`` runs of ``render_progressive``'s ticks against the
  launch's start and end on one clock, with the host's phases
  (``chip_smoke.progressive_ticks``), without and with the smoke's host
  stall in every tick (``TICK_STALL_MS``, a viewer's PNG encode);
- ``--cold N``: N fresh processes, each timing its first
  ``render_progressive`` (after one still, as a viewer's first full render
  follows its previews) the same way;
- ``--poll N``: N bare progressive launches (no epilogue) whose band flags
  Python polls in a tight loop: when each flag was first seen, against the
  launch's start and end on one clock, the longest gap between two polls
  (a stall of the polling thread) and the garbage collector's runs.

    mkdir -p build/old_csrc
    for f in march.cu noise.cuh noise_probe.cu; do
        git show COMMIT:gamer_tpu_torch/csrc/$f > build/old_csrc/$f; done
    python3 scripts/torch_march_ab.py --old build/old_csrc --same-code \\
        --changed ILi1E --out chiprun_out/march_ab.json

Exits non-zero if a variant's radiance differs from the old kernels', a
progressive frame or its ticks differ from the still's, the iq table or
the perlin gradient check finds a differing bit, or (``--same-code``) a
variant changed an old function's ptxas report or SASS, except the
functions ``--changed`` matches: ``ILi1E`` the perlin instantiations
(against a tree from before the perlin gradient table), ``ILi2E`` the iq
ones (before the iq hash table), ``ILi[12]E`` both. Against a tree from
before the march took the reference's bookkeeping (``march_instance``'s
doubles: the step, the exit, the ray's and the chord's lengths) every
march function changes and most radiance words differ in their last bits:
run it without ``--same-code`` and read each case's ``bits_differ`` beside
its times.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import difflib
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gamer_tpu_torch import kernels  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine.allsky import allsky_dirs  # noqa: E402
from gamer_tpu_torch.engine.batch import _scene_groups  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.scene.cameracontrols import orbit_path  # noqa: E402

WORK = ROOT / "build" / "march_ab"
SIZE, BANDS, FRAMES, NSIDE = 512, 16, 8, 512
K1_SASS = "12march_kernelILi0E"
# --ablate: copies of csrc/ with one part of the progressive launch's
# bookkeeping taken out (an early return put first in a device function)
ABLATIONS = {
    "no_abort_read": ("bool aborted(const int* abort_word, int lane) {",
                      "return false;"),
    "no_band_flags": ("int* flag, int lane) {", "return;"),
}
# --wait-ab: a copy of csrc/ whose gamer_progress_wait spins without
# yielding its thread between two looks at the flags
SPIN_WAIT = [(r"std::this_thread::yield\(\);", "")]
# the frame kernels whose SASS mix the code report prints (perlin, iq)
MIX_SASS = ("12march_kernelILi1E", "12march_kernelILi2E")


def edited_sources(name: str, src: Path, edits) -> Path:
    """A copy of ``src`` under WORK with each (pattern, replacement) of
    ``edits`` made once in march.cu."""
    dst = WORK / f"csrc_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / "march.cu").read_text()
    for pattern, replacement in edits:
        text, n = re.subn(pattern, replacement, text)
        if n != 1:
            raise RuntimeError(f"{pattern!r} not found once in march.cu")
    (dst / "march.cu").write_text(text)
    return dst


def budget_edits(threads: int, min_blocks: int) -> list:
    return [(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {v};")
            for key, v in (("BLOCK_THREADS", threads),
                           ("MIN_BLOCKS", min_blocks))]


def load_old(path: Path) -> ctypes.CDLL:
    """The earlier build, with the C signatures the frame and ray-list
    wrappers call, and the progressive ones where it has them."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gamer_march_batch.argtypes = [p, i, i, i, p, i, p, p, i, i, i, i,
                                      p, p]
    lib.gamer_march_rays.argtypes = [p, i, p, i, p, p, i, p, i, i, p, p]
    if hasattr(lib, "gamer_march_progressive"):
        lib.gamer_march_progressive.argtypes = [p, i, p, i, p, p, i, i, i, i,
                                                i, p, p, p, p]
        lib.gamer_progress_wait.argtypes = [p, i, i, p, i]
    if hasattr(lib, "gamer_march_dealt"):
        lib.gamer_march_dealt.argtypes = [p, i, p, i, p, p, i, i, i, i, i,
                                          p, p]
    lib.gamer_march_occupancy.argtypes = [i, i]
    lib.gamer_march_block_threads.argtypes = []
    lib.gamer_error_string.argtypes = [i]
    lib.gamer_error_string.restype = ctypes.c_char_p
    return lib


def k1_band(page, table, rows: int, row0: int, size: int = SIZE):
    """The rows row0 + [0, rows) of a frame through the frame kernel (one
    launch of ``gamer_march_batch`` of the page, its row0 set): K1's code
    on every build."""
    return cr._launch(cr._with_row0(page[None], row0), table, size, rows)[0]


def sass_distance(a: list, b: list) -> int:
    """Instructions of ``a`` outside the longest matching runs of ``b``
    (difflib, no junk heuristic)."""
    m = difflib.SequenceMatcher(None, a, b, autojunk=False)
    return len(a) - sum(block.size for block in m.get_matching_blocks())


def use(lib) -> None:
    """Route the package's wrappers to ``lib``."""
    kernels._LIB = lib
    cr._OCCUPANCY.clear()


def code_report(path: Path, old: dict, changed: str | None = None) -> dict:
    """A build's ptxas report and SASS against the old build's (``old``:
    {"ptxas": ..., "sass": ...} of the old build, or None for the old
    build itself); the functions whose name matches ``changed`` are listed
    apart (``allowed_changed``)."""
    ptxas = kernels.ptxas_report(path.with_suffix(".log").read_text())
    sass = kernels.sass_functions(path) or {}
    report = {"ptxas": ptxas, "sass": sass,
              "k1_instructions": [len(v) for n, v in sass.items()
                                  if K1_SASS in n],
              "kernel_mix": kernels.sass_mix(path, MIX_SASS)}
    if old is not None:
        moved = [n for n in old["ptxas"] if ptxas.get(n) != old["ptxas"][n]]
        moved += [n for n in old["sass"] if sass.get(n) != old["sass"][n]
                  and n not in moved]
        allowed = [n for n in moved if changed and re.search(changed, n)]
        report["allowed_changed"] = allowed
        report["ptxas_changed"] = [n for n in old["ptxas"] if n not in allowed
                                   and ptxas.get(n) != old["ptxas"][n]]
        report["sass_changed"] = [n for n in old["sass"] if n not in allowed
                                  and sass.get(n) != old["sass"][n]]
        report["new_functions"] = {n: len(v) for n, v in sass.items()
                                   if n not in old["sass"]}
        # each new function against the frame kernel of its kind
        frame = {m.group(1): v for n, v in sass.items()
                 if (m := re.search(r"12march_kernelILi(\d)E", n))}
        report["new_vs_frame_kernel"] = {
            n: sass_distance(sass[n], frame[m.group(1)])
            for n in report["new_functions"]
            if (m := re.search(r"ILi(\d)E", n)) and m.group(1) in frame}
    return report


def cases(dev, held: list):
    """name -> (fn() under the old build, fn() under a variant, timed?),
    each giving radiance; ``held`` keeps every progressive launch until the
    caller has synchronized."""
    out = {}

    def same(name, fn, timed=False):
        out[name] = (fn, fn, timed)

    def still(name, scene, timed=False):
        page, table, size, _ = cr.prepare(scene, dev)
        same(name, lambda: cr.march(page, table, size), timed)

    band_rows, n_bands = cr.band_geometry(SIZE, 1, BANDS)
    for kind in cr.NOISE_KINDS:
        scene = cs.spiral_scene(SIZE, noise_kind=kind)
        still(f"K1 {kind} {SIZE}^2", scene, True)
        page, table, _, _ = cr.prepare(scene, dev)

        def sweep(page=page, table=table):
            return torch.cat([k1_band(page, table, band_rows, b * band_rows)
                              for b in range(n_bands)])

        def band_sweep(page=page, table=table):
            return torch.cat([cr.march_band(page, table, SIZE, band_rows,
                                            b * band_rows)
                              for b in range(n_bands)])

        def progressive(page=page, table=table):
            held.append(cr.march_progressive(page, table, SIZE, band_rows,
                                             n_bands))
            return held[-1].out

        if kind == "simplex":
            same(f"K5 {n_bands} bands of {SIZE}^2", sweep, True)
            out[f"K5 {n_bands} bands of {SIZE}^2 as march_band"] = (
                sweep, band_sweep, True)
        out[f"K5 {kind} as one launch of {n_bands} bands"] = (
            sweep, progressive, kind == "simplex")
        if kind == "perlin":
            same("K5 perlin one launch on both builds", progressive, True)
    far = cs.iq_far_scene(SIZE)
    still(f"K1 iq past the table {SIZE}^2", far, True)
    page, table, _, _ = cr.prepare(far, dev)

    def far_sweep(page=page, table=table):
        return torch.cat([k1_band(page, table, band_rows, b * band_rows)
                          for b in range(n_bands)])

    def far_progressive(page=page, table=table):
        held.append(cr.march_progressive(page, table, SIZE, band_rows,
                                         n_bands))
        return held[-1].out

    out[f"K5 iq past the table as one launch of {n_bands} bands"] = (
        far_sweep, far_progressive, False)
    sky = torch.as_tensor(allsky_dirs(NSIDE), device=dev)
    for kind in cr.NOISE_KINDS:
        label = "" if kind == "simplex" else f" {kind}"
        main = cs.spiral_scene(SIZE, noise_kind=kind)
        fly = [dataclasses.replace(main, camera=c)
               for c in orbit_path(main.camera, FRAMES, horizontal_deg=120.0)]
        st, pages, _ = _scene_groups(fly)[0]
        fly_pages = torch.as_tensor(pages, device=dev)
        fly_tab = cr.upload_table(cr._build_table(st, cr._build_layout(st)),
                                  dev)
        same(f"K4{label} {FRAMES}-frame orbit {SIZE}^2",
             lambda p=fly_pages, t=fly_tab: cr.march_batch(p, t, SIZE), True)
        if kind == "simplex":
            # S2 on four cards: card 0's dealt share (tile rows 0, 4, ...) of
            # the first n orbit frames, against those rows of K4's frames
            for n in (FRAMES, 5, 3):
                def k4_rows(p=fly_pages[:n], t=fly_tab):
                    return cr.march_batch(p, t, SIZE).view(
                        p.shape[0], SIZE // cr.TILE_H, cr.TILE_H, SIZE,
                        3)[:, 0::4].reshape(p.shape[0], -1, SIZE, 3)

                out[f"S2 card 0 of 4, {n} orbit frames {SIZE}^2"] = (
                    k4_rows, lambda p=fly_pages[:n], t=fly_tab: cr.march_dealt(
                        p, t, SIZE, 0, 4, SIZE // cr.TILE_H // 4), True)
        sky_page, sky_tab, _, _ = cr.prepare(cs.allsky_scene(noise_kind=kind),
                                             dev)
        same(f"K6{label} nside {NSIDE}",
             lambda p=sky_page, t=sky_tab: cr.march_rays(p, t, sky), True)
        page, table, _, _ = cr.prepare(main, dev)
        half = SIZE // 2
        same(f"2{label} slabs of {half} rows, one stream",
             lambda p=page, t=table: torch.cat(
                 [k1_band(p, t, half, r) for r in (0, half)]),
             kind == "simplex")
    sky_page, sky_tab, _, _ = cr.prepare(cs.allsky_scene(), dev)
    still("two_instance 64^2", cs.two_instance_scene(64))
    still("dusty_disk dither 256^2",
          cs.spiral_scene(256, presets.dusty_disk(), dither=True))
    for kind in cr.NOISE_KINDS:
        still(f"{kind} size 100", cs.spiral_scene(100, noise_kind=kind))
    p100, t100, _, _ = cr.prepare(cs.spiral_scene(100), dev)
    out["band rows 80-127 of 100"] = (
        lambda: k1_band(p100, t100, 48, 80, 100),
        lambda: cr.march_band(p100, t100, 100, 48, 80), False)
    small = cs.spiral_scene(100)
    st3, pages3, _ = _scene_groups(
        [dataclasses.replace(small, camera=c)
         for c in orbit_path(small.camera, 3, horizontal_deg=90.0)])[0]
    pages3 = torch.as_tensor(pages3, device=dev)
    tab3 = cr.upload_table(cr._build_table(st3, cr._build_layout(st3)), dev)
    same("3 frames of 100", lambda: cr.march_batch(pages3, tab3, 100))
    d1000 = sky[::3145][:1000].contiguous()
    same("1000 rays", lambda: cr.march_rays(sky_page, sky_tab, d1000))
    return out


def tick_summary(runs: list, n_bands: int) -> dict:
    """Each tick run's ticks against its launch, and the medians."""
    for r in runs:
        r["before_end"] = sum(t < r["end_ms"] for t in r["ticks_ms"])
    return {"runs": runs, "first_tick_ms": float(np.median(
        [r["ticks_ms"][0] for r in runs])), "end_ms": float(np.median(
            [r["end_ms"] for r in runs])), "wall_ms": float(np.median(
                [r["wall_ms"] for r in runs])),
        "first_after_end": sum(r["ticks_ms"][0] >= r["end_ms"]
                               for r in runs), "n_bands": n_bands,
        "gc": [p for r in runs for p in r["phases"] if p[0] == "gc"]}


def print_ticks(label: str, summary: dict) -> None:
    n = summary["n_bands"]
    for r in summary["runs"]:
        late = r["ticks_ms"][0] >= r["end_ms"]
        print(f"{label}: ticks at {[round(t, 3) for t in r['ticks_ms']]} ms;"
              f" launch {r['start_ms']:.3f}-{r['end_ms']:.3f} ms; "
              f"{r['before_end']} of {n} ticks before its end; wall "
              f"{r['wall_ms']:.3f} ms"
              + (f"; FIRST TICK AFTER THE END, host phases {r['phases']}"
                 if late else ""), flush=True)
    print(f"{label}: medians of {len(summary['runs'])}: first tick "
          f"{summary['first_tick_ms']:.3f} ms, launch end "
          f"{summary['end_ms']:.3f} ms, wall {summary['wall_ms']:.3f} ms; "
          f"first tick after the launch's end in "
          f"{summary['first_after_end']} runs; garbage collections during "
          f"the runs (generation, freed, start, end): {summary['gc']}",
          flush=True)


def tick_runs(scene, frame, n_bands, stall_ms: float, runs: int):
    """``runs`` tick runs after a warm-up: (frames and ticks right?,
    summary)."""
    cs.progressive_ticks(scene, BANDS, stall_ms=stall_ms)  # warm-up
    ok, rows = True, []
    want = [(b + 1) / n_bands for b in range(n_bands)]
    for _ in range(runs):
        r = cs.progressive_ticks(scene, BANDS, stall_ms=stall_ms)
        ok &= np.array_equal(r.pop("img"), frame) and r["fracs"] == want
        rows.append(r)
    return ok, tick_summary(rows, n_bands)


def poll_run(page, table, band_rows: int, n_bands: int) -> dict:
    """One progressive launch whose flags are polled from Python until
    every band is seen: each band's first sighting, the launch's start and
    end (CUDA events mapped to the host clock by an event recorded on the
    idle stream), ms after the launch call, the longest gap between two
    polls with the time it ended, and each collection of Python's garbage
    collector (generation, start, end)."""
    import gc
    import time

    collections, began = [], []

    def collected(what, info):
        if what == "start":
            began.append(time.perf_counter())
        elif began:
            collections.append((info["generation"], began.pop(),
                                time.perf_counter()))

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    ev[1].record()
    launch = cr.march_progressive(page, table, SIZE, band_rows, n_bands)
    ev[2].record()
    flags = launch.flags.numpy()  # the pinned words the launch writes
    seen = np.full(n_bands, np.nan)
    gap, gap_at, last = 0.0, 0.0, time.perf_counter()
    gc.callbacks.append(collected)
    try:
        while np.isnan(seen).any():
            now = time.perf_counter()
            if now - last > gap:
                gap, gap_at = now - last, now
            last = now
            seen[np.isnan(seen) & (flags != 0)] = (now - t0) * 1e3
    finally:
        gc.callbacks.remove(collected)
    launch.stop()
    return {"seen_ms": seen.tolist(), "start_ms": ev[0].elapsed_time(ev[1]),
            "end_ms": ev[0].elapsed_time(ev[2]), "gap_ms": gap * 1e3,
            "gap_end_ms": (gap_at - t0) * 1e3,
            "gc": [(g, round((a - t0) * 1e3, 3), round((b - t0) * 1e3, 3))
                   for g, a, b in collections]}


def cold_child(lib_path: str) -> int:
    """One fresh process's first render_progressive after one still: one
    JSON line of its tick run (frame and ticks checked)."""
    use(kernels.load(Path(lib_path)))
    main = cs.spiral_scene(SIZE)
    frame = cr.render_scene(main, device="cuda")
    r = cs.progressive_ticks(main, BANDS)
    n_bands = cr.band_geometry(SIZE, 1, BANDS)[1]
    r["ok"] = bool(np.array_equal(r.pop("img"), frame)
                   and r["fracs"] == [(b + 1) / n_bands
                                      for b in range(n_bands)])
    print(json.dumps(r))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=[DIR]@THREADS:MIN_BLOCKS (default: csrc/ as "
                         "it is)")
    ap.add_argument("--same-code", action="store_true",
                    help="fail if a variant changed an old function's code")
    ap.add_argument("--changed", help="a regex of the functions --same-code "
                                      "lets change (ILi1E: the perlin kernels, "
                                      "ILi2E: the iq kernels)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--spare", type=int, nargs="*", default=[])
    ap.add_argument("--tick-runs", type=int, default=5)
    ap.add_argument("--cold", type=int, default=0)
    ap.add_argument("--poll", type=int, default=0)
    ap.add_argument("--wait-ab", type=int, default=0)
    ap.add_argument("--cold-child", help=argparse.SUPPRESS)
    ap.add_argument("--code-only", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_march_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if args.cold_child:
        return cold_child(args.cold_child)
    if args.old is None:
        ap.error("--old is required")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card} (torch {torch.__version__}, cuda "
          f"{torch.version.cuda})", flush=True)

    builds = {"old": (args.old, WORK / "old")}
    for spec in args.variant or [None]:
        if spec is None:
            builds["csrc"] = (kernels.CSRC, WORK / "csrc")
            continue
        name, rest = spec.split("=", 1)
        where, budget = rest.split("@")
        threads, blocks = (int(v) for v in budget.split(":"))
        src = edited_sources(name, Path(where) if where else kernels.CSRC,
                             budget_edits(threads, blocks))
        builds[name] = (src, src / "lib")
    for name, (head, stmt) in ABLATIONS.items() if args.ablate else ():
        src = edited_sources(name, kernels.CSRC,
                             [(re.escape(head), f"{head} {stmt}")])
        builds[name] = (src, src / "lib")
    if args.wait_ab:
        src = edited_sources("spin_wait", kernels.CSRC, SPIN_WAIT)
        builds["spin_wait"] = (src, src / "lib")
    with ThreadPoolExecutor(len(builds)) as pool:  # nvcc runs in parallel
        paths = dict(zip(builds, pool.map(
            lambda b: kernels.build(*b, kernels.SOURCES), builds.values())))
    ok = True

    # --- code: ptxas report and SASS against the old build's ---------------
    old_code = code_report(paths["old"], None)
    old = load_old(paths.pop("old"))
    print(f"old: march_kernel<0> {old_code['k1_instructions']} "
          f"instructions; ptxas "
          f"{ {n: v for n, v in old_code['ptxas'].items() if 'march' in n} }",
          flush=True)
    ablated = {n: kernels.load(paths.pop(n)) for n in ABLATIONS
               if n in paths}
    spin = kernels.load(paths.pop("spin_wait")) if args.wait_ab else None
    variants, record = {}, {"card": card, "cases": {}, "variants": {}}
    for name, path in paths.items():
        lib = variants[name] = kernels.load(path)
        code = code_report(path, old_code, args.changed)
        with torch.cuda.device(dev):
            occ = {f"{kind} form {form}": lib.gamer_march_occupancy(k, form)
                   for k, kind in enumerate(cr.NOISE_KINDS)
                   for form in (cr.FORM_FRAMES, cr.FORM_RAYS,
                                cr.FORM_PROGRESSIVE, cr.FORM_DEALT,
                                cr.FORM_DEALT_STACK)}
        report = {"block_threads": lib.gamer_march_block_threads(),
                  "blocks_per_sm": occ,
                  "ptxas": {n: v for n, v in code["ptxas"].items()
                            if "march" in n},
                  **{k: code[k] for k in (
                      "k1_instructions", "kernel_mix", "ptxas_changed",
                      "sass_changed", "allowed_changed", "new_functions",
                      "new_vs_frame_kernel")}}
        same_code = not code["ptxas_changed"] and not code["sass_changed"]
        if args.same_code:
            ok &= same_code and bool(old_code["sass"])
        record["variants"][name] = report
        print(f"variant {name}: {json.dumps(report)}; the old build's "
              f"{len(old_code['sass'])} functions "
              f"{'unchanged' if same_code else 'CHANGED'}", flush=True)
    print(f"old: perlin and iq kernel SASS mix {old_code['kernel_mix']}",
          flush=True)
    if args.code_only:
        return 0 if ok else 1

    # --- the iq hash table: built once, by the first variant ---------------
    from gamer_tpu_torch.ops import noise as tnoise

    first = next(iter(variants))
    use(variants[first])
    iq_table = tnoise.iq_hash_table(dev)
    table_bad, check_ms = cs.iq_table_check(dev)
    table_ok = (table_bad["pairs"] == table_bad["corners"] == 0
                and table_bad["fallback"] == table_bad["fallback_expected"])
    ok &= table_ok
    record["iq_table"] = {"build_ms": tnoise.iq_hash_table.build_ms[0],
                          "bytes": iq_table.numel() * 4,
                          "r": tnoise.IQ_TABLE_R, "check": table_bad,
                          "check_ms": check_ms}
    print(f"iq table [{first}]: {json.dumps(record['iq_table'])}: "
          f"{'bit-equal' if table_ok else 'DIFFERS'}", flush=True)
    grads_bad, grads_ms = cs.perlin_grad_check(dev)
    ok &= grads_bad == {"entries": 0, "dots": 0}
    record["perlin_grads"] = {"check": grads_bad, "check_ms": grads_ms}
    print(f"perlin gradient table [{first}]: {json.dumps(grads_bad)} in "
          f"{grads_ms:.4f} ms", flush=True)

    # --- every case: bit for bit against the old build, timed in turns -----
    held = []
    for case, (run_old, run_new, timed) in cases(dev, held).items():
        use(old)
        want = run_old()
        row = {}
        for name, lib in variants.items():
            use(lib)
            got = run_new()
            torch.cuda.synchronize()
            differ = int((got[:want.shape[0]].view(torch.int32)
                          != want.view(torch.int32)).sum())
            row[name] = {"bits_differ": differ}
            if held:  # the progressive launch: flags and tile counter
                launch = held[-1]
                tiles = cr.frame_tiles(SIZE, launch.out.shape[0])
                c = launch.counters.cpu().tolist()
                row[name]["flags_and_counters"] = (
                    launch.flags.tolist() == [1] * (len(c) - 1)
                    and c[0] >= tiles and len(set(c[1:])) == 1
                    and sum(c[1:]) == tiles)
                differ += not row[name]["flags_and_counters"]
            ok &= differ == 0
        if timed:
            samples = {n: [] for n in ["old", *variants]}
            order = ["old", *variants]
            for turn in (order, order[::-1]):
                for name in turn:
                    use(old if name == "old" else variants[name])
                    fn = run_old if name == "old" else run_new
                    fn()  # warm-up
                    samples[name].append(cs.cuda_ms(fn, args.reps)[0])
            row["old_ms"] = float(np.median(samples["old"]))
            for name in variants:
                row[name]["ms"] = float(np.median(samples[name]))
                row[name]["vs_old"] = row[name]["ms"] / row["old_ms"] - 1
        held.clear()
        record["cases"][case] = row
        print(f"{case}: {json.dumps(row)}", flush=True)
    use(variants[first])

    page, table, _, _ = cr.prepare(cs.spiral_scene(SIZE), dev)
    band_rows, n_bands = cr.band_geometry(SIZE, 1, BANDS)

    def progressive():
        held.append(cr.march_progressive(page, table, SIZE, band_rows,
                                         n_bands))
        return held[-1].out

    def k1():
        return cr.march(page, table, SIZE)

    # --- ablations: the progressive launch and K1 on each build, in turns ---
    if ablated:
        builds = {first: variants[first], **ablated}
        samples = {n: {"progressive": [], "k1": []} for n in builds}
        for who in list(builds) + list(builds)[::-1]:
            use(builds[who])
            progressive()
            samples[who]["progressive"].append(
                cs.cuda_ms(progressive, args.reps)[0])
            samples[who]["k1"].append(cs.cuda_ms(k1, args.reps)[0])
            held.clear()
        use(variants[first])
        record["ablate"] = samples
        for n, s in samples.items():
            print(f"timing [{card}] ablation {n}: progressive launch "
                  f"{float(np.median(s['progressive'])):.3f} ms, K1 "
                  f"{float(np.median(s['k1'])):.3f} ms (samples {s})",
                  flush=True)

    # --- the ticks against the launch, per count of spare blocks -----------
    main_scene = cs.spiral_scene(SIZE)
    frame = cr.render_scene(main_scene, device="cuda")
    real_spare = cr.PROGRESS_SPARE_BLOCKS
    record["spare"] = {}
    for spare in args.spare:
        cr.PROGRESS_SPARE_BLOCKS = spare
        progressive()
        rows = {"progressive_ms": cs.cuda_ms(progressive, args.reps)[0],
                "k1_ms": cs.cuda_ms(k1, args.reps)[0]}
        held.clear()
        for stall in (0.0, cs.TICK_STALL_MS):
            good, summary = tick_runs(main_scene, frame, n_bands, stall,
                                      args.tick_runs)
            ok &= good
            print_ticks(f"spare {spare}, stall {stall:g} ms", summary)
            rows[f"stall {stall:g} ms"] = summary
        print(f"timing [{card}] spare {spare}: progressive launch "
              f"{rows['progressive_ms']:.3f} ms, K1 {rows['k1_ms']:.3f} ms "
              f"(CUDA events, median of {args.reps})", flush=True)
        record["spare"][spare] = rows
    cr.PROGRESS_SPARE_BLOCKS = real_spare

    # --- bare launches, their flags polled from Python ----------------------
    if args.poll:
        poll_run(page, table, band_rows, n_bands)  # warm-up
        runs = [poll_run(page, table, band_rows, n_bands)
                for _ in range(args.poll)]
        seen0 = np.array([r["seen_ms"][0] - r["start_ms"] for r in runs])
        late = [r for r, f in zip(runs, seen0) if f > np.median(seen0) + 2.0]
        print(f"poll, {len(runs)} bare launches: band 0 first seen "
              f"{np.median(seen0):.3f} ms after the launch's start (median; "
              f"min {seen0.min():.3f}, max {seen0.max():.3f}); the launch "
              f"{np.median([r['end_ms'] - r['start_ms'] for r in runs]):.3f}"
              f" ms; polls stalled > 1 ms in "
              f"{sum(r['gap_ms'] > 1.0 for r in runs)} runs (longest "
              f"{max(r['gap_ms'] for r in runs):.3f} ms); band 0 seen > 2 ms "
              f"after the median in {len(late)} runs", flush=True)
        for r in late + [r for r in runs if r["gap_ms"] > 1.0]:
            print(f"poll run: bands seen at "
                  f"{[round(x, 3) for x in r['seen_ms']]} ms; launch "
                  f"{r['start_ms']:.3f}-{r['end_ms']:.3f} ms; longest poll "
                  f"gap {r['gap_ms']:.3f} ms, ending at "
                  f"{r['gap_end_ms']:.3f} ms; garbage collections "
                  f"(generation, start, end) {r['gc']}", flush=True)
        gcs = [c for r in runs for c in r["gc"]]
        print(f"poll: {len(gcs)} garbage collections in {len(runs)} runs, "
              f"{sum(c[0] == 2 for c in gcs)} of generation 2; longest "
              f"{max((c[2] - c[1] for c in gcs), default=0.0):.3f} ms",
              flush=True)
        record["poll"] = runs

    # --- the host's wait: yielding between looks, or spinning --------------
    if spin is not None:
        waits = {first: [], "spin_wait": []}
        for block in range(2 * args.wait_ab // 50):
            who = first if block % 2 == 0 else "spin_wait"
            use(variants[first] if who == first else spin)
            for _ in range(50):
                r = cs.progressive_ticks(main_scene, BANDS)
                ok &= np.array_equal(r.pop("img"), frame)
                wait0 = next(p for p in r["phases"] if p[0] == "wait")
                waits[who].append((r["ticks_ms"][0] - r["start_ms"],
                                   r["ticks_ms"][0] >= r["end_ms"],
                                   wait0[2], wait0[4] - r["start_ms"]))
        use(variants[first])
        record["wait_ab"] = waits
        for who, rows in waits.items():
            back = np.array([w[3] for w in rows])
            print(f"wait A/B {who}: {len(rows)} tick runs; first tick "
                  f"{np.median([w[0] for w in rows]):.3f} ms after the "
                  f"launch's start (median, max "
                  f"{max(w[0] for w in rows):.3f}); after the launch's end "
                  f"in {sum(w[1] for w in rows)}; the first wait returned "
                  f"more than one band in {sum(w[2] > 1 for w in rows)}, "
                  f"> 2 ms after its median ({np.median(back):.3f} ms after "
                  f"the start) in {int((back > np.median(back) + 2).sum())}",
                  flush=True)

    # --- the first progressive frame of fresh processes --------------------
    if args.cold:
        runs = []
        for _ in range(args.cold):
            child = subprocess.run(
                [sys.executable, __file__, "--cold-child",
                 str(paths[first])], capture_output=True, text=True,
                timeout=300)
            if child.returncode != 0:
                print(child.stderr[-2000:], flush=True)
                ok = False
                continue
            runs.append(json.loads(child.stdout.strip().splitlines()[-1]))
            ok &= runs[-1].pop("ok")
        if runs:
            summary = tick_summary(runs, n_bands)
            print_ticks("cold process, stall 0 ms", summary)
            for r in runs:
                print(f"cold process host phases: {r['phases']}", flush=True)
            record["cold"] = summary
    print(f"ok: {ok}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
