"""A/B of gamer_tpu_torch's march kernels on one CUDA card.

Builds the march kernels of an earlier source tree (``--old DIR``, holding
that tree's ``march.cu`` and ``noise.cuh``: one thread per pixel, a fixed
grid, the plain PERM[512] and Perlin permutation as lookup tables) beside
variants of the package's kernels (``--variant NAME=[DIR]@THREADS:MIN_BLOCKS``,
each a copy of DIR, by default the package's csrc/, with BLOCK_THREADS and
MIN_BLOCKS replaced in march.cu). Then, on the same inputs:

- holds every variant's radiance against the old kernels' bit for bit: the
  512^2 spiral still for each noise kind, its 16 row bands, the 8-frame
  orbit batch, the nside-512 all-sky ray list, two instances at 64^2,
  dusty_disk with dither at 256^2, odd shapes (size 100, a band past the
  frame's last row, 3 frames, 1000 rays), and the still as 2 and 4
  concurrent row slabs on one card (S1's pattern) and as 2 slabs one
  after another;
- prints each variant's ptxas registers and spills, resident blocks per
  SM, the static SASS mix of its frame kernels, and the times of K1 (each
  kind), the 16 bands, the batch, the ray list and the slabs: CUDA events,
  median of the samples of two rounds taken in turns (old, variants...,
  variants reversed, old).

    mkdir -p build/old_csrc
    for f in march.cu noise.cuh; do
        git show COMMIT:gamer_tpu_torch/csrc/$f > build/old_csrc/$f; done
    python3 scripts/torch_march_ab.py --old build/old_csrc \
        --variant a=@256:3 --variant b=@256:4 --variant c=@128:8 \
        --out build/march_ab/record.json

Exits non-zero if any variant's radiance differs from the old kernels'.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import shutil
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
from gamer_tpu_torch.ops.altnoise import perlin_perm_table  # noqa: E402
from gamer_tpu_torch.ops.noise import perm_table  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.scene.cameracontrols import orbit_path  # noqa: E402

WORK = ROOT / "build" / "march_ab"
SIZE, BANDS, FRAMES, NSIDE = 512, 16, 8, 512


def variant_sources(name: str, src: Path, threads: int,
                    min_blocks: int) -> Path:
    """A copy of ``src`` with the register budget replaced."""
    dst = WORK / f"csrc_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / "march.cu").read_text()
    for key, value in (("BLOCK_THREADS", threads), ("MIN_BLOCKS", min_blocks)):
        text, n = re.subn(rf"constexpr int {key} = \d+;",
                          f"constexpr int {key} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{key} not found once in {dst / 'march.cu'}")
    (dst / "march.cu").write_text(text)
    return dst


def ptxas_report(lib_path: Path) -> list:
    """(kernel, registers, spill stores, spill loads) of each march kernel
    in the build log."""
    rows, name = [], None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or "march" not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            short = re.sub(r"_ZN5gamer\d+(\w+?)ILi(\d)E.*", r"\1<\2>", name)
            rows.append((short, int(m.group(1)), *spill))
            name = None
    return rows


class Old:
    """The earlier tree's kernels through their own C interface."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.gamer_march_batch.argtypes = [p, i, i, i, p, i, p, p, i, i,
                                               i, p]
        self.lib.gamer_march_rays.argtypes = [p, i, p, i, p, p, i, p, i, p]

    @staticmethod
    def _table(kind: int, dev):
        if cr.NOISE_KINDS[kind] == "perlin":
            return perlin_perm_table(dev, torch.int32)
        return perm_table(dev, torch.int32)

    def frames(self, pages, table, frame_size, rows):
        kind = cr._table_kind(table)
        n, n_page = pages.shape
        out = torch.empty((n, rows, frame_size, 3), device=pages.device)
        rc = self.lib.gamer_march_batch(
            pages.data_ptr(), n_page, n_page, n, table.data_ptr(),
            table.numel(), self._table(kind, pages.device).data_ptr(),
            out.data_ptr(), frame_size, rows, kind,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old march launch failed: {rc}")
        return out

    def rays(self, page, table, dirs):
        kind = cr._table_kind(table)
        out = torch.empty_like(dirs)
        rc = self.lib.gamer_march_rays(
            page.data_ptr(), page.numel(), table.data_ptr(), table.numel(),
            self._table(kind, page.device).data_ptr(), dirs.data_ptr(),
            dirs.shape[0], out.data_ptr(), kind,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old ray launch failed: {rc}")
        return out


def use(lib) -> None:
    """Route the package's wrappers to ``lib``."""
    kernels._LIB = lib
    cr._OCCUPANCY.clear()


def cases(dev):
    """name -> (fn(old) -> radiance, fn() -> radiance, timed?) where the
    first runs the old kernels and the second the package's wrappers."""
    out = {}

    def still(name, scene, timed=False):
        page, table, size, _ = cr.prepare(scene, dev)
        out[name] = (lambda o: o.frames(page[None], table, size, size)[0],
                     lambda: cr.march(page, table, size), timed)

    for kind in cr.NOISE_KINDS:
        still(f"K1 {kind} {SIZE}^2", cs.spiral_scene(SIZE, noise_kind=kind),
              True)
    page, table, _, _ = cr.prepare(cs.spiral_scene(SIZE), dev)
    band_rows, n_bands = cr.band_geometry(SIZE, 1, BANDS)
    out[f"K5 {n_bands} bands of {SIZE}^2"] = (
        lambda o: torch.cat([o.frames(cr._with_row0(page, b * band_rows)[None],
                                      table, SIZE, band_rows)[0]
                             for b in range(n_bands)]),
        lambda: torch.cat([cr.march_band(page, table, SIZE, band_rows,
                                         b * band_rows)
                           for b in range(n_bands)]), True)
    main = cs.spiral_scene(SIZE)
    fly = [dataclasses.replace(main, camera=c)
           for c in orbit_path(main.camera, FRAMES, horizontal_deg=120.0)]
    st, pages, _ = _scene_groups(fly)[0]
    fly_pages = torch.as_tensor(pages, device=dev)
    fly_tab = cr.upload_table(cr._build_table(st, cr._build_layout(st)), dev)
    out[f"K4 {FRAMES}-frame orbit {SIZE}^2"] = (
        lambda o: o.frames(fly_pages, fly_tab, SIZE, SIZE),
        lambda: cr.march_batch(fly_pages, fly_tab, SIZE), True)
    sky_page, sky_tab, _, _ = cr.prepare(cs.allsky_scene(), dev)
    sky = torch.as_tensor(allsky_dirs(NSIDE), device=dev)
    out[f"K6 nside {NSIDE}"] = (lambda o: o.rays(sky_page, sky_tab, sky),
                                lambda: cr.march_rays(sky_page, sky_tab, sky),
                                True)
    still("two_instance 64^2", cs.two_instance_scene(64))
    still("dusty_disk dither 256^2",
          cs.spiral_scene(256, presets.dusty_disk(), dither=True))
    for kind in cr.NOISE_KINDS:
        still(f"{kind} size 100", cs.spiral_scene(100, noise_kind=kind))
    p100, t100, _, _ = cr.prepare(cs.spiral_scene(100), dev)
    out["band rows 80-127 of 100"] = (
        lambda o: o.frames(cr._with_row0(p100, 80)[None], t100, 100, 48)[0],
        lambda: cr.march_band(p100, t100, 100, 48, 80), False)
    small = cs.spiral_scene(100)
    st3, pages3, _ = _scene_groups(
        [dataclasses.replace(small, camera=c)
         for c in orbit_path(small.camera, 3, horizontal_deg=90.0)])[0]
    pages3 = torch.as_tensor(pages3, device=dev)
    tab3 = cr.upload_table(cr._build_table(st3, cr._build_layout(st3)), dev)
    out["3 frames of 100"] = (lambda o: o.frames(pages3, tab3, 100, 100),
                              lambda: cr.march_batch(pages3, tab3, 100), False)
    d1000 = sky[::3145][:1000].contiguous()
    out["1000 rays"] = (lambda o: o.rays(sky_page, sky_tab, d1000),
                        lambda: cr.march_rays(sky_page, sky_tab, d1000), False)
    # S1 on a mesh that names the card n times: n concurrent slab launches
    for n in (2, 4):
        mesh = Mesh(["cuda:0"] * n)
        streams = [torch.cuda.Stream(dev) for _ in range(n)]
        out[f"S1 {SIZE}^2 on {n} entries of one card"] = (
            lambda o, n=n, st=streams: _old_slabs(o, page, table, n, st),
            lambda m=mesh: cr.march_rowshard(page, table, SIZE, m), True)
    half = SIZE // 2
    out[f"2 slabs of {half} rows, one stream"] = (
        lambda o: torch.cat([o.frames(cr._with_row0(page, r)[None], table,
                                      SIZE, half)[0] for r in (0, half)]),
        lambda: torch.cat([cr.march_band(page, table, SIZE, half, r)
                           for r in (0, half)]), True)
    return out


def _old_slabs(o, page, table, n, streams):
    """The old kernels in S1's pattern: the frame's n row slabs, each
    launched on a stream of its own after the caller's, assembled on the
    caller's stream."""
    rows = cr.slab_rows(SIZE, n)
    cur = torch.cuda.current_stream()
    outs = []
    for i, s in enumerate(streams):
        r0 = i * rows
        if r0 >= SIZE:
            break
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            outs.append(o.frames(cr._with_row0(page, r0)[None], table, SIZE,
                                 min(rows, SIZE - r0))[0])
    for s, t in zip(streams, outs):
        cur.wait_stream(s)
        t.record_stream(cur)
    return torch.cat(outs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=[DIR]@THREADS:MIN_BLOCKS (default: csrc/ as "
                         "it is)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_march_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}", flush=True)

    builds = {"old": (args.old, WORK / "old", ("march.cu",))}
    for spec in args.variant or [None]:
        if spec is None:
            builds["csrc"] = (kernels.CSRC, WORK / "csrc", kernels.SOURCES)
            continue
        name, rest = spec.split("=", 1)
        where, budget = rest.split("@")
        threads, blocks = (int(v) for v in budget.split(":"))
        src = variant_sources(name, Path(where) if where else kernels.CSRC,
                              threads, blocks)
        builds[name] = (src, src / "lib", kernels.SOURCES)
    with ThreadPoolExecutor(len(builds)) as pool:  # nvcc runs in parallel
        paths = dict(zip(builds, pool.map(lambda b: kernels.build(*b),
                                          builds.values())))
    old = Old(paths.pop("old"))
    variants = {}
    for name, path in paths.items():
        variants[name] = kernels.load(path)
        report = {"ptxas": ptxas_report(path),
                  "block_threads": variants[name].gamer_march_block_threads(),
                  "sass": kernels.sass_mix(path, [
                      f"12march_kernelILi{k}E"
                      for k in range(len(cr.NOISE_KINDS))])}
        with torch.cuda.device(dev):
            report["blocks_per_sm"] = {
                f"{k}{'_rays' if r else ''}":
                    variants[name].gamer_march_occupancy(i, r)
                for i, k in enumerate(cr.NOISE_KINDS) for r in (0, 1)}
        variants[name].report = report
        print(f"variant {name}: {json.dumps(report)}", flush=True)

    record = {"card": card, "cases": {}, "variants": {
        n: v.report for n, v in variants.items()}}
    bad = 0
    for case, (run_old, run_new, timed) in cases(dev).items():
        want = run_old(old)
        row = {}
        for name, lib in variants.items():
            use(lib)
            got = run_new()
            torch.cuda.synchronize()
            differ = int((got.view(torch.int32)
                          != want.view(torch.int32)).sum())
            bad += differ > 0
            row[name] = {"bits_differ": differ}
        if timed:
            samples = {n: [] for n in ["old", *variants]}
            order = ["old", *variants]
            for turn in (order, order[::-1]):
                for name in turn:
                    if name == "old":
                        fn = lambda: run_old(old)  # noqa: E731
                    else:
                        use(variants[name])
                        fn = run_new
                    fn()  # warm-up
                    samples[name].append(cs.cuda_ms(fn, args.reps)[0])
            row["old_ms"] = float(np.median(samples["old"]))
            for name in variants:
                row[name]["ms"] = float(np.median(samples[name]))
        record["cases"][case] = row
        print(f"{case}: {json.dumps(row)}", flush=True)
    print(f"bit-equal to the old kernels on every case: {bad == 0}",
          flush=True)
    print(json.dumps(record), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
