"""The sharded launches (S1, S2, S3), the sharded autograd fits and the
sharded XLA-form frame of gamer_tpu_torch on a mesh of several cards,
beside the same calls on one card: the results held to the same gates as
chip_smoke.py's (JAX's tolerances for its own sharded fits; S1, S2, S3,
the batch and the XLA-form frame bit for bit), the times and peak memory
printed for each.

    python3 scripts/torch_mesh_cards.py            # every visible card
    python3 scripts/torch_mesh_cards.py --cpu 4    # 4 CPU entries, tiny sizes
    python3 scripts/torch_mesh_cards.py --launches-only   # S1-S3 alone
    python3 scripts/torch_mesh_cards.py --launches-only --entries 4
        # S1-S3 on 4 entries over the visible cards in turn
    python3 scripts/torch_mesh_cards.py --launches-only --tree DIR
        # the same cases on another tree's gamer_tpu_torch (and its
        # chip_smoke.py), e.g. an earlier commit unpacked with git archive
    python3 scripts/torch_mesh_cards.py --launches-only --only "S2 " \
        --bounds build/s2_bounds.json [--tree DIR]
        # S2's cases alone; the bounds' plain runs made once and reused
        # by the next run that names the same file
    python3 scripts/torch_mesh_cards.py --launches-only --entries 4 \
        --only "S1 512^2" --reps 64 [--pages-ahead]
        # one case, 64 calls: S1's call-to-call spread on one card

S1 and S3 (``--launches-only`` runs them alone): ``render_scene(scene,
mesh=)`` on the smoke's spiral at 512^2, 2048^2 and 4096^2 (simplex;
perlin and iq at 4096^2) and ``render_allsky_map(..., mesh=)`` on the
smoke's all-sky scene at nside 512 and 1024, each bit-equal to the
unsharded call; then ``march_rowshard`` / ``march_rays_rowshard`` on the
same page, with each entry's launch timed by CUDA events on that entry's
stream beside its tile count, the assembly (the copies into the first
card's tensor, events on its stream), the call's wall time until the
output is ready on the first card, and one card's ``march`` /
``march_rays`` of the same work, bit-equal; the bound per card is the
plain version's work counts at 128^2 (nside 32) scaled to the case and
divided by the entries. Each call is also timed whole by CUDA events on
the first card's stream (as chip_smoke.py times S1), with the calls that
took more than ``SLOW_OVER_MEDIAN`` times the median counted. ``--only
TEXT`` runs the cases whose name holds TEXT; ``--pages-ahead`` makes the
per-entry page copies (``cuda_render._with_row0``: the share's first row
written into a copy of the page) once, before the timed calls, so that a
call launches the march kernels and the counters' fills alone. The peer
access of every pair of cards and ``nvidia-smi topo -m`` are printed
first.

S2 (``S2_CASES``): ``render_batch_linear(scenes, mesh=)``, the entry
point that fly-throughs, dataset chunks and the fd fits' probe sets call,
on the 1-D batch mesh of the cards and on a ('batch', 'rows') mesh of two
rows over the same cards: the smoke's 8 orbit frames of the spiral at
512^2 (both meshes), 3 of them, the 5 frames of an fd probe set of two
galaxy parameters, and the seven presets, one frame each (7 structure
groups). Each entry's kernel ms is the sum of its launches (one a
structure group), beside its tiles; the bound a card is the plain
version's work counts of every frame at 128^2, scaled, over the entries;
one card is ``march_batch`` of each group's pages, one after another,
bit-equal to the sharded call's frames. On an earlier tree (``--tree``)
the same call runs that tree's S2 (whole frames, the groups padded to the
batch entries, row slabs over 'rows').

Prints one line per case and, last, a JSON object of the readings; exits
non-zero if a gate fails. With one card it compares the card named n
times with itself.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
# --tree DIR: the package and chip_smoke.py of another tree
TREE = (Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
        if "--tree" in sys.argv else ROOT)
sys.path.insert(0, str(TREE))

# the smoke's gates and scenes, so the two hold the fits to one standard
from chip_smoke import (  # noqa: E402
    FIT_STEPS as STEPS,
    MESH_FIT_RTOL as RTOL,
    POSE_START,
    _rel as rel,
    allsky_scene,
    card_line,
    march_bound,
    scaled,
    spiral_scene,
)

# S1's frames (size, noise kind) and S3's skies (nside) on the card, and
# their reduced forms on CPU entries
S1_CASES = ((512, "simplex"), (2048, "simplex"), (4096, "simplex"),
            (4096, "perlin"), (4096, "iq"))
S3_NSIDES = (512, 1024)
S1_CPU, S3_CPU = ((16, "simplex"), (20, "iq")), (4,)
# S2's cases: name -> (frames, 2-D mesh?) at S2_SIZE (S2_CPU on CPU
# entries); the frames are "orbit N", "fd" (an fd probe set: the spiral,
# then winding_b and winding_n each x (1 +- FD_H)) or "presets"
S2_SIZE, S2_CPU, FD_H = 512, 16, 0.05
S2_CASES = {
    "S2 8 orbit frames": ("orbit 8", False),
    "S2 8 orbit frames 2x2": ("orbit 8", True),
    "S2 3 orbit frames": ("orbit 3", False),
    "S2 5 fd probe frames": ("fd", False),
    "S2 7 presets": ("presets", False),
}
# the plain run whose work counts, scaled, give a case's bound
BOUND_SIZE, BOUND_NSIDE = 128, 32
# a call this many times its case's median counts as slow
SLOW_OVER_MEDIAN = 1.05


class EntryTimes:
    """Events around each entry's launch (on the entry's stream) and
    around each copy of the assembly (on the first card's stream), taken by
    wrapping the sharded launches' per-entry wrapper (``names``) and
    ``_gather`` of cuda_render for the length of a ``with`` block. On CPU
    entries only each launch's device and tiles are kept."""

    def __init__(self, cr, names, tiles, cuda: bool):
        self.cr, self.names, self.tiles, self.cuda = cr, names, tiles, cuda
        self.launches, self.copies = [], []

    def __enter__(self):
        cr, self.saved = self.cr, {}
        for name in self.names + ("_gather",):
            if hasattr(cr, name):
                self.saved[name] = getattr(cr, name)
        for name, fn in self.saved.items():
            setattr(cr, name, self._copy(fn) if name == "_gather"
                    else self._launch(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            if hasattr(fn, "launch_count"):
                fn.launch_count = getattr(self.cr, name).launch_count
            setattr(self.cr, name, fn)

    def _launch(self, fn):
        def timed(page, *args, **kwargs):
            if not self.cuda:
                out = fn(page, *args, **kwargs)
                self.launches.append((str(page.device), None, None,
                                      self.tiles(out), None))
                return out
            stream = torch.cuda.current_stream(page.device)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record(stream)
            out = fn(page, *args, **kwargs)
            e1.record(stream)
            self.launches.append((str(page.device), e0, e1,
                                  self.tiles(out), stream.cuda_stream))
            return out
        # the wrapper counts its launches under its module name, now this
        timed.launch_count = getattr(fn, "launch_count", 0)
        return timed

    def _copy(self, fn):
        def timed(dst, src, mesh, i):
            if not self.cuda:
                return fn(dst, src, mesh, i)
            stream = torch.cuda.current_stream(dst.device)
            if mesh.stream(i) is not None:
                stream.wait_stream(mesh.stream(i))
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record(stream)
            fn(dst, src, mesh, i)
            e1.record(stream)
            self.copies.append((e0, e1))
        return timed

    def read(self):
        """([(device, kernel ms, tiles, stream)] in launch order, assembly
        ms)."""
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        return ([(dev, e0.elapsed_time(e1), t, st)
                 for dev, e0, e1, t, st in self.launches],
                sum(e0.elapsed_time(e1) for e0, e1 in self.copies))


def topology(cuda: bool) -> dict:
    """Peer access of every ordered pair of cards and nvidia-smi's
    topology matrix."""
    if not cuda:
        return {"peer": {}, "topo": "not measured (CPU entries)"}
    n = torch.cuda.device_count()
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for a in range(n) for b in range(n) if a != b}
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    return {"peer": peer, "topo": topo}


def s2_scenes(frames: str, size: int, preview: dict) -> list:
    """The scenes of an S2 case's ``frames`` (see S2_CASES)."""
    from gamer_tpu_torch.models import presets
    from gamer_tpu_torch.scene.cameracontrols import orbit_path

    base = spiral_scene(size, **preview)
    if frames.startswith("orbit "):
        cams = orbit_path(base.camera, 8, horizontal_deg=120.0)
        return [dataclasses.replace(base, camera=c)
                for c in cams[:int(frames.split()[1])]]
    if frames == "fd":
        return [base] + [scaled(base, field, 1.0 + sign * FD_H, gp=True)
                         for field in ("winding_b", "winding_n")
                         for sign in (1.0, -1.0)]
    return [spiral_scene(size, galaxy=make(), **preview)
            for make in presets.GALLERY.values()]


def per_entry(rows: list, n: int) -> list:
    """Each rep's launches summed per mesh entry (the launches of one
    stream on the card; on CPU entries launch i % n): [(device, ms, tiles,
    launches)] in the order of each entry's first launch."""
    out = []
    for r in rows:
        sums = {}
        for i, (dev, ms, tiles, stream) in enumerate(r["entries"]):
            key = (dev, stream) if stream is not None else i % n
            got = sums.setdefault(key, [dev, 0.0, 0, 0])
            got[1] += ms
            got[2] += tiles
            got[3] += 1
        out.append(dict(r, entries=[tuple(v) for v in sums.values()]))
    return out


def sharded_launch_cases(cuda: bool, cards, card: str, reps: int,
                         readings: dict, failed: list, only: str = "",
                         pages_ahead: bool = False,
                         bounds_path: Path | None = None) -> None:
    """S1, S3 and S2 on ``cards`` beside one card's K1 / K6 / K4 (see the
    module's docstring); readings["S1 ..."] / ["S3 ..."] / ["S2 ..."] per
    case."""
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine.allsky import allsky_dirs
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.parallel import Mesh

    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    n = cards.size
    s1 = [c for c in (S1_CASES if cuda else S1_CPU)
          if only in f"S1 {c[0]}^2 {c[1]}"]
    s3 = [c for c in (S3_NSIDES if cuda else S3_CPU)
          if only in f"S3 nside {c}"]
    preview = {} if cuda else {"is_preview": True, "noise_octaves": 2}
    if pages_ahead and hasattr(cr, "_with_row0"):
        made, with_row0 = {}, cr._with_row0

        def made_ahead(page, row0):
            key = (page.data_ptr(), str(page.device), tuple(page.shape),
                   int(row0))
            if key not in made:  # (the page held: its address stays its)
                made[key] = (page, with_row0(page, row0))
            return made[key][1]

        cr._with_row0 = made_ahead

    def sync():
        if cuda:
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)

    def one_card_ms(fn):
        """(median device ms of ``reps`` calls, output) on the first card."""
        if not cuda:
            return float("nan"), fn()
        times = []
        for _ in range(reps):
            sync()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            out = fn()
            e1.record()
            sync()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times)), out

    def sharded(fn, names, tiles):
        """Per rep: each entry's (device, ms, tiles), the assembly ms and
        the wall ms until the output is ready on the first card; the last
        rep's output."""
        rows, out = [], None
        for _ in range(reps):
            sync()
            with EntryTimes(cr, names, tiles, cuda) as times:
                call = [torch.cuda.Event(enable_timing=True)
                        for _ in "ab"] if cuda else None
                t0 = time.perf_counter()
                if cuda:
                    call[0].record()
                out = fn()
                if cuda:
                    call[1].record()
                    torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
            if cuda:
                entries, assembly = times.read()
                call_ms = call[0].elapsed_time(call[1])
            else:
                entries = [(d, float("nan"), t, st)
                           for d, _, _, t, st in times.launches]
                assembly = call_ms = float("nan")
            rows.append({"entries": entries, "assembly_ms": assembly,
                         "wall_ms": wall, "call_ms": call_ms})
        return rows, out

    def summary(name, rows, one_ms, bound, same, main_same):
        ms = np.array([[e[1] for e in r["entries"]] for r in rows])
        med = np.median(ms, axis=0)
        mean = float(med.mean())
        # S2's entries sum their launches (e[3]); a launch's warps
        out = {"entries": [{"device": e[0], "ms": float(m), "tiles": e[2],
                            "warps": warps(e[0], e[2] // e[3]
                                           if len(e) > 3 else e[2]),
                            "launches": e[3] if len(e) > 3 else 1}
                           for e, m in zip(rows[0]["entries"], med)],
               "entry_ms_reps": ms.tolist(),
               "heaviest_over_mean": float(med.max() / mean),
               "spread_over_mean": float((med.max() - med.min()) / mean),
               "assembly_ms": float(np.median([r["assembly_ms"]
                                               for r in rows])),
               "wall_ms": float(np.median([r["wall_ms"] for r in rows])),
               "wall_ms_reps": [r["wall_ms"] for r in rows],
               "call_ms_reps": [r["call_ms"] for r in rows],
               "one_card_ms": one_ms, "bound_per_card_ms": bound,
               "bit_equal": same, "main_path_bit_equal": main_same}
        calls = np.array(out["call_ms_reps"])
        call_med = float(np.median(calls))
        out["slow_calls"] = int((calls > SLOW_OVER_MEDIAN * call_med).sum())
        readings[name] = out
        if not (same and main_same):
            failed.append(f"{name}: not bit-equal to one card")
        print(f"[{card}] {name} on {n} entries (medians of {reps}): entries "
              + ", ".join(f"{e['device']} {e['ms']:.3f} ms / {e['tiles']} "
                          f"tiles / {e['warps']} warps"
                          for e in out["entries"])
              + f"; heaviest / mean {out['heaviest_over_mean']:.4f}, "
              f"(max - min) / mean {out['spread_over_mean']:.4f}; assembly "
              f"{out['assembly_ms']:.3f} ms; wall to the first card "
              f"{out['wall_ms']:.3f} ms; whole call median {call_med:.3f} "
              f"ms, slowest {calls.max():.3f} ms, {out['slow_calls']} of "
              f"{reps} calls above {SLOW_OVER_MEDIAN} x the median; one "
              f"card {one_ms:.3f} ms; bound "
              f"per card {bound:.4f} ms; "
              f"{'bit-equal' if cuda else 'close'} {same}, main path "
              f"{main_same}", flush=True)

    def equal(a, b):
        """Bit for bit on the card; on CPU entries within 1 uint8 LSB or
        1e-5 relative (torch's CPU kernels round a tensor's tail elements
        apart, tests/test_torch_plain_reuse.py)."""
        if cuda:
            return bool(torch.equal(a, b) if torch.is_tensor(a)
                        else np.array_equal(a, b))
        if torch.is_tensor(a):
            return bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6))
        if a.dtype == np.uint8:
            return int(np.abs(a.astype(np.int16) - b).max()) <= 1
        return bool(np.allclose(a, b, rtol=1e-5, atol=1e-7))

    def warps(device, tiles):
        """The warps of a launch of ``tiles`` tiles (its persistent grid;
        the card holds blocks x SMs x warps a block at once)."""
        if not cuda:
            return 0
        blocks, sms, per_block = cr.occupancy(torch.device(device), 0,
                                              cr.FORM_FRAMES)
        return cr.persistent_grid(blocks, sms, tiles, per_block) * per_block

    def bound_ms(kind, stats, scale, in_bytes, out_bytes):
        stats = {k: v * scale for k, v in stats.items()}
        return march_bound(stats, in_bytes, out_bytes, kind)[0] / n

    def frame_tiles(out):
        return cr.frame_tiles(out.shape[-2], out.shape[-3],
                              out.shape[0] if out.dim() == 4 else 1)

    def list_tiles(out):
        return cr.ray_tiles(out.shape[0])

    for size, kind in s1:
        scene = spiral_scene(size, noise_kind=kind, **preview)
        main_same = equal(gt.render_scene(scene, mesh=cards),
                          gt.render_scene(scene, device=dev))
        page, table, _, _ = cr.prepare(scene, dev)
        one_ms, want = one_card_ms(lambda: cr.march(page, table, size))
        cr.march_rowshard(page, table, size, cards)  # warm-up: the streams
        rows, got = sharded(lambda: cr.march_rowshard(page, table, size,
                                                      cards),
                            ("march_dealt", "march_band",
                             "march_dealt_plain", "march_band_plain"),
                            frame_tiles)
        same = equal(got, want)
        del got, want
        small = min(size, BOUND_SIZE)
        bp, bt, _, _ = cr.prepare(spiral_scene(small, noise_kind=kind,
                                               **preview), dev)
        stats = {}
        cr.march_plain(bp, bt, small, stats=stats)
        bound = bound_ms(kind, stats, (size / small) ** 2,
                         page.numel() * 4 + table.numel() * 4,
                         size * size * 12)
        summary(f"S1 {size}^2 {kind}", rows, one_ms, bound, same, main_same)
    sky = allsky_scene(**preview)
    for nside in s3:
        main_same = equal(gt.render_allsky_map(sky, nside, mesh=cards),
                          gt.render_allsky_map(sky, nside, device=dev))
        page, table, _, _ = cr.prepare(sky, dev)
        dirs = torch.as_tensor(allsky_dirs(nside), device=dev)
        one_ms, want = one_card_ms(lambda: cr.march_rays(page, table, dirs))
        cr.march_rays_rowshard(page, table, dirs, cards)  # warm-up
        rows, got = sharded(lambda: cr.march_rays_rowshard(page, table, dirs,
                                                           cards),
                            ("march_rays", "march_rays_plain"), list_tiles)
        same = equal(got, want)
        del got, want
        small = min(nside, BOUND_NSIDE)
        stats = {}
        cr.march_rays_plain(page, table, torch.as_tensor(
            allsky_dirs(small), device=dev), stats=stats)
        bound = bound_ms("simplex", stats, (nside / small) ** 2,
                         page.numel() * 4 + table.numel() * 4
                         + dirs.numel() * 4, dirs.numel() * 4)
        summary(f"S3 nside {nside}", rows, one_ms, bound, same, main_same)
        del dirs

    # S2: render_batch_linear on the batch mesh and the (batch, rows) mesh
    size = S2_SIZE if cuda else S2_CPU
    meshes = {False: Mesh(cards.devices, ("batch",))}
    if n >= 4 and n % 2 == 0:
        meshes[True] = Mesh(cards.devices, ("batch", "rows"), (n // 2, 2))
    bounds = (json.loads(bounds_path.read_text())
              if bounds_path is not None and bounds_path.exists() else {})
    for name, (frames, two_d) in S2_CASES.items():
        if only not in name or two_d not in meshes:
            continue
        mesh = meshes[two_d]
        scenes = s2_scenes(frames, size, preview)
        groups = []
        for st, pages, _ in _scene_groups(scenes):
            groups.append((torch.as_tensor(pages, device=dev),
                           cr.upload_table(cr._build_table(
                               st, cr._build_layout(st)), dev)))
        one_ms, _ = one_card_ms(lambda: [cr.march_batch(pg, tb, size)
                                         for pg, tb in groups])
        want = gt.render_batch_linear(scenes, device=dev)
        gt.render_batch_linear(scenes, mesh=mesh)  # warm-up: the streams
        rows, got = sharded(lambda: gt.render_batch_linear(scenes, mesh=mesh),
                            ("march_dealt", "march_batch",
                             "march_dealt_plain", "march_batch_plain"),
                            frame_tiles)
        same = equal(got, want)
        del got, want
        key = f"{frames} {size}"
        if key not in bounds:  # every frame's work at BOUND_SIZE, scaled
            small = min(size, BOUND_SIZE)
            total = 0.0
            for scene in s2_scenes(frames, small, preview):
                bp, bt, _, _ = cr.prepare(scene, dev)
                stats = {}
                cr.march_plain(bp, bt, small, stats=stats)
                scale = (size / small) ** 2
                total += march_bound({k: v * scale for k, v in stats.items()},
                                     bp.numel() * 4 + bt.numel() * 4,
                                     size * size * 12,
                                     scene.config.noise_kind)[0]
            bounds[key] = total
            if bounds_path is not None:
                bounds_path.parent.mkdir(parents=True, exist_ok=True)
                bounds_path.write_text(json.dumps(bounds))
        summary(name, per_entry(rows, mesh.size), one_ms, bounds[key] / n,
                same, same)
        del groups


def main() -> int:
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import fit as tfit
    from gamer_tpu_torch.engine import render as trender
    from gamer_tpu_torch.parallel import Mesh
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.utils.tree import tree_leaves

    args = sys.argv[1:]
    cuda = "--cpu" not in args
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 3
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
    readings["topology"] = topology(cuda)
    print(f"[{card}] tree {TREE}; peer access "
          f"{readings['topology']['peer']}; nvidia-smi topo -m:\n"
          f"{readings['topology']['topo']}", flush=True)
    # --entries N: S1 and S3 on N entries over the mesh's devices in turn
    # (one card: that card N times)
    k = int(args[args.index("--entries") + 1]) if "--entries" in args else n
    launch_mesh = Mesh([cards.devices[i % n] for i in range(k)])
    only = args[args.index("--only") + 1] if "--only" in args else ""
    bounds = (Path(args[args.index("--bounds") + 1]).resolve()
              if "--bounds" in args else None)
    sharded_launch_cases(cuda, launch_mesh, card, reps, readings, failed,
                         only, "--pages-ahead" in args, bounds)
    if "--launches-only" in args:
        print(json.dumps({"card": card, "entries": n, "readings": readings,
                          "failed": failed}))
        return 1 if failed else 0

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
