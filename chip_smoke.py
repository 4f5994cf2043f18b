"""Card smoke run for gamer_tpu_torch: builds the CUDA march kernel from csrc/
and drives the port's main paths on the spiral preset: one still frame at
512x512 (``render_scene``, K1), the same frame in 16 row bands
(``render_progressive``, K5: one launch that flags each band while it runs;
ticks against the launch, an abort inside it), an 8-frame orbit fly-through
in one batched launch (``render_flythrough``, K4), the all-sky image at
nside 512 (``render_allsky_image``, K6: 3,145,728 rays in one ray-list
launch) and the still with the perlin and the iq noise backends (K1-perlin,
K1-iq; the perlin gradient table and the iq hash table, every entry of which
is checked against the kernels' own hash or sine), the same frame, orbit
and sky spread over a mesh that names the card several times (S1-S3: one
launch per mesh entry, each on a stream of its own) and the render service
on all of them, through the library and over HTTP on a loopback port. Each
launch form and each noise kind is checked
against its plain torch version; the frames against each other (bands, batch
frames and the ray list are bit-equal to the still frame), the spec oracle
and the CLI commands (``render``, ``galaxy``, ``skybox``, ``dataset``,
``flythrough`` and ``morph`` with their GIFs, ``allsky``, ``renderhpx``).
Beside the spec oracle's 48x48 frame, each of the seven presets' 512x512
kernel frame is held to the oracle's stored frame, and the spiral runs
above 512x512: at 1024, 2048 and 4096 (each noise kind at 4096; frame,
kernel and host prep times, march Msamples/s), the 4096x4096 progressive
frame bit-equal to the still and its middle rows against the plain version.
Then the fit path: ``fit_scene_fd`` at 128x128 (each step's probe set is one
``march_batch`` launch, held to the plain version), ``fit_scene`` on the
tensor and frozen marches at 128x128 and the scan march at 32x32 (step times
and CUDA launches per step), each march's losses against the CPU's at 12x12,
and the CLI ``fit ... march=fd`` on a PNG target. Then the fit families:
``fit_pose_fd`` at 128x128 (each step's 7 probe frames one ``march_batch``
launch; the base frame and first +- pair of its first probe set held to the
plain version on the card), ``fit_pose`` and ``fit_pose_multiscale``,
``fit_scene_batch`` (K=4, tensor and frozen), ``fit_scene_multiview`` (K=3),
``fit_joint`` (fd poses) and ``fit_joint_multiview`` (K=2) at 64x64 (step
times as medians of 3 untraced steps, CUDA launches per step, peak memory),
four of them against the CPU at 12x12, ``POST /fit`` over HTTP, and the CLI
``fitpose ... fd`` and ``fitjoint ... pose=fd``. Then the autograd fits with
``mesh=`` on a mesh that names the card 4 or 2 times, each beside the same
fit unsharded (step times, CUDA launches, peak memory; losses within JAX's
tolerances for its own sharded fits, the batch bit-equal; one sharded SGD
step's losses and summed gradient against CPU entries and one entry at
12x12), and the XLA-form surfaces: the march's CUDA-graph loop against the
eager loop, bit for bit; ``render_scene_sharded(method="xla")`` at 512x512
on 4 entries (bit-equal to the unsharded XLA-form frame, within 3 LSB of the
kernel's), ``render_allsky_map(kernel="xla")`` at nside 512 against K6's
map, ``queue.render_progressive`` in 16 chunks (ticks, an abort after chunk
4, the finished frame) and the CLI ``galaxy xla|sharded|oracle`` and
``skybox xla``. Last the front end: the interactive viewer over HTTP
(``/render`` at 256x256 through ``march``, the streamed 512x512
``/fullrender`` through one ``march_progressive`` launch, ``/skybox``
through one ``march_batch`` launch, each image against its library call and
each route's kernel against its plain version on the route's own inputs,
request latencies), ``dryrun_multichip`` on 4 entries of the card,
``entry()``'s frame step against the kernel's frame, ``profile_trace``
around the 512x512 still (in this process, where a lost kernel record must
be reported, and in a fresh one: the trace's kernel time beside CUDA events)
and ``RenderStats``.

    python3 chip_smoke.py
    python3 chip_smoke.py --fit-only   # the build report, the fit paths,
                                       # the sharded fits, the XLA surfaces
    python3 chip_smoke.py --frontend-only  # the build report, the front end
    python3 chip_smoke.py --production-only  # the build report, the 512^2
                                       # oracle frames, the ladder
    python3 chip_smoke.py --profiler-loss [N ...]  # kernel records lost
                                       # after a session of N launches

Needs one CUDA card and nvcc. Prints one line per phase; the line before
the last is the card's name and power limit, the line before that the
kernels' JSON record, and the last line {"ok": true, "device": {...}}.
Any failed phase raises and the script exits non-zero without that line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import unittest.mock
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAIN_SIZE = 512
PLAIN_BUDGET_S = 60.0
FLY_FRAMES = 8
BANDS = 16

# Published H100 SXM peaks at 700 W (NVIDIA's data sheet): f32 outside the
# tensor cores, the special-function units (16 per SM per clock, 132 SMs at
# the 1.98 GHz boost clock) and HBM3.
F32_PEAK = 67e12
SFU_PEAK = 16 * 132 * 1.98e9
HBM_PEAK = 3.35e12
# A lower bound of the march kernel's work per counted unit, from
# csrc/march.cu, as (f32 ops, SFU ops): one op per add, sub, mul or
# compare-select; one SFU op per sqrt, divide, exp, sin, cos or atan
# reciprocal, two per pow; nothing for their extra instructions. The counts
# come from the plain version on the same inputs (march_plain's stats).
WORK = {
    "samples": (83, 3),      # exit test (distance along the chord), step
                             # (|p - cam|), dott, radius, advance, floor;
                             # the ~22 float64 operations of the step's
                             # bookkeeping count twice (the H100's FP64
                             # rate is half its FP32 rate)
    "bulge": (58, 6),        # quat rotate, radius, pow, two sqrt, exp
    "triggers": (5, 1),      # |dott/z0| and the radial cutoff, per component
    "triggered": (14, 5),    # sech^2 and the intensity exp: the exact gates
    "gated": (18, 1),        # smoothstep, val, ival
    "arm_gated": (130, 13),  # two-arm pow ladder, atan2, winding
    "emitting": (40, 3),     # twirl (sin, cos, quat rotate), accumulate
}
# One raw 3-D noise evaluation per kind, from csrc/noise.cuh, as the least
# work of the function: (f32 ops, SFU ops, 4-byte words read from a table in
# shared memory). simplex: skew, 4 corners, gradients. perlin: 3 cell
# setups, 3 reads of the paired permutation, 8 gradient dots of 5 ops, 3
# s-curves, 7 lerps, and the 8 corners' decoded gradients read from a
# table, 3 words each: the gradient hash and its decode (~21 ops a corner)
# are a function of a 10-bit index, which a table answers with one read.
# iq: 3 floors, the cell's hash argument and its range test, 3 s-curves, 7
# lerps; its 8 corner hashes frac(sin(n) * 753.5453123) are a function of
# an integer n, which the kernels read as 4 pairs from a table in L2 (not
# counted: the L2's rate is not published, so the bound is lower for it).
RAW_NOISE_WORK = {"simplex": (100, 0, 0), "perlin": (100, 0, 27),
                  "iq": (50, 0, 0)}
# perlin and iq as counted before their tables: perlin's 8 hashed gradient
# dots of ~26 ops (260 in all); iq's 8 sin-hashes of ~15 ops (the build has
# no fast math, so sinf is a polynomial on the f32 pipes and no MUFU.SIN: at
# least 10 ops, counted as f32; 170 in all). Their bounds are logged beside
# the ones above, so that a share can be compared with earlier rows'.
HASHED_NOISE_WORK = {"perlin": (260, 0, 0), "iq": (170, 0, 0)}
# shared-memory reads: 32 banks of one 4-byte word a clock per SM (132 SMs
# at the 1.98 GHz boost clock)
SMEM_WORDS_PEAK = 32 * 132 * 1.98e9
# The iq gate, kernel against plain: the hash frac(sin(n) * 753.5453123)
# amplifies the last ulps of two sine implementations, so single lattice
# corners may hash differently.
IQ_SHARE_WITHIN_2LSB = 0.98
IQ_MEAN_LSB = 0.25
ALLSKY_NSIDE = 512
ALLSKY_SIZE = 1024
MESH_ENTRIES = 4
SERVE_SIZE = 256
SERVE_WAIT_S = 120.0
# the fit path: fit_scene_fd's probes (K4), the autograd marches, CLI fit
FIT_SIZE = 128
# five steps: step 0 holds the fit's setup and step 1 is traced, so a step
# time is the median of the 3 steps after them
FIT_STEPS = 5
SCAN_SIZE = 32
CHECK_SIZE = 12
# the kernel's probe losses against the plain version's, and the card's
# losses against the CPU's at CHECK_SIZE (relative)
FIT_PROBE_RTOL = 1e-4
FIT_CPU_RTOL = 1e-3
LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx")
# march_kernel<0> (K1, simplex) as built since the march keeps the
# reference's double bookkeeping (until then 80 registers, 92/132 B of
# spills, 4,320 instructions): ptxas's registers and spill bytes and the
# static SASS instruction count. The progressive kernel is a template flag
# of the same body and must leave the other kernels' code as it is
# (scripts/torch_march_ab.py compares the whole code of two builds).
K1_CODE = {"registers": 80, "spill_stores": 152, "spill_loads": 188,
           "sass": 4736}
# the host work a viewer does in each tick of a streamed /fullrender (a
# stdlib PNG of 512^2, ~8 ms)
TICK_STALL_MS = 8.0
# the frame whose abort at the first tick must leave tiles untaken: 16 bands
# of 64 rows, the size the service's abort in mid-frame uses
ABORT_SIZE = 1024



def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def spiral_scene(size, galaxy=None, **cfg):
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.models import presets

    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy or presets.spiral())],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg),
    )


# The spiral's ridged dust ("dust2") scale times this: its highest octaves
# then hash arguments past the iq table's 2^20 (the spiral's own reach
# 517,222; x4 about 2.07 M), so the fallback to the sines runs.
IQ_FAR_SCALE = 4.0


def iq_far_scene(size, **cfg):
    """The spiral with the iq noise kind and its ridged dust's scale times
    IQ_FAR_SCALE: a scene some of whose iq hash arguments lie outside the
    kernels' table."""
    from gamer_tpu_torch.models import presets

    g = presets.spiral()
    for c in g.components:
        if c.class_name == "dust2":
            c.scale = c.scale * IQ_FAR_SCALE
    return spiral_scene(size, g, noise_kind="iq", **cfg)


def iq_table_check(dev):
    """The iq hash table's exhaustive check on the card
    (csrc/march.cu::check_iq_table): every pair of the table against the
    kernels' own sinf path, and the corners the kernels read for every
    integer n in [-2R - 300, 2R + 300] (the table inside, the fallback
    beyond) against the eight sines. Returns ({"pairs": pairs that differ,
    "corners": arguments whose corners differ, "fallback": arguments that
    took the fallback, "fallback_expected": ...}, ms)."""
    from gamer_tpu_torch.kernels import library
    from gamer_tpu_torch.ops import noise as tnoise

    lib = library()
    table = tnoise.iq_hash_table(dev)
    r = tnoise.IQ_TABLE_R
    lo, n_args = -2 * r - 300, 4 * r + 601
    bad = torch.zeros(3, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        e0.record(stream)
        rc = lib.gamer_iq_table_check(table.data_ptr(), lo, n_args,
                                      bad.data_ptr(), stream.cuda_stream)
        e1.record(stream)
    check(rc == 0, f"iq table check launch failed: CUDA error {rc}")
    e1.synchronize()
    pairs, corners, far = bad.tolist()
    return ({"pairs": pairs, "corners": corners, "fallback": far,
             "fallback_expected": 2 * (r + 300)}, e0.elapsed_time(e1))


def perlin_grad_check(dev):
    """The perlin gradient table's check on the card
    (csrc/march.cu::check_perlin_grads): each of its 1,024 entries against
    the gradient hash's decode (noise.cuh's perlin_grad_hashed), and the
    kernels' own perlin_grad_dot, reading the table as the perlin kernels
    stage it, at the unit offsets for every lattice index in [0, 2048)
    (the & 1023 wrap) against the same decode. Returns ({"entries":
    entries that differ in a bit, "dots": indices whose dots differ}, ms)."""
    from gamer_tpu_torch.kernels import library
    from gamer_tpu_torch.ops import noise as tnoise

    lib = library()
    table = tnoise.noise_table("perlin", dev)
    bad = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        e0.record(stream)
        rc = lib.gamer_perlin_grad_check(table.data_ptr(),
                                         2 * tnoise.PERLIN_GRADS,
                                         bad.data_ptr(), stream.cuda_stream)
        e1.record(stream)
    check(rc == 0, f"perlin gradient check launch failed: CUDA error {rc}")
    e1.synchronize()
    entries, dots = bad.tolist()
    return {"entries": entries, "dots": dots}, e0.elapsed_time(e1)


def two_instance_scene(size):
    """The multi-instance geometry of tests/test_pallas.py:142-162."""
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.models import presets

    g = presets.spiral()
    return gt.Scene(
        camera=gt.CameraParams(camera=(2.5, 0.3, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=70.0),
        instances=[
            gt.GalaxyInstance(galaxy=g, position=(0, 0, 0)),
            gt.GalaxyInstance(galaxy=g, position=(0.5, 0.2, -0.8),
                              orientation=(0.3, 0.8, 0.1),
                              intensity_scale=0.7),
        ],
        config=gt.RenderConfig(size=size, ray_step=0.025),
    )


def lsb_diff(a: np.ndarray, b: np.ndarray):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d.max(-1) > 0).mean()), float(d.mean())


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def allsky_scene(size=16, **cfg):
    """The all-sky geometry of scripts/allsky_bench.py: the camera inside
    the ellipsoid, so every ray hits."""
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.models import presets

    return gt.Scene(
        camera=gt.CameraParams(camera=(0.3, 0.05, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
        config=gt.RenderConfig(size=size, ray_step=0.025, **cfg),
    )


def iq_gate(a: np.ndarray, b: np.ndarray):
    """(passes, share of pixels within 2 LSB, mean |d| in LSB)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    within, mean_d = float((d.max(-1) <= 2).mean()), float(d.mean())
    return (within >= IQ_SHARE_WITHIN_2LSB and mean_d <= IQ_MEAN_LSB,
            within, mean_d)


def march_bound(stats: dict, in_bytes: int, out_bytes: int,
                kind: str = "simplex", raw_work=None):
    """(bound ms, "bytes" or "operations", detail): the least time the card
    could take for the counted work, the larger of the operation bound (f32
    ops at the f32 peak, SFU ops at the SFU peak, shared-memory word reads
    at the shared memory's rate) and the byte bound (each input read once,
    each output written once, at the HBM rate). ``raw_work`` replaces the
    kind's RAW_NOISE_WORK."""
    raw = RAW_NOISE_WORK[kind] if raw_work is None else raw_work
    work = dict(WORK, raw_noise=raw[:2])
    ops = sum(stats.get(k, 0) * w[0] for k, w in work.items())
    sfu = sum(stats.get(k, 0) * w[1] for k, w in work.items())
    words = stats.get("raw_noise", 0) * raw[2]
    t_ops, t_sfu = ops / F32_PEAK, sfu / SFU_PEAK
    t_smem = words / SMEM_WORDS_PEAK
    t_bytes = (in_bytes + out_bytes) / HBM_PEAK
    t = max(t_ops, t_sfu, t_smem, t_bytes)
    detail = (f"{ops:.4g} f32 ops -> {t_ops * 1e3:.4f} ms, {sfu:.4g} SFU ops "
              f"-> {t_sfu * 1e3:.4f} ms, {words:.4g} shared-memory word "
              f"reads -> {t_smem * 1e3:.4f} ms, {in_bytes + out_bytes} B -> "
              f"{t_bytes * 1e3:.5f} ms")
    return t * 1e3, ("bytes" if t == t_bytes else "operations"), detail


def cuda_ms(fn, reps: int):
    """Median over ``reps`` calls of the device time between two events
    around ``fn()`` (the stream is idle before each call)."""
    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), out


def progressive_ticks(scene, bands: int, on_tick=None,
                      stall_ms: float = 0.0) -> dict:
    """``render_progressive(scene, bands)`` on the card, with each tick's
    host time and the launch's start and end on the same clock, in ms after
    the call began: events recorded on the launch's stream just before and
    just after the launch's set-up (``_launch_bands``; the launch counts
    stay the wrappers'), mapped to the host clock by an event recorded on
    the idle stream as the call began. ``on_tick(frac)``'s result goes back
    to render_progressive (False aborts); ``stall_ms`` of host work follows
    every tick (a viewer's PNG encode). ``abort_ms``: from the return of an
    aborting tick to the return of the call; ``tiles``: the tiles the
    launch took and each band's finished tiles (its device counters);
    ``phases``: the host's steps, (name, first band, bands or rows, start,
    end) on the same clock: each wait for flags, each epilogue's enqueue,
    each download's wait and each collection of Python's garbage collector
    (its generation and the objects it freed)."""
    import gc

    from gamer_tpu_torch.engine import cuda_render as cr

    marks, fracs, ticks, phases = {}, [], [], []
    real = {"launch": cr._launch_bands, "wait": cr.ProgressiveLaunch.wait,
            "epilogue": cr._Bands.epilogue, "finish": cr._Bands.finish}

    def launch_bands(plan):
        stream = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch = real["launch"](plan)
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        marks["launch"] = (start, end)
        marks["counters"] = launch.counters
        return launch

    def wait(self, b):
        t = time.perf_counter()
        n = real["wait"](self, b)
        phases.append(("wait", b, n, t, time.perf_counter()))
        return n

    def epilogue(self, b, n, lin):
        t = time.perf_counter()
        out = real["epilogue"](self, b, n, lin)
        phases.append(("epilogue", b, n, t, time.perf_counter()))
        return out

    def finish(pending):
        t = time.perf_counter()
        out = real["finish"](pending)
        phases.append(("download", -1, len(out), t, time.perf_counter()))
        return out

    def collected(what, info):
        if what == "start":
            marks["gc"] = time.perf_counter()
        else:
            phases.append(("gc", info["generation"], info["collected"],
                           marks.pop("gc", t0), time.perf_counter()))

    def on_progress(frac, partial):
        ticks.append(time.perf_counter())
        fracs.append(frac)
        go = True if on_tick is None else on_tick(frac)
        t = time.perf_counter()
        while (time.perf_counter() - t) * 1e3 < stall_ms:
            pass
        marks["returned"] = time.perf_counter()
        return go

    cr._launch_bands = launch_bands
    cr.ProgressiveLaunch.wait = wait
    cr._Bands.epilogue = epilogue
    cr._Bands.finish = staticmethod(finish)
    t0 = time.perf_counter()
    gc.callbacks.append(collected)
    try:
        torch.cuda.synchronize()
        anchor = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        anchor.record()
        img = cr.render_progressive(scene, bands=bands,
                                    on_progress=on_progress, device="cuda")
        t1 = time.perf_counter()
    finally:
        gc.callbacks.remove(collected)
        cr._launch_bands = real["launch"]
        cr.ProgressiveLaunch.wait = real["wait"]
        cr._Bands.epilogue = real["epilogue"]
        cr._Bands.finish = staticmethod(real["finish"])
    torch.cuda.synchronize()
    start, end = marks["launch"]
    return {"img": img, "fracs": fracs,
            "ticks_ms": [(t - t0) * 1e3 for t in ticks],
            "start_ms": anchor.elapsed_time(start),
            "end_ms": anchor.elapsed_time(end), "wall_ms": (t1 - t0) * 1e3,
            "abort_ms": (t1 - marks["returned"]) * 1e3,
            "tiles": marks["counters"].cpu().tolist(),
            "phases": [(name, b, n, round((x - t0) * 1e3, 3),
                        round((z - t0) * 1e3, 3))
                       for name, b, n, x, z in phases]}


def log_abort(ab: dict, size: int, band_rows: int, n_bands: int,
              n_tiles: int) -> None:
    """Print an abort at the first tick (``progressive_ticks(...,
    on_tick=lambda f: False)``): the tiles the launch took, the bands it
    finished, and its times on the host clock."""
    counts = ab["tiles"]
    per_band = n_tiles // n_bands
    log(f"band path: abort at the first tick of {size}^2 leaves rows "
        f"{band_rows}- black; the launch took {counts[0]} of {n_tiles} tiles "
        f"and finished {sum(counts[1:])} "
        f"({sum(c == per_band for c in counts[1:])} of {n_bands} bands "
        f"whole); abort latency {ab['abort_ms']:.3f} ms (host clock, from "
        f"the tick's return to the call's), first tick at "
        f"{ab['ticks_ms'][0]:.3f} ms, the launch "
        f"{ab['start_ms']:.3f}-{ab['end_ms']:.3f} ms")


def oracle_512_phase() -> float:
    """Each preset's 512^2 kernel frame (``render_scene``, K1) against the
    spec oracle's frame stored in the port (gamer_tpu_torch/golden.py;
    tests/test_torch_conformance_512.py holds the files to their presets'
    scenes and to a fresh oracle run): one record a preset in
    scripts/conformance_512.py's form, then the oracle gate on each. The
    frame oracle marches simplex noise only: perlin and iq stay held to
    their plain versions and to their raw-noise gates. Returns the
    spiral's oracle samples per pixel."""
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.golden import (ORACLE_SIZE, PRESETS, diff_record,
                                        load_oracle_frame, oracle_gate,
                                        oracle_scene)

    t0 = time.perf_counter()
    recs = {}
    for preset in PRESETS:
        gold = load_oracle_frame(preset)
        ours = gt.render_scene(oracle_scene(preset, ORACLE_SIZE),
                               device="cuda")
        recs[preset] = {"preset": preset, "size": ORACLE_SIZE,
                        **diff_record(gold["image"], ours),
                        "samples_per_px": gold["samples"] / gold["pixels"]}
        log(f"kernel vs oracle {ORACLE_SIZE}^2 record: "
            f"{json.dumps(recs[preset])}")
    bad = [p for p, r in recs.items() if not oracle_gate(r)]
    log(f"kernel vs oracle at {ORACLE_SIZE}^2: {len(recs) - len(bad)} of "
        f"{len(recs)} presets within 3 LSB with < 5 % of pixels differing "
        f"(stored oracle frames, simplex: the frame oracle marches no perlin "
        f"or iq, which are held to their plain versions and raw-noise "
        f"oracles); phase {time.perf_counter() - t0:.1f} s")
    check(not bad, f"kernel vs oracle at {ORACLE_SIZE}^2 failed on {bad}: "
                   f"{[recs[p] for p in bad]}")
    return recs["spiral"]["samples_per_px"]


# the frame sizes above 512^2: bench.py's ladder (512, 4096, 2048, 1024);
# each noise kind at the largest; reps of CUDA events a size
LADDER = ((1024, "simplex", 3), (2048, "simplex", 3), (4096, "simplex", 2),
          (4096, "perlin", 2), (4096, "iq", 2))
# the rows of the largest frame held to the plain version: 4 at its middle
LADDER_BAND_ROWS = 4


def ladder_phase(card: str, dev, samples_per_px: float) -> None:
    """The spiral above 512^2: per rung of LADDER the frame
    (``render_scene(..., device_out=True)``), the march kernel and the host
    prep, with march Msamples/s from the oracle's samples per pixel at
    512^2; at the largest rung the progressive frame (16 bands, one launch)
    bit-equal to the still with its ticks in order, and the kernel's middle
    rows (``march_band``) held to the plain version on the card; the
    phase's peak device memory."""
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine.render import post_process

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    big = None
    for size, kind, reps in LADDER:
        scene = spiral_scene(size, noise_kind=kind)
        gt.render_scene(scene, device="cuda", device_out=True)  # warm-up
        frame_ms, img = cuda_ms(lambda: gt.render_scene(
            scene, device="cuda", device_out=True), reps)
        prep = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            page, table, _, _ = cr.prepare(scene, dev)
            torch.cuda.synchronize()
            prep.append((time.perf_counter() - t) * 1e3)
        kern_ms, lin = cuda_ms(lambda: cr.march(page, table, size), reps)
        check(tuple(img.shape) == (size, size, 3) and int(img.sum()) > 0
              and bool(torch.isfinite(lin).all()),
              f"{kind} {size}^2: frame {tuple(img.shape)}, black or "
              f"non-finite")
        px = size * size
        log(f"timing [{card}] ladder {kind} spiral {size}^2 (median of "
            f"{reps}): frame {frame_ms:.3f} ms, march kernel {kern_ms:.3f} ms "
            f"({samples_per_px * px / (kern_ms * 1e-3) / 1e6:.1f} march "
            f"Msamples/s at the oracle's {samples_per_px:.1f} samples/px of "
            f"512^2), host prep + page upload {float(np.median(prep)):.3f} "
            f"ms (host clock)")
        if size == LADDER[-1][0] and kind == "simplex":
            big = (scene, page, table, img.cpu().numpy())
        del img, lin
    scene, page, table, still = big
    size = scene.config.size
    ticks = []
    before = cr.march_progressive.launch_count
    t = time.perf_counter()
    prog = gt.render_progressive(scene, bands=BANDS, device="cuda",
                                 on_progress=lambda f, _: ticks.append(f))
    prog_s = time.perf_counter() - t
    n_bands = cr.band_geometry(size, 1, BANDS)[1]
    check(cr.march_progressive.launch_count - before == 1,
          f"the {size}^2 progressive frame was not one launch")
    check(ticks == [(b + 1) / n_bands for b in range(n_bands)],
          f"{size}^2 progress ticks {ticks}")
    same = np.array_equal(prog, still)
    check(same, f"the {size}^2 progressive frame differs from the still: "
                f"{None if same else lsb_diff(prog, still)}")
    log(f"ladder: render_progressive(spiral {size}^2, bands={BANDS}) one "
        f"launch, {prog_s * 1e3:.1f} ms wall with download, {len(ticks)} "
        f"ticks in order; bit-equal to render_scene")
    row0 = size // 2 - LADDER_BAND_ROWS // 2
    c = scene.config
    post = (np.float32(c.exposure), np.float32(c.gamma),
            np.float32(c.saturation))
    k = cr.march_band(page, table, size, LADDER_BAND_ROWS, row0)
    t = time.perf_counter()
    p = cr.march_band_plain(page, table, size, LADDER_BAND_ROWS, row0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    check(np.array_equal(post_process(k, *post).cpu().numpy(),
                         still[row0:row0 + LADDER_BAND_ROWS]),
          f"march_band rows {row0}- differ from the {size}^2 still")
    mx, frac, mean_d = lsb_diff(post_process(k.cpu(), *post).numpy(),
                                post_process(p.cpu(), *post).numpy())
    log(f"march_band vs plain (on the card, {plain_s:.1f} s) {size}^2 rows "
        f"{row0}-{row0 + LADDER_BAND_ROWS - 1} ({LADDER_BAND_ROWS * size} "
        f"rays): max {mx} LSB, {frac:.5f} of pixels differ, mean "
        f"{mean_d:.4f} LSB, linear max_abs_err "
        f"{float((k - p).abs().max()):.3g}; the band is the still's rows")
    check(mx <= 2, f"march_band vs plain at {size}^2: {mx} LSB > 2")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"ladder: peak device memory {peak / 2 ** 30:.3f} GiB "
        f"(max_memory_allocated); phase {time.perf_counter() - t0:.1f} s")
    del big, page, table, k, p
    torch.cuda.empty_cache()


def report_build() -> None:
    """Build the kernels and print the toolchain, ptxas's register and spill
    report, and each march kernel's resident blocks per SM and static SASS
    instruction mix."""
    sys.path.insert(0, str(ROOT))
    from gamer_tpu_torch import kernels
    from gamer_tpu_torch.ops.noise import NOISE_KINDS

    t0 = time.perf_counter()
    lib = kernels.library()
    info = kernels.BUILD_INFO
    release = [ln for ln in info.get("nvcc", "").splitlines() if "release" in ln]
    log(f"nvcc: {kernels.nvcc_path()} | {(release or ['cached build'])[0]}")
    log(f"build: {info['path']} in {info['seconds']:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s, cached={info['cached']})")
    for line in info.get("log", "").splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"ptxas: {line.strip()}")
    threads = lib.gamer_march_block_threads()
    forms = ((0, "march_kernel"), (1, "march_rays_kernel"),
             (2, "march_progressive_kernel"))
    with torch.cuda.device(0):
        for k, kind in enumerate(NOISE_KINDS):
            for form, name in forms:
                n = lib.gamer_march_occupancy(k, form)
                check(n > 0, f"occupancy query of {name}<{kind}> failed: {n}")
                log(f"occupancy: {name}<{kind}> {n} resident blocks of "
                    f"{threads} threads per SM ({n * threads // 32} warps of "
                    f"64)")
                # the perlin gradients' shared memory and the iq table's
                # address cost no resident block
                simplex = lib.gamer_march_occupancy(0, form)
                check(n == simplex, f"{name}<{kind}> holds {n} blocks per SM,"
                                    f" the simplex kernel {simplex}")
    names = [f"{len(n)}{n}ILi{i}E" for _, n in forms
             for i in range(len(NOISE_KINDS))]
    mixes = kernels.sass_mix(info["path"], names)
    for name in names:
        log(f"sass mix {name} (static instruction counts, cuobjdump -sass): "
            + (json.dumps(mixes[name]) if mixes else "not measured (no "
               "cuobjdump)"))
    # the frame kernel's code is as recorded (K1_CODE)
    counts = next((v for k, v in kernels.ptxas_report(
        info.get("log", "")).items() if "12march_kernelILi0E" in k), None)
    check(counts is not None, "no ptxas report of march_kernel<0> in the "
                              "build log")
    got = dict(zip(("registers", "spill_stores", "spill_loads"), counts))
    if mixes:  # the static SASS count where cuobjdump exists
        got["sass"] = mixes["12march_kernelILi0E"]["total"]
    want = {k: K1_CODE[k] for k in got}
    log(f"march_kernel<0> code: {got}, as recorded (K1_CODE): {K1_CODE}")
    check(got == want, f"march_kernel<0> code changed: {got} against {want}")


def scaled(scene, field, factor, gp=False):
    """A copy of a one-instance scene with ``field`` of every component (of
    the galaxy parameters with ``gp``) scaled by ``factor``."""
    import copy

    s = copy.deepcopy(scene)
    g = s.instances[0].galaxy
    for obj in ([g.params] if gp else g.components):
        setattr(obj, field, getattr(obj, field) * factor)
    return s


def cuda_profile():
    """A torch.profiler session of the CUDA activity alone: a step of 10^5
    launches would otherwise add ~10^6 CPU op events."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def launch_count(prof):
    """The runtime launch calls a stopped profiler session recorded, None
    when it recorded none. The raw records are read: building the
    profiler's event tree costs ~30 us an event, 10 s for a traced step of
    a batch fit."""
    try:
        names = [e.name() for e in prof.profiler.kineto_results.events()]
    except AttributeError:  # a torch without the raw records
        names = [e.name for e in prof.events()]
    return sum(n in LAUNCH_API for n in names) or None


def traced_fit(run, windows=((0, 1),)):
    """Run ``run(on_step)`` once: the fit's result, {step: host ms} of
    every step after the first (which holds the fit's setup) outside the
    traced windows, the CUDA launches of each traced window {(a, b): n}
    (from the end of step a to the end of step b, torch.profiler's runtime
    launch calls; None when it traced none) and the peak device memory in
    GiB. Every step ends in a sync, as a fit's loss comes to the host."""
    starts = {a: b for a, b in windows}
    traced = set()
    for a, b in windows:
        traced.update(range(a + 1, b + 1))
    state = {"prof": None, "mark": 0.0}
    steps = {}
    counts = {}

    def on_step(i, loss):
        torch.cuda.synchronize()
        steps[i] = (time.perf_counter() - state["mark"]) * 1e3
        prof = state["prof"]
        if prof is not None and i == prof[1]:
            prof[0].stop()
            counts[(prof[2], i)] = launch_count(prof[0])
            state["prof"] = None
        if i in starts:
            p = cuda_profile()
            p.start()
            state["prof"] = (p, starts[i], i)
        # the next step's clock starts after the profiler's own work
        state["mark"] = time.perf_counter()
        return None

    torch.cuda.reset_peak_memory_stats()
    state["mark"] = time.perf_counter()
    res = run(on_step)
    torch.cuda.synchronize()
    if state["prof"] is not None:
        state["prof"][0].stop()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = {i: d for i, d in steps.items() if i > 0 and i not in traced}
    return res, ms, counts, peak


def fmt_ms(ms, keep=None):
    """The median of the step times ``ms`` ({step: ms}; only the steps in
    ``keep`` when given), with how many steps it is the median of."""
    vals = [d for i, d in ms.items() if keep is None or i in keep]
    return (f"{float(np.median(vals)):.3f} ms (host clock, median of "
            f"{len(vals)} untraced steps)") if vals else "not measured"


def fit_phases(card: str, dev, keep: dict):
    """The fit path on the card; returns the fields of its kernel record
    (march_batch launched by fit_scene_fd's probes). The tensor and frozen
    fits' inputs, results and readings go into ``keep`` for the sharded
    fits (``mesh_fit_phases``)."""
    import copy

    import gamer_tpu_torch as gt
    from gamer_tpu_torch import cli
    from gamer_tpu_torch.engine import batch as tbatch
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine import fit as tfit
    from gamer_tpu_torch.engine.diff import post_process_float
    from gamer_tpu_torch.io.png import read_png, write_png
    from gamer_tpu_torch.scene import gax

    truth = spiral_scene(FIT_SIZE)
    target = gt.render_scene(truth, device=dev)
    tgt = torch.as_tensor(target, device=dev).float() / 255.0

    def probe_losses(lin):
        with torch.no_grad():
            img = post_process_float(lin, torch.tensor(1.0, device=dev),
                                     torch.tensor(1.0, device=dev),
                                     torch.tensor(1.0, device=dev)) / 255.0
            return torch.mean((img - tgt) ** 2, dim=(1, 2, 3)).cpu().numpy()

    # --- fit_scene_fd: every step's 2K+1 probes are one K4 launch ----------
    fd_start = scaled(truth, "winding_b", 1.15, gp=True)
    seen = []
    real_batch, real_plain = tbatch.render_batch_linear, cr.march_batch_plain
    plain_calls = []

    def spy_batch(scenes, device=dev, mesh=None):
        seen.append(list(scenes))
        return real_batch(scenes, device=device, mesh=mesh)

    def spy_plain(*a, **k):
        plain_calls.append(1)
        return real_plain(*a, **k)

    tbatch.render_batch_linear, cr.march_batch_plain = spy_batch, spy_plain
    try:
        cr.march_batch.launch_count = 0
        fd, fd_ms, fd_n, _ = traced_fit(lambda cb: tfit.fit_scene_fd(
            fd_start, target, steps=FIT_STEPS, device=dev, on_step=cb))
        fd_launches = cr.march_batch.launch_count
    finally:
        tbatch.render_batch_linear, cr.march_batch_plain = real_batch, real_plain
    check(fd_launches == FIT_STEPS + 1 and len(seen) == FIT_STEPS + 1
          and not plain_calls,
          f"fit_scene_fd: {fd_launches} march_batch launches for "
          f"{len(seen)} probe sets, {len(plain_calls)} plain calls")
    check(all(np.isfinite(fd.losses)) and min(fd.losses[1:]) < fd.losses[0],
          f"fit_scene_fd losses {fd.losses}")

    # the first probe set again, kernel against its plain version on the card
    ((static, pages, _),) = tbatch._scene_groups(seen[0])
    tab = cr.upload_table(cr._build_table(static, cr._build_layout(static)),
                          dev)
    pages_d = torch.as_tensor(pages, device=dev)
    probe_k_ms, lin_k = cuda_ms(lambda: cr.march_batch(pages_d, tab,
                                                       FIT_SIZE), 5)
    # one plain run (~9 s a frame on the card) that also counts its work
    probe_stats = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    lin_p = cr.march_batch_plain(pages_d, tab, FIT_SIZE, stats=probe_stats)
    torch.cuda.synchronize()
    probe_plain_ms = (time.perf_counter() - t) * 1e3
    probe_err = float((lin_k - lin_p).abs().max())
    lk, lp = probe_losses(lin_k), probe_losses(lin_p)
    rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    check(rel <= FIT_PROBE_RTOL and abs(lk[0] - fd.losses[0]) <= 1e-6 * lk[0],
          f"fd probe losses: kernel {lk}, plain {lp}, fit {fd.losses[0]}")
    probe_bound = march_bound(probe_stats, pages_d.numel() * 4
                              + tab.numel() * 4 + 2048,
                              pages_d.shape[0] * FIT_SIZE * FIT_SIZE * 12)
    log(f"fit_scene_fd spiral {FIT_SIZE}^2 (winding_b x1.15, fields "
        f"winding_b,winding_n, {FIT_STEPS} steps): {fd_launches} march_batch "
        f"launches of {pages.shape[0]} frames, 0 plain calls; losses "
        f"{[f'{x:.6g}' for x in fd.losses]}; first probe losses kernel vs "
        f"plain on cuda max rel {rel:.3g} (limit {FIT_PROBE_RTOL:g}), linear "
        f"max_abs_err {probe_err:.3g}")
    log(f"timing [{card}] fit_scene_fd step at {FIT_SIZE}^2: {fmt_ms(fd_ms)}"
        f", {fd_n.get((0, 1))} CUDA launches per step (traced); probe "
        f"launch ({pages.shape[0]} frames) kernel {probe_k_ms:.3f} ms, plain "
        f"on cuda {probe_plain_ms:.1f} ms (counting its work), bound "
        f"{probe_bound[0]:.4f} ms by {probe_bound[1]} ({probe_bound[2]})")

    # --- the autograd marches ----------------------------------------------
    for march, size in (("tensor", FIT_SIZE), ("frozen", FIT_SIZE),
                        ("scan", SCAN_SIZE)):
        scene = spiral_scene(size)
        tgt_img = gt.render_scene(scene, device=dev)
        start = scaled(scene, "strength", 1.5)

        def run(cb, steps=FIT_STEPS, march=march, **kw):
            return tfit.fit_scene(start, tgt_img, steps=steps, march=march,
                                  device=dev, on_step=cb, **kw)

        if march == "scan":
            # one step of ~40 s, its setup included; every trip issues the
            # same ops: launches = a + b * trips, from two short trip counts
            t0 = time.perf_counter()
            res, _, _, peak = traced_fit(lambda cb: run(cb, steps=1),
                                         windows=())
            ms = f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock, " \
                 f"1 step with the fit's setup)"
            n = [traced_fit(lambda cb, m=m: run(cb, steps=2, max_steps=m))[2]
                 .get((0, 1)) for m in (8, 16)]
            trips = tfit.step_bound_for_scene(start)
            per_step = (None if None in n
                        else n[0] + (n[1] - n[0]) * (trips - 8) // 8)
            how = f"a + b * {trips} trips from 8 and 16 trips: {n}"
        else:
            res, step_times, n, peak = traced_fit(run)
            ms, per_step, how = fmt_ms(step_times), n.get((0, 1)), "traced"
            keep[f"fit_scene {march}"] = dict(
                scene=scene, target=tgt_img, start=start, res=res,
                ms=step_times, launches=per_step, peak=peak)
        check(all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0],
              f"fit_scene march={march}: losses {res.losses}")
        log(f"timing [{card}] fit_scene march={march} step at {size}^2: "
            f"{ms}, {per_step} CUDA launches per "
            f"step ({how}), peak {peak:.2f} GiB; losses "
            f"{[f'{x:.6g}' for x in res.losses]}")

    # the card's loss trajectories against the CPU's at a small size
    small = spiral_scene(CHECK_SIZE, is_preview=True)
    small_tgt = gt.render_scene(small, device=dev)
    for march in ("tensor", "frozen", "scan", "fd"):
        steps = 1 if march == "scan" else 2
        if march == "fd":
            st = scaled(small, "winding_b", 1.15, gp=True)
            runs = [tfit.fit_scene_fd(st, small_tgt, steps=steps, device=d)
                    for d in (dev, "cpu")]
        else:
            st = scaled(small, "strength", 1.5)
            runs = [tfit.fit_scene(st, small_tgt, steps=steps, march=march,
                                   device=d) for d in (dev, "cpu")]
        a, b = (np.asarray(r.losses) for r in runs)
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        same_way = bool(np.all(np.sign(np.diff(a)) == np.sign(np.diff(b))))
        log(f"fit march={march} {CHECK_SIZE}^2, {steps} step(s): card losses "
            f"{a.tolist()}, CPU {b.tolist()}: max rel {rel:.3g} (limit "
            f"{FIT_CPU_RTOL:g}), moves the CPU's way: {same_way}")
        check(rel <= FIT_CPU_RTOL and same_way,
              f"march={march}: card {a} vs CPU {b}")

    # --- the CLI fit, march=fd, on a PNG target ----------------------------
    cli_scene = spiral_scene(64)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_png(tmp / "target.png", gt.render_scene(cli_scene, device=dev))
        g = copy.deepcopy(cli_scene.instances[0].galaxy)
        g.params.winding_b *= 1.15
        gax.save(g, tmp / "start.gax")
        cr.march_batch.launch_count = 0
        rc = cli.main(["fit", "0.5", "0", "0", "0", "0", "0", "0", "1", "0",
                       "90", "1", "1", "1", "0.025", str(tmp / "start.gax"),
                       str(tmp / "target.png"), str(tmp / "out.gax"), "2",
                       "0.02", "winding_b", "march=fd"])
        cli_launches = cr.march_batch.launch_count
        fitted = gax.load(tmp / "out.gax")
        check(rc == 0 and cli_launches == 3
              and fitted.params.winding_b != g.params.winding_b
              and read_png(tmp / "target.png").shape == (64, 64, 3),
              f"cli fit: rc {rc}, {cli_launches} launches, winding_b "
              f"{g.params.winding_b} -> {fitted.params.winding_b}")
    log(f"cli fit march=fd 64^2 on a PNG target: {cli_launches} march_batch "
        f"launches, winding_b {g.params.winding_b:.6g} -> "
        f"{fitted.params.winding_b:.6g}")
    return (fd_launches, probe_err, probe_k_ms, probe_plain_ms, probe_bound)


# the fit families: pose, pose-fd, multiscale pose, batch, multi-view, joint
POSE_SIZE = 64
POSE_START = (0.52, 0.01, 0.0)
BATCH_K = 4
# frames of fit_pose_fd's first 128^2 probe set held to the plain version
PROBE_CHECK_FRAMES = 3
MVIEW_K = 3


def fit_family_phases(card: str, dev, keep: dict):
    """The pose, batch, multi-view and joint fits on the card; returns the
    fields of the march_batch[fit_pose_fd] kernel record. The fit_pose,
    frozen batch and fit_joint runs go into ``keep`` for the sharded
    fits."""
    import base64
    import copy

    import gamer_tpu_torch as gt
    from gamer_tpu_torch import cli
    from gamer_tpu_torch.engine import batch as tbatch
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine import fit as tfit
    from gamer_tpu_torch.io.png import encode_png, write_png
    from gamer_tpu_torch.scene import gax
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.serve import serve

    t_phase = time.perf_counter()

    def moved(scene, cam=POSE_START):
        return dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, camera=cam))

    def check_fit(name, losses):
        a = np.asarray(losses, np.float64)
        check(bool(np.all(np.isfinite(a))) and a.min() < a.flat[0],
              f"{name}: losses {a.tolist()}")

    # --- fit_pose_fd at 128^2: every step's 7 probes are one K4 launch ------
    truth = spiral_scene(FIT_SIZE)
    target = gt.render_scene(truth, device=dev)
    start = moved(truth)
    seen, plain_calls = [], []
    real_batch, real_plain = tbatch.render_batch_linear, cr.march_batch_plain

    def spy_batch(scenes, device=dev, mesh=None):
        seen.append(list(scenes))
        return real_batch(scenes, device=device, mesh=mesh)

    def spy_plain(*a, **k):
        plain_calls.append(1)
        return real_plain(*a, **k)

    tbatch.render_batch_linear, cr.march_batch_plain = spy_batch, spy_plain
    try:
        # the main path's counts: 0 just before it, read just after
        for fn in (cr.march, cr.march_band, cr.march_batch, cr.march_rays,
                   cr.march_progressive):
            fn.launch_count = 0
        pfd, pfd_ms, pfd_n, pfd_peak = traced_fit(
            lambda cb: tfit.fit_pose_fd(start, target, steps=FIT_STEPS,
                                        device=dev, on_step=cb))
        torch.cuda.synchronize()
        pfd_launches = cr.march_batch.launch_count
        others = (cr.march.launch_count + cr.march_band.launch_count
                  + cr.march_rays.launch_count
                  + cr.march_progressive.launch_count)
    finally:
        tbatch.render_batch_linear, cr.march_batch_plain = real_batch, real_plain
    check(pfd_launches == FIT_STEPS + 1
          and [len(x) for x in seen] == [7] * (FIT_STEPS + 1)
          and not plain_calls and others == 0,
          f"fit_pose_fd: {pfd_launches} march_batch launches for probe sets "
          f"{seen}, {len(plain_calls)} plain calls, {others} other launches")
    check_fit("fit_pose_fd", pfd.losses)
    check(pfd.scene.camera.camera != start.camera.camera,
          "fit_pose_fd did not move the camera")
    log(f"fit_pose_fd spiral {FIT_SIZE}^2 (camera from {POSE_START}, full "
        f"octaves, {FIT_STEPS} steps): {pfd_launches} march_batch launches "
        f"of 7 frames, 0 plain calls; losses "
        f"{[f'{x:.6g}' for x in pfd.losses]}; camera -> "
        f"{[round(v, 5) for v in pfd.scene.camera.camera]}")
    log(f"timing [{card}] fit_pose_fd step at {FIT_SIZE}^2: {fmt_ms(pfd_ms)}, "
        f"{pfd_n.get((0, 1))} CUDA launches per step (traced), peak "
        f"{pfd_peak:.2f} GiB")
    # the main path's first probe set again: the whole launch timed alone,
    # and its base frame and first +- pair held to the plain version on the
    # card (~11 s a frame of small launches)
    ((static, pages, _),) = tbatch._scene_groups(seen[0])
    tab = cr.upload_table(cr._build_table(static, cr._build_layout(static)),
                          dev)
    big_pages = torch.as_tensor(pages, device=dev)
    big_k_ms, _ = cuda_ms(lambda: cr.march_batch(big_pages, tab, FIT_SIZE),
                          5)
    pages_d = big_pages[:PROBE_CHECK_FRAMES]
    probe_k_ms, lin_k = cuda_ms(lambda: cr.march_batch(pages_d, tab,
                                                       FIT_SIZE), 5)
    probe_stats = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    lin_p = cr.march_batch_plain(pages_d, tab, FIT_SIZE, stats=probe_stats)
    torch.cuda.synchronize()
    probe_plain_ms = (time.perf_counter() - t) * 1e3
    probe_err = float((lin_k - lin_p).abs().max())
    # the fit's own loss of a probe batch (normalized MSE, on the card)
    losses_of = tfit._batch_losses(truth.config,
                                   np.asarray(target, np.float32) / 255.0,
                                   1, True)
    lk, lp = losses_of(lin_k), losses_of(lin_p)
    rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    check(rel <= FIT_PROBE_RTOL
          and abs(lk[0] - pfd.losses[0]) <= 1e-6 * lk[0],
          f"fit_pose_fd probes: kernel {lk}, plain {lp}, fit "
          f"{pfd.losses[0]}")
    probe_bound = march_bound(probe_stats, pages_d.numel() * 4
                              + tab.numel() * 4 + 2048,
                              pages_d.shape[0] * FIT_SIZE ** 2 * 12)
    log(f"fit_pose_fd {FIT_SIZE}^2 first probe set, frames 0-"
        f"{PROBE_CHECK_FRAMES - 1} (the base pose and camera.x +- eps) "
        f"kernel vs plain on cuda: losses max rel {rel:.3g} (limit "
        f"{FIT_PROBE_RTOL:g}), linear max_abs_err {probe_err:.3g}")
    log(f"timing [{card}] fit_pose_fd probe launch at {FIT_SIZE}^2 (CUDA "
        f"events, median of 5): 7 frames {big_k_ms:.3f} ms; "
        f"{PROBE_CHECK_FRAMES} frames kernel {probe_k_ms:.3f} ms, plain on "
        f"cuda {probe_plain_ms:.1f} ms (counting its work), bound "
        f"{probe_bound[0]:.4f} ms by {probe_bound[1]} ({probe_bound[2]})")

    # --- fit_pose (tensor march, LOD 3) and the multiscale ladder at 64^2 ---
    ptruth = spiral_scene(POSE_SIZE)
    ptarget = gt.render_scene(ptruth, device=dev)
    lod3 = dataclasses.replace(moved(ptruth), config=dataclasses.replace(
        ptruth.config, noise_octaves=3))
    pose, pose_ms, pose_n, pose_peak = traced_fit(
        lambda cb: tfit.fit_pose(lod3, ptarget, ("camera",), steps=FIT_STEPS,
                                 lr=1e-2, device=dev, on_step=cb))
    check_fit("fit_pose", pose.losses)
    keep["fit_pose"] = dict(scene=lod3, truth=ptruth, target=ptarget,
                            res=pose, ms=pose_ms, launches=pose_n.get((0, 1)),
                            peak=pose_peak)
    log(f"timing [{card}] fit_pose march=tensor LOD 3 step at {POSE_SIZE}^2: "
        f"{fmt_ms(pose_ms)}, {pose_n.get((0, 1))} CUDA launches per step "
        f"(traced), peak {pose_peak:.2f} GiB; losses "
        f"{[f'{x:.6g}' for x in pose.losses]}")
    t0 = time.perf_counter()
    ladder, _, lad_n, lad_peak = traced_fit(
        lambda cb: tfit.fit_pose_multiscale(moved(ptruth), ptarget, steps=1,
                                            device=dev, on_step=cb))
    lad_ms = (time.perf_counter() - t0) * 1e3
    check(all(np.isfinite(ladder.losses)) and len(ladder.losses) == 6
          and ladder.scene.config.noise_octaves is None,
          f"fit_pose_multiscale: losses {ladder.losses}")
    log(f"timing [{card}] fit_pose_multiscale at {POSE_SIZE}^2, 1 step a rung "
        f"over {tfit.DEFAULT_POSE_SCHEDULE}: the ladder {lad_ms:.3f} ms (host "
        f"clock, one reading: 3 rungs' setups, steps and final evaluations), "
        f"{lad_n.get((0, 1))} CUDA launches from the end of rung 1's step to "
        f"the end of rung 2's (rung 1's final evaluation, rung 2's setup and "
        f"step; traced), peak {lad_peak:.2f} GiB; losses "
        f"{[f'{x:.6g}' for x in ladder.losses]}")

    # --- fit_scene_batch K=4 and fit_scene_multiview K=3 at 64^2 ------------
    factors = (0.6, 0.8, 1.2, 1.4)[:BATCH_K]
    btargets = np.stack([gt.render_scene(scaled(ptruth, "strength", f),
                                         device=dev) for f in factors])
    template = scaled(ptruth, "strength", 1.5)
    starts = [scaled(ptruth, "strength", 1.5 * f) for f in factors]
    how = {"tensor": "per-scene starts",
           "frozen": "one template, one frozen field set"}
    for march, scenes in (("tensor", starts), ("frozen", template)):
        res, b_ms, b_n, b_peak = traced_fit(
            lambda cb: tfit.fit_scene_batch(
                scenes, btargets, steps=FIT_STEPS, march=march, device=dev,
                on_step=cb))
        # each scene's best iterate (the one the fit returns) beats its
        # start: a scene that starts near its target may overshoot later
        check(res.losses.shape == (FIT_STEPS + 1, BATCH_K)
              and bool(np.all(res.losses.min(axis=0) < res.losses[0])),
              f"fit_scene_batch march={march}: losses {res.losses.tolist()}")
        keep[f"fit_scene_batch {march}"] = dict(
            scenes=scenes, targets=btargets, res=res, ms=b_ms,
            truths=[scaled(ptruth, "strength", f) for f in factors],
            launches=b_n.get((0, 1)), peak=b_peak)
        log(f"timing [{card}] fit_scene_batch K={BATCH_K} march={march} "
            f"({how[march]}) "
            f"step at {POSE_SIZE}^2: {fmt_ms(b_ms)}, {b_n.get((0, 1))} CUDA "
            f"launches per step (traced), peak {b_peak:.2f} GiB; first/last "
            f"losses {res.losses[0].tolist()} / {res.losses[-1].tolist()}")
    cams = orbit_path(ptruth.camera, MVIEW_K, 120.0)
    vtargets = np.stack([gt.render_scene(dataclasses.replace(ptruth,
                                                             camera=c),
                                         device=dev) for c in cams])
    mv, mv_ms, mv_n, mv_peak = traced_fit(
        lambda cb: tfit.fit_scene_multiview(
            template, vtargets, cams, steps=FIT_STEPS, march="frozen",
            device=dev, on_step=cb))
    check_fit("fit_scene_multiview", mv.losses)
    log(f"timing [{card}] fit_scene_multiview K={MVIEW_K} march=frozen step "
        f"at {POSE_SIZE}^2: {fmt_ms(mv_ms)}, {mv_n.get((0, 1))} CUDA launches "
        f"per step (traced), peak {mv_peak:.2f} GiB; losses "
        f"{[f'{x:.6g}' for x in mv.losses]}")

    # --- fit_joint (pose fd) and fit_joint_multiview K=2, one round ---------
    # each block's first step holds its setup and its second is traced
    P = FIT_STEPS
    jstart = moved(scaled(ptruth, "strength", 1.5))
    cr.march_batch.launch_count = 0
    joint, j_ms, j_n, j_peak = traced_fit(
        lambda cb: tfit.fit_joint(jstart, ptarget, ("strength",), rounds=1,
                                  pose_steps=P, scene_steps=P,
                                  pose_method="fd", march="frozen",
                                  device=dev, on_step=cb),
        windows=((0, 1), (P, P + 1)))
    j_launches = cr.march_batch.launch_count
    keep["fit_joint"] = dict(scene=jstart, target=ptarget, res=joint,
                             ms=j_ms, launches=j_n, peak=j_peak)
    check(all(np.isfinite(joint.losses)) and j_launches == P + 1
          and joint.scene.camera.camera != jstart.camera.camera,
          f"fit_joint: {j_launches} march_batch launches, losses "
          f"{joint.losses}")
    log(f"timing [{card}] fit_joint pose_method=fd at {POSE_SIZE}^2 (1 "
        f"round: {P} fd pose steps, {P} frozen scene steps): a pose step "
        f"{fmt_ms(j_ms, range(2, P))}, a scene step "
        f"{fmt_ms(j_ms, range(P + 2, 2 * P))}; CUDA launches a pose step "
        f"{j_n.get((0, 1))}, a scene step {j_n.get((P, P + 1))} (traced), "
        f"{j_launches} march_batch launches, peak {j_peak:.2f} GiB")
    mcams = cams[:2]
    mstarts = [dataclasses.replace(c, camera=tuple(
        v + d for v, d in zip(c.camera, (0.015, 0.01, -0.01)))) for c in mcams]
    cr.march_batch.launch_count = 0
    jmv, jmv_ms, jmv_n, jmv_peak = traced_fit(
        lambda cb: tfit.fit_joint_multiview(
            template, vtargets[:2], mstarts, ("strength",), rounds=1,
            pose_steps=P, scene_steps=P, march="frozen", device=dev,
            on_step=cb),
        windows=((0, 1), (2 * P, 2 * P + 1)))
    jmv_launches = cr.march_batch.launch_count
    check(all(np.isfinite(jmv.losses)) and jmv_launches == 2 * (P + 1)
          and all(a.camera != b.camera for a, b in zip(jmv.cameras, mstarts)),
          f"fit_joint_multiview: {jmv_launches} march_batch launches, losses "
          f"{jmv.losses}")
    log(f"timing [{card}] fit_joint_multiview K=2 at {POSE_SIZE}^2 (1 round: "
        f"{P} fd pose steps a view, {P} frozen scene steps): a pose step "
        f"{fmt_ms(jmv_ms, [*range(2, P), *range(P + 1, 2 * P)])}, a scene "
        f"step {fmt_ms(jmv_ms, range(2 * P + 2, 3 * P))}; CUDA launches a "
        f"pose step {jmv_n.get((0, 1))}, a scene step "
        f"{jmv_n.get((2 * P, 2 * P + 1))} (traced), {jmv_launches} "
        f"march_batch launches, peak {jmv_peak:.2f} GiB")

    # --- the card's trajectories against the CPU's at 12^2 ------------------
    c_truth = spiral_scene(CHECK_SIZE, is_preview=True, noise_octaves=2)
    c_target = gt.render_scene(c_truth, device=dev)
    c_cams = [c_truth.camera, dataclasses.replace(c_truth.camera,
                                                  camera=(0.0, 0.0, 0.5))]
    c_views = np.stack([gt.render_scene(dataclasses.replace(c_truth,
                                                            camera=c),
                                        device=dev) for c in c_cams])
    c_btargets = np.stack([gt.render_scene(scaled(c_truth, "strength", f),
                                           device=dev) for f in (0.8, 1.2)])
    c_weak = scaled(c_truth, "strength", 1.5)
    runs = {
        "fit_pose": lambda d: tfit.fit_pose(
            moved(c_truth), c_target, ("camera",), steps=2, lr=1e-2,
            device=d).losses,
        # one step: a step is 7 frames of the plain march on the CPU
        "fit_pose_fd": lambda d: tfit.fit_pose_fd(
            moved(c_truth), c_target, steps=1, device=d).losses,
        "fit_scene_batch": lambda d: tfit.fit_scene_batch(
            [c_weak, scaled(c_weak, "strength", 0.8)], c_btargets,
            ("strength",), steps=2, lr=5e-2, device=d).losses,
        "fit_scene_multiview": lambda d: tfit.fit_scene_multiview(
            c_weak, c_views, c_cams, ("strength",), steps=2, lr=5e-2,
            march="frozen", device=d).losses,
    }
    for name, run in runs.items():
        a, b = (np.asarray(run(d), np.float64) for d in (dev, "cpu"))
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        same_way = bool(np.all(np.sign(np.diff(a, axis=0))
                               == np.sign(np.diff(b, axis=0))))
        log(f"{name} {CHECK_SIZE}^2, {len(a) - 1} step(s): card losses "
            f"{a.tolist()}, CPU "
            f"{b.tolist()}: max rel {rel:.3g} (limit {FIT_CPU_RTOL:g}), moves "
            f"the CPU's way: {same_way}")
        check(rel <= FIT_CPU_RTOL and same_way, f"{name}: card {a} vs CPU {b}")
    # the camera chain on the card: a pose fit's first loss (normalize off)
    # is fit_scene's at the same pose, bit for bit
    a0, b0 = (r.losses[0] for r in (
        tfit.fit_pose(moved(c_truth), c_target, ("camera",), steps=0,
                      normalize=False, device=dev),
        tfit.fit_scene(moved(c_truth), c_target, ("strength",), steps=0,
                       march="tensor", device=dev)))
    log(f"fit_pose first loss {a0!r} vs fit_scene's {b0!r} at the same pose "
        f"on cuda {CHECK_SIZE}^2: bit-equal {a0 == b0}")
    check(a0 == b0, f"fit_pose first loss {a0!r} vs fit_scene's {b0!r}")

    # --- POST /fit over HTTP: an fd pose job and a frozen scene job ---------
    httpd = serve(port=0, poll=False, batch_window_s=0.0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def http(path, data=None, method=None):
        if data is not None:
            data = json.dumps(data).encode()
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
            return r.status, r.read()

    try:
        png = base64.b64encode(encode_png(ptarget)).decode()
        from gamer_tpu_torch.scene.schema import scene_to_dict

        jobs = {
            "fd": {"scene": scene_to_dict(moved(ptruth)), "target_png": png,
                   "steps": 2, "lr": 1e-2, "pose": "fd"},
            "frozen": {"scene": scene_to_dict(scaled(ptruth, "strength",
                                                     1.5)),
                       "target_png": png, "steps": 2, "lr": 5e-2,
                       "fields": ["strength"], "march": "frozen"},
        }
        results = {}
        cr.march_batch.launch_count = 0
        for name, payload in jobs.items():
            status, body = http("/fit", payload)
            jid = json.loads(body)["job"]
            check(status == 202, f"POST /fit {name}: {status}")
            info = json.loads(http(f"/job/{jid}?wait=60")[1])
            check(info["state"] == "done", f"/fit {name}: {info}")
            results[name] = json.loads(http(f"/job/{jid}/result.json")[1])
            _, img = http(f"/job/{jid}/image.png")
            check(img[:8] == b"\x89PNG\r\n\x1a\n", f"/fit {name} image")
        http_launches = cr.march_batch.launch_count
        fd_lib = tfit.fit_pose_fd(moved(ptruth), ptarget, steps=2, lr=1e-2,
                                  device=dev)
        check(http_launches == 3
              and set(results["fd"]) == {"scene", "losses", "fit_fields",
                                         "pose"}
              and results["fd"]["losses"] == [float(v) for v in fd_lib.losses]
              and set(results["frozen"]) == {"scene", "losses", "fit_fields"}
              and results["frozen"]["losses"][-1]
              < results["frozen"]["losses"][0],
              f"/fit: {http_launches} march_batch launches; fd losses "
              f"{results['fd']['losses']} against the library's "
              f"{fd_lib.losses}; keys {sorted(results['fd'])}, "
              f"{sorted(results['frozen'])}; frozen losses "
              f"{results['frozen']['losses']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.stop()
        http_thread.join(SERVE_WAIT_S)
    check(not http_thread.is_alive(), "the HTTP thread did not stop")
    log(f"http POST /fit: fd pose job ({http_launches} march_batch launches, "
        f"losses equal "
        f"to the library call's {results['fd']['losses']}) and a frozen "
        f"scene job (losses {results['frozen']['losses']}); result.json and "
        f"image.png served")

    # --- the CLI fitpose ... fd and fitjoint ... pose=fd at 64^2 ------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_png(tmp / "target.png", ptarget)
        g = copy.deepcopy(ptruth.instances[0].galaxy)
        for c in g.components:
            c.strength *= 1.5
        gax.save(g, tmp / "start.gax")
        args = [str(v) for v in POSE_START] + ["0", "0", "0", "0", "1", "0",
                                               "90", "1", "1", "1", "0.025",
                                               str(tmp / "start.gax"),
                                               str(tmp / "target.png")]
        cr.march_batch.launch_count = 0
        rc1 = cli.main(["fitpose", *args, str(tmp / "pose.json"), "2",
                        "0.01", "fd"])
        n1 = cr.march_batch.launch_count
        rc2 = cli.main(["fitjoint", *args, str(tmp / "joint.json"), "1", "2",
                        "2", "pose=fd", "fields=strength"])
        n2 = cr.march_batch.launch_count - n1
        pose_json = json.loads((tmp / "pose.json").read_text())
        fitted = gax.load(tmp / "joint.gax")
        check(rc1 == 0 and rc2 == 0 and n1 == 3 and n2 == 3
              and pose_json["camera"]["camera"] != list(POSE_START)
              and fitted.components[1].strength != g.components[1].strength,
              f"cli fitpose/fitjoint: rc {rc1} {rc2}, launches {n1} {n2}")
    log(f"cli fitpose ... fd and fitjoint ... pose=fd at {POSE_SIZE}^2: "
        f"{n1} and {n2} march_batch launches; camera -> "
        f"{pose_json['camera']['camera']}")
    log(f"fit families phase: {time.perf_counter() - t_phase:.1f} s (host "
        f"clock)")
    return (pfd_launches, probe_err, probe_k_ms, probe_plain_ms, probe_bound)


# the sharded autograd fits: cases on Mesh([card] * n), beside the same fit
# unsharded; JAX's tolerances for its own sharded fits (tests/test_fit.py:
# 582, 615, 1091); the batch axis is bit-equal
MESH_FIT_RTOL = {"fit_scene": 2e-3, "fit_pose": 5e-3, "fit_joint": 2e-3,
                 "fit_scene_multiview": 5e-5}
MESH_MVIEW_K = 4
# one SGD step's summed gradient on a mesh against one entry, relative to
# each leaf's largest element (tests/test_torch_fit_mesh.py's limit)
MESH_GRAD_RTOL = 1e-5


def _rel(a, b) -> float:
    """max |a - b| / |b| over the elements, inf where b is 0 and a is not."""
    a, b = (np.asarray(v, np.float64).ravel() for v in (a, b))
    nz = b != 0
    if np.any(a[~nz] != 0):
        return float("inf")
    return float(np.max(np.abs(a[nz] - b[nz]) / np.abs(b[nz]), initial=0.0))


class SGDProbe:
    """Plain SGD (params += -lr * g) in the fits' ``Adam`` interface that
    keeps each step's gradient as the fit's loop passes it (summed over
    the mesh's entries, made finite and masked)."""

    def __init__(self, lr):
        self.lr, self.grads = lr, []

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        from gamer_tpu_torch.utils.tree import tree_leaves, tree_map

        self.grads.append([g.detach().cpu().numpy().copy()
                           for g in tree_leaves(grads)])
        return tree_map(lambda g: g * -self.lr, grads), state


def grad_rel(got, want) -> float:
    """max over the leaves of max |got - want| / max |want| (a leaf that
    is zero in ``want``, an unfitted one, must be zero in ``got``)."""
    out = 0.0
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        d = float(np.abs(g - w).max())
        out = max(out, d / scale if scale else (0.0 if d == 0 else np.inf))
    return out


def mesh_fit_phases(card: str, dev, keep: dict) -> None:
    """The autograd fits with ``mesh=``: fit_scene (tensor, frozen) at
    128^2 and fit_pose (LOD 3) and fit_scene_batch (K=4, frozen) at 64^2
    on 4 entries of the card, fit_scene_multiview (K=4, frozen) and
    fit_joint (fd poses) at 64^2 on 2, each beside the same fit unsharded
    (from the earlier fit phases, ``keep``; multi-view run here), its
    targets from S1 on the same mesh; then one sharded SGD step on the
    card against the same fit on a mesh of CPU entries and on one card
    entry at 12^2, its losses and its summed gradient."""
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import fit as tfit
    from gamer_tpu_torch.parallel import Mesh
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()

    def fit_rel(got, want):
        return max([_rel(got.losses, want.losses)]
                   + [_rel(x, y) for x, y in zip(tree_leaves(got.params),
                                                 tree_leaves(want.params))])

    def s1_target(scene, mesh, want):
        img = gt.render_scene(scene, mesh=mesh)
        check(np.array_equal(img, want),
              "S1 target differs from the unsharded kernel frame")
        return img

    def report(name, n, size, got, base, err, limit, keep_steps=None):
        res, ms, counts, peak = got
        log(f"timing [{card}] {name} at {size}^2 on {n} entries of one "
            f"card: {fmt_ms(ms, keep_steps)}, {counts.get((0, 1))} CUDA "
            f"launches a step (traced), peak {peak:.2f} GiB; unsharded "
            f"{fmt_ms(base['ms'], keep_steps)}, "
            f"{base['launches']} launches, peak {base['peak']:.2f} GiB; "
            f"losses and fitted values max rel {err:.3g} against unsharded "
            f"(limit {limit}); losses "
            f"{np.asarray(res.losses, np.float64).tolist()}")

    # --- fit_scene, tensor and frozen, 128^2 on 4 entries ------------------
    mesh4, mesh2 = Mesh([dev] * 4), Mesh([dev] * 2)
    for march in ("tensor", "frozen"):
        base = keep[f"fit_scene {march}"]
        target = s1_target(base["scene"], mesh4, base["target"])
        got = traced_fit(lambda cb: tfit.fit_scene(
            base["start"], target, steps=FIT_STEPS, march=march, mesh=mesh4,
            on_step=cb))
        err = fit_rel(got[0], base["res"])
        report(f"fit_scene march={march} mesh=", 4, FIT_SIZE, got, base, err,
               MESH_FIT_RTOL["fit_scene"])
        check(err <= MESH_FIT_RTOL["fit_scene"],
              f"fit_scene {march} on the mesh: {got[0].losses} vs "
              f"{base['res'].losses}")

    # --- fit_pose, LOD 3, 64^2 on 4 entries --------------------------------
    base = keep["fit_pose"]
    target = s1_target(base["truth"], mesh4, base["target"])
    got = traced_fit(lambda cb: tfit.fit_pose(
        base["scene"], target, ("camera",), steps=FIT_STEPS, lr=1e-2,
        mesh=mesh4, on_step=cb))
    err = fit_rel(got[0], base["res"])
    report("fit_pose march=tensor LOD 3 mesh=", 4, POSE_SIZE, got, base, err,
           MESH_FIT_RTOL["fit_pose"])
    check(err <= MESH_FIT_RTOL["fit_pose"],
          f"fit_pose on the mesh: {got[0].losses} vs {base['res'].losses}")

    # --- fit_scene_batch K=4, frozen, 64^2 on 4 entries: bit-equal ---------
    base = keep["fit_scene_batch frozen"]
    targets = np.stack([s1_target(sc, mesh4, t) for sc, t in
                        zip(base["truths"], base["targets"])])
    got = traced_fit(lambda cb: tfit.fit_scene_batch(
        base["scenes"], targets, steps=FIT_STEPS, march="frozen", mesh=mesh4,
        on_step=cb))
    same = (np.array_equal(got[0].losses, base["res"].losses)
            and all(np.array_equal(x, y) for x, y in zip(
                tree_leaves(got[0].params), tree_leaves(base["res"].params))))
    report(f"fit_scene_batch K={BATCH_K} march=frozen mesh=", 4, POSE_SIZE,
           got, base, 0.0 if same else fit_rel(got[0], base["res"]),
           "bit-equal")
    check(same, f"fit_scene_batch on the mesh is not bit-equal: "
                f"{got[0].losses.tolist()} vs {base['res'].losses.tolist()}")

    # --- fit_scene_multiview K=4, frozen, 64^2 on 2 entries ----------------
    ptruth = keep["fit_pose"]["truth"]
    cams = orbit_path(ptruth.camera, MESH_MVIEW_K, 120.0)
    views = [dataclasses.replace(ptruth, camera=c) for c in cams]
    vtargets = np.stack([s1_target(v, mesh2, gt.render_scene(v, device=dev))
                         for v in views])
    start = scaled(ptruth, "strength", 1.5)
    res, ms, counts, peak = traced_fit(lambda cb: tfit.fit_scene_multiview(
        start, vtargets, cams, steps=FIT_STEPS, march="frozen", device=dev,
        on_step=cb))
    base = dict(res=res, ms=ms, launches=counts.get((0, 1)), peak=peak)
    got = traced_fit(lambda cb: tfit.fit_scene_multiview(
        start, vtargets, cams, steps=FIT_STEPS, march="frozen", mesh=mesh2,
        on_step=cb))
    err = fit_rel(got[0], res)
    report(f"fit_scene_multiview K={MESH_MVIEW_K} march=frozen mesh=", 2,
           POSE_SIZE, got, base, err, MESH_FIT_RTOL["fit_scene_multiview"])
    check(err <= MESH_FIT_RTOL["fit_scene_multiview"],
          f"fit_scene_multiview on the mesh: {got[0].losses} vs {res.losses}")

    # --- fit_joint, fd poses (S2) and frozen scene steps, on 2 entries -----
    base = keep["fit_joint"]
    P = FIT_STEPS
    target = s1_target(keep["fit_pose"]["truth"], mesh2, base["target"])
    res, ms, counts, peak = traced_fit(
        lambda cb: tfit.fit_joint(base["scene"], target, ("strength",),
                                  rounds=1, pose_steps=P, scene_steps=P,
                                  pose_method="fd", march="frozen",
                                  mesh=mesh2, on_step=cb),
        windows=((0, 1), (P, P + 1)))
    err = _rel(res.losses, base["res"].losses)
    log(f"timing [{card}] fit_joint pose_method=fd mesh= at {POSE_SIZE}^2 on "
        f"2 entries of one card: a pose step {fmt_ms(ms, range(2, P))}, a "
        f"scene step {fmt_ms(ms, range(P + 2, 2 * P))}; CUDA launches a pose "
        f"step {counts.get((0, 1))}, a scene step {counts.get((P, P + 1))} "
        f"(traced), peak {peak:.2f} GiB; unsharded: a pose step "
        f"{fmt_ms(base['ms'], range(2, P))}, a scene step "
        f"{fmt_ms(base['ms'], range(P + 2, 2 * P))}, launches "
        f"{base['launches'].get((0, 1))} / {base['launches'].get((P, P + 1))}"
        f", peak {base['peak']:.2f} GiB; losses max rel {err:.3g} against "
        f"unsharded (limit {MESH_FIT_RTOL['fit_joint']})")
    check(err <= MESH_FIT_RTOL["fit_joint"],
          f"fit_joint on the mesh: {res.losses} vs {base['res'].losses}")

    # --- one sharded step: the card against CPU entries at 12^2 ------------
    c_truth = spiral_scene(CHECK_SIZE, is_preview=True, noise_octaves=2)
    c_target = gt.render_scene(c_truth, device=dev)
    c_weak = scaled(c_truth, "strength", 1.5)
    c_moved = dataclasses.replace(c_truth, camera=dataclasses.replace(
        c_truth.camera, camera=POSE_START))
    c_cams = orbit_path(c_truth.camera, 2, 120.0)
    c_views = np.stack([gt.render_scene(dataclasses.replace(c_truth,
                                                            camera=c),
                                        device=dev) for c in c_cams])
    c_btargets = np.stack([gt.render_scene(scaled(c_truth, "strength", f),
                                           device=dev)
                           for f in (0.7, 0.9, 1.1, 1.3)])
    # plain SGD, whose step is proportional to the gradient, and each
    # step's summed gradient kept: Adam's lr x sign(m) steps would hide a
    # gradient part that the mesh drops, doubles or scales by 1/n
    runs = {
        ("fit_scene", 4): lambda m, o: tfit.fit_scene(
            c_weak, c_target, ("strength",), steps=1, lr=5e-2, optimizer=o,
            mesh=m),
        ("fit_pose", 4): lambda m, o: tfit.fit_pose(
            c_moved, c_target, ("camera",), steps=1, lr=1e-3, optimizer=o,
            mesh=m),
        ("fit_scene_batch", 4): lambda m, o: tfit.fit_scene_batch(
            c_weak, c_btargets, ("strength",), steps=1, lr=5e-2,
            march="frozen", optimizer=o, mesh=m),
        ("fit_scene_multiview", 2): lambda m, o: tfit.fit_scene_multiview(
            c_weak, c_views, c_cams, ("strength",), steps=1, lr=5e-2,
            march="frozen", optimizer=o, mesh=m),
    }
    for (name, n), run in runs.items():
        probes = {k: SGDProbe(5e-2) for k in ("card", "cpu", "one entry")}
        a, b = (np.asarray(run(Mesh([d] * n), probes[k]).losses, np.float64)
                for k, d in (("card", dev), ("cpu", "cpu")))
        run(Mesh([dev]), probes["one entry"])
        err = _rel(a, b)
        g_cpu = grad_rel(probes["card"].grads[0], probes["cpu"].grads[0])
        g_one = grad_rel(probes["card"].grads[0],
                         probes["one entry"].grads[0])
        log(f"{name} mesh= {CHECK_SIZE}^2, 1 SGD step on {n} entries: card "
            f"losses {a.tolist()}, CPU entries {b.tolist()}: max rel "
            f"{err:.3g} (limit {FIT_CPU_RTOL:g}); the step's summed gradient "
            f"max |d| / max |g| against CPU entries {g_cpu:.3g} (limit "
            f"{FIT_CPU_RTOL:g}), against the card unsharded {g_one:.3g} "
            f"(limit {MESH_GRAD_RTOL:g})")
        check(err <= FIT_CPU_RTOL and g_cpu <= FIT_CPU_RTOL
              and g_one <= MESH_GRAD_RTOL,
              f"{name} mesh: card {a} vs CPU {b}, gradient {g_cpu} / {g_one}")
    log(f"sharded fits phase: {time.perf_counter() - t_phase:.1f} s (host "
        f"clock)")


# the XLA-form surfaces: the progressive frame's chunks and where the
# abort run stops; the sky at ALLSKY_NSIDE (one nside-512 call takes
# ~28 s on an NVIDIA H100 80GB HBM3 at 700 W, under the 60 s that would
# call for nside 256)
XLA_CHUNKS = 16
XLA_ABORT_AFTER = 4
XLA_MAX_LSB = 3
# the XLA-form map against K6's: max |d| / max |m|. tests/test_pallas.py
# holds the two to 1e-3 at nside 4 and 16; the XLA march's per-step norm
# (ROADMAP.md section 3) puts them 8.96e-4 apart at nside 256 and 1.25e-3
# at nside 512 on this sky (NVIDIA H100 80GB HBM3, 700 W), so the gate takes the frame's allowance for
# it (2 -> 3 LSB) in the same proportion
XLA_MAP_GATE = 1.5e-3


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def xla_surface_phases(card: str, dev) -> None:
    """The XLA-form surfaces on the card: render_scene_sharded(method=
    "xla") at 512^2 on 4 entries against the unsharded XLA-form frame and
    the kernel's; render_allsky_map(kernel="xla") against K6's map;
    queue.render_progressive (ticks, abort, the finished frame); the CLI
    galaxy xla / sharded / oracle and skybox xla against their library
    calls."""
    import gamer_tpu_torch as gt
    from gamer_tpu_torch import cli
    from gamer_tpu_torch.engine import queue as tqueue
    from gamer_tpu_torch.engine import render as trender
    from gamer_tpu_torch.io.png import read_png
    from gamer_tpu_torch.io.renderparams import RenderParamsFile
    from gamer_tpu_torch.models import presets
    from gamer_tpu_torch.oracle import render_oracle
    from gamer_tpu_torch.parallel import (Mesh, make_pixel_mesh,
                                          render_scene_sharded)
    from gamer_tpu_torch.scene import gax

    t_phase = time.perf_counter()
    scene = spiral_scene(MAIN_SIZE)
    xla, xla_ms = _timed(lambda: trender.render_scene(scene, device=dev))
    # the march's trip replayed as a CUDA graph against the eager loop
    graphed = trender._march_graphed

    def eager(step, state):
        while bool((~state[4]).any()):
            state = step(state)
        return state[1], state[2]

    trender._march_graphed = eager
    try:
        xla_eager, eager_ms = _timed(lambda: trender.render_scene(
            scene, device=dev))
    finally:
        trender._march_graphed = graphed
    check(np.array_equal(xla, xla_eager),
          "the CUDA-graph march differs from the eager loop")
    sharded, sh_ms = _timed(lambda: render_scene_sharded(
        scene, Mesh([dev] * 4), method="xla"))
    kernel, k_ms = _timed(lambda: gt.render_scene(scene, device=dev))
    d = np.abs(xla.astype(np.int16) - kernel.astype(np.int16))
    check(np.array_equal(sharded, xla),
          "sharded XLA-form frame differs from the unsharded one")
    check(int(d.max()) <= XLA_MAX_LSB,
          f"XLA-form frame {int(d.max())} LSB from the kernel's")
    log(f"timing [{card}] XLA-form frame {MAIN_SIZE}^2 (host clock, one "
        f"call each): the trip as a CUDA graph {xla_ms:.1f} ms, bit-equal to "
        f"the eager loop ({eager_ms:.1f} ms); render_scene_sharded(method="
        f"'xla') on 4 entries of one card {sh_ms:.1f} ms, bit-equal to the "
        f"unsharded XLA-form frame; against the kernel's frame ({k_ms:.1f} "
        f"ms) max {int(d.max())} LSB (limit {XLA_MAX_LSB}), "
        f"{int((d.max(-1) > 2).sum())} pixels above 2 LSB, "
        f"{float((d.max(-1) > 0).mean()):.5f} of pixels differ")

    # --- the all-sky map through the XLA-form march ------------------------
    sky = allsky_scene()
    k6, k6_ms = _timed(lambda: gt.render_allsky_map(sky, ALLSKY_NSIDE,
                                                    device=dev))
    xmap, xmap_ms = _timed(lambda: gt.render_allsky_map(
        sky, ALLSKY_NSIDE, device=dev, kernel="xla"))
    gate = float(np.abs(xmap - k6).max() / (np.abs(k6).max() + 1e-12))
    check(gate < XLA_MAP_GATE and bool((xmap > 0).all()),
          f"XLA-form all-sky map: max |d| / max |m| {gate}")
    log(f"timing [{card}] render_allsky_map nside {ALLSKY_NSIDE} "
        f"({12 * ALLSKY_NSIDE ** 2} rays, host clock, one call each): "
        f"kernel='xla' {xmap_ms:.1f} ms, K6 {k6_ms:.1f} ms; max |d| / max "
        f"|m| {gate:.3g} (limit {XLA_MAP_GATE:g}), every pixel non-zero")

    # --- queue.render_progressive: ticks, abort, the finished frame --------
    ticks = []
    prog, prog_ms = _timed(lambda: tqueue.render_progressive(
        scene, XLA_CHUNKS, lambda f, _p: ticks.append(f), device=dev))
    check(ticks == [(c + 1) / XLA_CHUNKS for c in range(XLA_CHUNKS)]
          and np.array_equal(prog, xla),
          f"progressive XLA-form frame: ticks {ticks}, bit-equal "
          f"{np.array_equal(prog, xla)}")
    seen = []

    def stop(frac, partial):
        seen.append((frac, partial))
        return len(seen) < XLA_ABORT_AFTER

    part, part_ms = _timed(lambda: tqueue.render_progressive(
        scene, XLA_CHUNKS, stop, device=dev))
    rows = XLA_ABORT_AFTER * MAIN_SIZE // XLA_CHUNKS
    check([f for f, _ in seen] == [(c + 1) / XLA_CHUNKS
                                   for c in range(XLA_ABORT_AFTER)]
          and np.array_equal(part, seen[-1][1])
          and np.array_equal(part[:rows], xla[:rows])
          and not part[rows:].any(),
          f"progressive abort: ticks {[f for f, _ in seen]}")
    log(f"timing [{card}] queue.render_progressive {MAIN_SIZE}^2 (host "
        f"clock): {XLA_CHUNKS} chunks {prog_ms:.1f} ms, ticks in order, "
        f"bit-equal to the unsharded XLA-form frame; stopped after chunk "
        f"{XLA_ABORT_AFTER}: {part_ms:.1f} ms, the partial frame (rows "
        f"0-{rows - 1} the frame's, the rest black)")

    # --- the CLI methods, on the spiral's bulge alone ----------------------
    # (the skybox camera sits outside the bulge, so most faces march no
    # trip; a frame of queue.render_progressive is bit-equal to
    # render.render_scene's, held above at 512^2, so the library frames
    # are one march each)
    g = presets.spiral()
    g.components = [c for c in g.components if c.cid == 0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gax.save(g, tmp / "bulge.gax")
        RenderParamsFile(camera=gt.CameraParams(camera=(1.5, 0, 0)),
                         ray_step=0.025).save(tmp / "rp.dat")
        small = spiral_scene(32, galaxy=g)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            clis = {}
            for method in ("xla", "sharded", "oracle"):
                argv = ["galaxy", method, "0.5", "0", "0", "0", "0", "0",
                        "0", "1", "0", "90", "1", "1", "1.0", "0.025",
                        "bulge.gax", "32", f"{method}.png"]
                _, clis[method] = _timed(lambda: cli.main(argv))
            _, clis["skybox xla"] = _timed(lambda: cli.main(
                ["skybox", "xla", "rp.dat", "bulge.gax", "64"]))
        finally:
            os.chdir(cwd)
        want = {
            "xla": trender.render_scene(small, device=dev),
            "sharded": render_scene_sharded(small, make_pixel_mesh()),
            "oracle": render_oracle(small)[0],
        }
        for method, img in want.items():
            check(np.array_equal(read_png(tmp / f"{method}.png"), img),
                  f"CLI galaxy {method} differs from its library call")
        rp = RenderParamsFile.load(tmp / "rp.dat")
        faces = tqueue.skybox_jobs(gt.Scene(
            camera=rp.camera, instances=[gt.GalaxyInstance(galaxy=g)],
            config=rp.to_render_config(size=64)))
        for job in faces:
            check(np.array_equal(
                read_png(tmp / f"{job.filename}.png"),
                trender.render_scene(job.scene, device=dev)),
                f"CLI skybox xla face {job.filename} differs")
    log(f"cli galaxy xla / sharded / oracle at 32^2 and skybox xla at 64^2 "
        f"(the spiral's bulge alone, the skybox from (1.5, 0, 0)): each PNG "
        f"equals its library frame (the XLA-form frame, "
        f"render_scene_sharded over every card, render_oracle; each face's "
        f"XLA-form frame); host clock "
        f"{', '.join(f'{k} {v:.0f} ms' for k, v in clis.items())}")
    log(f"XLA-form surfaces phase: {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")


VIEWER_SIZE = 256
VIEWER_LOD = 4
VIEWER_REQUESTS = 20
VIEWER_FULL = 512
VIEWER_FACE = 128
DRYRUN_ENTRIES = 4
DRYRUN_BUDGET_S = 300.0
STATS_FRAMES = 5
PROFILER_LOSS_SIZES = [0, 600000, 2000000]


def _multipart(body: bytes):
    """(progress, PNG bytes) of each part of a multipart/x-mixed-replace
    body with the viewer's boundary."""
    parts = []
    for chunk in body.split(b"--gamerband\r\n")[1:]:
        head, _, rest = chunk.partition(b"\r\n\r\n")
        fields = dict(line.split(b": ", 1) for line in head.split(b"\r\n"))
        n = int(fields[b"Content-Length"])
        parts.append((float(fields[b"X-Progress"]), rest[:n]))
    return parts


# profile_trace around one still of the spiral (after a warm-up launch),
# in a process of its own: prints [name, microseconds] of each kernel in
# the trace
PROFILE_CHILD = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import gamer_tpu_torch as gt
from gamer_tpu_torch.models import presets
from gamer_tpu_torch.utils.profiling import profile_trace
scene = gt.Scene(
    camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                           up=(0, 1, 0), fov=90.0),
    instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
    config=gt.RenderConfig(size=int(sys.argv[2]), ray_step=0.025))
gt.render_scene(scene)
with tempfile.TemporaryDirectory() as tmp:
    with profile_trace(tmp, device="cuda"):
        gt.render_scene(scene)
    events = json.loads((Path(tmp) / "trace.json").read_text())
print(json.dumps([[e["name"], e["dur"]] for e in events["traceEvents"]
                  if e.get("cat") == "kernel"]))
"""


# a CUDA-only session of N launches (as a traced fit step issues them),
# then three profile_trace sessions of 10 launches, in a process of its own:
# prints per session the launch calls, kernel records, launches without
# their kernel, their order and whether a TraceLossWarning was raised
PROFILER_LOSS_CASE = r"""
import json, sys, tempfile, warnings
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from gamer_tpu_torch.utils.profiling import (TraceLossWarning, kernel_records,
                                             profile_trace)
n = int(sys.argv[2])
x = torch.ones(1024, device="cuda")
torch.cuda.synchronize()
if n:
    big = profile(activities=[ProfilerActivity.CUDA])
    big.start()
    for _ in range(n):
        x.add_(0.0)
    torch.cuda.synchronize()
    big.stop()
rows = []
for _ in range(3):
    with tempfile.TemporaryDirectory() as tmp:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", TraceLossWarning)
            with profile_trace(tmp, device="cuda"):
                for _ in range(10):
                    x.mul_(1.0)
        trace = json.loads((Path(tmp) / "trace.json").read_text())
    ev = trace["traceEvents"]
    kernels = {e["args"].get("correlation") for e in ev
               if e.get("cat") == "kernel"}
    calls = sorted((e["ts"], e["args"].get("correlation")) for e in ev
                   if e.get("cat") == "cuda_runtime" and "Launch" in e["name"])
    lost_at = [i for i, (_, c) in enumerate(calls) if c not in kernels]
    launches, n_kernels, lost = kernel_records(trace)
    rows.append({"launches": launches, "kernels": n_kernels, "lost": lost,
                 "lost_at": lost_at,
                 "warned": any(issubclass(w.category, TraceLossWarning)
                               for w in caught)})
print(json.dumps(rows))
"""


def profiler_loss(card: str, sizes) -> bool:
    """The kernel records a torch.profiler session loses after a CUDA-only
    session of N launches earlier in the same process, for each N in
    ``sizes``, and whether profile_trace reported each loss; False if it
    misreported a session."""
    ok = True
    for n in sizes:
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-W", "ignore", "-c",
                            PROFILER_LOSS_CASE, str(ROOT), str(n)], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"profiler loss N={n}: {r.stderr[-2000:]}")
        rows = json.loads(r.stdout.strip().splitlines()[-1])
        for row in rows:
            ok &= row["warned"] == bool(row["lost"] or not row["kernels"])
        log(f"profiler loss [{card}] after a CUDA-only session of {n} "
            f"launches ({time.perf_counter() - t:.1f} s): " + "; ".join(
                f"{x['kernels']} kernel records for {x['launches']} "
                f"launches, lost {x['lost']} (launches {x['lost_at']}), "
                f"TraceLossWarning {x['warned']}" for x in rows))
    return ok


def frontend_phases(card: str, dev) -> float:
    """The front end on the card: the interactive viewer over HTTP on a
    loopback port (/galaxies, /params, /render at a noise LOD through K1,
    /set, the streamed /fullrender through K5's one progressive launch,
    /skybox through one K4 launch; each image against the library call, the
    launches each route made, each route's kernel against its plain
    version), the dry run on 4 entries of the card (rungs a-h), the entry
    step against the kernel's frame, profile_trace around a still and
    RenderStats over stills. Returns the linear max_abs_err of the
    /fullrender launch's middle band against its plain version (the main
    path's shape: 512^2 in 16 bands)."""
    from gamer_tpu_torch import dryrun, viewer
    from gamer_tpu_torch.engine import batch
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine.queue import skybox_jobs
    from gamer_tpu_torch.golden import load_oracle_golden
    from gamer_tpu_torch.io.png import decode_png
    from gamer_tpu_torch.models import presets
    from gamer_tpu_torch.scene.schema import galaxy_to_dict
    from gamer_tpu_torch.utils.profiling import (RenderStats, TraceLossWarning,
                                                 kernel_records, profile_trace)

    from gamer_tpu_torch.engine.render import post_process

    t_phase = time.perf_counter()
    routes = (cr.march, cr.march_band, cr.march_batch, cr.march_progressive)

    def counts():
        torch.cuda.synchronize()
        return [fn.launch_count for fn in routes]

    taken = {}

    @contextlib.contextmanager
    def spying(route):
        """Keep the inputs and the output of each march launch while the
        block runs, under ``route``: the kernel's inputs as the route made
        them ((pages, table, frame size, rows) of a frame launch, (page,
        table, frame size, band rows, bands) of a progressive one, whose
        output is its ``ProgressiveLaunch``). The launch helpers under the
        wrappers are wrapped, so the wrappers' launch counts stay theirs."""
        reals = {name: getattr(cr, name)
                 for name in ("_launch", "_launch_progressive")}

        def spy(real):
            def launch(*a):
                out = real(*a)
                taken.setdefault(route, []).append((a, out))
                return out
            return launch

        for name, real in reals.items():
            setattr(cr, name, spy(real))
        try:
            yield
        finally:
            for name, real in reals.items():
                setattr(cr, name, real)

    httpd = viewer.serve(port=0, size=VIEWER_SIZE, poll=False, device=dev)
    state = httpd.state
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def http(path):
        try:
            with urllib.request.urlopen(base + path,
                                        timeout=SERVE_WAIT_S) as r:
                status, body = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        check(status == 200, f"viewer {path}: {status} {body[:200]!r}")
        return body

    g = "spiral"
    try:
        names = json.loads(http("/galaxies"))
        check(g in names, f"/galaxies: {names}")
        params = json.loads(http(f"/params?galaxy={g}"))
        check(params == galaxy_to_dict(presets.spiral()),
              "/params differs from galaxy_to_dict of the preset")
        view = f"/render?galaxy={g}&h=30&v=10&lod={VIEWER_LOD}"
        c0 = counts()
        with spying("/render"):
            img = decode_png(http(view))
        c1 = counts()
        view_scene = state._scene(g, 30.0, 10.0, 0.0, VIEWER_SIZE,
                                  preview=True, lod=VIEWER_LOD)
        want = cr.render_scene(view_scene, device=dev)
        check(np.array_equal(img, want) and int(img.sum()) > 0,
              "viewer /render differs from render_scene of its scene")
        lat = []
        for _ in range(VIEWER_REQUESTS):
            t = time.perf_counter()
            http(view)
            lat.append((time.perf_counter() - t) * 1e3)
        http(f"/set?galaxy={g}&comp=0&field=strength&value=400")
        edited = decode_png(http(view))
        check(not np.array_equal(edited, img), "/set did not change /render")
        http(f"/reset?galaxy={g}")
        c2 = counts()
        t = time.perf_counter()
        with spying("/fullrender"):
            body = http(f"/fullrender?galaxy={g}&size={VIEWER_FULL}&v=20"
                        f"&stream=1&bands={BANDS}")
        full_ms = (time.perf_counter() - t) * 1e3
        c3 = counts()
        parts = _multipart(body)
        full = decode_png(parts[-1][1])
        full_scene = state._scene(g, 0.0, 20.0, 0.0, VIEWER_FULL,
                                  preview=False)
        want_full = cr.render_scene(full_scene, device=dev)
        check(len(parts) >= BANDS and parts[-1][0] == 1.0
              and np.array_equal(full, want_full),
              f"/fullrender stream: {len(parts)} parts, last bit-equal "
              f"{np.array_equal(full, want_full)}")
        c4 = counts()
        t = time.perf_counter()
        with spying("/skybox"):
            montage = decode_png(http(f"/skybox?galaxy={g}"
                                      f"&size={VIEWER_FACE}"))
        sky_ms = (time.perf_counter() - t) * 1e3
        c5 = counts()
        sky_scene = state._scene(g, 0.0, 0.0, 0.0, VIEWER_FACE,
                                 preview=False)
        faces = batch.render_batch([j.scene for j in skybox_jobs(sky_scene)],
                                   device=dev)
        f = VIEWER_FACE
        check(montage.shape == (2 * f, 3 * f, 3) and all(
            np.array_equal(montage[(i // 3) * f:(i // 3 + 1) * f,
                                   (i % 3) * f:(i % 3 + 1) * f], face)
            for i, face in enumerate(faces)),
              "viewer /skybox faces differ from render_batch's")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(SERVE_WAIT_S)
    check(not thread.is_alive(), "the viewer's thread did not stop")
    rises = {"/render": [b - a for a, b in zip(c0, c1)],
             "/fullrender": [b - a for a, b in zip(c2, c3)],
             "/skybox": [b - a for a, b in zip(c4, c5)]}
    check(rises == {"/render": [1, 0, 0, 0], "/fullrender": [0, 0, 0, 1],
                    "/skybox": [0, 0, 1, 0]},
          f"launches (march, march_band, march_batch, march_progressive) "
          f"per route: {rises}")
    log(f"viewer on {base} ({card}): /galaxies, /params = galaxy_to_dict; "
        f"/render {VIEWER_SIZE}^2 LOD {VIEWER_LOD} bit-equal to render_scene"
        f", /set changes it; /fullrender?stream=1 {VIEWER_FULL}^2: "
        f"{len(parts)} parts, the last bit-equal to render_scene; /skybox "
        f"{VIEWER_FACE}^2 faces bit-equal to render_batch; launches "
        f"(march, march_band, march_batch, march_progressive) per route "
        f"{rises}")
    log(f"timing [{card}] viewer (host clock, request -> last byte): "
        f"/render {VIEWER_SIZE}^2 LOD {VIEWER_LOD}, {VIEWER_REQUESTS} "
        f"sequential: p50 {np.percentile(lat, 50):.3f} ms, p95 "
        f"{np.percentile(lat, 95):.3f} ms; /fullrender?stream=1 "
        f"{VIEWER_FULL}^2 in {BANDS} bands (one launch) with a PNG per band: "
        f"{full_ms:.1f} ms; /skybox 6 x {VIEWER_FACE}^2: {sky_ms:.1f} ms")

    # --- each route's kernel against its plain version ----------------------
    # on the card, on the inputs the route gave its kernel and the output the
    # kernel gave the route: /render's page (LOD 4), the middle band of the
    # 512^2 /fullrender's progressive launch (its plain version over those
    # rows) and the six /skybox faces; a few rays may take one
    # more or fewer march step (f32 ulps at the exit test), so the gate is
    # the whole-frame one of the 512^2 checks
    def held(label, scene, out, plain_fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        err = float((out - plain).abs().max())
        c = scene.config
        mx, frac, mean_d = lsb_diff(*(post_process(
            x.cpu(), np.float32(c.exposure), np.float32(c.gamma),
            np.float32(c.saturation)).numpy() for x in (out, plain)))
        log(f"viewer {label} kernel vs plain on the card: linear max_abs_err "
            f"{err:.3g}, uint8 max {mx} LSB, {frac:.5f} of pixels differ, "
            f"mean {mean_d:.4f} LSB (limits: < 0.01 differ, mean < 0.05); "
            f"plain {plain_ms:.1f} ms")
        check(bool(torch.isfinite(out).all()) and frac < 0.01
              and mean_d < 0.05,
              f"viewer {label} kernel vs plain: {frac:.4f} differ, mean "
              f"{mean_d}, max_abs_err {err}")
        return err

    seen = {r: len(taken.get(r, ())) for r in ("/render", "/fullrender",
                                                "/skybox")}
    check(seen == {"/render": 1, "/fullrender": 1, "/skybox": 1},
          f"march launches seen per route: {seen}")
    (pages, table, size, _), out = taken["/render"][0]
    held(f"/render {VIEWER_SIZE}^2 LOD {VIEWER_LOD} (march)", view_scene,
         out[0], lambda: cr.march_plain(pages[0], table, size))
    (page, table, size, rows, n_bands), launch = taken["/fullrender"][0]
    row0 = n_bands // 2 * rows
    full_err = held(f"/fullrender {VIEWER_FULL}^2 band rows {row0}-"
                    f"{row0 + rows - 1} (march_progressive)", full_scene,
                    launch.bands(n_bands // 2, 1),
                    lambda: cr.march_band_plain(page, table, size, rows,
                                                row0))
    (pages, table, size, _), out = taken["/skybox"][0]
    held(f"/skybox {len(pages)} x {VIEWER_FACE}^2 (march_batch)", sky_scene,
         out, lambda: cr.march_batch_plain(pages, table, size))
    taken.clear()

    # --- the dry run on entries of the card, and the entry step -----------
    ticks = dryrun.dryrun_multichip(DRYRUN_ENTRIES, budget_s=DRYRUN_BUDGET_S,
                                    devices=[dev] * DRYRUN_ENTRIES)
    check(len(ticks) == 8, f"dry run rungs: {list(ticks)}")
    prev, per = 0.0, []
    for rung, at in ticks.items():
        per.append(f"{rung.split(':')[0]} {at - prev:.2f}")
        prev = at
    log(f"timing [{card}] dryrun_multichip({DRYRUN_ENTRIES}) on "
        f"{DRYRUN_ENTRIES} entries of one card (host clock, s per rung): "
        f"{', '.join(per)}; {prev:.1f} s in all")
    fn, args = dryrun.entry(device=dev)
    (step, _lin), step_ms = _timed(lambda: fn(*args))
    kernel = cr.render_scene(dryrun._spiral_scene(dryrun.ENTRY_SIZE),
                             device=dev)
    d = int(np.abs(step.cpu().numpy().astype(np.int16)
                   - kernel.astype(np.int16)).max())
    check(d <= XLA_MAX_LSB, f"entry step {d} LSB from the kernel's frame")
    log(f"entry(): the XLA-form step at {dryrun.ENTRY_SIZE}^2 "
        f"({dryrun.spiral_galaxy()[1]}) {step_ms:.1f} ms (host clock), max "
        f"{d} LSB from the kernel's frame (limit {XLA_MAX_LSB})")

    # --- profile_trace around a still, RenderStats over stills ------------
    # in this process first: after the fit phases' large CUDA-only sessions
    # torch.profiler may lose kernel records (here the march kernel's), and
    # profile_trace must then say so with a TraceLossWarning; a trace that
    # holds every launch's kernel must not warn
    scene = spiral_scene(MAIN_SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", TraceLossWarning)
            with profile_trace(tmp, device=dev):
                cr.render_scene(scene, device=dev)
        trace = json.loads((Path(tmp) / "trace.json").read_text())
    launches_k, kernels_k, lost_k = kernel_records(trace)
    named = [e["dur"] for e in trace["traceEvents"]
             if e.get("cat") == "kernel" and "march_kernel" in e["name"]]
    warned = [w for w in caught if issubclass(w.category, TraceLossWarning)]
    check(bool(warned) == bool(lost_k or not kernels_k),
          f"profile_trace: {lost_k} of {launches_k} launches lost their "
          f"kernel, {kernels_k} kernels, {len(warned)} warnings")
    check(len(named) == 1 or warned,
          f"the in-process trace names {len(named)} march kernels and "
          f"profile_trace did not warn")
    log(f"profile_trace in this process: "
        f"{launches_k} launch calls, {kernels_k} kernel records, {lost_k} "
        f"launches without their kernel; march kernel "
        f"{'recorded, %.4f ms' % (named[0] / 1e3) if named else 'lost'}; "
        f"TraceLossWarning {'raised' if warned else 'not raised'}")
    # then in a fresh process, as a user profiles, for the kernel's time
    child = subprocess.run(
        [sys.executable, "-c", PROFILE_CHILD, str(ROOT), str(MAIN_SIZE)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(child.returncode == 0, f"profile_trace child: {child.stderr[-2000:]}")
    kernels = [(name, dur) for name, dur in
               json.loads(child.stdout.strip().splitlines()[-1])
               if "march_kernel" in name]
    check(len(kernels) == 1, f"the trace names {len(kernels)} march kernels")
    prof_ms = kernels[0][1] / 1e3
    page, table, size, _ = cr.prepare(scene, dev)
    event_ms, _ = cuda_ms(lambda: cr.march(page, table, size), 5)
    log(f"timing [{card}] profile_trace around the {MAIN_SIZE}^2 still (a "
        f"fresh process): trace.json names {kernels[0][0]!r}, {prof_ms:.4f} "
        f"ms in the trace; the same launch by CUDA events here "
        f"{event_ms:.4f} ms (median of 5)")
    gold = load_oracle_golden()
    stats = RenderStats(samples_per_pixel=gold["samples"] / gold["pixels"])
    for _ in range(STATS_FRAMES):
        with stats.frame(MAIN_SIZE * MAIN_SIZE, device=dev):
            cr.render_scene(scene, device=dev, device_out=True)
    summary = stats.summary()
    check(summary["frames"] == STATS_FRAMES and summary["rays_per_sec"] > 0,
          f"RenderStats: {summary}")
    log(f"timing [{card}] RenderStats over {STATS_FRAMES} {MAIN_SIZE}^2 "
        f"stills (device_out, synchronized; {stats.samples_per_pixel:.1f} "
        f"samples per pixel from the oracle): {summary}")
    log(f"front-end phase: {time.perf_counter() - t_phase:.1f} s (host "
        f"clock)")
    return full_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import gamer_tpu_torch as gt
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine.render import pool_linear, post_process
    from gamer_tpu_torch.golden import load_oracle_golden, oracle_scene
    from gamer_tpu_torch.io.png import decode_png
    from gamer_tpu_torch.models import presets
    from gamer_tpu_torch.post.stars import (pad_star_rows, star_field_device,
                                            star_params)
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.scene.schema import ComponentParams, scene_to_dict
    from gamer_tpu_torch.ops import noise as tnoise

    wrappers = (cr.march, cr.march_band, cr.march_batch, cr.march_rays,
                cr.march_progressive, cr.march_rowshard,
                cr.march_batch_rowshard, cr.march_rays_rowshard,
                tnoise.noise_probe, tnoise.iq_hash_table)

    def reset_counts():
        for fn in wrappers:
            fn.launch_count = 0
        for kind in cr.KIND_LAUNCHES:
            cr.KIND_LAUNCHES[kind] = 0

    def read_counts():
        torch.cuda.synchronize()
        return {**{fn.__name__: fn.launch_count for fn in wrappers},
                **cr.KIND_LAUNCHES}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card} (torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]})")
    if "--profiler-loss" in sys.argv[1:]:
        # measurement: the profiler's lost kernel records, no kernel build
        sizes = [int(a) for a in sys.argv[2:]] or PROFILER_LOSS_SIZES
        ok = profiler_loss(card, sizes)
        check(ok, "profile_trace misreported a session")
        return 0

    report_build()
    f32 = np.float32
    if "--fit-only" in sys.argv[1:]:
        # development: the build report and the fit phases alone
        keep = {}
        fit_phases(card, dev, keep)
        fit_family_phases(card, dev, keep)
        mesh_fit_phases(card, dev, keep)
        xla_surface_phases(card, dev)
        return 0
    if "--frontend-only" in sys.argv[1:]:
        # development: the build report and the front-end phase alone
        frontend_phases(card, dev)
        return 0
    if "--production-only" in sys.argv[1:]:
        # development: the build report and the production-size phases
        ladder_phase(card, dev, oracle_512_phase())
        return 0

    # --- the kernel's noise device functions vs their plain versions -------
    # csrc/noise_probe.cu runs noise.cuh's raw/octave/ridged functions at
    # explicit points; the plain torch ops on the CPU do the same float32
    # operations in the same order, so equality is expected
    rng = np.random.default_rng(2)
    pts = rng.uniform(-40.0, 40.0, (1 << 18, 3)).astype(np.float32)
    pts[:64] = np.round(pts[:64])  # exact integers: the fastfloor edge
    probe_err = 0.0
    for octaves, pers, scale, n_sw in ((10, 0.6, 0.1, 9), (4, -2.0, 0.2, 4)):
        args = (octaves, pers, scale, tnoise.ridged_weights(1.5, n_sw),
                2.5, 1.0, 1.2)
        got = tnoise.noise_probe(torch.as_tensor(pts, device=dev), *args).cpu()
        want = tnoise.noise_probe(torch.as_tensor(pts), *args)
        err = (got - want).abs().amax(dim=0)
        exact = (got == want).float().mean(dim=0)
        log(f"noise probe vs plain ({octaves} octaves, persistence {pers}): "
            f"max |d| raw/octave/ridged {err.tolist()}, bit-equal share "
            f"{exact.tolist()} over {len(pts)} points")
        check(float(err.max()) <= 1e-6, f"noise probe disagrees: {err.tolist()}")
        probe_err = max(probe_err, float(err.max()))
    # the probe kernel timed at these points (simplex), and its bound: per
    # point 1 + octaves + ridged octaves raw evaluations, the octave sum ~8
    # f32 ops an octave and the ridged one ~12, 12 B read and 12 B written
    pts_d = torch.as_tensor(pts, device=dev)
    args = (10, 0.6, 0.1, tnoise.ridged_weights(1.5, 9), 2.5, 1.0, 1.2)
    probe_ms, _ = cuda_ms(lambda: tnoise.noise_probe(pts_d, *args), 5)
    _, probe_plain_ms = _timed(lambda: tnoise.noise_probe_plain(pts_d,
                                                                *args))
    n_pts = len(pts)
    probe_ops = n_pts * ((1 + 10 + 9) * RAW_NOISE_WORK["simplex"][0]
                         + 10 * 8 + 9 * 12)
    probe_bytes = n_pts * 24 + tnoise.noise_table("simplex", dev).numel() * 4
    t_ops, t_bytes = probe_ops / F32_PEAK, probe_bytes / HBM_PEAK
    probe_bound = (max(t_ops, t_bytes) * 1e3,
                   "operations" if t_ops >= t_bytes else "bytes")
    log(f"timing [{card}] noise_probe kernel, {n_pts} points (10 octaves, 9 "
        f"ridged; CUDA events, median of 5): {probe_ms:.4f} ms, plain on "
        f"cuda {probe_plain_ms:.1f} ms; bound {max(t_ops, t_bytes) * 1e3:.4f}"
        f" ms by {'operations' if t_ops >= t_bytes else 'bytes'} "
        f"({probe_ops:.4g} f32 ops -> {t_ops * 1e3:.4f} ms, {probe_bytes} B "
        f"-> {t_bytes * 1e3:.5f} ms)")
    # the other raw backends on the same points: perlin is integer lattice
    # work and lerps in one order, so bit-equal; iq's hash amplifies the
    # last ulps of the sine (the card's sinf against torch's CPU sine), so
    # its raw values are held to >= 99 % within 2e-3 and a mean below 1e-3
    args = (10, 0.6, 0.1, tnoise.ridged_weights(1.5, 9), 2.5, 1.0, 1.2)
    for kind in ("perlin", "iq"):
        got = tnoise.noise_probe(torch.as_tensor(pts, device=dev), *args,
                                 kind).cpu()
        want = tnoise.noise_probe(torch.as_tensor(pts), *args, kind)
        d = (got - want).abs()
        exact = (got == want).float().mean(dim=0)
        log(f"noise probe vs plain [{kind}]: max |d| raw/octave/ridged "
            f"{d.amax(dim=0).tolist()}, mean |d| {d.mean(dim=0).tolist()}, "
            f"bit-equal share {exact.tolist()} over {len(pts)} points")
        if kind == "perlin":
            check(float(d.max()) == 0.0, f"perlin probe is not bit-equal: "
                                         f"{d.amax(dim=0).tolist()}")
        else:
            near = float((d[:, 0] <= 2e-3).float().mean())
            on_card = tnoise.noise_probe_plain(
                torch.as_tensor(pts, device=dev), *args, kind).cpu()
            log(f"noise probe [iq]: {near:.5f} of raw values within 2e-3 of "
                f"the CPU's (limit 0.99), mean {float(d[:, 0].mean()):.3g} "
                f"(limit 1e-3); against the torch ops on the card: max |d| "
                f"{(got - on_card).abs().amax(dim=0).tolist()}")
            check(near >= 0.99 and float(d[:, 0].mean()) < 1e-3,
                  f"iq probe: {near} within 2e-3, mean {float(d[:, 0].mean())}")

    def post_cpu(lin, scene):
        c = scene.config
        return post_process(lin.cpu(), f32(c.exposure), f32(c.gamma),
                            f32(c.saturation)).numpy()

    # --- kernel vs plain (CPU) at 64^2 --------------------------------------
    cases = {
        "spiral": spiral_scene(64),
        "dusty_disk": spiral_scene(64, presets.dusty_disk()),
        "flocculent": spiral_scene(64, presets.flocculent()),
        "ring": spiral_scene(64, presets.ring()),
        "two_instance": two_instance_scene(64),
    }
    for name, scene in cases.items():
        page, table, size, _ = cr.prepare(scene, "cpu")
        lin_k = cr.march(page.to(dev), table.to(dev), size)
        torch.cuda.synchronize()
        lin_p = cr.march_plain(page, table, size)
        check(bool(torch.isfinite(lin_k).all()), f"{name}: non-finite kernel output")
        mx, frac, _ = lsb_diff(post_cpu(lin_k, scene), post_cpu(lin_p, scene))
        err = float((lin_k.cpu() - lin_p).abs().max())
        log(f"kernel vs plain {name} 64^2: max {mx} LSB, {frac:.4f} of pixels "
            f"differ, linear max_abs_err {err:.3g}")
        check(mx <= 2, f"{name}: kernel vs plain {mx} LSB > 2")

    # --- kernel vs spec oracle at 48^2 --------------------------------------
    # the oracle's frame is stored (gamer_tpu_torch/golden.py); the CPU tests
    # hold the file to a fresh oracle run
    gold = load_oracle_golden()
    samples_per_px = gold["samples"] / gold["pixels"]
    ours = gt.render_scene(oracle_scene("spiral", 48), device="cuda")
    mx, frac, _ = lsb_diff(ours, gold["image"])
    log(f"kernel vs oracle spiral 48^2: max {mx} LSB, {frac:.4f} of pixels "
        f"differ (stored oracle frame, {samples_per_px:.1f} samples/px)")
    check(mx <= 3 and frac < 0.05, f"kernel vs oracle: {mx} LSB, {frac:.3f}")

    # --- production size: every preset against the oracle at 512^2, and the
    # spiral above 512^2 (the ladder to 4096^2, its progressive frame) ------
    ladder_phase(card, dev, oracle_512_phase())

    # --- statistical phases: hash-driven pixels ----------------------------
    sg = presets.spiral()
    sg.components.append(ComponentParams(
        class_name="stars small", spectrum="White", name="sparkle",
        strength=400.0, r0=0.5, z0=0.05, arm=0.1, winding=1.0, scale=40.0,
        noise_tilt=1.0))
    for name, scene in (("dither", spiral_scene(64, dither=True)),
                        ("stars_small", spiral_scene(64, sg,
                                                     deterministic=False))):
        k = gt.render_scene(scene, device="cuda").astype(np.int64)
        p = gt.render_scene(scene, device="cpu").astype(np.int64)
        ratio = float(k.sum()) / float(p.sum())
        mean_d = float(np.abs(k - p).mean())
        log(f"statistical {name} 64^2: sum ratio {ratio:.4f}, mean |d| "
            f"{mean_d:.3f} LSB")
        check(p.sum() > 0 and abs(ratio - 1.0) < 0.1 and mean_d < 10.0,
              f"{name}: ratio {ratio}, mean |d| {mean_d}")

    # --- epilogue phases at 256^2: the card's pooling / stars / post chain
    # against the same steps on the CPU, from the same kernel radiance
    for name, scene in (("supersample=2", spiral_scene(256, supersample=2)),
                        ("no_stars=200", spiral_scene(256, no_stars=200,
                                                      star_size=3.0,
                                                      star_seed=7))):
        c = scene.config
        img = gt.render_scene(scene, device="cuda")
        page, table, size, ss = cr.prepare(scene, dev)
        lin = pool_linear(cr.march(page, table, size).cpu(), ss)
        if c.no_stars:
            sp = pad_star_rows(star_params(c.size, c.no_stars, c.star_size,
                                           c.star_size_spread,
                                           c.star_strength, c.star_seed))
            check(int((sp[:, 2] > 0).sum()) > 0, "no stars drawn")
            lin = lin + star_field_device(sp, c.size)
        mx, frac, _ = lsb_diff(img, post_cpu(lin, scene))
        log(f"epilogue {name} 256^2: max {mx} LSB, {frac:.4f} of pixels differ")
        check(img.shape == (256, 256, 3) and mx <= 2, f"{name}: {mx} LSB")

    # --- the CLI ------------------------------------------------------------
    cli_scene = spiral_scene(128)
    with tempfile.TemporaryDirectory() as tmp:
        sj = Path(tmp) / "scene.json"
        sj.write_text(json.dumps(scene_to_dict(cli_scene)))
        png = Path(tmp) / "out.png"
        r = subprocess.run([sys.executable, "-m", "gamer_tpu_torch.cli",
                            "render", str(sj), str(png)], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"CLI failed:\n{r.stdout}\n{r.stderr}")
        decoded = decode_png(png.read_bytes())
    lib_img = gt.render_scene(cli_scene, device="cuda")
    check(np.array_equal(decoded, lib_img), "CLI PNG differs from the library frame")
    log(f"cli render 128^2: PNG decodes to the library frame "
        f"({r.stdout.strip().splitlines()[0]})")

    # --- the main path: one 512^2 spiral frame ------------------------------
    main_scene = spiral_scene(MAIN_SIZE)
    gt.render_scene(main_scene, device="cuda")  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    frame = gt.render_scene(main_scene, device="cuda")
    wall_ms = (time.perf_counter() - t) * 1e3
    main_counts = read_counts()
    launches = main_counts["march"]
    check(launches >= 1, "the main path launched no march kernel")
    # the noise probe is a check of the device functions, not a kernel of
    # any path: the main path must not launch it
    check(main_counts["noise_probe"] == 0,
          f"the main path launched noise_probe {main_counts['noise_probe']} "
          f"time(s)")
    check(frame.shape == (MAIN_SIZE, MAIN_SIZE, 3) and frame.dtype == np.uint8,
          f"main frame has shape {frame.shape} {frame.dtype}")
    check(int(frame.sum()) > 0, "main frame is black")
    log(f"main path: render_scene(spiral {MAIN_SIZE}^2, device='cuda') "
        f"launched march {launches} time(s), noise_probe "
        f"{main_counts['noise_probe']}, {wall_ms:.1f} ms wall with "
        f"download, mean pixel {frame.mean():.2f}")

    frame_ms, _ = cuda_ms(lambda: gt.render_scene(main_scene, device="cuda",
                                                  device_out=True), 5)
    prep = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        page, table, size, _ = cr.prepare(main_scene, dev)
        torch.cuda.synchronize()
        prep.append((time.perf_counter() - t) * 1e3)
    prep_ms = float(np.median(prep))
    kern_ms, lin_k = cuda_ms(lambda: cr.march(page, table, size), 5)
    check(bool(torch.isfinite(lin_k).all()), "non-finite main-frame radiance")
    px = MAIN_SIZE * MAIN_SIZE
    msps = samples_per_px * px / (kern_ms * 1e-3) / 1e6
    frame_msps = samples_per_px * px / (frame_ms * 1e-3) / 1e6
    log(f"timing [{card}] spiral {MAIN_SIZE}^2 (median of 5): frame "
        f"{frame_ms:.3f} ms ({frame_msps:.1f} Msamples/s), march kernel "
        f"{kern_ms:.3f} ms ({msps:.1f} march Msamples/s), host prep + page "
        f"upload {prep_ms:.3f} ms (host clock)")

    # --- the plain version on the card ---------------------------------------
    half = MAIN_SIZE // 2
    ph, th, _, _ = cr.prepare(spiral_scene(half), dev)
    t = time.perf_counter()
    cr.march_plain(ph, th, half)
    torch.cuda.synchronize()
    t_half = time.perf_counter() - t
    plain_size = MAIN_SIZE if 4.0 * t_half <= PLAIN_BUDGET_S else half
    if plain_size == MAIN_SIZE:
        pp, tp = page, table
        k_ms = kern_ms
    else:
        pp, tp = ph, th
        k_ms, _ = cuda_ms(lambda: cr.march(ph, th, half), 5)
    # the plain version counts its work (the bound's counts) as it runs:
    # the counters change no output (tests/test_torch_plain_reuse.py)
    k1_stats = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    lin_p = cr.march_plain(pp, tp, plain_size, stats=k1_stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    lin_kp = cr.march(pp, tp, plain_size)
    max_abs = float((lin_kp - lin_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(lin_kp, main_scene),
                                post_cpu(lin_p, main_scene))
    log(f"timing [{card}] march_plain on cuda at {plain_size}^2: "
        f"{plain_ms:.1f} ms with its counters vs kernel {k_ms:.3f} ms; kernel "
        f"vs plain: linear "
        f"max_abs_err {max_abs:.3g}, uint8 max {mx} LSB, {frac:.5f} of "
        f"pixels differ, mean {mean_d:.4f} LSB")
    # at this size a few rays may take one more or fewer march step
    # (f32 ulps at the exit test), so the gate is on the whole frame
    check(frac < 0.01 and mean_d < 0.05,
          f"kernel vs plain at {plain_size}^2: {frac:.4f} differ, mean {mean_d}")

    k1_bound = march_bound(k1_stats, pp.numel() * 4 + tp.numel() * 4 + 2048,
                           plain_size * plain_size * 12)
    log(f"bound march {plain_size}^2: {k1_bound[0]:.4f} ms by {k1_bound[1]} "
        f"({k1_bound[2]}; {k1_stats})")

    # --- band and batch launches vs their plain versions (CPU) at 64^2 -----
    small = spiral_scene(64)
    page_s, table_s, size_s, _ = cr.prepare(small, "cpu")
    for rows, row0 in ((32, 0), (32, 32)):
        k = cr.march_band(page_s.to(dev), table_s.to(dev), size_s, rows, row0)
        torch.cuda.synchronize()
        p = cr.march_band_plain(page_s, table_s, size_s, rows, row0)
        mx, frac, _ = lsb_diff(post_cpu(k, small), post_cpu(p, small))
        log(f"march_band vs plain 64^2 rows {row0}-{row0 + rows - 1}: max "
            f"{mx} LSB, {frac:.4f} of pixels differ, linear max_abs_err "
            f"{float((k.cpu() - p).abs().max()):.3g}")
        check(mx <= 2, f"march_band vs plain: {mx} LSB > 2")
    small_orbit = [dataclasses.replace(small, camera=c)
                   for c in orbit_path(small.camera, 3, horizontal_deg=90.0)]
    groups = _scene_groups(small_orbit)
    check(len(groups) == 1, "a one-galaxy orbit is one structure group")
    st, pages_s, _ = groups[0]
    tab_s = torch.as_tensor(cr._build_table(st, cr._build_layout(st)))
    k = cr.march_batch(torch.as_tensor(pages_s, device=dev), tab_s.to(dev),
                       64)
    torch.cuda.synchronize()
    p = cr.march_batch_plain(torch.as_tensor(pages_s), tab_s, 64)
    for i in range(3):
        mx, frac, _ = lsb_diff(post_cpu(k[i], small), post_cpu(p[i], small))
        log(f"march_batch vs plain 64^2 frame {i}: max {mx} LSB, {frac:.4f} "
            f"of pixels differ, linear max_abs_err "
            f"{float((k[i].cpu() - p[i]).abs().max()):.3g}")
        check(mx <= 2, f"march_batch vs plain frame {i}: {mx} LSB > 2")
    # the progressive launch: the 64^2 frame in its 2 bands of 32 rows
    rows_s, n_s = cr.band_geometry(size_s, 1, BANDS)
    launch_s = cr.march_progressive(page_s.to(dev), table_s.to(dev), size_s,
                                    rows_s, n_s)
    launch_s.stop()
    k, flags_s = launch_s.out, launch_s.flags.tolist()
    p = cr.march_progressive_plain(page_s, table_s, size_s, rows_s, n_s)
    mx, frac, _ = lsb_diff(post_cpu(k, small), post_cpu(p, small))
    log(f"march_progressive vs plain 64^2 ({n_s} bands of {rows_s} rows): "
        f"max {mx} LSB, {frac:.4f} of pixels differ, linear max_abs_err "
        f"{float((k.cpu() - p).abs().max()):.3g}; band flags {flags_s}")
    check(mx <= 2 and flags_s == [1] * n_s,
          f"march_progressive vs plain: {mx} LSB, flags {flags_s}")

    # --- the band main path: the 512^2 frame in 16 row bands, one launch --
    band_rows, n_bands = cr.band_geometry(MAIN_SIZE, 1, BANDS)
    gt.render_progressive(main_scene, bands=BANDS, device="cuda")  # warm-up
    torch.cuda.synchronize()
    ticks = []
    reset_counts()
    t = time.perf_counter()
    prog = gt.render_progressive(main_scene, bands=BANDS, device="cuda",
                                 on_progress=lambda f, _: ticks.append(f))
    prog_wall_ms = (time.perf_counter() - t) * 1e3
    band_launches = read_counts()
    check(band_launches["march_progressive"] == 1
          and band_launches["march_band"] == 0
          and band_launches["march"] == 0,
          f"the band path launched {band_launches}")
    check(ticks == [(b + 1) / n_bands for b in range(n_bands)],
          f"progress ticks {ticks}")
    check(np.array_equal(prog, frame),
          "the banded 512^2 frame differs from the fused frame")
    log(f"band main path: render_progressive(spiral {MAIN_SIZE}^2, "
        f"bands={BANDS}, device='cuda') launched {band_launches}, "
        f"{prog_wall_ms:.1f} ms wall with download, {len(ticks)} ticks in "
        f"order; bit-equal to render_scene")
    # the ticks against the launch, on the host clock: without host work,
    # and with a viewer's PNG encode in every tick
    runs = [progressive_ticks(main_scene, BANDS) for _ in range(3)]
    runs.append(progressive_ticks(main_scene, BANDS,
                                  stall_ms=TICK_STALL_MS))
    for i, r in enumerate(runs):
        check(np.array_equal(r["img"], frame) and r["fracs"] == ticks,
              f"tick run {i}: frame or ticks {r['fracs']} differ")
        log(f"timing [{card}] render_progressive {MAIN_SIZE}^2 ticks (host "
            f"clock, ms after the call began"
            f"{f', {TICK_STALL_MS:g} ms of host work a tick' if i == 3 else ''}"
            f"): {[round(x, 3) for x in r['ticks_ms']]}; the launch from "
            f"{r['start_ms']:.3f} to {r['end_ms']:.3f} ms (CUDA events); "
            f"{sum(x < r['end_ms'] for x in r['ticks_ms'])} of {n_bands} "
            f"ticks before its end; wall {r['wall_ms']:.3f} ms")
        check(r["ticks_ms"][0] < r["end_ms"],
              f"tick run {i}: the first tick ({r['ticks_ms'][0]:.3f} ms) "
              f"came after the launch's end ({r['end_ms']:.3f} ms); host "
              f"phases {r['phases']}")
    first_tick_ms = float(np.median([r["ticks_ms"][0] for r in runs[:3]]))
    # abort at the first tick: band 0, black below, and the launch stopped
    # before it took every tile (its tile counter). At 512^2 the first tick
    # comes ~5 ms before the launch's end, with its last ~2,000 tiles still
    # untaken: a host delay of a few ms there lets the launch take them all,
    # so that count is read, and the tile gate runs at ABORT_SIZE, where
    # tens of ms of tiles are left when band 0 is done.
    n_tiles = cr.frame_tiles(MAIN_SIZE, n_bands * band_rows)
    ab = progressive_ticks(main_scene, BANDS, on_tick=lambda f: False)
    check(ab["fracs"] == [1 / n_bands]
          and np.array_equal(ab["img"][:band_rows], frame[:band_rows])
          and int(ab["img"][band_rows:].sum()) == 0,
          "abort after the first band: wrong rows")
    log_abort(ab, MAIN_SIZE, band_rows, n_bands, n_tiles)
    big_rows, big_bands = cr.band_geometry(ABORT_SIZE, 1, BANDS)
    big_tiles = cr.frame_tiles(ABORT_SIZE, big_bands * big_rows)
    big = spiral_scene(ABORT_SIZE)
    big_frame = gt.render_scene(big, device="cuda")
    check(np.array_equal(gt.render_progressive(big, bands=BANDS,
                                               device="cuda"), big_frame),
          f"the banded {ABORT_SIZE}^2 frame differs from the fused frame")
    ab = progressive_ticks(big, BANDS, on_tick=lambda f: False)
    check(ab["fracs"] == [1 / big_bands]
          and np.array_equal(ab["img"][:big_rows], big_frame[:big_rows])
          and int(ab["img"][big_rows:].sum()) == 0,
          f"abort after the first band at {ABORT_SIZE}^2: wrong rows")
    check(ab["tiles"][0] < big_tiles,
          f"the aborted {ABORT_SIZE}^2 launch took {ab['tiles'][0]} of "
          f"{big_tiles} tiles; ticks {ab['ticks_ms']}, the launch "
          f"{ab['start_ms']:.3f}-{ab['end_ms']:.3f} ms, host phases "
          f"{ab['phases']}")
    log_abort(ab, ABORT_SIZE, big_rows, big_bands, big_tiles)
    ss_scene = spiral_scene(256, supersample=2, no_stars=200, star_size=3.0,
                            star_seed=7)
    check(np.array_equal(gt.render_progressive(ss_scene, bands=BANDS,
                                               device="cuda"),
                         gt.render_scene(ss_scene, device="cuda")),
          "supersample=2 + stars: bands differ from the fused frame")
    log("band path: supersample=2 + 200 stars at 256^2 bit-equal to the "
        "fused frame")

    # --- the batch main path: an 8-frame orbit in one launch ---------------
    fly_cams = orbit_path(main_scene.camera, FLY_FRAMES, horizontal_deg=120.0)
    fly_scenes = [dataclasses.replace(main_scene, camera=c) for c in fly_cams]
    reset_counts()
    t = time.perf_counter()
    fly = gt.render_flythrough(main_scene, fly_cams, device="cuda")
    fly_wall_ms = (time.perf_counter() - t) * 1e3
    batch_launches = read_counts()
    check(batch_launches["march_batch"] == 1,
          f"the batch path launched {batch_launches}")
    check(fly.shape == (FLY_FRAMES, MAIN_SIZE, MAIN_SIZE, 3),
          f"fly-through shape {fly.shape}")
    for i, s in enumerate(fly_scenes):
        check(np.array_equal(fly[i], gt.render_scene(s, device="cuda")),
              f"fly-through frame {i} differs from its single render")
    on_card = gt.render_batch(fly_scenes[:2], device="cuda", device_out=True)
    check(on_card.device.type == "cuda"
          and np.array_equal(on_card.cpu().numpy(), fly[:2]),
          "render_batch(device_out=True) left the card or differs")
    log(f"batch main path: render_flythrough(spiral {MAIN_SIZE}^2, "
        f"{FLY_FRAMES} cameras, device='cuda') launched {batch_launches}, "
        f"{fly_wall_ms:.1f} ms wall with download; every frame bit-equal to "
        f"its render_scene")
    mixed = [spiral_scene(64), spiral_scene(64, presets.dusty_disk()),
             two_instance_scene(64)]
    before = cr.march_batch.launch_count
    mf = gt.render_batch(mixed, device="cuda")
    n_groups = len(_scene_groups(mixed))
    check(cr.march_batch.launch_count - before == n_groups == 3,
          "mixed batch: not one launch per structure group")
    for i, s in enumerate(mixed):
        check(np.array_equal(mf[i], gt.render_scene(s, device="cuda")),
              f"mixed batch frame {i} differs from its single render")
    log("mixed batch {spiral, dusty_disk, two_instance} 64^2: 3 launches, "
        "one per structure group, each frame bit-equal to its single render")

    # --- the CLI commands of the band and batch paths ----------------------
    from gamer_tpu_torch import cli
    from gamer_tpu_torch.engine.jobs import DatasetJob
    from gamer_tpu_torch.engine.queue import skybox_jobs
    from gamer_tpu_torch.io.renderparams import RenderParamsFile
    from gamer_tpu_torch.scene import gax

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gax.save(presets.spiral(), tmp / "spiral.gax")
        gax.save(presets.spiral(winding_n=6.0, winding_b=0.8),
                 tmp / "wound.gax")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        argv = ["galaxy", "omp", "0.5", "0", "0", "0", "0", "0", "0", "1",
                "0", "90", "1", "1", "1.0", "0.025", "spiral.gax", "128",
                "g.png"]
        r = subprocess.run([sys.executable, "-m", "gamer_tpu_torch.cli",
                            *argv], cwd=tmp, env=env, capture_output=True,
                           text=True, timeout=600)
        check(r.returncode == 0, f"CLI galaxy failed:\n{r.stdout}\n{r.stderr}")
        check(np.array_equal(decode_png((tmp / "g.png").read_bytes()),
                             gt.render_progressive(spiral_scene(128),
                                                   device="cuda")),
              "CLI galaxy PNG differs from render_progressive's frame")
        rp = RenderParamsFile(camera=gt.CameraParams(camera=(0.5, 0, 0)),
                              ray_step=0.025)
        rp.save(tmp / "rp.dat")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            check(cli.main(["skybox", "omp", "rp.dat", "spiral.gax",
                            "64"]) == 0, "CLI skybox failed")
            check(cli.main(["dataset", "spiral.gax", "2", "1", "64", "1",
                            "ds"]) == 0, "CLI dataset failed")
            check(cli.main(["flythrough", "spiral.gax", "3", "64",
                            "fly"]) == 0, "CLI flythrough failed")
            check(cli.main(["morph", "spiral.gax", "wound.gax", "2", "64",
                            "mo"]) == 0, "CLI morph failed")
        finally:
            os.chdir(cwd)
        # the animated GIFs beside the PNGs (io/gif.py, host numpy: its
        # frames, delays and loop are held to PIL's and gamer_tpu's on the
        # CPU, tests/test_torch_gif.py)
        for prefix in ("fly", "mo"):
            data = (tmp / f"{prefix}.gif").read_bytes()
            check(data[:6] == b"GIF89a" and data[-1:] == b";",
                  f"CLI {prefix}.gif is not a GIF89a file")
        faces = skybox_jobs(gt.Scene(
            camera=rp.camera,
            instances=[gt.GalaxyInstance(galaxy=presets.spiral())],
            config=rp.to_render_config(size=64)))
        for job in faces:
            img = decode_png((tmp / f"{job.filename}.png").read_bytes())
            check(np.array_equal(img, gt.render_scene(job.scene,
                                                      device="cuda")),
                  f"skybox face {job.filename} differs from its single render")
        ds_scenes = cli.dataset_scenes([str(tmp / "spiral.gax")], 2, 1, 64)
        calls = {"n": 0}

        def interrupt(c, dt):
            calls["n"] += 1
            if calls["n"] == 1:
                raise KeyboardInterrupt

        try:
            DatasetJob(ds_scenes, tmp / "ds2", chunk_size=1).run(interrupt)
        except KeyboardInterrupt:
            pass
        resumed = DatasetJob(ds_scenes, tmp / "ds2", chunk_size=1)
        check(resumed.remaining == [1] and resumed.run() == 1,
              "dataset resume did not render the one missing chunk")
        for c in range(2):
            name = f"chunk_{c:05d}.npy"
            check((tmp / "ds" / name).read_bytes()
                  == (tmp / "ds2" / name).read_bytes(),
                  f"resumed dataset {name} differs from the CLI's")
    log("cli galaxy 128^2 (19 tokens): PNG equals render_progressive's frame;"
        " skybox 64^2: six faces equal their single renders; dataset of 2 "
        "chunks: interrupted and resumed, bitwise equal to the CLI run; "
        "flythrough (3 frames) and morph (2) at 64^2: a GIF89a beside the "
        "PNGs")

    # --- timing of the band and batch launches at 512^2 ---------------------
    def band_sweep():  # the progressive frame's earlier form, for comparison
        for b in range(n_bands):
            cr.march_band(page, table, MAIN_SIZE, band_rows, b * band_rows)

    held = []  # each launch's words live until the launch has ended

    def progressive_launch():
        held.append(cr.march_progressive(page, table, MAIN_SIZE, band_rows,
                                         n_bands))
        return held[-1].out

    sweep_ms, _ = cuda_ms(band_sweep, 5)
    prog_k_ms, prog_lin = cuda_ms(progressive_launch, 5)
    check(all(x.flags.tolist() == [1] * n_bands for x in held),
          "a timed progressive launch left a band flag unset")
    held.clear()
    check(torch.equal(prog_lin[:MAIN_SIZE], lin_k),
          "the progressive launch's radiance differs from march's")
    st, fly_pages, _ = _scene_groups(fly_scenes)[0]
    fly_tab = torch.as_tensor(cr._build_table(st, cr._build_layout(st)),
                              device=dev)
    fly_pages_d = torch.as_tensor(fly_pages, device=dev)
    batch_ms, _ = cuda_ms(lambda: cr.march_batch(fly_pages_d, fly_tab,
                                                 MAIN_SIZE), 5)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gt.render_progressive(main_scene, bands=BANDS, device="cuda")
        walls.append((time.perf_counter() - t) * 1e3)
    prog_ms = float(np.median(walls))
    # the earlier form's first tick: band 0's own launch, its epilogue and
    # its download
    firsts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        post_process(cr.march_band(page, table, MAIN_SIZE, band_rows, 0),
                     f32(1.0), f32(1.0), f32(1.0)).cpu()
        firsts.append((time.perf_counter() - t) * 1e3)
    log(f"timing [{card}] {MAIN_SIZE}^2 spiral (median of 5): K1 march "
        f"{kern_ms:.3f} ms; the progressive launch (K5, {n_bands} bands) "
        f"{prog_k_ms:.3f} ms ({prog_k_ms / kern_ms:.3f} x K1), bit-equal to "
        f"K1's radiance; the earlier form, {n_bands} march_band launches "
        f"{sweep_ms:.3f} ms together ({sweep_ms / kern_ms:.3f} x K1); first "
        f"tick {first_tick_ms:.3f} ms after the call (host clock, median of "
        f"3) against the earlier form's band 0 with its epilogue and "
        f"download {float(np.median(firsts)):.3f} ms; march_batch of "
        f"{FLY_FRAMES} orbit frames {batch_ms:.3f} ms = {batch_ms / FLY_FRAMES:.3f}"
        f" ms per frame ({batch_ms / FLY_FRAMES / kern_ms:.3f} x K1); "
        f"render_progressive {prog_ms:.3f} ms wall with download (host clock)"
        f" vs render_scene frame {frame_ms:.3f} ms (CUDA events)")

    # one band (the middle one) and a 2-frame batch at 512^2: kernel vs plain
    mid = (n_bands // 2) * band_rows
    band_k_ms, band_k = cuda_ms(lambda: cr.march_band(
        page, table, MAIN_SIZE, band_rows, mid), 5)
    band_stats = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    band_p = cr.march_band_plain(page, table, MAIN_SIZE, band_rows, mid,
                                 stats=band_stats)
    torch.cuda.synchronize()
    band_plain_ms = (time.perf_counter() - t) * 1e3
    band_err = float((band_k - band_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(band_k, main_scene),
                                post_cpu(band_p, main_scene))
    check(frac < 0.01 and mean_d < 0.05,
          f"march_band vs plain at 512^2: {frac:.4f} differ, mean {mean_d}")
    band_bound = march_bound(band_stats, page.numel() * 4 + table.numel() * 4
                             + 2048, band_rows * MAIN_SIZE * 12)
    log(f"timing [{card}] march_band rows {mid}-{mid + band_rows - 1} of "
        f"{MAIN_SIZE}^2: kernel {band_k_ms:.3f} ms, plain on cuda "
        f"{band_plain_ms:.1f} ms with its counters; linear max_abs_err "
        f"{band_err:.3g}, uint8 "
        f"max {mx} LSB, {frac:.5f} of pixels differ; bound "
        f"{band_bound[0]:.4f} ms by {band_bound[1]} ({band_bound[2]}; "
        f"{band_stats})")

    two = fly_pages_d[:2].contiguous()
    batch_k_ms, batch_k = cuda_ms(lambda: cr.march_batch(two, fly_tab,
                                                         MAIN_SIZE), 5)
    batch_stats = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch_p = cr.march_batch_plain(two, fly_tab, MAIN_SIZE, stats=batch_stats)
    torch.cuda.synchronize()
    batch_plain_ms = (time.perf_counter() - t) * 1e3
    batch_err = float((batch_k - batch_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(batch_k, main_scene),
                                post_cpu(batch_p, main_scene))
    check(frac < 0.01 and mean_d < 0.05,
          f"march_batch vs plain at 512^2: {frac:.4f} differ, mean {mean_d}")
    batch_bound = march_bound(batch_stats, two.numel() * 4
                              + fly_tab.numel() * 4 + 2048,
                              2 * MAIN_SIZE * MAIN_SIZE * 12)
    log(f"timing [{card}] march_batch 2 frames of {MAIN_SIZE}^2: kernel "
        f"{batch_k_ms:.3f} ms, plain on cuda {batch_plain_ms:.1f} ms with "
        f"its counters; linear "
        f"max_abs_err {batch_err:.3g}, uint8 max {mx} LSB, {frac:.5f} of "
        f"pixels differ; bound {batch_bound[0]:.4f} ms by {batch_bound[1]} "
        f"({batch_bound[2]}; {batch_stats})")


    # =======================================================================
    # K6: the ray-list launch and the all-sky path
    # =======================================================================
    from gamer_tpu_torch.engine.allsky import allsky_dirs
    from gamer_tpu_torch.io.fits import write_fits_image
    from gamer_tpu_torch.ops.camera import ray_grid

    sky = allsky_scene()
    page_y, table_y, _, _ = cr.prepare(sky, "cpu")
    d32 = np.concatenate([allsky_dirs(32), np.zeros((1, 3), np.float32)])
    rays_k = cr.march_rays(page_y.to(dev), table_y.to(dev),
                           torch.as_tensor(d32, device=dev))
    torch.cuda.synchronize()
    rays_p = cr.march_rays_plain(page_y, table_y, torch.as_tensor(d32))
    check(bool(torch.isfinite(rays_k).all()), "non-finite ray-list radiance")
    check(float(rays_k[-1].abs().max()) == 0.0 and
          float(rays_p[-1].abs().max()) == 0.0,
          "the zero direction did not give radiance 0")
    mx, frac, _ = lsb_diff(post_cpu(rays_k, sky), post_cpu(rays_p, sky))
    log(f"march_rays vs plain nside 32 ({len(d32) - 1} rays + a zero "
        f"direction): max {mx} LSB, {frac:.4f} of rays differ, linear "
        f"max_abs_err {float((rays_k.cpu() - rays_p).abs().max()):.3g}; the "
        f"zero direction gives 0")
    check(mx <= 2, f"march_rays vs plain: {mx} LSB > 2")

    # the 512^2 still's own rays as a list: the same direction bits give the
    # frame's radiance
    grid = ray_grid(MAIN_SIZE, page[cr.G_INV_VP:cr.G_INV_VP + 16].cpu().numpy(),
                    0.0, device=dev, rows=MAIN_SIZE).reshape(-1, 3).contiguous()
    grid_ms, grid_lin = cuda_ms(lambda: cr.march_rays(page, table, grid), 5)
    grid_err = float((grid_lin.reshape(MAIN_SIZE, MAIN_SIZE, 3)
                      - lin_k).abs().max())
    log(f"march_rays on the {MAIN_SIZE}^2 still's ray_grid: bit-equal to "
        f"march's frame: {grid_err == 0.0} (max |d| {grid_err:.3g}); "
        f"{grid_ms:.3f} ms vs march {kern_ms:.3f} ms [{card}]")
    check(grid_err <= 1e-6 * float(lin_k.abs().max()),
          f"march_rays on the frame's rays differs by {grid_err}")

    # the map at nside 32 against the same pixels from the plain version
    map_k = gt.render_allsky_map(sky, 32, device="cuda")
    map_p = gt.render_allsky_map(sky, 32, device="cpu")
    map_rel = float(np.abs(map_k - map_p).max() / np.abs(map_p).max())
    log(f"render_allsky_map nside 32: card vs plain max |d| / max |m| "
        f"{map_rel:.3g} (limit 1e-3), non-zero share "
        f"{float((map_k > 0).mean()):.4f}")
    check(map_rel < 1e-3 and bool((map_k > 0).all()), "all-sky map nside 32")

    # --- the all-sky main path at full size --------------------------------
    n_sky = 12 * ALLSKY_NSIDE * ALLSKY_NSIDE
    reset_counts()
    t = time.perf_counter()
    sky_img = gt.render_allsky_image(sky, nside=ALLSKY_NSIDE, size=ALLSKY_SIZE,
                                     device="cuda")
    sky_wall_ms = (time.perf_counter() - t) * 1e3
    sky_launches = read_counts()
    check(sky_launches["march_rays"] == 1 and sky_launches["simplex"] == 1,
          f"the all-sky path launched {sky_launches}")
    check(sky_img.shape == (ALLSKY_SIZE, ALLSKY_SIZE, 3)
          and sky_img.dtype == np.uint8 and int(sky_img.sum()) > 0,
          f"all-sky image {sky_img.shape} {sky_img.dtype}")
    check(np.array_equal(sky_img[..., 0], sky_img[..., 1])
          and not sky_img[0, 0].any(), "all-sky image is not a gray ellipse")
    t = time.perf_counter()
    sky_dirs_np = allsky_dirs(ALLSKY_NSIDE)
    dirs_host_ms = (time.perf_counter() - t) * 1e3
    page_yd, table_yd = page_y.to(dev), cr.upload_table(table_y.numpy(), dev)
    sky_dirs = torch.as_tensor(sky_dirs_np, device=dev)
    check(sky_dirs.shape == (n_sky, 3), "all-sky ray count")
    sky_ms, sky_lin = cuda_ms(lambda: cr.march_rays(page_yd, table_yd,
                                                    sky_dirs), 5)
    check(bool(torch.isfinite(sky_lin).all()), "non-finite all-sky radiance")
    sky_nonzero = float((sky_lin.sum(dim=1) > 0).float().mean())
    log(f"all-sky main path: render_allsky_image(spiral, nside="
        f"{ALLSKY_NSIDE}, size={ALLSKY_SIZE}, device='cuda') launched "
        f"{sky_launches}, {sky_wall_ms:.1f} ms wall (host clock; "
        f"allsky_dirs alone {dirs_host_ms:.1f} ms on the host), mean pixel "
        f"{sky_img.mean():.2f}")
    log(f"timing [{card}] march_rays nside {ALLSKY_NSIDE} ({n_sky} rays, "
        f"median of 5): {sky_ms:.3f} ms = {n_sky / sky_ms / 1e3:.2f} Mrays/s"
        f" ({sky_ms / n_sky * MAIN_SIZE * MAIN_SIZE / kern_ms:.3f} x K1 per "
        f"ray); non-zero share of the map {sky_nonzero:.5f}")
    check(sky_nonzero == 1.0, "the camera is inside: every ray should hit")

    # the plain version on the card at the main path's ray count, if a
    # quarter-size trial says it fits the budget; else at nside 128
    d128 = torch.as_tensor(allsky_dirs(128), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cr.march_rays_plain(page_yd, table_yd, d128)
    torch.cuda.synchronize()
    t128 = time.perf_counter() - t
    full = 3.0 * t128 <= PLAIN_BUDGET_S
    sky_plain_dirs = sky_dirs if full else d128
    sky_k_ms = sky_ms if full else cuda_ms(
        lambda: cr.march_rays(page_yd, table_yd, d128), 5)[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    sky_stats = {}
    sky_p = cr.march_rays_plain(page_yd, table_yd, sky_plain_dirs,
                                stats=sky_stats)
    torch.cuda.synchronize()
    sky_plain_ms = (time.perf_counter() - t) * 1e3
    sky_k = sky_lin if full else cr.march_rays(page_yd, table_yd, d128)
    sky_err = float((sky_k - sky_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(sky_k, sky), post_cpu(sky_p, sky))
    n_plain = sky_plain_dirs.shape[0]
    sky_bound = march_bound(sky_stats, page_yd.numel() * 4
                            + table_yd.numel() * 4 + 2048 + n_plain * 12,
                            n_plain * 12)
    log(f"timing [{card}] march_rays_plain on cuda, {n_plain} rays (nside 128"
        f" trial {t128:.1f} s): {sky_plain_ms:.1f} ms with its counters vs "
        f"kernel {sky_k_ms:.3f} ms; linear max_abs_err {sky_err:.3g}, uint8 "
        f"max {mx} LSB, {frac:.5f} of rays differ, mean {mean_d:.4f} LSB; "
        f"bound {sky_bound[0]:.4f} ms by {sky_bound[1]} ({sky_bound[2]}; "
        f"{sky_stats})")
    check(frac < 0.01 and mean_d < 0.05,
          f"march_rays vs plain at {n_plain} rays: {frac:.4f} differ, "
          f"mean {mean_d}")

    # =======================================================================
    # K1-perlin and K1-iq: the other raw-noise backends
    # =======================================================================
    kind_rows = {}
    # the iq hash table (csrc/noise.cuh): every pair and the corners of
    # every integer in [-2R - 300, 2R + 300] against the kernels' own sinf
    bad, check_ms = iq_table_check(dev)
    check(bad["pairs"] == 0 and bad["corners"] == 0
          and bad["fallback"] == bad["fallback_expected"],
          f"the iq hash table check failed: {bad}")
    iq_table_bytes = tnoise.iq_hash_table(dev).numel() * 4
    log(f"iq hash table: R {tnoise.IQ_TABLE_R}, {tnoise.IQ_TABLE_PAIRS} pairs"
        f", {iq_table_bytes} B; exhaustive check {json.dumps(bad)} in "
        f"{check_ms:.3f} ms (CUDA events): every pair and every corner "
        f"bit-equal to the sines, the fallback taken past +-R")
    # the perlin gradient table (csrc/noise.cuh): every entry, and the
    # kernels' own gradient reads, against the gradient hash's decode
    grads_bad, grads_ms = perlin_grad_check(dev)
    check(grads_bad == {"entries": 0, "dots": 0},
          f"the perlin gradient table check failed: {grads_bad}")
    log(f"perlin gradient table: {tnoise.PERLIN_GRADS} float4 entries after "
        f"the paired permutation; check {json.dumps(grads_bad)} in "
        f"{grads_ms:.4f} ms (CUDA events): every entry and every staged "
        f"read of lattice indices 0-2047 bit-equal to the hash's decode")
    for kind in ("perlin", "iq"):
        # kernel vs plain (CPU) at 64^2; for iq the scene whose hash
        # arguments pass the table too, with the plain run's census
        small_cases = [spiral_scene(64, noise_kind=kind)]
        if kind == "iq":
            small_cases.append(iq_far_scene(64))
        for small_k in small_cases:
            pg, tb, sz, _ = cr.prepare(small_k, "cpu")
            a = cr.march(pg.to(dev), tb.to(dev), sz)
            torch.cuda.synchronize()
            with tnoise.iq_census() as census:
                b = cr.march_plain(pg, tb, sz)
            ia, ib = post_cpu(a, small_k), post_cpu(b, small_k)
            mx, frac, mean_d = lsb_diff(ia, ib)
            ok, within, _ = iq_gate(ia, ib)
            far = small_k is not small_cases[0]
            log(f"kernel vs plain [{kind}] spiral{' past the table' * far} "
                f"64^2: max {mx} LSB, {frac:.4f} of pixels differ, mean "
                f"{mean_d:.4f} LSB, {within:.4f} within 2 LSB, linear "
                f"max_abs_err {float((a.cpu() - b).abs().max()):.3g}"
                + (f"; iq hash arguments of the plain run {census}: "
                   f"{census['outside']} raw evaluations take the fallback"
                   if kind == "iq" else ""))
            check(mx <= 2 if kind == "perlin" else ok,
                  f"{kind}: kernel vs plain at 64^2: {mx} LSB, {within} "
                  f"within 2")
            if kind == "iq":
                check(census["non_integer"] == 0
                      and (census["outside"] > 0) == far,
                      f"iq hash arguments: {census}")

        # the still at 512^2 through render_scene; for iq from no table,
        # so that the run builds it
        scene_k = spiral_scene(MAIN_SIZE, noise_kind=kind)
        gt.render_scene(scene_k, device="cuda")  # warm-up
        if kind == "iq":
            tnoise._IQ_TABLES.clear()
        reset_counts()
        frame_k = gt.render_scene(scene_k, device="cuda")
        counts = read_counts()
        check(counts["march"] == 1 and counts[kind] == 1
              and counts["simplex"] == 0
              and counts["iq_hash_table"] == (kind == "iq"),
              f"the {kind} still launched {counts}")
        if kind == "iq":
            # the fill kernel against its plain version on the card
            table_iq = tnoise.iq_hash_table(dev)
            fill_ms = tnoise.iq_hash_table.build_ms[dev.index or 0]
            torch.cuda.synchronize()
            t = time.perf_counter()
            table_p = tnoise.iq_hash_table_plain(dev)
            torch.cuda.synchronize()
            fill_plain_ms = (time.perf_counter() - t) * 1e3
            d = (table_iq - table_p).abs()
            fill_err = float(d.max())
            fill_exact = float((table_iq.view(torch.int32)
                                == table_p.view(torch.int32)).float().mean())
            del table_p
            # bytes: the table written once; operations: per pair two
            # hashes of >= 10 f32 ops a sine and 3 more (mul, floor, sub)
            t_bytes = iq_table_bytes / HBM_PEAK
            t_ops = tnoise.IQ_TABLE_PAIRS * 2 * 13 / F32_PEAK
            fill_bound = (max(t_bytes, t_ops) * 1e3,
                          "bytes" if t_bytes >= t_ops else "operations")
            log(f"timing [{card}] iq hash table fill ({iq_table_bytes} B, "
                f"built by the iq still's run: {counts['iq_hash_table']} "
                f"launch): {fill_ms:.4f} ms (CUDA events), plain on cuda "
                f"{fill_plain_ms:.2f} ms (host clock); against the plain "
                f"version: max_abs_err {fill_err:.3g}, bit-equal share "
                f"{fill_exact:.7f}, mean |d| {float(d.mean()):.3g}; bound "
                f"{fill_bound[0]:.5f} ms by {fill_bound[1]}")
            check(fill_exact >= 0.99 and float(d.mean()) < 1e-3,
                  f"the iq table against torch's sine: {fill_exact} "
                  f"bit-equal, mean {float(d.mean())}")
            fill_row = (counts["iq_hash_table"], fill_err, fill_ms,
                        fill_plain_ms, fill_bound)
        check(frame_k.shape == frame.shape and int(frame_k.sum()) > 0
              and lsb_diff(frame_k, frame)[0] > 2,
              f"the {kind} still is black or is the simplex frame")
        pg_d, tb_d, _, _ = cr.prepare(scene_k, dev)
        ms_k, lin_kk = cuda_ms(lambda: cr.march(pg_d, tb_d, MAIN_SIZE), 5)
        check(bool(torch.isfinite(lin_kk).all()), f"non-finite {kind} radiance")
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats_k = {}
        lin_pp = cr.march_plain(pg_d, tb_d, MAIN_SIZE, stats=stats_k)
        torch.cuda.synchronize()
        plain_k_ms = (time.perf_counter() - t) * 1e3
        err_k = float((lin_kk - lin_pp).abs().max())
        ia, ib = post_cpu(lin_kk, scene_k), post_cpu(lin_pp, scene_k)
        mx, frac, mean_d = lsb_diff(ia, ib)
        ok, within, _ = iq_gate(ia, ib)
        in_bytes_k = (pg_d.numel() + tb_d.numel()
                      + tnoise.noise_table(kind, dev).numel()) * 4
        bound_k = march_bound(stats_k, in_bytes_k,
                              MAIN_SIZE * MAIN_SIZE * 12, kind)
        hashed_k = march_bound(stats_k, in_bytes_k,
                               MAIN_SIZE * MAIN_SIZE * 12, kind,
                               HASHED_NOISE_WORK[kind])
        log(f"timing [{card}] {kind} still {MAIN_SIZE}^2 (median of 5): march "
            f"kernel {ms_k:.3f} ms ({ms_k / kern_ms:.3f} x simplex "
            f"{kern_ms:.3f} ms), plain on cuda {plain_k_ms:.1f} ms with its "
            f"counters; kernel vs plain: linear max_abs_err {err_k:.3g}, "
            f"uint8 max {mx} LSB, {frac:.5f} of pixels differ, mean "
            f"{mean_d:.4f} LSB, {within:.5f} within 2 LSB; bound "
            f"{bound_k[0]:.4f} ms by {bound_k[1]} ({bound_k[2]}; {stats_k}); "
            f"counted with the hashes as before their table "
            f"{HASHED_NOISE_WORK[kind][0]} ops a raw evaluation: "
            f"{hashed_k[0]:.4f} ms, a share of {hashed_k[0] / ms_k:.4f}")
        check((frac < 0.01 and mean_d < 0.05) if kind == "perlin" else ok,
              f"{kind} kernel vs plain at {MAIN_SIZE}^2: {frac:.4f} differ, "
              f"mean {mean_d}, {within} within 2 LSB")
        kind_rows[kind] = (counts[kind], err_k, ms_k, plain_k_ms, bound_k)
        # the progressive frame of this kind: one launch, bit-equal to the
        # kind's still
        reset_counts()
        prog_k = gt.render_progressive(scene_k, bands=BANDS, device="cuda")
        counts = read_counts()
        check(counts["march_progressive"] == 1 and counts["march_band"] == 0
              and counts[kind] == 1 and counts["simplex"] == 0,
              f"the {kind} bands launched {counts}")
        check(np.array_equal(prog_k, frame_k),
              f"{kind} bands differ from the {kind} still")
        log(f"{kind} progressive frame {MAIN_SIZE}^2: one march_progressive "
            f"launch of {BANDS} bands, bit-equal to the {kind} still")
        # every launch form with the other kinds: a 2-frame batch and a ray
        # list
        reset_counts()
        fly_k = gt.render_flythrough(scene_k, fly_cams[:2], device="cuda")
        counts = read_counts()
        check(counts["march_batch"] == 1 and counts[kind] == 1
              and counts["simplex"] == 0,
              f"the {kind} batch launched {counts}")
        for i in range(2):
            check(np.array_equal(fly_k[i], gt.render_scene(
                dataclasses.replace(scene_k, camera=fly_cams[i]),
                device="cuda")),
                f"{kind} batch frame {i} differs from its still")
        sky_p32 = gt.render_dirs(allsky_scene(noise_kind=kind), d32[:768],
                                 device="cuda")
        check(np.isfinite(sky_p32).all() and (sky_p32.sum(1) > 0).all(),
              f"{kind} ray list")
        log(f"{kind} launch forms: a 2-frame batch bit-equal to the "
            f"{kind} still ({counts}); a {kind} ray list of 768 rays is "
            f"finite and non-zero")

    # --- the CLI commands of the all-sky path -------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gax.save(presets.spiral(), tmp / "spiral.gax")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        r = subprocess.run([sys.executable, "-m", "gamer_tpu_torch.cli",
                            "allsky", "spiral.gax", "64", "256", "sky.png"],
                           cwd=tmp, env=env, capture_output=True, text=True,
                           timeout=600)
        check(r.returncode == 0, f"CLI allsky failed:\n{r.stdout}\n{r.stderr}")
        check(np.array_equal(
            decode_png((tmp / "sky.png").read_bytes()),
            gt.render_allsky_image(spiral_scene(256), 64, 256, device="cuda")),
            "CLI allsky PNG differs from render_allsky_image's frame")
        hpx = gt.render_allsky_map(sky, 64, device="cuda")
        write_fits_image(tmp / "map.fits", hpx[None, :])
        r = subprocess.run([sys.executable, "-m", "gamer_tpu_torch.cli",
                            "renderhpx", "map.fits", "256", "hpx.png", "1.0",
                            "1.0", "1.0"], cwd=tmp, env=env,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 0,
              f"CLI renderhpx failed:\n{r.stdout}\n{r.stderr}")
        check(np.array_equal(
            decode_png((tmp / "hpx.png").read_bytes()),
            gt.render_allsky_image(sky, 64, 256, device="cuda")),
            "CLI renderhpx PNG differs from render_allsky_image's frame")
    log("cli allsky nside 64, 256^2: PNG equals render_allsky_image's frame; "
        "renderhpx on a FITS map from the port's writer: PNG equals the "
        "all-sky image of that map")


    # =======================================================================
    # S1-S3: the sharded launches, on a mesh that names this card n times
    # =======================================================================
    from gamer_tpu_torch.parallel import Mesh

    def card_mesh(n, *axes):
        return Mesh(["cuda:0"] * n, *axes)

    # S1 against its plain version (CPU) at 64^2: two 32-row slabs
    k = cr.march_rowshard(page_s.to(dev), table_s.to(dev), size_s,
                          card_mesh(2))
    torch.cuda.synchronize()
    p = cr.march_rowshard_plain(page_s, table_s, size_s, Mesh(["cpu"] * 2))
    mx, frac, _ = lsb_diff(post_cpu(k, small), post_cpu(p, small))
    log(f"march_rowshard vs plain 64^2 on 2 entries: max {mx} LSB, "
        f"{frac:.4f} of pixels differ, linear max_abs_err "
        f"{float((k.cpu() - p).abs().max()):.3g}")
    check(mx <= 2, f"march_rowshard vs plain: {mx} LSB > 2")

    # the S1 main path: the 512^2 still over 4 entries, then 1-3 entries,
    # a size that does not tile, and supersampling with stars
    mesh4 = card_mesh(MESH_ENTRIES)
    gt.render_scene(main_scene, mesh=mesh4)  # warm-up: makes the streams
    reset_counts()
    t = time.perf_counter()
    shard_frame = gt.render_scene(main_scene, mesh=mesh4)
    s1_wall_ms = (time.perf_counter() - t) * 1e3
    s1_launches = read_counts()
    check(s1_launches["march_rowshard"] == MESH_ENTRIES
          and s1_launches["march_band"] == MESH_ENTRIES
          and s1_launches["march"] == 0,
          f"the row-sharded still launched {s1_launches}")
    check(np.array_equal(shard_frame, frame),
          "the row-sharded 512^2 frame differs from the fused frame")
    for n in (1, 2, 3):
        before = cr.march_rowshard.launch_count
        got = gt.render_scene(main_scene, mesh=card_mesh(n))
        slabs = -(-MAIN_SIZE // cr.slab_rows(MAIN_SIZE, n))
        check(cr.march_rowshard.launch_count - before == slabs,
              f"{n} entries: not one launch per slab that owns rows")
        check(np.array_equal(got, frame),
              f"the frame over {n} entries differs from the fused frame")
    odd = spiral_scene(500)
    before = cr.march_rowshard.launch_count
    odd_sharded = gt.render_scene(odd, mesh=card_mesh(3))
    check(cr.march_rowshard.launch_count - before == 3
          and cr.slab_rows(500, 3) == 192,
          "size 500 on 3 entries: slabs of 192, 192 and 116 rows expected")
    check(np.array_equal(odd_sharded, gt.render_scene(odd, device="cuda")),
          "size 500 over 3 entries differs from the fused frame")
    many = card_mesh(8)
    before = cr.march_rowshard.launch_count
    check(np.array_equal(gt.render_scene(spiral_scene(100), mesh=many),
                         gt.render_scene(spiral_scene(100), device="cuda"))
          and cr.march_rowshard.launch_count - before == 4,
          "size 100 over 8 entries: 4 slabs of 32 rows own rows, 4 none")
    check(np.array_equal(gt.render_scene(ss_scene, mesh=mesh4),
                         gt.render_scene(ss_scene, device="cuda")),
          "supersample=2 + stars over 4 entries differs from the fused frame")
    log(f"S1 main path: render_scene(spiral {MAIN_SIZE}^2, mesh=4 x cuda:0) "
        f"launched {s1_launches}, {s1_wall_ms:.1f} ms wall with download; "
        f"bit-equal to render_scene on 1, 2, 3 and 4 entries, at size 500 on "
        f"3 (last slab clipped), at size 100 on 8 (four entries idle) and at "
        f"256^2 with supersample=2 and stars")

    s1_ms = {n: cuda_ms(lambda: cr.march_rowshard(
        page, table, MAIN_SIZE, card_mesh(n)), 5)[0] for n in (2, 4, 16)}
    kern2_ms, _ = cuda_ms(lambda: cr.march(page, table, MAIN_SIZE), 5)
    # the entry of the kernels' record: at the size K1's plain version and
    # bound were taken at (the main size, if the plain version fits)
    s1_k_ms, s1_k = cuda_ms(lambda: cr.march_rowshard(pp, tp, plain_size,
                                                      mesh4), 5)
    # S1's plain version is march_band_plain per slab, bit-equal to
    # march_plain on the same rays (tests/test_torch_plain_reuse.py): the
    # kernel is held against K1's plain run above, and its time cited
    s1_plain_ms = plain_ms
    s1_err = float((s1_k - lin_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(s1_k, main_scene),
                                post_cpu(lin_p, main_scene))
    check(frac < 0.01 and mean_d < 0.05,
          f"march_rowshard vs plain at {plain_size}^2: {frac:.4f} differ, "
          f"mean {mean_d}")
    check(bool((s1_k == lin_kp).all()),
          "march_rowshard's radiance differs from march's")
    log(f"timing [{card}] march_rowshard {MAIN_SIZE}^2 (median of 5, CUDA "
        f"events): 2 entries {s1_ms[2]:.3f} ms, 4 entries {s1_ms[4]:.3f} ms, "
        f"16 entries (the band path's 32-row slabs, on 16 "
        f"streams) {s1_ms[16]:.3f} ms; K1 march beside them {kern2_ms:.3f} ms "
        f"(earlier {kern_ms:.3f}), the 16 sequential bands {sweep_ms:.3f} ms; "
        f"at {plain_size}^2 over 4 entries: kernel {s1_k_ms:.3f} ms, plain "
        f"on cuda (K1's, unsharded) {s1_plain_ms:.1f} ms; kernel vs plain: "
        f"linear max_abs_err {s1_err:.3g}, uint8 max {mx} LSB, {frac:.5f} of "
        f"pixels differ; radiance bit-equal to march's")

    # S2: the orbit on a 4-entry batch mesh and on a 2 x 2 mesh
    small_pages = torch.as_tensor(pages_s[:2])
    for axes, cpu_mesh in (
            ((("batch",),), Mesh(["cpu"] * 2, ("batch",))),
            ((("batch", "rows"), (2, 2)),
             Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2)))):
        n = 2 if len(axes) == 1 else 4
        k = cr.march_batch_rowshard(small_pages.to(dev), tab_s.to(dev), 64,
                                    card_mesh(n, *axes))
        torch.cuda.synchronize()
        p = cr.march_batch_rowshard_plain(small_pages, tab_s, 64, cpu_mesh)
        mx = max(lsb_diff(post_cpu(k[i], small), post_cpu(p[i], small))[0]
                 for i in range(2))
        log(f"march_batch_rowshard vs plain 64^2, 2 frames on a "
            f"{'x'.join(map(str, cpu_mesh.shape))} mesh: max {mx} LSB, linear "
            f"max_abs_err {float((k.cpu() - p).abs().max()):.3g}")
        check(mx <= 2, f"march_batch_rowshard vs plain: {mx} LSB > 2")
    batch_mesh = card_mesh(MESH_ENTRIES, ("batch",))
    mesh2d = card_mesh(4, ("batch", "rows"), (2, 2))
    gt.render_flythrough(main_scene, fly_cams[:4], mesh=batch_mesh)  # warm-up
    reset_counts()
    t = time.perf_counter()
    fly_sharded = gt.render_flythrough(main_scene, fly_cams, mesh=batch_mesh)
    s2_wall_ms = (time.perf_counter() - t) * 1e3
    s2_launches = read_counts()
    check(s2_launches["march_batch_rowshard"] == MESH_ENTRIES
          and s2_launches["march_batch"] == MESH_ENTRIES,
          f"the batch-sharded orbit launched {s2_launches}")
    check(np.array_equal(fly_sharded, fly),
          "the batch-sharded orbit differs from render_batch's frames")
    reset_counts()
    fly_2d = gt.render_flythrough(main_scene, fly_cams, mesh=mesh2d)
    s2_launches_2d = read_counts()
    check(s2_launches_2d["march_batch_rowshard"] == 4
          and np.array_equal(fly_2d, fly),
          f"the orbit on a 2 x 2 mesh: {s2_launches_2d}, or frames differ")
    before = cr.march_batch_rowshard.launch_count
    three = gt.render_flythrough(main_scene, fly_cams[:3], mesh=batch_mesh)
    check(three.shape[0] == 3 and np.array_equal(three, fly[:3])
          and cr.march_batch_rowshard.launch_count - before == MESH_ENTRIES,
          "3 frames on 4 entries: one pad frame, sliced off, expected")
    log(f"S2 main path: render_flythrough(spiral {MAIN_SIZE}^2, {FLY_FRAMES} "
        f"cameras, mesh=4 x cuda:0 'batch') launched {s2_launches}, "
        f"{s2_wall_ms:.1f} ms wall with download; on a (2 batch x 2 rows) "
        f"mesh {s2_launches_2d['march_batch_rowshard']} launches; a 3-frame "
        f"group on 4 entries is padded by one frame; every frame bit-equal "
        f"to render_batch's")
    s2_ms_1d, _ = cuda_ms(lambda: cr.march_batch_rowshard(
        fly_pages_d, fly_tab, MAIN_SIZE, batch_mesh), 5)
    s2_ms_2d, _ = cuda_ms(lambda: cr.march_batch_rowshard(
        fly_pages_d, fly_tab, MAIN_SIZE, mesh2d), 5)
    batch2_ms, _ = cuda_ms(lambda: cr.march_batch(fly_pages_d, fly_tab,
                                                  MAIN_SIZE), 5)
    s2_k_ms, s2_k = cuda_ms(lambda: cr.march_batch_rowshard(
        two, fly_tab, MAIN_SIZE, mesh2d), 5)
    # against K4's plain run of the same 2 frames (S2's plain version, one
    # march_batch_plain per entry, is bit-equal to it)
    s2_plain_ms = batch_plain_ms
    s2_err = float((s2_k - batch_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(s2_k, main_scene),
                                post_cpu(batch_p, main_scene))
    check(frac < 0.01 and mean_d < 0.05 and bool((s2_k == batch_k).all()),
          f"march_batch_rowshard at 512^2: {frac:.4f} differ from plain, "
          f"mean {mean_d}, or radiance differs from march_batch's")
    log(f"timing [{card}] march_batch_rowshard, {FLY_FRAMES} orbit frames of "
        f"{MAIN_SIZE}^2 (median of 5, CUDA events): 4-entry batch mesh "
        f"{s2_ms_1d:.3f} ms, 2 x 2 mesh {s2_ms_2d:.3f} ms, K4 march_batch "
        f"beside them {batch2_ms:.3f} ms (earlier {batch_ms:.3f}); 2 frames "
        f"on the 2 x 2 mesh {s2_k_ms:.3f} ms, plain on cuda (K4's, "
        f"unsharded) {s2_plain_ms:.1f} ms, linear max_abs_err {s2_err:.3g}, uint8 max "
        f"{mx} LSB, {frac:.5f} of pixels differ; radiance bit-equal to "
        f"march_batch's")

    # S3: the sky in four blocks of rays
    d32_t = torch.as_tensor(d32)
    k = cr.march_rays_rowshard(page_y.to(dev), table_y.to(dev), d32_t.to(dev),
                               card_mesh(3))
    torch.cuda.synchronize()
    p = cr.march_rays_rowshard_plain(page_y, table_y, d32_t,
                                     Mesh(["cpu"] * 3))
    mx, frac, _ = lsb_diff(post_cpu(k, sky), post_cpu(p, sky))
    log(f"march_rays_rowshard vs plain nside 32 on 3 entries ({len(d32)} "
        f"rays, blocks of {-(-len(d32) // 3)}, the tail short): max {mx} "
        f"LSB, {frac:.4f} of rays differ, linear max_abs_err "
        f"{float((k.cpu() - p).abs().max()):.3g}")
    check(mx <= 2, f"march_rays_rowshard vs plain: {mx} LSB > 2")
    sky_map = gt.render_allsky_map(sky, ALLSKY_NSIDE, device="cuda")
    gt.render_allsky_map(sky, 64, mesh=mesh4)  # warm-up
    reset_counts()
    t = time.perf_counter()
    sky_map_sharded = gt.render_allsky_map(sky, ALLSKY_NSIDE, mesh=mesh4)
    s3_wall_ms = (time.perf_counter() - t) * 1e3
    s3_launches = read_counts()
    check(s3_launches["march_rays_rowshard"] == MESH_ENTRIES
          and s3_launches["march_rays"] == MESH_ENTRIES,
          f"the sharded all-sky map launched {s3_launches}")
    check(np.array_equal(sky_map_sharded, sky_map),
          "the sharded nside-512 map differs from the unsharded map")
    check(np.array_equal(
        gt.render_allsky_image(sky, 64, 256, mesh=card_mesh(3)),
        gt.render_allsky_image(sky, 64, 256, device="cuda")),
        "the sharded all-sky image differs from the unsharded one")
    s3_ms, s3_lin = cuda_ms(lambda: cr.march_rays_rowshard(
        page_yd, table_yd, sky_dirs, mesh4), 5)
    sky2_ms, _ = cuda_ms(lambda: cr.march_rays(page_yd, table_yd, sky_dirs), 5)
    check(bool((s3_lin == sky_lin).all()),
          "march_rays_rowshard's radiance differs from march_rays's")
    s3_k_ms = s3_ms if full else cuda_ms(lambda: cr.march_rays_rowshard(
        page_yd, table_yd, d128, mesh4), 5)[0]
    s3_k = s3_lin if full else cr.march_rays_rowshard(page_yd, table_yd, d128,
                                                      mesh4)
    # against K6's plain run of the same rays (S3's plain version, one
    # march_rays_plain per block, is bit-equal to it)
    s3_plain_ms = sky_plain_ms
    s3_err = float((s3_k - sky_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(s3_k, sky), post_cpu(sky_p, sky))
    del sky_p
    check(frac < 0.01 and mean_d < 0.05,
          f"march_rays_rowshard vs plain: {frac:.4f} differ, mean {mean_d}")
    pg_iq, tb_iq, _, _ = cr.prepare(allsky_scene(noise_kind="iq"), dev)
    rays_iq_ms, rays_iq = cuda_ms(lambda: cr.march_rays(pg_iq, tb_iq,
                                                        sky_dirs), 3)
    check(bool(torch.isfinite(rays_iq).all()) and float(rays_iq.sum()) > 0,
          "the iq ray list is not finite or is black")
    del rays_iq
    log(f"S3 main path: render_allsky_map(spiral, nside={ALLSKY_NSIDE}, "
        f"mesh=4 x cuda:0) launched {s3_launches}, {s3_wall_ms:.1f} ms wall "
        f"(host clock); bit-equal to the unsharded map")
    log(f"timing [{card}] march_rays_rowshard nside {ALLSKY_NSIDE} ({n_sky} "
        f"rays in 4 blocks, median of 5): {s3_ms:.3f} ms, K6 march_rays "
        f"beside it {sky2_ms:.3f} ms (earlier {sky_ms:.3f}); plain on cuda "
        f"(K6's, unsharded), {n_plain} rays {s3_plain_ms:.1f} ms vs kernel "
        f"{s3_k_ms:.3f} ms, linear max_abs_err {s3_err:.3g}, uint8 max {mx} "
        f"LSB, {frac:.5f} of rays differ; march_rays_kernel<iq> on the same "
        f"{n_sky} rays (median of 3): {rays_iq_ms:.3f} ms "
        f"({rays_iq_ms / sky2_ms:.3f} x simplex)")

    # =======================================================================
    # the render service: library surface, then HTTP
    # =======================================================================
    from gamer_tpu_torch.scene.morph import morph_scenes
    from gamer_tpu_torch.serve import (ABORTED, DONE, FAILED, RenderService,
                                       serve)

    def done(svc, jid):
        job = svc.wait(jid, timeout=SERVE_WAIT_S)
        check(job.state == DONE, f"job {jid} is {job.state}: {job.error}")
        return job

    serve_scene = spiral_scene(SERVE_SIZE)
    serve_orbit = [dataclasses.replace(serve_scene, camera=c)
                   for c in orbit_path(serve_scene.camera, 8,
                                       horizontal_deg=120.0)]
    serve_stills = [gt.render_scene(s, device="cuda") for s in serve_orbit]
    still_256 = gt.render_scene(serve_scene, device="cuda")

    # 8 concurrent requests -> one launch
    svc = RenderService(device="cuda", bands=BANDS, autostart=False)
    try:
        jids = [svc.submit(scene_to_dict(s)) for s in serve_orbit]
        reset_counts()
        svc.start()
        jobs = [done(svc, j) for j in jids]
        counts = read_counts()
        check(svc.metrics["batches"] == 1
              and svc.metrics["batched_frames"] == 8
              and svc.metrics["padded_frames"] == 0
              and counts["march_batch"] == 1 and counts["march"] == 0
              and all(j.batched for j in jobs),
              f"8 concurrent requests: {svc.metrics}, {counts}")
        for j, want in zip(jobs, serve_stills):
            check(np.array_equal(j.image, want),
                  f"served batch frame {j.id} differs from its render_scene")
        # a 256^2 single is one fused launch
        reset_counts()
        job = done(svc, svc.submit(serve_scene))
        counts = read_counts()
        check(svc.metrics["singles_fused"] == 1 and counts["march"] == 1
              and counts["march_band"] == 0 and not job.batched
              and np.array_equal(job.image, still_256),
              f"fused single: {svc.metrics}, {counts}")
        # a 512^2 single is progressive, with rising progress: the value
        # the job holds after each of the service's ticks, recorded in the
        # tick (a thread that polls the job sees as many as the host's
        # timing lets it; it is held only to an order)
        published = []
        render_progressive = cr.render_progressive

        def recording(scene, *args, on_progress, **kw):
            job = next(j for j in svc.jobs.values() if j.scene is scene)

            def tick(frac, partial):
                go = on_progress(frac, partial)
                published.append(job.progress)
                return go

            return render_progressive(scene, *args, on_progress=tick, **kw)

        n_bands = cr.band_geometry(MAIN_SIZE, main_scene.config.supersample,
                                   BANDS)[1]
        reset_counts()
        with unittest.mock.patch.object(cr, "render_progressive", recording):
            jid = svc.submit(main_scene)
            job, seen = svc.jobs[jid], []
            deadline = time.time() + SERVE_WAIT_S
            while job.state != DONE and time.time() < deadline:
                seen.append(job.progress)
                time.sleep(0.0005)
            job = done(svc, jid)
        counts = read_counts()
        steps = sorted(set(seen))
        check(counts["march_progressive"] == 1 and counts["march_band"] == 0
              and published == [(b + 1) / n_bands for b in range(n_bands)]
              and seen == sorted(seen)
              and np.array_equal(job.image, frame),
              f"progressive single: {counts}, progress values published "
              f"{published}, seen by a poller {steps}")
        log(f"service: 8 concurrent {SERVE_SIZE}^2 requests were 1 "
            f"march_batch launch, each image bit-equal to its render_scene; "
            f"a {SERVE_SIZE}^2 single 1 march launch; a {MAIN_SIZE}^2 single "
            f"1 march_progressive launch of {n_bands} bands, which published "
            f"{len(published)} rising progress values on the job ({len(steps)}"
            f" seen by a thread polling it), bit-equal to render_scene")
        # abort in mid-frame keeps the partial frame (1024^2: 16 bands of
        # 64 rows, long enough to be caught between two bands)
        big = spiral_scene(1024)
        big_frame = gt.render_scene(big, device="cuda")
        jid = svc.submit(big)
        job = svc.jobs[jid]
        deadline = time.time() + SERVE_WAIT_S
        while job.progress < 0.2 and time.time() < deadline:
            time.sleep(0.0005)
        svc.abort(jid)
        job = svc.wait(jid, timeout=SERVE_WAIT_S)
        rows = int(round(job.progress * 1024))
        check(job.state == ABORTED and 0 < rows < 1024
              and job.image is not None and int(job.image.sum()) > 0
              and np.array_equal(job.image[:rows], big_frame[:rows])
              and int(job.image[rows:].sum()) == 0,
              f"abort in mid-frame: {job.state}, progress {job.progress}")
        abort_progress = job.progress
        # preview-then-refine at 512^2
        jid = svc.submit(main_scene, preview=True)
        job = svc.wait(jid, timeout=SERVE_WAIT_S, until="preview")
        check(job.preview_ready and job.image is not None,
              "no preview frame")
        preview = job.image.copy()
        job = done(svc, jid)
        check(np.array_equal(job.image, frame)
              and lsb_diff(preview, frame)[0] > 2
              and svc.metrics["previews_rendered"] == 1,
              "preview-then-refine: the final frame is not render_scene's, "
              "or the preview is not a different frame")
        # animations, a warm job, another noise kind
        reset_counts()
        job = done(svc, svc.submit_flythrough(serve_scene, 8, 120.0))
        check(read_counts()["march_batch"] == 1
              and np.array_equal(job.frames, gt.render_flythrough(
                  serve_scene, orbit_path(serve_scene.camera, 8, 120.0),
                  device="cuda")), "served fly-through differs")
        target = presets.spiral(arm_tightness=0.5)
        job = done(svc, svc.submit_morph(serve_scene, target, 3))
        check(np.array_equal(job.frames, gt.render_batch(
            morph_scenes(serve_scene, target, 3), device="cuda"))
            and not np.array_equal(job.frames[0], job.frames[-1]),
            "served morph differs")
        job = done(svc, svc.submit_warm(serve_scene, buckets=(1, 2),
                                        sizes=[128, SERVE_SIZE]))
        check(sorted(job.result["warmed"]) == sorted(
            f"{s}px/{k}" for s in (128, SERVE_SIZE)
            for k in ("single", "batch1", "batch2")), f"warm: {job.result}")
        perlin_scene = spiral_scene(SERVE_SIZE, noise_kind="perlin")
        reset_counts()
        job = done(svc, svc.submit(scene_to_dict(perlin_scene)))
        check(read_counts()["perlin"] == 1 and np.array_equal(
            job.image, gt.render_scene(perlin_scene, device="cuda")),
            "served perlin request differs")
        # a job made to fail fails alone
        real_launch = cr._launch

        def boom(*a, **k):
            raise RuntimeError("launch made to fail")

        cr._launch = boom
        try:
            failed = svc.wait(svc.submit(serve_scene), timeout=SERVE_WAIT_S)
        finally:
            cr._launch = real_launch
        job = done(svc, svc.submit(serve_scene))
        check(failed.state == FAILED and "made to fail" in failed.error
              and np.array_equal(job.image, still_256) and svc.healthy()
              and svc.metrics["jobs_failed"] == 1,
              f"failure isolation: {failed.state}, {failed.error}")
        log(f"service: abort in mid-frame at 1024^2 kept a partial frame "
            f"(progress {abort_progress:.3f}); preview-then-refine at "
            f"{MAIN_SIZE}^2 published a different frame first and ended "
            f"bit-equal to render_scene; an 8-frame fly-through, a 3-frame "
            f"morph, a warm job of 6 shapes and a perlin request equal their "
            f"library renders; a job made to fail failed alone")
    finally:
        svc.stop()

    # a 5-request wave with max_batch=4 is two launches
    svc = RenderService(device="cuda", autostart=False, max_batch=4)
    try:
        jids = [svc.submit(s) for s in serve_orbit[:5]]
        reset_counts()
        svc.start()
        jobs = [done(svc, j) for j in jids]
        counts = read_counts()
        check(counts["march_batch"] == 1 and counts["march"] == 1
              and svc.metrics["batches"] == 1
              and svc.metrics["batched_frames"] == 4
              and svc.metrics["singles_fused"] == 1,
              f"max_batch=4 on 5 requests: {counts}, {svc.metrics}")
        for j, want in zip(jobs, serve_stills):
            check(np.array_equal(j.image, want), "capped wave: frame differs")
    finally:
        svc.stop()

    # the same single and batch over a mesh
    svc = RenderService(mesh=mesh4, autostart=False)
    try:
        jids = [svc.submit(s) for s in serve_orbit]
        reset_counts()
        svc.start()
        jobs = [done(svc, j) for j in jids]
        counts = read_counts()
        check(counts["march_batch_rowshard"] == MESH_ENTRIES
              and svc.metrics["padded_frames"] == 0
              and all(j.batched for j in jobs),
              f"mesh service batch: {counts}, {svc.metrics}")
        for j, want in zip(jobs, serve_stills):
            check(np.array_equal(j.image, want), "mesh service: frame differs")
        reset_counts()
        job = done(svc, svc.submit(main_scene))
        counts = read_counts()
        check(counts["march_rowshard"] == MESH_ENTRIES
              and np.array_equal(job.image, frame),
              f"mesh service single: {counts}")
        # three requests queued while the worker is down pad to four
        svc.stop()
        jids = [svc.submit(s) for s in serve_orbit[:3]]
        svc.start()
        jobs = [done(svc, j) for j in jids]
        check(svc.metrics["padded_frames"] == 1
              and all(np.array_equal(j.image, w)
                      for j, w in zip(jobs, serve_stills)),
              f"mesh service pad: {svc.metrics}")
        log(f"service over mesh=4 x cuda:0: 8 requests were "
            f"{MESH_ENTRIES} march_batch_rowshard launches, a {MAIN_SIZE}^2 "
            f"single {MESH_ENTRIES} march_rowshard launches, 3 requests "
            f"padded by one frame; a 5-request wave with max_batch=4 was a "
            f"launch of 4 and a single; all bit-equal to render_scene")
    finally:
        svc.stop()

    # the HTTP surface on a loopback port
    httpd = serve(port=0, poll=False, batch_window_s=0.0, bands=BANDS)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def http(path, data=None, method=None, expect=200):
        if data is not None:
            data = json.dumps(data).encode()
        req = urllib.request.Request(base + path, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
                status, body = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        check(status == expect, f"{method or 'GET'} {path}: {status} "
                                f"{body[:200]!r}, expected {expect}")
        return body

    try:
        health = json.loads(http("/healthz"))
        check(health == {"ok": True, "platform": "cuda",
                         "device": torch.cuda.get_device_name(0)},
              f"/healthz: {health}")
        jid = json.loads(http("/render", scene_to_dict(serve_scene),
                              expect=202))["job"]
        info = json.loads(http(f"/job/{jid}?wait=60"))
        check(info["state"] == "done" and info["size"] == SERVE_SIZE,
              f"long-poll: {info}")
        check(np.array_equal(decode_png(http(f"/job/{jid}/image.png")),
                             still_256),
              "the served PNG differs from the library frame")
        metrics = dict(
            line.rsplit(" ", 1) for line in
            http("/metrics").decode().splitlines() if not line.startswith("#"))
        check(float(metrics["gamer_frames_rendered"]) == 1
              and float(metrics["gamer_long_polls"]) == 1
              and float(metrics["gamer_request_seconds_count"]) == 1
              and float(metrics["gamer_healthy"]) == 1,
              f"/metrics: {metrics}")
        check("target image" in json.loads(http(
            "/fit", {"scene": scene_to_dict(serve_scene)},
            expect=400))["error"], "/fit without a target was not a 400")
        # DELETE aborts a job queued behind a long one
        long_id = json.loads(http("/render", scene_to_dict(spiral_scene(1024)),
                                  expect=202))["job"]
        queued_id = json.loads(http("/render", scene_to_dict(serve_scene),
                                    expect=202))["job"]
        gone = json.loads(http(f"/job/{queued_id}", method="DELETE"))
        check(gone["state"] == "aborted", f"DELETE of a queued job: {gone}")
        http(f"/job/{queued_id}/image.png", expect=409)
        check(json.loads(http(f"/job/{long_id}?wait=60"))["state"] == "done",
              "the long job did not finish")
        http("/job/999", expect=404)
        http("/render", {"instances": ["not a galaxy"]}, expect=400)
        log(f"http on {base}: /healthz names {health['device']}; POST "
            f"/render, long-poll and image.png give the library frame; "
            f"/metrics parses ({len(metrics)} samples); POST /fit without a "
            f"target answers 400; DELETE aborts a queued job; a bad payload "
            f"answers 400")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.stop()
        http_thread.join(SERVE_WAIT_S)
    check(not http_thread.is_alive(), "the HTTP thread did not stop")

    # --- request latency, submit -> done on the host clock -----------------
    def percentiles(jobs):
        lat = np.asarray([j.finished - j.submitted for j in jobs]) * 1e3
        return (f"p50 {np.percentile(lat, 50):.3f} ms, p95 "
                f"{np.percentile(lat, 95):.3f} ms, max {lat.max():.3f} ms")

    svc = RenderService(device="cuda")
    try:
        for _ in range(4):
            done(svc, svc.submit(serve_scene))  # warm-up
        t = time.perf_counter()
        jobs = [done(svc, svc.submit(serve_scene)) for _ in range(64)]
        wall = time.perf_counter() - t
    finally:
        svc.stop()
    log(f"timing [{card}] service latency, 64 sequential {SERVE_SIZE}^2 "
        f"singles (host clock, submit -> done): {percentiles(jobs)}; "
        f"{64 / wall:.2f} frames/s")

    def client_wave(svc):
        """8 client threads, each 8 requests one after another."""
        finished, errors = [], []

        def client(k):
            try:
                for i in range(8):
                    finished.append(done(svc, svc.submit(
                        serve_orbit[(k + i) % 8])))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_WAIT_S)
        wall = time.perf_counter() - t
        check(not errors and len(finished) == 64
              and not any(th.is_alive() for th in threads),
              f"client wave: {len(finished)} finished, errors {errors[:1]}")
        return finished, wall

    for window, pipeline in ((0.0, True), (0.05, True), (0.0, False),
                             (0.05, False)):
        svc = RenderService(device="cuda", batch_window_s=window,
                            pipeline=pipeline)
        try:
            client_wave(svc)  # warm-up
            before = dict(svc.metrics)
            jobs, wall = client_wave(svc)
            n_batches = svc.metrics["batches"] - before["batches"]
            singles = svc.metrics["singles_fused"] - before["singles_fused"]
            frames = svc.metrics["batched_frames"] - before["batched_frames"]
        finally:
            svc.stop()
        log(f"timing [{card}] service latency, 8 clients x 8 requests at "
            f"{SERVE_SIZE}^2, batch_window_s={window}, pipeline="
            f"{'on' if pipeline else 'off'} (host clock): "
            f"{percentiles(jobs)}; {64 / wall:.2f} frames/s; {n_batches} "
            f"batched launches of {frames / max(n_batches, 1):.2f} frames, "
            f"{singles} singles")
    left = [th.name for th in threading.enumerate()
            if th is not threading.main_thread()]
    check(not any(name.startswith("gamer-render") for name in left),
          f"service threads left behind: {left}")

    # =======================================================================
    # the fit path: fit_scene_fd (K4 probes), the autograd marches, CLI fit
    # =======================================================================
    keep = {}
    (fit_launches, fit_err, fit_k_ms, fit_plain_ms,
     fit_bound) = fit_phases(card, dev, keep)
    # the pose, batch, multi-view and joint fits (fit_pose_fd's probes: K4)
    (pfd_launches, pfd_err, pfd_k_ms, pfd_plain_ms,
     pfd_bound) = fit_family_phases(card, dev, keep)
    # the autograd fits on a mesh, beside the unsharded runs above
    mesh_fit_phases(card, dev, keep)
    # the XLA-form surfaces: the sharded frame, the sky, the queue, the CLI
    xla_surface_phases(card, dev)
    # the front end: the viewer, the dry run, the entry step, profiling
    full_err = frontend_phases(card, dev)

    for pkg in ("jax", "gamer_tpu"):
        check(pkg not in sys.modules, f"{pkg} was imported")

    def entry(name, replaces, launches, err, ms, plain, bound,
              source="gamer_tpu_torch/csrc/march.cu"):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    log(json.dumps({"kernels": [
        entry("march", "gamer_tpu/engine/pallas_render.py:1094", launches,
              max_abs, k_ms, plain_ms, k1_bound),
        # the progressive frame (render_progressive_pallas's bands of
        # _compiled_band) in one launch: at 512^2 its 16 bands of 32 rows
        # pad nothing, so its plain version is march_plain over K1's rays
        # (K1's plain time, at plain_size) and its bound K1's; its error is
        # the viewer's 512^2 launch in 16 bands against the plain version
        entry("march_progressive", "gamer_tpu/engine/pallas_render.py:1243",
              band_launches["march_progressive"], full_err, prog_k_ms,
              plain_ms, k1_bound),
        # a row band: S1's launch on each mesh entry (its main path)
        entry("march_band", "gamer_tpu/engine/pallas_render.py:1243",
              s1_launches["march_band"], band_err, band_k_ms,
              band_plain_ms, band_bound),
        entry("march_batch", "gamer_tpu/engine/pallas_render.py:1294",
              batch_launches["march_batch"], batch_err, batch_k_ms,
              batch_plain_ms, batch_bound),
        entry("march_rays", "gamer_tpu/engine/pallas_render.py:1324",
              sky_launches["march_rays"], sky_err, sky_k_ms, sky_plain_ms,
              sky_bound),
        entry("march[perlin]", "gamer_tpu/ops/pallas_noise.py:248",
              *kind_rows["perlin"], source="gamer_tpu_torch/csrc/noise.cuh"),
        entry("march[iq]", "gamer_tpu/ops/pallas_noise.py:294",
              *kind_rows["iq"], source="gamer_tpu_torch/csrc/noise.cuh"),
        # the iq hash table's fill, once per device: the first iq launch's
        # (its launches the iq still's run from no table)
        entry("iq_hash_table", "gamer_tpu/ops/pallas_noise.py:294",
              *fill_row),
        # the sharded launches: the same march.cu kernels, one launch per
        # mesh entry; the bound is the unsharded form's for the same rays
        entry("rowshard", "gamer_tpu/engine/pallas_render.py:1124",
              s1_launches["march_rowshard"], s1_err, s1_k_ms, s1_plain_ms,
              k1_bound),
        entry("batch_rowshard", "gamer_tpu/engine/pallas_render.py:1190",
              s2_launches["march_batch_rowshard"], s2_err, s2_k_ms,
              s2_plain_ms, batch_bound),
        entry("dirs_rowshard", "gamer_tpu/engine/pallas_render.py:1349",
              s3_launches["march_rays_rowshard"], s3_err, s3_k_ms,
              s3_plain_ms, sky_bound),
        # fit_scene_fd's probe sets: one march_batch launch per step
        entry("march_batch[fit_scene_fd]",
              "gamer_tpu/engine/pallas_render.py:1294", fit_launches,
              fit_err, fit_k_ms, fit_plain_ms, fit_bound),
        # fit_pose_fd's probe sets: one march_batch launch per step
        entry("march_batch[fit_pose_fd]",
              "gamer_tpu/engine/pallas_render.py:1294", pfd_launches,
              pfd_err, pfd_k_ms, pfd_plain_ms, pfd_bound),
        # the noise device functions at explicit points: a check, on no
        # main path (its launches are the main 512^2 path's count; the
        # noise phase above measured the rest)
        entry("noise_probe", "tests/test_pallas.py:55",
              main_counts["noise_probe"], probe_err,
              probe_ms, probe_plain_ms, probe_bound,
              source="gamer_tpu_torch/csrc/noise_probe.cu"),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
