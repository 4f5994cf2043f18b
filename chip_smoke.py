"""Card smoke run for gamer_tpu_torch: builds the CUDA march kernel from
csrc/ and drives the port's three main paths at 512x512 on the spiral
preset: one still frame (``render_scene``, K1), the same frame in 16 row
bands (``render_progressive``, K5) and an 8-frame orbit fly-through in one
batched launch (``render_flythrough``, K4). Each launch form is checked
against its plain torch version; the frames against each other (bands and
batch frames are bit-equal to the still frame), the spec oracle and the
CLI commands (``render``, ``galaxy``, ``skybox``, ``dataset``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Prints one line per phase; the line before
the last is the card's name and power limit, the line before that the
kernels' JSON record, and the last line {"ok": true, "device": {...}}.
Any failed phase raises and the script exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
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
    "samples": (35, 2),      # exit test, step, dott, radius, advance, floor
    "bulge": (58, 6),        # quat rotate, radius, pow, two sqrt, exp
    "triggers": (5, 1),      # |dott/z0| and the radial cutoff, per component
    "triggered": (14, 5),    # sech^2 and the intensity exp: the exact gates
    "gated": (18, 1),        # smoothstep, val, ival
    "arm_gated": (130, 13),  # two-arm pow ladder, atan2, winding
    "emitting": (40, 3),     # twirl (sin, cos, quat rotate), accumulate
    "raw_noise": (100, 0),   # one raw 3-D simplex: skew, 4 corners, gradients
}


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


def march_bound(stats: dict, in_bytes: int, out_bytes: int):
    """(bound ms, "bytes" or "operations", detail): the least time the card
    could take for the counted work, the larger of the operation bound (f32
    ops at the f32 peak, SFU ops at the SFU peak) and the byte bound (each
    input read once, each output written once, at the HBM rate)."""
    ops = sum(stats.get(k, 0) * w[0] for k, w in WORK.items())
    sfu = sum(stats.get(k, 0) * w[1] for k, w in WORK.items())
    t_ops, t_sfu = ops / F32_PEAK, sfu / SFU_PEAK
    t_bytes = (in_bytes + out_bytes) / HBM_PEAK
    t = max(t_ops, t_sfu, t_bytes)
    detail = (f"{ops:.4g} f32 ops -> {t_ops * 1e3:.4f} ms, {sfu:.4g} SFU ops "
              f"-> {t_sfu * 1e3:.4f} ms, {in_bytes + out_bytes} B -> "
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


def decode_png(data: bytes) -> np.ndarray:
    """Decode the CLI's 8-bit RGB PNG (filter type 0 rows)."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
            check(body[8:10] == b"\x08\x02", "PNG is not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), "unexpected PNG row filter")
    return raw[:, 1:].reshape(h, w, 3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import gamer_tpu_torch as gt
    from gamer_tpu_torch import kernels
    from gamer_tpu_torch.engine import cuda_render as cr
    from gamer_tpu_torch.engine.render import pool_linear, post_process
    from gamer_tpu_torch.golden import golden_scene, load_oracle_golden
    from gamer_tpu_torch.models import presets
    from gamer_tpu_torch.post.stars import (pad_star_rows, star_field_device,
                                            star_params)
    from gamer_tpu_torch.engine.batch import _scene_groups
    from gamer_tpu_torch.scene.cameracontrols import orbit_path
    from gamer_tpu_torch.scene.schema import ComponentParams, scene_to_dict

    wrappers = (cr.march, cr.march_band, cr.march_batch)

    def reset_counts():
        for fn in wrappers:
            fn.launch_count = 0

    def read_counts():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launch_count for fn in wrappers}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card} (torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]})")

    # --- toolchain and build ----------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    info = kernels.BUILD_INFO
    release = [ln for ln in info.get("nvcc", "").splitlines() if "release" in ln]
    log(f"nvcc: {kernels.nvcc_path()} | {(release or ['cached build'])[0]}")
    log(f"build: {info['path']} in {info['seconds']:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s, cached={info['cached']})")
    for line in info.get("log", "").splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"ptxas: {line.strip()}")

    f32 = np.float32

    # --- the kernel's noise device functions vs their plain versions -------
    # csrc/noise_probe.cu runs noise.cuh's raw/octave/ridged functions at
    # explicit points; the plain torch ops on the CPU do the same float32
    # operations in the same order, so equality is expected
    from gamer_tpu_torch.ops import noise as tnoise

    rng = np.random.default_rng(2)
    pts = rng.uniform(-40.0, 40.0, (1 << 18, 3)).astype(np.float32)
    pts[:64] = np.round(pts[:64])  # exact integers: the fastfloor edge
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
    ours = gt.render_scene(golden_scene(48), device="cuda")
    mx, frac, _ = lsb_diff(ours, gold["image"])
    log(f"kernel vs oracle spiral 48^2: max {mx} LSB, {frac:.4f} of pixels "
        f"differ (stored oracle frame, {samples_per_px:.1f} samples/px)")
    check(mx <= 3 and frac < 0.05, f"kernel vs oracle: {mx} LSB, {frac:.3f}")

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
    launches = read_counts()["march"]
    check(launches >= 1, "the main path launched no march kernel")
    check(frame.shape == (MAIN_SIZE, MAIN_SIZE, 3) and frame.dtype == np.uint8,
          f"main frame has shape {frame.shape} {frame.dtype}")
    check(int(frame.sum()) > 0, "main frame is black")
    log(f"main path: render_scene(spiral {MAIN_SIZE}^2, device='cuda') "
        f"launched march {launches} time(s), {wall_ms:.1f} ms wall with "
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
    torch.cuda.synchronize()
    t = time.perf_counter()
    lin_p = cr.march_plain(pp, tp, plain_size)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    lin_kp = cr.march(pp, tp, plain_size)
    max_abs = float((lin_kp - lin_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(lin_kp, main_scene),
                                post_cpu(lin_p, main_scene))
    log(f"timing [{card}] march_plain on cuda at {plain_size}^2: "
        f"{plain_ms:.1f} ms vs kernel {k_ms:.3f} ms; kernel vs plain: linear "
        f"max_abs_err {max_abs:.3g}, uint8 max {mx} LSB, {frac:.5f} of "
        f"pixels differ, mean {mean_d:.4f} LSB")
    # at this size a few rays may take one more or fewer march step
    # (f32 ulps at the exit test), so the gate is on the whole frame
    check(frac < 0.01 and mean_d < 0.05,
          f"kernel vs plain at {plain_size}^2: {frac:.4f} differ, mean {mean_d}")

    k1_stats = {}
    cr.march_plain(pp, tp, plain_size, stats=k1_stats)
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

    # --- the band main path: the 512^2 frame in 16 row bands ----------------
    gt.render_progressive(main_scene, bands=BANDS, device="cuda")  # warm-up
    torch.cuda.synchronize()
    ticks = []
    reset_counts()
    t = time.perf_counter()
    prog = gt.render_progressive(main_scene, bands=BANDS, device="cuda",
                                 on_progress=lambda f, _: ticks.append(f))
    prog_wall_ms = (time.perf_counter() - t) * 1e3
    band_launches = read_counts()
    check(band_launches["march_band"] == BANDS,
          f"the band path launched {band_launches}")
    check(ticks == sorted(ticks) and len(ticks) == BANDS and ticks[-1] == 1.0,
          f"progress ticks {ticks}")
    check(np.array_equal(prog, frame),
          "the banded 512^2 frame differs from the fused frame")
    log(f"band main path: render_progressive(spiral {MAIN_SIZE}^2, "
        f"bands={BANDS}, device='cuda') launched {band_launches}, "
        f"{prog_wall_ms:.1f} ms wall with download, {len(ticks)} ticks; "
        f"bit-equal to render_scene")
    aborted = gt.render_progressive(main_scene, bands=BANDS, device="cuda",
                                    on_progress=lambda f, _: False)
    band_rows = cr.band_geometry(MAIN_SIZE, 1, BANDS)[0]
    check(np.array_equal(aborted[:band_rows], frame[:band_rows])
          and int(aborted[band_rows:].sum()) == 0,
          "abort after the first band: wrong rows")
    ss_scene = spiral_scene(256, supersample=2, no_stars=200, star_size=3.0,
                            star_seed=7)
    check(np.array_equal(gt.render_progressive(ss_scene, bands=BANDS,
                                               device="cuda"),
                         gt.render_scene(ss_scene, device="cuda")),
          "supersample=2 + stars: bands differ from the fused frame")
    log(f"band path: abort after band 1 leaves rows {band_rows}- black; "
        f"supersample=2 + 200 stars at 256^2 bit-equal to the fused frame")

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
        finally:
            os.chdir(cwd)
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
        "chunks: interrupted and resumed, bitwise equal to the CLI run")

    # --- timing of the band and batch launches at 512^2 ---------------------
    n_bands = cr.band_geometry(MAIN_SIZE, 1, BANDS)[1]

    def band_sweep():
        for b in range(n_bands):
            cr.march_band(page, table, MAIN_SIZE, band_rows, b * band_rows)

    sweep_ms, _ = cuda_ms(band_sweep, 5)
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
    log(f"timing [{card}] {MAIN_SIZE}^2 spiral (median of 5): K1 march "
        f"{kern_ms:.3f} ms; {n_bands} march_band launches {sweep_ms:.3f} ms "
        f"together ({sweep_ms / kern_ms:.3f} x K1); march_batch of "
        f"{FLY_FRAMES} orbit frames {batch_ms:.3f} ms = {batch_ms / FLY_FRAMES:.3f}"
        f" ms per frame ({batch_ms / FLY_FRAMES / kern_ms:.3f} x K1); "
        f"render_progressive {prog_ms:.3f} ms wall with download (host clock)"
        f" vs render_scene frame {frame_ms:.3f} ms (CUDA events)")

    # one band (the middle one) and a 2-frame batch at 512^2: kernel vs plain
    mid = (n_bands // 2) * band_rows
    band_k_ms, band_k = cuda_ms(lambda: cr.march_band(
        page, table, MAIN_SIZE, band_rows, mid), 5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    band_p = cr.march_band_plain(page, table, MAIN_SIZE, band_rows, mid)
    torch.cuda.synchronize()
    band_plain_ms = (time.perf_counter() - t) * 1e3
    band_err = float((band_k - band_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(band_k, main_scene),
                                post_cpu(band_p, main_scene))
    check(frac < 0.01 and mean_d < 0.05,
          f"march_band vs plain at 512^2: {frac:.4f} differ, mean {mean_d}")
    band_stats = {}
    cr.march_band_plain(page, table, MAIN_SIZE, band_rows, mid,
                        stats=band_stats)
    band_bound = march_bound(band_stats, page.numel() * 4 + table.numel() * 4
                             + 2048, band_rows * MAIN_SIZE * 12)
    log(f"timing [{card}] march_band rows {mid}-{mid + band_rows - 1} of "
        f"{MAIN_SIZE}^2: kernel {band_k_ms:.3f} ms, plain on cuda "
        f"{band_plain_ms:.1f} ms; linear max_abs_err {band_err:.3g}, uint8 "
        f"max {mx} LSB, {frac:.5f} of pixels differ; bound "
        f"{band_bound[0]:.4f} ms by {band_bound[1]} ({band_bound[2]}; "
        f"{band_stats})")

    two = fly_pages_d[:2].contiguous()
    batch_k_ms, batch_k = cuda_ms(lambda: cr.march_batch(two, fly_tab,
                                                         MAIN_SIZE), 5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch_p = cr.march_batch_plain(two, fly_tab, MAIN_SIZE)
    torch.cuda.synchronize()
    batch_plain_ms = (time.perf_counter() - t) * 1e3
    batch_err = float((batch_k - batch_p).abs().max())
    mx, frac, mean_d = lsb_diff(post_cpu(batch_k, main_scene),
                                post_cpu(batch_p, main_scene))
    check(frac < 0.01 and mean_d < 0.05,
          f"march_batch vs plain at 512^2: {frac:.4f} differ, mean {mean_d}")
    batch_stats = {}
    cr.march_batch_plain(two, fly_tab, MAIN_SIZE, stats=batch_stats)
    batch_bound = march_bound(batch_stats, two.numel() * 4
                              + fly_tab.numel() * 4 + 2048,
                              2 * MAIN_SIZE * MAIN_SIZE * 12)
    log(f"timing [{card}] march_batch 2 frames of {MAIN_SIZE}^2: kernel "
        f"{batch_k_ms:.3f} ms, plain on cuda {batch_plain_ms:.1f} ms; linear "
        f"max_abs_err {batch_err:.3g}, uint8 max {mx} LSB, {frac:.5f} of "
        f"pixels differ; bound {batch_bound[0]:.4f} ms by {batch_bound[1]} "
        f"({batch_bound[2]}; {batch_stats})")

    for pkg in ("jax", "gamer_tpu"):
        check(pkg not in sys.modules, f"{pkg} was imported")

    def entry(name, replaces, launches, err, ms, plain, bound):
        return {"name": name, "route": "cuda",
                "source": "gamer_tpu_torch/csrc/march.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    log(json.dumps({"kernels": [
        entry("march", "gamer_tpu/engine/pallas_render.py:1094", launches,
              max_abs, k_ms, plain_ms, k1_bound),
        entry("march_band", "gamer_tpu/engine/pallas_render.py:1243",
              band_launches["march_band"], band_err, band_k_ms,
              band_plain_ms, band_bound),
        entry("march_batch", "gamer_tpu/engine/pallas_render.py:1294",
              batch_launches["march_batch"], batch_err, batch_k_ms,
              batch_plain_ms, batch_bound),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
