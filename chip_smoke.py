"""Card smoke run for gamer_tpu_torch: builds the CUDA march kernel from
csrc/, drives the port's main path (one 512x512 still frame of the spiral
preset through ``gamer_tpu_torch.render_scene(device="cuda")``), and checks
the kernel against its plain torch version, the spec oracle and the CLI.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Prints one line per phase; the line before
the last is the card's name and power limit, the line before that the
kernels' JSON record, and the last line {"ok": true, "device": {...}}.
Any failed phase raises and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
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
    from gamer_tpu_torch.scene.schema import ComponentParams, scene_to_dict

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
        if "registers" in line or "spill" in line:
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
    cr.march.launch_count = 0
    t = time.perf_counter()
    frame = gt.render_scene(main_scene, device="cuda")
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = cr.march.launch_count
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

    for pkg in ("jax", "gamer_tpu"):
        check(pkg not in sys.modules, f"{pkg} was imported")
    log(json.dumps({"kernels": [{
        "name": "march",
        "route": "cuda",
        "source": "gamer_tpu_torch/csrc/march.cu",
        "replaces": "gamer_tpu/engine/pallas_render.py:1094",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": plain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
