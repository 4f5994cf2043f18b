"""Headless CLI for the port: the reference's positional commands
(ConsoleRenderer parity, consolerenderer.cpp) with every method of
``gamer_tpu.cli`` (the kernel's bands, the XLA-form march, the oracle, the
sharded kernel), the JAX package's batch and fit commands (``fit``,
``fitpose``, ``fitjoint``) and its interactive editor (``viewer``).

  python -m gamer_tpu_torch.cli <command> <parameters> [--device cuda|cpu]

Every command renders on the card unless a trailing ``--device cpu`` asks
for the plain torch march. ``render`` with an outfile ending in .fits writes
one FITS image per channel of the linear radiance buffer (io/fits.py);
images are 8-bit RGB PNGs from a standard-library encoder (io/png.py).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

from .io.gif import write_gif
from .io.png import write_png
from .scene import gax
from .scene.schema import (
    CameraParams,
    GalaxyInstance,
    RenderConfig,
    Scene,
    galaxy_to_dict,
    scene_from_dict,
    scene_to_dict,
)
from .utils.timers import ScopedTimer, format_ms

USAGE = """Usage: python -m gamer_tpu_torch.cli [ command ] [ parameters ] [--device cuda|cpu]
Commands:
   galaxy <method> <camera x y z> <target x y z> <up x y z> <fov> <exposure>
          <gamma> <saturation> <ray step> <gax file> <size> <outfile>
   skybox <method> <RenderParams.dat> <gax file> <size>
   render <scene.json> <outfile>
   info <gax file>
   flythrough <gax file> <frames> <size> <outprefix>
   morph <gax A> <gax B> <frames> <size> <outprefix>
   scene <gax[,gax...]> <n> <box> <seed> <size> <outfile>
   dataset <gax[,gax...]> <n per gax> <seed> <size> <chunk> <out dir>
   allsky <gax file> <nside> <size> <outfile>
   renderhpx <fits file> <size> <outfile> <exposure> <gamma> <saturation>
   serve [port] [batch window s] [bands] [mesh] [maxbatch=N]
         [warm=<gax file>[:size,size...]]
   fit <camera x y z> <target x y z> <up x y z> <fov> <exposure> <gamma>
       <saturation> <ray step> <gax file> <target png> <out gax>
       [steps] [lr] [field,field,...] [march=tensor|scan|frozen|fd]
       [sweep=N] [ckpt=<file>] [multiscale]
   fitpose <camera x y z> <target x y z> <up x y z> <fov> <exposure> <gamma>
       <saturation> <ray step> <gax file> <target png> <out scene.json>
       [steps=80] [lr=0.01] [noise LOD=3 | multiscale | fd] [ckpt=<file>]
   fitjoint <camera x y z> <target x y z> <up x y z> <fov> <exposure> <gamma>
       <saturation> <ray step> <gax file> <target png> <out scene.json>
       [rounds=2] [posesteps=30] [scenesteps=60] [fields=strength,r0,z0]
       [ckpt=<file>] [march=frozen] [pose=multiscale|fd]  (an unknown camera
       AND unknown parameters: alternating pose and parameter blocks; also
       writes the fitted galaxy as <out>.gax)
   viewer [port=8000] [size=256] [gax dir]
<method>: omp | thread | pallas (the CUDA march kernel, in row bands)
          | xla (the XLA-form march, in 16 row chunks) | oracle (the numpy
          spec oracle, galaxy only) | sharded (the kernel's row slabs over
          every visible card, galaxy only)
"""

METHODS = ("omp", "thread", "pallas", "xla", "oracle", "sharded")


def _progress_printer(t0: float):
    state = {"prev": -1}

    def cb(frac: float, _img=None) -> None:
        cur = int(frac * 1000)
        if cur != state["prev"]:
            elapsed = (time.perf_counter() - t0) * 1000.0
            eta = elapsed / frac - elapsed if frac > 0 else 0.0
            print(f"\r[ {cur / 10:.1f}% ]  with ETA in {format_ms(eta)} ",
                  end="", flush=True)
            state["prev"] = cur
    return cb


def _save_png(img, outfile: str) -> str:
    out = outfile if outfile.endswith(".png") else outfile + ".png"
    write_png(out, img)
    return out


def _method(name: str, command: str):
    """The lower-cased method, or None after printing why it is refused."""
    method = name.lower()
    if method not in METHODS:
        print(f"ERROR! Cannot recognize {name} for {command}")
        print(f"Must be one of {', '.join(METHODS)}")
        return None
    return method


def _orbit_scene(gax_file: str, size: int) -> Scene:
    """The reference's canonical view of one galaxy (singleGalaxy.sh)."""
    return Scene(
        camera=CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0), up=(0, 1, 0),
                            fov=90.0),
        instances=[GalaxyInstance(galaxy=gax.load(gax_file))],
        config=RenderConfig(size=size, ray_step=0.025),
    )


def cmd_galaxy(argv, device) -> int:
    """The reference's 19-token still with its percent-done and ETA ticker
    (consolerenderer.cpp:80-93): omp / thread / pallas through the band
    path (K5), xla through the XLA-form march in 16 row chunks, sharded
    through the kernel's row slabs over every visible card (one CPU entry
    under --device cpu), oracle through the numpy spec oracle."""
    if len(argv) != 19:
        print(f"{len(argv)}\nIncorrect usage/parameters for galaxy. Usage:")
        print(USAGE)
        return 1
    method = _method(argv[1], "galaxy")
    if method is None:
        return 1
    fl = [float(x) for x in argv[2:16]]
    scene = Scene(
        camera=CameraParams(camera=tuple(fl[0:3]), target=tuple(fl[3:6]),
                            up=tuple(fl[6:9]), fov=fl[9]),
        instances=[GalaxyInstance(galaxy=gax.load(argv[16]))],
        config=RenderConfig(size=int(float(argv[17])), ray_step=fl[13],
                            exposure=fl[10], gamma=fl[11],
                            saturation=fl[12]),
    )
    print(f"Starting rendering on {_method_desc(method, device)}.")
    t0 = time.perf_counter()
    with ScopedTimer("Rendering"):
        if method == "oracle":
            from .oracle import render_oracle

            img, _ = render_oracle(scene)
        elif method == "sharded":
            from .parallel import make_pixel_mesh, render_scene_sharded

            mesh = make_pixel_mesh(["cpu"] if device == "cpu" else None)
            img = render_scene_sharded(scene, mesh)
        else:
            if method == "xla":
                from .engine.queue import render_progressive

                kw = {"chunks": 16}
            else:
                from .engine.cuda_render import render_progressive

                kw = {"bands": 16}
            img = render_progressive(scene, on_progress=_progress_printer(t0),
                                     device=device, **kw)
            print()
    out = _save_png(img, argv[18])
    print(f"Image saved to file {out}")
    return 0


def cmd_skybox(argv, device) -> int:
    """Six cube faces around the RenderParams camera: in one batched launch
    (K4), or with xla one face after another through the XLA-form march in
    16 row chunks; PNGs Skybox<face>.png in the working directory."""
    if len(argv) != 5:
        print(f"{len(argv)}\nIncorrect usage/parameters for skybox. Usage:")
        print(USAGE)
        return 1
    method = _method(argv[1], "skybox")
    if method is None:
        return 1
    from .engine.batch import render_batch
    from .engine.queue import render_progressive, skybox_jobs
    from .io.renderparams import RenderParamsFile

    rp = RenderParamsFile.load(argv[2])
    scene = Scene(
        camera=rp.camera,
        instances=[GalaxyInstance(galaxy=gax.load(argv[3]))],
        config=rp.to_render_config(size=int(float(argv[4]))),
        spectra=rp.spectra or None,
    )
    print(f"Starting rendering on {_method_desc(method, device)}.")
    jobs = skybox_jobs(scene)
    with ScopedTimer("Rendering"):
        if method == "xla":
            for job in jobs:
                t0 = time.perf_counter()
                img = render_progressive(job.scene, device=device)
                out = _save_png(img, job.filename)
                print(f"Image saved to file {out}  "
                      f"({time.perf_counter() - t0:.1f}s)")
            return 0
        frames = render_batch([j.scene for j in jobs], device=device)
    for job, img in zip(jobs, frames):
        print(f"Image saved to file {_save_png(img, job.filename)}")
    return 0


def cmd_render(argv, device) -> int:
    if len(argv) != 3:
        print(USAGE)
        return 1
    from .engine.cuda_render import render_linear, render_scene

    scene = scene_from_dict(json.loads(Path(argv[1]).read_text()))
    outfile = argv[2]
    t0 = time.perf_counter()
    if outfile.endswith(".fits"):
        from .io.fits import write_fits_channels

        linear = render_linear(scene, device=device).cpu().numpy()
        paths = write_fits_channels(outfile[:-5], linear)
    else:
        paths = [_save_png(render_scene(scene, device=device), outfile)]
    print(f"Rendering: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for p in paths:
        print(f"Image saved to file {p}")
    return 0


def cmd_info(argv, device) -> int:
    if len(argv) != 2:
        print(USAGE)
        return 1
    print(json.dumps(galaxy_to_dict(gax.load(argv[1])), indent=2))
    return 0


def _save_frames(imgs, prefix: str, duration_ms: int) -> None:
    """<prefix>_NNN.png per frame and the animated <prefix>.gif, looping,
    ``duration_ms`` a frame (gamer_tpu/cli.py's PIL GIF)."""
    for i, frame in enumerate(imgs):
        write_png(f"{prefix}_{i:03d}.png", frame)
    write_gif(f"{prefix}.gif", imgs, duration_ms, loop=0)
    print(f"Saved {len(imgs)} frames to {prefix}_NNN.png and {prefix}.gif")


def cmd_flythrough(argv, device) -> int:
    """An orbit of <frames> cameras rendered as one batched launch (K4);
    writes <outprefix>_NNN.png per frame and the animated <outprefix>.gif."""
    if len(argv) != 5:
        print(USAGE)
        return 1
    from .engine.batch import render_flythrough
    from .scene.cameracontrols import orbit_path

    frames = int(argv[2])
    scene = _orbit_scene(argv[1], int(argv[3]))
    cams = orbit_path(scene.camera, frames)
    with ScopedTimer(f"{frames}-frame fly-through"):
        imgs = render_flythrough(scene, cams, device=device)
    _save_frames(imgs, argv[4], 80)
    return 0


def cmd_morph(argv, device) -> int:
    """Morph one galaxy into another: each frame a parameter interpolation,
    all in one batched launch; writes <outprefix>_NNN.png per frame and the
    animated <outprefix>.gif."""
    if len(argv) != 6:
        print(USAGE)
        return 1
    from .engine.batch import render_batch
    from .scene.morph import morph_scenes

    frames = int(argv[3])
    scene = _orbit_scene(argv[1], int(argv[4]))
    try:
        scenes = morph_scenes(scene, gax.load(argv[2]), frames)
        with ScopedTimer(f"{frames}-frame morph"):
            imgs = render_batch(scenes, device=device)
    except ValueError as e:
        print(f"morph: {e}")
        return 1
    _save_frames(imgs, argv[5], 120)
    return 0


def cmd_scene(argv, device) -> int:
    """Scene mode (mainwindow.cpp:1137-1170): N random instances of the
    given galaxies in a box, one frame."""
    if len(argv) != 7:
        print(USAGE)
        return 1
    from .engine.cuda_render import render_scene
    from .scene.generate import generate_scene

    pool = [gax.load(p) for p in argv[1].split(",")]
    n, box = int(argv[2]), float(argv[3])
    seed, size = int(argv[4]), int(argv[5])
    base = Scene(
        camera=CameraParams(camera=(2.5, 0.4, 0), target=(0, 0, 0),
                            up=(0, 1, 0), fov=70.0),
        config=RenderConfig(size=size, ray_step=0.025),
    )
    scene = generate_scene(pool, n, box, seed=seed, base_scene=base)
    with ScopedTimer(f"{n}-instance scene"):
        img = render_scene(scene, device=device)
    print(f"Image saved to file {_save_png(img, argv[6])}")
    return 0


def dataset_scenes(gax_files, n: int, seed: int, size: int):
    """The dataset command's corpus: n structure-preserving variations of
    each galaxy, template-major, at the canonical camera."""
    from .scene.generate import generate_galaxy_variations

    base = Scene(
        camera=CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0), up=(0, 1, 0),
                            fov=90.0),
        config=RenderConfig(size=size, ray_step=0.025),
    )
    return [
        dataclasses.replace(base, instances=[GalaxyInstance(galaxy=g)])
        for t, path in enumerate(gax_files)
        for g in generate_galaxy_variations(gax.load(path), n, seed=seed + t)
    ]


def cmd_dataset(argv, device) -> int:
    """Resumable dataset generation: variations rendered to .npy chunks with
    a manifest; re-running into the same out dir resumes."""
    if len(argv) != 7:
        print(USAGE)
        return 1
    from .engine.jobs import DatasetJob

    n, seed, size = int(argv[2]), int(argv[3]), int(argv[4])
    chunk = int(argv[5])
    scenes = dataset_scenes(argv[1].split(","), n, seed, size)
    job = DatasetJob(scenes, argv[6], chunk_size=chunk, device=device)
    done = {"frames": 0}

    def on_chunk(c, cdt):
        done["frames"] += min(chunk, len(scenes) - c * chunk)
        print(f"chunk {c + 1}/{job.n_chunks} in {format_ms(cdt * 1000.0)}")

    t0 = time.perf_counter()
    rendered = job.run(on_chunk=on_chunk)
    dt = time.perf_counter() - t0
    rate = done["frames"] / dt if dt > 0 and done["frames"] else 0.0
    print(f"{rendered}/{job.n_chunks} chunks this run "
          f"({done['frames']} scenes, {rate:.1f} scenes/s) -> {argv[6]}")
    return 0


def cmd_allsky(argv, device) -> int:
    """The HEALPix sky around the canonical camera in one ray-list launch
    (K6), Mollweide-projected to a <size>^2 PNG."""
    if len(argv) != 5:
        print(USAGE)
        return 1
    from .engine.allsky import render_allsky_image

    scene = _orbit_scene(argv[1], int(argv[3]))
    with ScopedTimer("All-sky rendering"):
        img = render_allsky_image(scene, nside=int(argv[2]),
                                  size=int(argv[3]), device=device)
    print(f"Image saved to file {_save_png(img, argv[4])}")
    return 0


def cmd_renderhpx(argv, device) -> int:
    """A stored HEALPix map (FITS) through the Mollweide projection and the
    post chain; nothing is marched."""
    if len(argv) != 7:
        print(USAGE)
        return 1
    import numpy as np
    import torch

    from .engine.cuda_render import _device
    from .engine.render import post_process
    from .io.fits import read_fits_image
    from .post.mollweide import mollweide_image

    hpx = np.asarray(read_fits_image(argv[1])).ravel()
    nside = int(np.sqrt(hpx.size / 12))
    if 12 * nside * nside != hpx.size:
        print(f"ERROR: {hpx.size} values is not a HEALPix map (12*nside^2)")
        return 1
    buf = mollweide_image(hpx, nside, int(argv[2]))
    img = post_process(torch.as_tensor(buf, device=_device(device)),
                       np.float32(float(argv[4])), np.float32(float(argv[5])),
                       np.float32(float(argv[6])))
    print(f"Image saved to file {_save_png(img.cpu().numpy(), argv[3])}")
    return 0


def cmd_serve(argv, device) -> int:
    """The HTTP render service (serve.py): POST /render with a scene dict;
    concurrent requests that share a structure batch into one launch. A
    trailing 'mesh' serves over all visible cards: single frames
    row-sharded, batches and animations sharded on the batch axis. A
    'warm=FILE.gax[:SIZE,SIZE...]' token runs that galaxy's launch shapes
    once at startup, so the first client does not wait for the kernel
    build. 'maxbatch=N' caps how many compatible requests merge into one
    launch (the latency/throughput dial of RenderService)."""
    from .serve import serve

    args = argv[1:]
    use_mesh = any(a.lower() == "mesh" for a in args)
    warm = next((a[len("warm="):] for a in args if a.startswith("warm=")),
                None)
    raw_maxbatch = next((a[len("maxbatch="):] for a in args
                         if a.startswith("maxbatch=")), None)
    max_batch = None
    if raw_maxbatch is not None:
        try:
            max_batch = int(raw_maxbatch)
        except ValueError:
            print(f"bad maxbatch value {raw_maxbatch!r} (want an integer). "
                  "Usage:")
            print(USAGE)
            return 1
    args = [a for a in args
            if a.lower() != "mesh" and not a.startswith("warm=")
            and not a.startswith("maxbatch=")]
    port = int(args[0]) if len(args) > 0 else 8100
    window = float(args[1]) if len(args) > 1 else 0.05
    bands = int(args[2]) if len(args) > 2 else 8
    mesh = None
    if use_mesh:
        from .parallel import make_pixel_mesh

        mesh = make_pixel_mesh(["cpu"] if device == "cpu" else None)
        print(f"serving over a {mesh.size}-device mesh")
    warm_submit = None
    if warm is not None:
        path, _, size_csv = warm.partition(":")
        sizes = [int(s) for s in size_csv.split(",")] if size_csv else None
        scene = _orbit_scene(path, sizes[0] if sizes else 512)

        def warm_submit(service):
            jid = service.submit_warm(scene, sizes=sizes)
            print(f"warming {path} at sizes {sizes or [scene.config.size]} "
                  f"(job {jid})")

    serve(port, window, bands, mesh=mesh, on_start=warm_submit,
          max_batch=max_batch, device=device)
    return 0


def _fit_args(argv, command: str):
    """The 14 numbers, three paths and optional tail of a fit command's
    positional arguments, or None after printing the usage."""
    if not 18 <= len(argv) <= 21:
        print(f"{len(argv)}\nIncorrect usage/parameters for {command}. "
              "Usage:")
        print(USAGE)
        return None
    return ([float(v) for v in argv[1:15]], argv[15], argv[16], argv[17],
            argv[18:])


def _posed_scene(vals, gax_file: str, size: int, **cfg) -> Scene:
    return Scene(
        camera=CameraParams(camera=tuple(vals[0:3]), target=tuple(vals[3:6]),
                            up=tuple(vals[6:9]), fov=vals[9]),
        instances=[GalaxyInstance(galaxy=gax.load(gax_file))],
        config=RenderConfig(size=size, ray_step=vals[13], exposure=vals[10],
                            gamma=vals[11], saturation=vals[12], **cfg),
    )


def _step_printer(total: int):
    def on_step(i, loss):
        print(f"\r[ step {i + 1}/{total} ]  loss {loss:.6f} ", end="",
              flush=True)
    return on_step


def _save_fitted_scene(result, out_file: str, t0: float) -> str:
    """Print the fit's summary and write its scene dict as JSON; returns
    the path written (``out_file``, with .json appended if missing)."""
    cam = result.scene.camera
    print(f"\nloss {result.losses[0]:.6f} -> {min(result.losses):.6f} in "
          f"{format_ms((time.perf_counter() - t0) * 1000.0)}")
    print(f"fitted camera: ({cam.camera[0]:.4f}, {cam.camera[1]:.4f}, "
          f"{cam.camera[2]:.4f})")
    out = out_file if out_file.endswith(".json") else out_file + ".json"
    with open(out, "w") as fh:
        json.dump(scene_to_dict(result.scene), fh, indent=2)
    return out


def cmd_fit(argv, device) -> int:
    """Galaxy fitting (inverse rendering, engine/fit.py): moves the named
    parameter fields of <gax file> until its render from the given camera
    matches <target png>, then writes the fitted galaxy to <out gax>.
    march=tensor|scan|frozen runs fit_scene's autograd marches (a trailing
    'multiscale' runs its resolution pyramid); march=fd runs fit_scene_fd,
    central differences through the march kernel, with sweep=N its staged
    global search. ckpt=FILE saves and resumes the optimizer state."""
    ckpt = next((a[len("ckpt="):] for a in argv if a.startswith("ckpt=")),
                None)
    march = next((a[len("march="):] for a in argv if a.startswith("march=")),
                 "tensor")
    raw_sweep = next((a[len("sweep="):] for a in argv
                      if a.startswith("sweep=")), None)
    argv = [a for a in argv
            if not (a.startswith("ckpt=") or a.startswith("march=")
                    or a.startswith("sweep="))]
    sweep = 0
    if raw_sweep is not None:
        try:
            sweep = int(raw_sweep)
        except ValueError:
            print(f"bad sweep value {raw_sweep!r} (want an integer). Usage:")
            print(USAGE)
            return 1
        if march != "fd":
            print("fit: sweep= is the staged global search of march=fd")
            return 1
    if march not in ("tensor", "scan", "frozen", "fd"):
        print(f"fit: unknown march {march!r} (tensor, scan, frozen or fd)")
        return 1
    multiscale = bool(argv) and argv[-1].lower() == "multiscale"
    if multiscale:
        argv = argv[:-1]
    args = _fit_args(argv, "fit")
    if args is None:
        return 1
    from .engine.fit import (
        DEFAULT_FIT_FIELDS,
        DEFAULT_SCENE_SCHEDULE,
        fit_scene,
        fit_scene_fd,
        fit_scene_multiscale,
    )
    from .io.png import read_png

    vals, gax_file, target_file, out_file, rest = args
    steps = int(rest[0]) if len(rest) > 0 else 100
    lr = float(rest[1]) if len(rest) > 1 else 2e-2
    fields = tuple(rest[2].split(",")) if len(rest) > 2 else DEFAULT_FIT_FIELDS
    if steps < 1:
        print("fit: steps must be >= 1")
        return 1
    if march == "fd" and multiscale:
        print("fit: march=fd has no multiscale ladder (FD probes are stable "
              "at full octaves); drop 'multiscale'")
        return 1

    target = read_png(target_file)
    if target.shape[0] != target.shape[1]:
        print("fit: target image must be square")
        return 1
    # full-render sampling (not preview), as the galaxy command renders the
    # target: a preview-mode fit would bake its coarser sampling into the
    # fitted parameters
    scene = _posed_scene(vals, gax_file, target.shape[0])
    mode = " [multiscale]" if multiscale else ""
    print(f"Fitting {','.join(fields)} of {gax_file} to {target_file} "
          f"({steps} steps, lr {lr}, march={march}){mode} on "
          f"{_device_desc(device)} ...")
    t0 = time.perf_counter()
    on_step = _step_printer(
        steps * (len(DEFAULT_SCENE_SCHEDULE) if multiscale else 1))
    if march == "fd":
        # the joint winding_b x scale grid when both families are fitted
        groups = None
        if sweep and "winding_b" in fields and "scale" in fields:
            groups = (("winding_b",), ("scale",))
        result = fit_scene_fd(scene, target, fields, steps=steps, lr=lr,
                              sweep=sweep, sweep_groups=groups,
                              on_step=on_step, checkpoint_path=ckpt,
                              device=device)
    elif multiscale:
        result = fit_scene_multiscale(scene, target, fields, steps=steps,
                                      lr=lr, on_step=on_step, march=march,
                                      checkpoint_path=ckpt, device=device)
    else:
        result = fit_scene(scene, target, fields, steps=steps, lr=lr,
                           on_step=on_step, march=march,
                           checkpoint_path=ckpt, device=device)
    print(f"\nloss {result.losses[0]:.6f} -> {result.losses[-1]:.6f} in "
          f"{format_ms((time.perf_counter() - t0) * 1000.0)}")
    gax.save(result.scene.instances[0].galaxy, out_file)
    print(f"Saved fitted galaxy to {out_file}")
    return 0


def cmd_fitpose(argv, device) -> int:
    """Camera-pose refinement (engine/fit.py): refine the given camera
    toward the pose that produced <target png>, holding the galaxy, and
    write the fitted scene dict to <out scene.json>. The default fits at
    noise LOD 3 (fit_pose: full-octave noise drowns the pose gradient);
    'multiscale' runs fit_pose_multiscale's LOD ladder and 'fd'
    fit_pose_fd, central differences through the march kernel at full
    quality. ckpt=FILE saves and resumes the optimizer state."""
    ckpt = next((a[len("ckpt="):] for a in argv if a.startswith("ckpt=")),
                None)
    argv = [a for a in argv if not a.startswith("ckpt=")]
    args = _fit_args(argv, "fitpose")
    if args is None:
        return 1
    from .engine.fit import (
        DEFAULT_POSE_SCHEDULE,
        fit_pose,
        fit_pose_fd,
        fit_pose_multiscale,
    )
    from .io.png import read_png

    vals, gax_file, target_file, out_file, rest = args
    steps = int(rest[0]) if len(rest) > 0 else 80
    lr = float(rest[1]) if len(rest) > 1 else 1e-2
    lod_arg = rest[2] if len(rest) > 2 else "3"
    multiscale = lod_arg.lower() == "multiscale"
    use_fd = lod_arg.lower() == "fd"
    lod = 3 if multiscale or use_fd else int(lod_arg)
    if steps < 1:
        print("fitpose: steps must be >= 1")
        return 1

    target = read_png(target_file)
    if target.shape[0] != target.shape[1]:
        print("fitpose: target image must be square")
        return 1
    scene = _posed_scene(vals, gax_file, target.shape[0], is_preview=True,
                         noise_octaves=None if multiscale or use_fd else lod)
    if use_fd:
        print(f"Refining camera pose toward {target_file} ({steps} FD steps "
              f"at full quality, lr {lr}) on {_device_desc(device)} ...")
        t0 = time.perf_counter()
        result = fit_pose_fd(scene, target, ("camera",), steps=steps, lr=lr,
                             on_step=_step_printer(steps),
                             checkpoint_path=ckpt, device=device)
    elif multiscale:
        total = steps * len(DEFAULT_POSE_SCHEDULE)
        print(f"Refining camera pose toward {target_file} ({steps} "
              f"steps/rung over LOD schedule "
              f"{[s[0] or 'exact' for s in DEFAULT_POSE_SCHEDULE]}, lr {lr}) "
              f"on {_device_desc(device)} ...")
        t0 = time.perf_counter()
        result = fit_pose_multiscale(scene, target, ("camera",), steps=steps,
                                     lr=lr, on_step=_step_printer(total),
                                     checkpoint_path=ckpt, device=device)
    else:
        print(f"Refining camera pose toward {target_file} ({steps} steps, "
              f"lr {lr}, noise LOD {lod}) on {_device_desc(device)} ...")
        t0 = time.perf_counter()
        result = fit_pose(scene, target, ("camera",), steps=steps, lr=lr,
                          on_step=_step_printer(steps), checkpoint_path=ckpt,
                          device=device)
    out = _save_fitted_scene(result, out_file, t0)
    print(f"Saved fitted scene to {out}")
    return 0


def cmd_fitjoint(argv, device) -> int:
    """Joint camera + parameter fitting (engine/fit.fit_joint): an image
    whose camera AND galaxy parameters are both unknown; block-coordinate
    descent alternating pose blocks (pose=multiscale: the LOD ladder;
    pose=fd: central differences through the march kernel) and parameter
    blocks (march=). Writes the fitted scene dict to <out scene.json> and
    the fitted galaxy to <out>.gax."""
    ckpt = next((a[len("ckpt="):] for a in argv if a.startswith("ckpt=")),
                None)
    march = next((a[len("march="):] for a in argv if a.startswith("march=")),
                 "frozen")
    pose_method = next((a[len("pose="):] for a in argv
                        if a.startswith("pose=")), "multiscale")
    fields_arg = next((a[len("fields="):] for a in argv
                       if a.startswith("fields=")), None)
    argv = [a for a in argv
            if not (a.startswith("ckpt=") or a.startswith("march=")
                    or a.startswith("pose=") or a.startswith("fields="))]
    args = _fit_args(argv, "fitjoint")
    if args is None:
        return 1
    from .engine.fit import (
        DEFAULT_FIT_FIELDS,
        DEFAULT_POSE_SCHEDULE,
        fit_joint,
    )
    from .io.png import read_png

    vals, gax_file, target_file, out_file, rest = args
    rounds = int(rest[0]) if len(rest) > 0 else 2
    pose_steps = int(rest[1]) if len(rest) > 1 else 30
    scene_steps = int(rest[2]) if len(rest) > 2 else 60
    fields = tuple(fields_arg.split(",")) if fields_arg else DEFAULT_FIT_FIELDS
    if rounds < 1 or pose_steps < 1 or scene_steps < 1:
        print("fitjoint: rounds/posesteps/scenesteps must be >= 1")
        return 1

    target = read_png(target_file)
    if target.shape[0] != target.shape[1]:
        print("fitjoint: target image must be square")
        return 1
    scene = _posed_scene(vals, gax_file, target.shape[0])
    pose_block = (pose_steps * len(DEFAULT_POSE_SCHEDULE)
                  if pose_method == "multiscale" else pose_steps)
    print(f"Jointly fitting camera + {','.join(fields)} of {gax_file} to "
          f"{target_file} ({rounds} rounds, {pose_steps} pose + "
          f"{scene_steps} scene steps/round, march={march}, "
          f"pose={pose_method}) on {_device_desc(device)} ...")
    t0 = time.perf_counter()
    result = fit_joint(scene, target, fields, rounds=rounds,
                       pose_steps=pose_steps, scene_steps=scene_steps,
                       march=march, pose_method=pose_method,
                       on_step=_step_printer(rounds * (pose_block
                                                       + scene_steps)),
                       checkpoint_path=ckpt, device=device)
    out = _save_fitted_scene(result, out_file, t0)
    gax_out = out[:-len(".json")] + ".gax"
    gax.save(result.scene.instances[0].galaxy, gax_out)
    print(f"Saved fitted scene to {out} and fitted galaxy to {gax_out}")
    return 0


def _device_desc(device: str) -> str:
    import torch

    if device == "cpu" or not torch.cuda.is_available():
        return f"device {device!r}"
    return f"{torch.cuda.get_device_name(0)} (CUDA march kernel)"


def _method_desc(method: str, device: str) -> str:
    """Where a galaxy or skybox method renders."""
    if method == "oracle":
        return "the host (numpy spec oracle)"
    if method == "xla":
        return f"device {device!r} (XLA-form march)"
    if method == "sharded":
        return f"every visible {device!r} device (row slabs)"
    return _device_desc(device)


def cmd_viewer(argv, device) -> int:
    """The interactive HTTP editor (viewer.py): orbit, zoom, noise LOD and
    live edits, rendered on the device."""
    from .viewer import serve as viewer_serve

    args = argv[1:]
    port = int(args[0]) if len(args) > 0 else 8000
    size = int(args[1]) if len(args) > 1 else 256
    gax_dir = args[2] if len(args) > 2 else None
    viewer_serve(port, size, gax_dir, device=device)
    return 0


COMMANDS = {
    "galaxy": cmd_galaxy,
    "skybox": cmd_skybox,
    "render": cmd_render,
    "info": cmd_info,
    "flythrough": cmd_flythrough,
    "morph": cmd_morph,
    "scene": cmd_scene,
    "dataset": cmd_dataset,
    "allsky": cmd_allsky,
    "renderhpx": cmd_renderhpx,
    "serve": cmd_serve,
    "fit": cmd_fit,
    "fitpose": cmd_fitpose,
    "fitjoint": cmd_fitjoint,
    "viewer": cmd_viewer,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if len(argv) >= 2 and argv[-2] == "--device":
        device = argv[-1]
        argv = argv[:-2]
        if device not in ("cuda", "cpu"):
            print(f"--device must be cuda or cpu, got {device!r}")
            return 1
    if not argv:
        print(USAGE)
        return 0
    handler = COMMANDS.get(argv[0].lower())
    if handler is None:
        print(USAGE)
        return 1
    return handler(argv, device)


if __name__ == "__main__":
    sys.exit(main())
