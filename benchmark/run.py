#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, CUDA context, the kernel library, the scene, warm-up of
the cell's own shapes) is timed as ``setup_s``; then the cell's traffic
runs for ``--seconds``; then the program's state is freed and the
cell's generator checks what the window produced against the plain
reference (``Run.check``): each number it returns is held to the limit of
the same name in the configuration's ``limits``, which decides
``correct``. With ``--trace 0`` the result
line holds the cell's end-to-end metrics; with ``--trace 1`` the window
runs under ``torch.profiler`` and the line holds its per-layer metrics.
The last line on standard output is the result, one JSON object. A
machine without the card(s) the cell asks for gets no result and a
non-zero exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# top-level module names no run may hold (the JAX package and JAX itself),
# compared whole: gamer_tpu_torch is the program and is allowed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gamer_tpu"})


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def fail(message: str, code: int):
    print(f"benchmark: {message}", file=sys.stderr)
    sys.exit(code)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from harness.cell import load_cell

    try:
        cell = load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        fail(str(e), 2)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this benchmark measures "
             "the CUDA port on an H100 and has no CPU fallback", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"cell {cell.name} needs {cell.chips} cards, this machine has "
             f"{torch.cuda.device_count()}", 3)
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    result = measure(cell, args.seed, args.seconds, bool(args.trace), devices)
    print(json.dumps(result), flush=True)
    return 0


def measure(cell, seed: int, seconds: float, traced: bool, devices) -> dict:
    """Set up, run the window, check, and return the result line's object.
    ``devices``: the cards the cell runs on (CPU entries in the tests,
    which drive everything but the look for a card)."""
    import torch

    from harness import work
    from harness.cell import generator, reader
    from harness.trace import Profile, Spans, breakdown, busy_us, parse

    cuda = [d for d in devices if torch.device(d).type == "cuda"]
    run = generator(cell).Run(cell, seed, devices)
    run.setup(seconds)
    for d in cuda:
        torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - T_START
    from gamer_tpu_torch import kernels

    info = kernels.BUILD_INFO
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    built = ("not loaded" if not info else "loaded, cached" if info["cached"]
             else f"built, {info['seconds']:.2f} s of nvcc")
    log(f"setup: {setup_s:.4f} s (kernel library {built})")

    spans = Spans(annotate=bool(traced))
    undo = run.install(spans) if traced else []
    prof = Profile(run.devices) if traced else None
    if prof is not None:
        with prof.record():
            res = run.window(seconds, spans)
    else:
        res = run.window(seconds, spans)
    for u in undo:
        u()
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package are loaded: {bad}", 4)
    memory_peak = max((torch.cuda.max_memory_allocated(d) for d in cuda),
                      default=0)
    tr = parse(prof.events, run.devices) if prof is not None else None
    if prof is not None:
        prof.events = None
    for line in res.get("lines", ()):
        log(line)
    log(f"window: {res['attempted']} attempted, {res['failed']} failed, "
        f"{res['elapsed_s']:.4f} s; " + ", ".join(
            f"{k} {v:.6g}" for k, v in res["e2e"].items()))

    # the program's state goes before the reference runs
    run.release()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    chk = run.check(int(cell.mix["check_rays"]))
    compared = chk["compared"]
    log(f"reference: {chk['rays']} rays in "
        f"{time.perf_counter() - t_ref:.2f} s")

    limits = cell.config["limits"]
    correct = (res["failed"] == 0 and chk["rays"] > 0
               and all(k in compared and compared[k] <= limits[k]
                       for k in limits))
    metrics = {}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {}
    if not traced:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else res["e2e"][m["name"]]
            if not math.isfinite(v):
                correct = False
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        t0, t1 = tr["window_us"]
        busy = [busy_us([(s, e) for _, _, s, e, _ in evs], t0, t1) * 1e-6
                for evs in tr["device"].values()]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = (t1 - t0) * 1e-6
        rec = {"trace": tr, "units": res["units"], "rays": res["rays"],
               "elapsed_s": res["elapsed_s"], "cards": len(run.devices),
               "spans": {k: spans.seconds(k) for k in spans.spans},
               "layer": res.get("layer", {}),
               "bound_s": (work.bound_for_rays(chk["stats"], chk["rays"],
                                               res["rays"])
                           if chk["rays"] and chk.get("stats") else None)}
        for m in cell.per_layer:
            v = reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = breakdown(tr)
    for k in limits:
        log(f"check {k}: {compared.get(k)} (limit {limits[k]})")
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": device, **out,
              "compared": {k: {"value": compared.get(k), "limit": limits[k]}
                           for k in limits}}
    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package are loaded: {bad}", 4)
    return result


if __name__ == "__main__":
    sys.exit(main())
