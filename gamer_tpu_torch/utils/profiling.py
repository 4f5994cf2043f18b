"""Profiling hooks, the counterpart of ``gamer_tpu.utils.profiling``.

The reference has only wall-clock scope timers (util.h:24-31) and a percent
counter; here:

  - ``profile_trace(log_dir, device=None)``: ``torch.profiler`` around a
    block, written to ``log_dir/trace.json`` as a Chrome trace (open it in
    Perfetto or chrome://tracing): the counterpart of the XProf trace that
    ``jax.profiler.trace`` writes. It records the host's torch ops and, on
    a CUDA device, the kernels (the march kernel's instantiations by name).
    A process that already ran large profiler sessions (10^5-10^6 launches)
    can lose kernel records in a later session; such a trace is detected
    (a launch call whose kernel record is missing, or no kernel record at
    all) and reported with a ``TraceLossWarning``.
  - ``span(name)``: the render path's spans (``gamer.render``,
    ``gamer.prep`` and its parts, ``gamer.march``, ``gamer.replicate``,
    ``gamer.assembly``, ``gamer.epilogue``, ``gamer.readback``). While a
    profiler session records on the calling thread, a span is a
    ``record_function`` range: a ``user_annotation`` event in the same
    trace and on the same clock as the device's kernel and copy records.
    Otherwise it costs one flag check.
  - ``RenderStats``: rays/s and Msamples/s from frame timings.
"""

from __future__ import annotations

import contextlib
import json
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import torch

TRACE_FILE = "trace.json"

# what a span is when no profiler records: one object, shared
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the block as the span ``name`` in a
    profiler session that records on this thread (``profile_trace``, or
    any ``torch.profiler`` session): a ``record_function(name)`` range,
    nested in the span open around it. With no session it checks one flag
    and returns a shared no-op context: no range, no clock read, nothing
    allocated."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.autograd.profiler.record_function(name)


class TraceLossWarning(RuntimeWarning):
    """A trace of CUDA activity that lacks kernel records."""


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def kernel_records(trace: dict):
    """(launch calls, kernel records, launch calls with no kernel record) of
    a Chrome trace: a runtime or driver launch call and the kernel it
    started carry the same correlation id."""
    launches, kernels = set(), set()
    for e in trace.get("traceEvents", ()):
        corr = (e.get("args") or {}).get("correlation")
        name = e.get("name", "")
        if e.get("cat") == "kernel":
            kernels.add(corr)
        elif (e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "Launch" in name and "Kernel" in name):
            launches.add(corr)
    return len(launches), len(kernels), len(launches - kernels)


def _check_kernels(path: Path) -> None:
    launches, kernels, lost = kernel_records(json.loads(path.read_text()))
    if lost or not kernels:
        warnings.warn(
            f"{path}: {kernels} kernel records for {launches} launch calls "
            f"({lost} launches without their kernel). Either the block "
            f"launched no kernel, or the profiler lost device activity, as "
            f"it can after large sessions earlier in the process: profile "
            f"in a fresh process", TraceLossWarning, stacklevel=3)


@contextlib.contextmanager
def profile_trace(log_dir: str, device=None):
    """Trace the block into ``log_dir/trace.json`` and yield the
    ``torch.profiler.profile`` session (its ``key_averages()`` sum the
    recorded events by name). CPU activity is always recorded; CUDA
    activity when ``device`` is a CUDA device, or when no device is given
    and a card is present. On a CUDA device the block's work is waited for
    before the trace stops, so kernels still in flight are recorded. The
    trace is written also when the block raises. A CUDA trace with a
    launch call whose kernel record is missing, or with no kernel record,
    raises a ``TraceLossWarning``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (_is_cuda(device) if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(str(out / TRACE_FILE))
        if cuda:
            _check_kernels(out / TRACE_FILE)


@dataclass
class RenderStats:
    """Running throughput counters (rays/s, Msamples/s, frame times)."""

    samples_per_pixel: float = 0.0  # march samples per pixel (the oracle's)
    frames: List[dict] = field(default_factory=list)

    @contextlib.contextmanager
    def frame(self, n_pixels: int, device=None):
        """Time the block as one frame of ``n_pixels`` rays. With a CUDA
        ``device`` the clock stops after ``torch.cuda.synchronize(device)``:
        a render that leaves its frame on the card returns before the card
        is done, and the clock would time only its launch."""
        t0 = time.perf_counter()
        yield
        if _is_cuda(device):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        self.frames.append({"pixels": n_pixels, "seconds": dt})

    @property
    def rays_per_sec(self) -> float:
        px = sum(f["pixels"] for f in self.frames)
        s = sum(f["seconds"] for f in self.frames)
        return px / s if s else 0.0

    @property
    def msamples_per_sec(self) -> float:
        return self.rays_per_sec * self.samples_per_pixel / 1e6

    def summary(self) -> dict:
        return {
            "frames": len(self.frames),
            "rays_per_sec": round(self.rays_per_sec, 1),
            "msamples_per_sec": round(self.msamples_per_sec, 3),
            "total_seconds": round(sum(f["seconds"] for f in self.frames), 4),
        }
