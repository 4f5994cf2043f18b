"""The traced run's records: ``torch.profiler`` around the window (CUPTI
kernel, copy and set records, CPU ops), and host spans that the benchmark
records around its own calls into the program's layers.

The trace is written as a Chrome trace to a temporary directory under
TMPDIR, read back and deleted."""

from __future__ import annotations

import bisect
import contextlib
import json
import tempfile
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
WINDOW = "bench.window"


class Spans:
    """Host spans by name: (start, end) on the host's perf_counter, and,
    in a traced run, a profiler annotation of the same name, so that the
    device work launched inside a span can be found in the trace."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.spans = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            from torch.profiler import record_function

            with record_function(name):
                yield
        else:
            yield
        self.spans[name].append((t0, time.perf_counter()))

    def wrap(self, owner, attr: str, name: str):
        """Replace ``owner.attr`` by a wrapper that records each call as
        span ``name``; returns a function that puts the original back."""
        real = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return real(*args, **kwargs)

        setattr(owner, attr, wrapped)
        return lambda: setattr(owner, attr, real)

    def seconds(self, name: str) -> list:
        return [t1 - t0 for t0, t1 in self.spans.get(name, ())]


class Profile:
    """``torch.profiler`` over the block, with CPU and CUDA activity; on
    exit every device is synchronised first, so kernels in flight are
    recorded. ``events`` holds the parsed trace."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.events = None

    @contextlib.contextmanager
    def record(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        try:
            with record_function(WINDOW):
                yield
                for d in self.devices:
                    if torch.device(d).type == "cuda":
                        torch.cuda.synchronize(d)
        finally:
            prof.stop()
        with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            self.events = json.loads(path.read_text()).get("traceEvents", [])


def parse(events, devices) -> dict:
    """The window's records from a Chrome trace: the window's span (us),
    each device's events (name, cat, start, end, correlation) inside it,
    the host's events, and the annotations by name."""
    window = None
    annotations = defaultdict(list)
    host = []
    dev = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            d = args.get("device", e.get("pid"))
            dev[int(d)].append((name, cat, ts, ts + dur,
                                args.get("correlation")))
        elif cat in HOST_CATS:
            if cat == "user_annotation":
                if name == WINDOW:
                    window = (ts, ts + dur)
                else:
                    annotations[name].append((ts, ts + dur))
            host.append((ts, ts + dur, name, cat, args.get("correlation")))
    if window is None:
        raise RuntimeError("the trace holds no window annotation: the "
                           "profiler recorded no host events")
    t0, t1 = window
    used = [int(getattr(d, "index", d) or 0) for d in devices]
    device_events = {d: sorted(ev for ev in dev.get(d, ())
                               if ev[3] > t0 and ev[2] < t1)
                     for d in used}
    host.sort()
    return {"window_us": window, "device": device_events, "host": host,
            "annotations": dict(annotations)}


def busy_us(intervals, t0: float, t1: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [t0, t1]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, t0: float, t1: float) -> list:
    """The idle (start, end) gaps of the union of intervals in [t0, t1]."""
    out, last = [], t0
    for s, e in sorted(intervals):
        if s > last:
            out.append((last, min(s, t1)))
        last = max(last, e)
        if last >= t1:
            break
    if last < t1:
        out.append((last, t1))
    return [g for g in out if g[1] > g[0]]


def launched_in(tr: dict, span: str) -> set:
    """Correlation ids of the launches and copies the host enqueued inside
    the annotation ``span``."""
    spans = sorted(tr["annotations"].get(span, ()))
    if not spans:
        return set()
    starts = [s for s, _ in spans]
    out = set()
    for ts, _, name, cat, corr in tr["host"]:
        if cat != "cuda_runtime" or corr is None:
            continue
        k = bisect.bisect_right(starts, ts) - 1
        if k >= 0 and spans[k][0] <= ts <= spans[k][1]:
            out.add(corr)
    return out


def breakdown(tr: dict, short_us: float = 50.0) -> dict:
    """The device operations that took most time (seconds, summed over the
    window and the devices) and the idle gaps of the first device grouped
    by what the host was doing at each gap's middle (the benchmark's
    innermost span and the innermost host op there; gaps under
    ``short_us`` in one entry), 10 of each."""
    t0, t1 = tr["window_us"]
    ops = defaultdict(float)
    for evs in tr["device"].values():
        for name, _, s, e, _ in evs:
            ops[name] += (min(e, t1) - max(s, t0)) * 1e-6
    first = next(iter(tr["device"].values()), [])
    host = tr["host"]
    starts = [h[0] for h in host]
    labels = defaultdict(float)
    for s, e in gaps([(a, b) for _, _, a, b, _ in first], t0, t1):
        if e - s < short_us:
            labels[f"gaps under {short_us:g} us"] += (e - s) * 1e-6
            continue
        mid = 0.5 * (s + e)
        k = bisect.bisect_right(starts, mid)
        op = span = None
        for h in reversed(host[max(0, k - 2000):k]):
            if h[1] < mid:
                continue
            if h[3] == "user_annotation":
                span = span or (h[2] if h[2] != WINDOW else None)
            else:
                op = op or h[2]
            if op and span:
                break
        label = (f"{span}: {op or 'no op'}" if span
                 else op or "host outside any recorded op")
        labels[label] += (e - s) * 1e-6
    top = lambda d: [[k, v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(labels)}
