"""``gamer_tpu_torch.utils.profiling`` against ``gamer_tpu.utils.profiling``:
``RenderStats`` gives JAX's counters for the same frames and clock, and
stops its clock after the card when given a CUDA device; ``profile_trace``
writes a Chrome trace that names the torch ops of a plain frame."""

from __future__ import annotations

import json
import time

import pytest

torch = pytest.importorskip("torch")

from gamer_tpu.utils import profiling as jprof  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.utils import profiling as tprof  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (pixels, seconds) of each frame
FRAMES = [(256 * 256, 0.0125), (64 * 64, 0.5), (100, 1e-4), (512 * 512, 2.0)]


def _fake_clock(monkeypatch, log=None):
    """time.perf_counter steps through each frame's start and end."""
    ticks = []
    t = 10.0
    for _, dt in FRAMES:
        ticks += [t, t + dt]
        t += dt + 1.0
    it = iter(ticks)

    def clock():
        if log is not None:
            log.append("clock")
        return next(it)

    monkeypatch.setattr(time, "perf_counter", clock)


@pytest.mark.parametrize("spp", [0.0, 1137.3])
def test_render_stats_summary_matches_jax(monkeypatch, spp):
    stats = []
    for mod in (tprof, jprof):
        _fake_clock(monkeypatch)
        st = mod.RenderStats(samples_per_pixel=spp)
        for px, _ in FRAMES:
            with st.frame(px):
                pass
        stats.append(st)
    ours, ref = stats
    assert ours.frames == ref.frames
    assert ours.summary() == ref.summary()
    assert ours.rays_per_sec == ref.rays_per_sec
    assert ours.msamples_per_sec == ref.msamples_per_sec
    assert tprof.RenderStats().summary() == jprof.RenderStats().summary()


def test_render_stats_waits_for_the_card(monkeypatch):
    """With a CUDA device the clock stops after torch.cuda.synchronize of
    that device; with the CPU or no device there is no sync."""
    log = []
    _fake_clock(monkeypatch, log)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (log.append("sync"), synced.append(d)))
    st = tprof.RenderStats()
    with st.frame(FRAMES[0][0], device="cuda:0"):
        log.append("render")
    assert log == ["clock", "render", "sync", "clock"]
    assert synced == ["cuda:0"]
    with st.frame(FRAMES[1][0], device="cpu"):
        pass
    with st.frame(FRAMES[2][0]):
        pass
    assert synced == ["cuda:0"] and len(st.frames) == 3


def _scene(size):
    g = presets.spiral()
    g.components = [c for c in g.components if c.cid == 0]  # the bulge
    return gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=g)],
        config=gt.RenderConfig(size=size, ray_step=0.025, is_preview=True))


def test_profile_trace_names_the_ops_of_a_plain_frame(tmp_path):
    """An 8^2 plain frame in the trace: trace.json is a Chrome trace whose
    events name the torch ops the plain march runs, and the session's
    key_averages count them; no CUDA activity is recorded on the CPU."""
    with tprof.profile_trace(tmp_path / "run", device="cpu") as prof:
        img = gt.render_scene(_scene(8), device="cpu")
    assert img.shape == (8, 8, 3) and int(img.sum()) > 0
    trace = json.loads((tmp_path / "run" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"aten::where", "aten::mul"} <= names
    assert not any(e.get("cat") == "kernel" for e in trace["traceEvents"])
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["aten::where"] > 0


def test_profile_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="stop"):
        with tprof.profile_trace(tmp_path, device="cpu"):
            torch.ones(4).add_(1)
            raise ValueError("stop")
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert "aten::add_" in {e.get("name") for e in trace["traceEvents"]}
    if not torch.cuda.is_available():  # no device given, no card: the CPU
        with tprof.profile_trace(tmp_path / "auto"):
            torch.ones(4).mul_(2)
        assert (tmp_path / "auto" / "trace.json").exists()


def _event(cat, name, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": 1,
            "args": {"correlation": corr}}


def test_kernel_records_pair_launches_with_kernels():
    """A launch call and its kernel share a correlation id; a launch whose
    kernel record is missing is counted as lost."""
    whole = {"traceEvents": [
        _event("cuda_runtime", "cudaLaunchKernel", 1),
        _event("kernel", "void gamer::march_kernel<0>(...)", 1),
        _event("cuda_driver", "cuLaunchKernel", 2),
        _event("kernel", "elementwise_kernel", 2),
        _event("cuda_runtime", "cudaMemcpyAsync", 3),
        _event("gpu_memcpy", "Memcpy HtoD", 3),
        _event("cpu_op", "aten::mul", None)]}
    assert tprof.kernel_records(whole) == (2, 2, 0)
    lossy = {"traceEvents": [e for e in whole["traceEvents"]
                             if e["name"] != "elementwise_kernel"]}
    assert tprof.kernel_records(lossy) == (2, 1, 1)
    assert tprof.kernel_records({"traceEvents": []}) == (0, 0, 0)


def test_profile_trace_warns_when_a_cuda_trace_lacks_kernels(tmp_path,
                                                             monkeypatch):
    """CUDA activity was asked for and the trace holds no kernel record: a
    TraceLossWarning (here the block launches nothing); a CPU trace never
    warns, and a trace whose launches all have their kernels does not."""
    import warnings

    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    with pytest.warns(tprof.TraceLossWarning, match="0 kernel records"):
        with tprof.profile_trace(tmp_path / "cuda", device="cuda:0"):
            torch.ones(4).add_(1)
    assert (tmp_path / "cuda" / "trace.json").exists()
    with warnings.catch_warnings():
        warnings.simplefilter("error", tprof.TraceLossWarning)
        with tprof.profile_trace(tmp_path / "cpu", device="cpu"):
            torch.ones(4).add_(1)
        path = tmp_path / "whole.json"
        path.write_text(json.dumps({"traceEvents": [
            _event("cuda_runtime", "cudaLaunchKernel", 7),
            _event("kernel", "k", 7)]}))
        tprof._check_kernels(path)
    path.write_text(json.dumps({"traceEvents": [
        _event("cuda_runtime", "cudaLaunchKernel", 7),
        _event("cuda_runtime", "cudaLaunchKernel", 8),
        _event("kernel", "k", 7)]}))
    with pytest.warns(tprof.TraceLossWarning, match="1 launches without"):
        tprof._check_kernels(path)
