"""The render path's profiler spans (``utils.profiling.span``) on the CPU:
each layer's span once a frame and nested as the layers are, the batch
path's host prep as one span ahead of its first launch, the mesh's
replication and assembly, no span overlapping another of its name, and a
span that costs one flag check when no profiler records."""

from __future__ import annotations

import json
import time
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch.engine.queue import skybox_jobs  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.parallel import Mesh  # noqa: E402
from gamer_tpu_torch.utils import profiling  # noqa: E402
from gamer_tpu_torch.utils.profiling import profile_trace, span  # noqa: E402

PREP_PARTS = ("gamer.prep.flatten", "gamer.prep.camera", "gamer.prep.pack",
              "gamer.prep.table", "gamer.prep.upload")
# each span of a still and the span it is nested in
STILL_PARENT = {"gamer.prep": "gamer.render", "gamer.march": "gamer.render",
                "gamer.epilogue": "gamer.render",
                "gamer.readback": "gamer.render",
                **{p: "gamer.prep" for p in PREP_PARTS}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(galaxy=None, size=8):
    """A frame whose camera, far out, looks away from the galaxy: every
    ray leaves at once, so that a plain frame takes milliseconds under the
    profiler. The spans are under test, not the march. Of its skybox the
    Z- and Z+ faces miss the galaxy too."""
    return gt.Scene(
        camera=gt.CameraParams(camera=(30, 0, 0), target=(60, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=galaxy or presets.spiral())],
        config=gt.RenderConfig(size=size, ray_step=0.1))


def _spans(log_dir, render) -> dict:
    """The ``gamer.*`` spans of one render's Chrome trace by name:
    [(start, end)] in integer ns, in order of start."""
    with profile_trace(str(log_dir), device="cpu"):
        render()
    events = json.loads((log_dir / profiling.TRACE_FILE).read_text())
    out = defaultdict(list)
    for e in events["traceEvents"]:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("gamer.")):
            t0 = round(float(e["ts"]) * 1e3)
            out[e["name"]].append((t0, t0 + round(float(e["dur"]) * 1e3)))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _still():
    gt.render_scene(_scene(), device="cpu")


def _skybox_faces():
    gt.render_batch([j.scene for j in skybox_jobs(_scene())[:2]],
                    device="cpu")


def _two_structures():
    gt.render_batch([_scene(), _scene(presets.ring())], device="cpu")


def _still_on_mesh():
    gt.render_scene(_scene(), mesh=Mesh(["cpu"] * 2))


RENDERS = {"still": _still, "skybox_faces": _skybox_faces,
           "two_structures": _two_structures, "still_on_mesh": _still_on_mesh}


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    return {name: _spans(tmp_path_factory.mktemp(name), fn)
            for name, fn in RENDERS.items()}


def test_still_spans_once_a_frame_nested_as_the_layers(traces):
    spans = traces["still"]
    assert set(spans) == {"gamer.render", *STILL_PARENT}
    assert all(len(v) == 1 for v in spans.values()), spans
    for name, parent in STILL_PARENT.items():
        assert _inside(spans[name][0], spans[parent][0]), (name, parent)
    # the layers follow one another: prep, march, epilogue, readback
    order = ["gamer.prep", "gamer.march", "gamer.epilogue", "gamer.readback"]
    for a, b in zip(order, order[1:]):
        assert spans[a][0][1] <= spans[b][0][0], (a, b)


@pytest.mark.parametrize("render, groups",
                         [("skybox_faces", 1), ("two_structures", 2)])
def test_batch_prep_is_one_span_before_the_first_launch(traces, render,
                                                        groups):
    spans = traces[render]
    (prep,) = spans["gamer.prep"]
    (whole,) = spans["gamer.render"]
    assert _inside(prep, whole)
    for part in ("gamer.prep.table", "gamer.prep.upload"):
        assert len(spans[part]) == groups
        assert all(_inside(s, prep) for s in spans[part])
    for part in ("gamer.prep.flatten", "gamer.prep.camera",
                 "gamer.prep.pack"):
        assert [_inside(s, prep) for s in spans[part]] == [True]
    assert len(spans["gamer.march"]) == groups
    assert prep[1] <= spans["gamer.march"][0][0]
    assert [_inside(s, whole) for s in spans["gamer.readback"]] == [True]


def test_still_on_a_mesh_replicates_and_assembles_once(traces):
    spans = traces["still_on_mesh"]
    (march,) = spans["gamer.march"]
    for name in ("gamer.replicate", "gamer.assembly"):
        assert len(spans[name]) == 1
        assert _inside(spans[name][0], march)
    assert spans["gamer.replicate"][0][1] <= spans["gamer.assembly"][0][0]
    assert len(spans["gamer.prep"]) == len(spans["gamer.epilogue"]) == 1


@pytest.mark.parametrize("render", sorted(RENDERS))
def test_no_span_overlaps_itself(traces, render):
    for name, ivs in traces[render].items():
        for (_, end), (start, _) in zip(ivs, ivs[1:]):
            assert end <= start, (render, name)


def test_span_off_enters_nothing_and_reads_no_clock(monkeypatch):
    entered, clock = [], []

    def recorder(name, *args, **kwargs):
        entered.append(name)
        raise AssertionError(f"record_function({name!r}) with no profiler")

    real_clock = time.perf_counter

    def counted():
        clock.append(1)
        return real_clock()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", recorder)
    monkeypatch.setattr(torch.profiler, "record_function", recorder)
    monkeypatch.setattr(time, "perf_counter", counted)
    assert not torch._C._autograd._profiler_enabled()
    for _ in range(100):
        with span("gamer.prep"):
            pass
    assert clock == []
    # one shared object: nothing made per span
    assert span("gamer.march") is span("gamer.epilogue")
    monkeypatch.setattr(time, "perf_counter", real_clock)
    _still()
    _skybox_faces()
    assert entered == []
