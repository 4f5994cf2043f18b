"""``gamer_tpu_torch.viewer`` against ``gamer_tpu.viewer``: both editors are
driven through the same script of edits over HTTP (loopback, ports picked
by the OS), and after every step they must answer alike: the galaxy list,
every galaxy's parameters and ``.gax`` bytes, the spectra and the render
settings, the scenes that ``/render``, ``/fullrender`` and ``/skybox``
would render (the renders are recorded, not run, during the script), the
page and the status codes and messages of bad requests.

Then the port's images on the CPU: ``/render`` within 2 uint8 LSB of the
JAX viewer's (the Pallas kernel, interpreted) at 12x12, and the port's
``/render``, streamed ``/fullrender`` and ``/skybox`` bit-equal to its own
``render_scene``, ``render_progressive`` and ``render_batch``; and the CLI
``viewer`` answers ``/`` in a subprocess.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gamer_tpu import viewer as jviewer  # noqa: E402
from gamer_tpu.engine import batch as jbatch  # noqa: E402
from gamer_tpu.engine import pallas_render as jpallas  # noqa: E402
from gamer_tpu.models import presets as jpresets  # noqa: E402
from gamer_tpu.scene import gax as jgax  # noqa: E402
from gamer_tpu.scene.schema import scene_to_dict as jscene_to_dict  # noqa: E402

from gamer_tpu_torch import viewer as tviewer  # noqa: E402
from gamer_tpu_torch.engine import batch as tbatch  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as tcr  # noqa: E402
from gamer_tpu_torch.engine.queue import skybox_jobs  # noqa: E402
from gamer_tpu_torch.io.png import decode_png  # noqa: E402
from gamer_tpu_torch.models import presets as tpresets  # noqa: E402
from gamer_tpu_torch.scene import gax as tgax  # noqa: E402
from gamer_tpu_torch.scene.schema import scene_to_dict  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SIZE = 12
LSB = 2
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gax_dir(tmp_path_factory):
    """A galaxy library of one file beside the presets."""
    d = tmp_path_factory.mktemp("galaxies")
    jgax.save(jpresets.dusty_disk("Disk"), d / "Disk.gax")
    return d


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture()
def servers(gax_dir):
    """(JAX viewer, port viewer) as (httpd, thread, base url) each, with a
    fresh session each."""
    pair = [
        _start(jviewer.serve(port=0, size=SIZE, gax_dir=str(gax_dir),
                             poll=False)),
        _start(tviewer.serve(port=0, size=SIZE, gax_dir=str(gax_dir),
                             poll=False, device="cpu")),
    ]
    yield pair
    for httpd, t, _ in pair:
        httpd.shutdown()
        httpd.server_close()
        t.join(TIMEOUT)


def _get(base, path, data=None, method=None):
    """(status, body bytes) of one request."""
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _Recorder:
    """Stands in for the renders: records each scene (as a dict) and
    returns black frames of the right shape."""

    def __init__(self):
        self.scenes = []

    def frame(self, to_dict):
        def render(scene, *a, **k):
            self.scenes.append(to_dict(scene))
            s = scene.config.size
            return np.zeros((s, s, 3), np.uint8)
        return render

    def progressive(self, to_dict):
        def render(scene, bands=16, on_progress=None, **k):
            self.scenes.append((bands, to_dict(scene)))
            s = scene.config.size
            img = np.zeros((s, s, 3), np.uint8)
            if on_progress is not None:
                on_progress(1.0, img)
            return img
        return render

    def batch(self, to_dict):
        def render(scenes, *a, **k):
            self.scenes.append([to_dict(s) for s in scenes])
            s = scenes[0].config.size
            return np.zeros((len(scenes), s, s, 3), np.uint8)
        return render


@pytest.fixture()
def recorders(monkeypatch):
    jrec, trec = _Recorder(), _Recorder()
    monkeypatch.setattr(jpallas, "render_scene_pallas", jrec.frame(
        jscene_to_dict))
    monkeypatch.setattr(jpallas, "render_progressive_pallas",
                        jrec.progressive(jscene_to_dict))
    monkeypatch.setattr(jbatch, "render_batch", jrec.batch(jscene_to_dict))
    monkeypatch.setattr(tcr, "render_scene", trec.frame(scene_to_dict))
    monkeypatch.setattr(tcr, "render_progressive",
                        trec.progressive(scene_to_dict))
    monkeypatch.setattr(tbatch, "render_batch", trec.batch(scene_to_dict))
    return jrec, trec


# a view of each render route, with every query knob the route reads
VIEWS = ("/render?galaxy={g}&h=30&v=-10&zoom=0.2&lod=3&ss=2",
         "/render?galaxy={g}",
         "/fullrender?galaxy={g}&size=16&h=15&v=5&zoom=-0.1&ss=1",
         "/fullrender?galaxy={g}&size=20&h=-45&stream=1&bands=4",
         "/skybox?galaxy={g}&size=8")


def _both(servers, path, data=None, method=None):
    (_, _, jbase), (_, _, tbase) = servers
    return (_get(jbase, path, data, method), _get(tbase, path, data, method))


def _same_state(servers, recorders, step):
    """Every read-only route answers alike, and every render route would
    render the same scene."""
    ours, ref = _both(servers, "/galaxies")
    assert ours == ref and ours[0] == 200, step
    names = json.loads(ours[1])
    for path in ("/spectra", "/cfg", "/params", "/save"):
        ours, ref = _both(servers, path)
        assert ours == ref and ours[0] == 200, (step, path)
    for g in names:
        for path in (f"/params?galaxy={g}", f"/save?galaxy={g}"):
            ours, ref = _both(servers, path)
            assert ours == ref and ours[0] == 200, (step, path)
    jrec, trec = recorders
    del jrec.scenes[:], trec.scenes[:]
    for view in VIEWS:
        ours, ref = _both(servers, view.format(g=names[0]))
        assert ours[0] == ref[0] == 200, (step, view, ours, ref)
    assert len(trec.scenes) == len(VIEWS)
    assert trec.scenes == jrec.scenes, step


def test_the_same_edits_give_the_same_answers(servers, recorders):
    (_, _, jbase), _ = servers
    ours, ref = _both(servers, "/")
    assert ours == ref and ours[0] == 200
    assert ours[1] == jviewer._PAGE.encode()
    g = json.loads(_both(servers, "/galaxies")[0][1])[0]
    assert g == "Disk"
    _same_state(servers, recorders, "start")
    script = [
        f"/set?galaxy={g}&comp=0&field=strength&value=5",
        f"/set?galaxy={g}&comp=1&field=active&value=0",
        f"/set?galaxy={g}&comp=1&field=name&value=Renamed",
        f"/set?galaxy={g}&comp=-1&field=winding_n&value=6",
        f"/set?galaxy={g}&comp=-1&field=axis&value=1,0.5,1",
        f"/set?galaxy={g}&comp=-1&field=name&value=Other",
        f"/addcomp?galaxy={g}&class=stars%20small",
        f"/clonecomp?galaxy={g}&comp=1",
        f"/delcomp?galaxy={g}&comp=0",
        "/setspectrum?name=Teal&value=0.2,0.9,0.8",
        f"/set?galaxy={g}&comp=0&field=spectrum&value=Teal",
        "/setspectrum?name=Red&value=1,0.1,0.1",
        "/delspectrum?name=Blue",
        "/setcfg?field=exposure&value=0.5",
        "/setcfg?field=no_stars&value=20",
        "/setcfg?field=star_size&value=30",
        "/setcfg?field=dither&value=1",
        "/setcfg?field=ray_step&value=0.05",
        "/setcfg?field=fov&value=60",
        "/setcfg?field=full_size&value=64",
        "/newgalaxy?name=Fresh",
        "/set?galaxy=Fresh&comp=2&field=scale&value=2.5",
        f"/clonegalaxy?galaxy={g}&name=",
        f"/clonegalaxy?galaxy={g}&name=Copy1",
        "/delgalaxy?galaxy=Copy1",
        "upload",
        "/delspectrum?name=Teal",
        f"/reset?galaxy={g}",
        "/reset",
    ]
    for step in script:
        if step == "upload":
            data = _get(jbase, f"/save?galaxy={g}")[1]
            ours, ref = _both(servers, "/upload?name=Uploaded", data=data,
                              method="POST")
        else:
            ours, ref = _both(servers, step)
        assert ours == ref and ours[0] == 200, (step, ours, ref)
        _same_state(servers, recorders, step)


BAD = [
    "/set?galaxy=Disk&comp=0&field=nope&value=1",
    "/set?galaxy=Disk&comp=9&field=strength&value=1",
    "/set?galaxy=Disk&comp=-1&field=axis&value=1,2",
    "/set?galaxy=Disk&comp=0&field=strength&value=abc",
    "/params?galaxy=NoSuch",
    "/render?h=notanumber",
    "/render?galaxy=NoSuch",
    "/nope",
    "/addcomp?galaxy=Disk&class=nope",
    "/delcomp?galaxy=Disk&comp=99",
    "/clonecomp?galaxy=Disk&comp=-1",
    "/setcfg?field=bogus&value=1",
    "/setcfg?field=ray_step&value=0",
    "/setcfg?field=full_size&value=4",
    "/setspectrum?name=&value=1,1,1",
    "/setspectrum?name=X&value=1,2",
    "/delspectrum?name=NoSuch",
    "/fullrender?galaxy=Disk&size=99999",
    "/fullrender?galaxy=Disk&size=4&stream=1",
    "/skybox?galaxy=Disk&size=4",
    "/newgalaxy?name=",
    "/newgalaxy?name=Disk",
    "/clonegalaxy?galaxy=NoSuch",
    "/delgalaxy?galaxy=NoSuch",
]


def test_bad_requests_answer_alike(servers, recorders):
    for path in BAD:
        ours, ref = _both(servers, path)
        if "stream=1" in path:
            # the stream's 200 went out before the size was checked: both
            # send the 400 inside that response
            assert ours[0] == ref[0] == 200 and b" 400 " in ours[1], path
            continue
        assert ours == ref and 400 <= ours[0] < 500, (path, ours, ref)
    for path, data in (("/upload?name=Bad", b"not a galaxy"),
                       ("/upload", b""), ("/nope", b"x")):
        ours, ref = _both(servers, path, data=data, method="POST")
        assert ours == ref and 400 <= ours[0] < 500, (path, ours, ref)
    assert not recorders[1].scenes


def test_render_is_within_2_lsb_of_jax_and_the_port_frame(servers):
    """The preview route at 12x12: within 2 LSB of the JAX viewer's
    (interpreted Pallas) and bit-equal to the port's render_scene of the
    viewer's own scene."""
    (_, _, jbase), (httpd, _, tbase) = servers
    path = "/render?galaxy=spiral&h=30&v=10&lod=4"
    ref = decode_png(_get(jbase, path)[1])  # the JAX viewer's PIL PNG
    status, body = _get(tbase, path)
    assert status == 200 and body[:4] == b"\x89PNG"
    ours = decode_png(body)
    assert ours.shape == (SIZE, SIZE, 3) and int(ours.sum()) > 0
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max()
    assert d <= LSB, d
    state = httpd.state
    scene = state._scene("spiral", 30.0, 10.0, 0.0, SIZE, preview=True, lod=4)
    np.testing.assert_array_equal(ours,
                                  tcr.render_scene(scene, device="cpu"))


def _parts(body: bytes):
    """(progress, image) of each part of a multipart/x-mixed-replace body."""
    out = []
    for chunk in body.split(b"--gamerband\r\n")[1:]:
        head, _, rest = chunk.partition(b"\r\n\r\n")
        fields = dict(line.split(b": ", 1) for line in head.split(b"\r\n"))
        n = int(fields[b"Content-Length"])
        out.append((float(fields[b"X-Progress"]), decode_png(rest[:n])))
    assert body.endswith(b"--gamerband--\r\n")
    return out


def test_fullrender_stream_and_skybox_are_the_port_frames(servers):
    """A bulge uploaded and streamed at 72x72 (3 row bands of 32): each
    part is a whole frame, the first band's rows final in the first part,
    the last part the port's render_progressive bit for bit; the skybox
    montage's faces are render_batch's of the six face scenes."""
    _, (httpd, _, tbase) = servers
    g = tpresets.spiral()
    g.components = [c for c in g.components if c.cid == 0]
    assert _get(tbase, "/upload?name=Bulge", data=tgax.dumps(g),
                method="POST")[0] == 200
    state = httpd.state
    status, body = _get(tbase, "/fullrender?galaxy=Bulge&size=72&v=20"
                               "&stream=1")
    assert status == 200
    parts = _parts(body)
    assert [f for f, _ in parts] == [0.3333, 0.6667, 1.0]
    scene = state._scene("Bulge", 0.0, 20.0, 0.0, 72, preview=False)
    want = tcr.render_progressive(scene, device="cpu")
    np.testing.assert_array_equal(parts[-1][1], want)
    np.testing.assert_array_equal(parts[0][1][:32], want[:32])
    assert not parts[0][1][32:].any() and int(want[32:].sum()) > 0

    status, body = _get(tbase, "/skybox?galaxy=Bulge&size=8")
    assert status == 200
    montage = decode_png(body)
    assert montage.shape == (16, 24, 3)
    faces = tbatch.render_batch([j.scene for j in skybox_jobs(
        state._scene("Bulge", 0.0, 0.0, 0.0, 8, preview=False))],
        device="cpu")
    for i, f in enumerate(faces):
        r, c = divmod(i, 3)
        np.testing.assert_array_equal(
            montage[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8], f)
    assert _get(tbase, "/delgalaxy?galaxy=Bulge")[0] == 200


def test_cli_viewer_answers_the_page(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gamer_tpu_torch.cli", "viewer", "0", "16",
         str(tmp_path), "--device", "cpu"], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://127\.0\.0\.1:(\d+)/", line)
        assert m, line
        assert "16px preview" in line and "cpu" in line
        status, page = _get(f"http://127.0.0.1:{m.group(1)}", "/")
        assert status == 200 and page == tviewer._PAGE.encode()
    finally:
        proc.kill()
        proc.wait(TIMEOUT)
