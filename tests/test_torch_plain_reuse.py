"""What lets chip_smoke.py march each plain ray set once: a plain run with
``stats=`` gives the same radiance as one without (the smoke takes the
bound's work counts on its timed run), and the sharded plain versions
(``march_rowshard_plain``, ``march_batch_rowshard_plain``,
``march_rays_rowshard_plain``: the plain march per mesh entry, then the
gather) give the unsharded plain radiance on the same rays, so the smoke
holds the sharded kernels against the unsharded plain runs. All bit for
bit.

The plain march is elementwise per ray, so where each element of a torch
op is computed by the same code wherever it lies in its tensor, as on the
card, a ray's radiance does not depend on the other rays it is marched
with. Torch's CPU kernels compute a tensor's tail elements with scalar
code: a vectorized sine or exp against the scalar libm's, and
``pow(tensor, float)`` in double against float, each of which may round
a few rays' radiance 1 ulp apart (2 of the 192 rays at nside 4). So the
sharded comparisons run in a child process with torch's scalar CPU
kernels (ATEN_CPU_CAPABILITY=default) and the power's exponent as a
tensor, where every element takes the same code as on the card; the card
holds the same equalities at full size (tests/test_torch_cuda.py)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402

SIZE, NSIDE = 8, 4

CHILD = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
_pow = torch.pow


def pow_same_everywhere(x, e, *args, **kwargs):
    if isinstance(x, torch.Tensor) and not isinstance(e, torch.Tensor):
        e = torch.full_like(x, e)
    return _pow(x, e, *args, **kwargs)


torch.pow = pow_same_everywhere
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from gamer_tpu_torch.engine import cuda_render as cr
from gamer_tpu_torch.engine.allsky import allsky_dirs
from gamer_tpu_torch.engine.batch import _scene_groups
from gamer_tpu_torch.parallel import Mesh
from gamer_tpu_torch.scene.cameracontrols import orbit_path

size, nside = int(sys.argv[2]), int(sys.argv[3])
out = {}
scene = cs.spiral_scene(size)
page, table, _, _ = cr.prepare(scene, "cpu")
want = cr.march_plain(page, table, size)
for n in (2, 3, 4):
    got = cr.march_rowshard_plain(page, table, size, Mesh(["cpu"] * n))
    out[f"S1 on {n}"] = int((got.view(torch.int32)
                             != want.view(torch.int32)).sum())
fly = [dataclasses.replace(scene, camera=c)
       for c in orbit_path(scene.camera, 2, horizontal_deg=120.0)]
st, pages, _ = _scene_groups(fly)[0]
pages = torch.as_tensor(pages)
tab = torch.as_tensor(cr._build_table(st, cr._build_layout(st)))
want = cr.march_batch_plain(pages, tab, size)
for name, mesh in (("batch", Mesh(["cpu"] * 2, ("batch",))),
                   ("2x2", Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2)))):
    got = cr.march_batch_rowshard_plain(pages, tab, size, mesh)
    out[f"S2 on {name}"] = int((got.view(torch.int32)
                                != want.view(torch.int32)).sum())
sp, stb, _, _ = cr.prepare(cs.allsky_scene(), "cpu")
dirs = torch.as_tensor(allsky_dirs(nside))
want = cr.march_rays_plain(sp, stb, dirs)
for n in (3, 4):
    got = cr.march_rays_rowshard_plain(sp, stb, dirs, Mesh(["cpu"] * n))
    out[f"S3 on {n}"] = int((got.view(torch.int32)
                             != want.view(torch.int32)).sum())
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps each worker of the parallel test run at
    its own pace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharded():
    """{case: elements that differ from the unsharded plain run}, from one
    child process whose torch ops compute every element alike."""
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    r = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), str(SIZE),
                        str(NSIDE)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["S1 on 2", "S1 on 3", "S1 on 4",
                                  "S2 on batch", "S2 on 2x2", "S3 on 3",
                                  "S3 on 4"])
def test_sharded_plain_is_the_unsharded_plain(sharded, case):
    assert sharded[case] == 0


@pytest.mark.parametrize("form", ["frame", "band", "batch", "rays"])
def test_counting_changes_no_output(form):
    scene = cs.spiral_scene(SIZE)
    page, table, _, _ = cr.prepare(scene, "cpu")
    if form == "frame":
        def run(**kw):
            return cr.march_plain(page, table, SIZE, **kw)
    elif form == "band":
        def run(**kw):
            return cr.march_band_plain(page, table, SIZE, 4, 4, **kw)
    elif form == "batch":
        pages = torch.stack([page, page])

        def run(**kw):
            return cr.march_batch_plain(pages, table, SIZE, **kw)
    else:
        from gamer_tpu_torch.engine.allsky import allsky_dirs

        sp, stb, _, _ = cr.prepare(cs.allsky_scene(), "cpu")
        dirs = torch.as_tensor(allsky_dirs(NSIDE))

        def run(**kw):
            return cr.march_rays_plain(sp, stb, dirs, **kw)
    stats = {}
    counted = run(stats=stats)
    assert stats["samples"] > 0 and stats.get("raw_noise", 0) > 0
    assert torch.equal(counted.view(torch.int32), run().view(torch.int32))
