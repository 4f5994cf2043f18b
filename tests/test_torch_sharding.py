"""The sharded launches on the CPU: ``render_scene(mesh=)`` (S1) against
the port's unsharded frame and against ``gamer_tpu.parallel``'s row-sharded
Pallas frame on the 8 virtual devices, the mesh type, ``host_shard`` and a
two-process ``torch.distributed`` job.

On ``Mesh(["cpu"] * n)`` every entry runs the plain march on its dealt
tile rows.
Tolerances: <= 1 uint8 LSB between the port's sharded and unsharded frames
(torch's vector and scalar CPU paths may round an element differently when
the tensor shapes differ), <= 2 LSB against the interpreted Pallas kernel
(the conformance ladder's kernel tolerance).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu import parallel as jparallel  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch import parallel as tparallel  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.parallel import HostTopology, Mesh  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain march runs thousands of small torch ops. Under the
    parallel test run, each op's thread-pool region waits on threads that
    the other workers' load has descheduled: a 40^2 frame took ~40x as
    long. One intra-op thread keeps each worker at its own pace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size, **cfg):
    cfg.setdefault("ray_step", 0.025)
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=[gamer_tpu.GalaxyInstance(galaxy=presets.spiral())],
        config=gamer_tpu.RenderConfig(size=size, **cfg))


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.fixture(scope="module")
def unsharded_40():
    return gt.render_scene(_scene(40, ray_step=0.1), device="cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_rowshard_matches_unsharded(n, unsharded_40):
    """Size 40 is 10 tile rows, dealt i, i + n, ...: on 3 entries the
    first owns four, on 8 the first two own two and the others one."""
    frame = gt.render_scene(_scene(40, ray_step=0.1), mesh=Mesh(["cpu"] * n))
    assert frame.shape == (40, 40, 3) and frame.dtype == np.uint8
    assert int(frame[32:].sum()) > 0
    assert _max_diff(frame, unsharded_40) <= 1


def test_rowshard_slab_geometry_is_the_jax_one():
    """The JAX package cuts a frame into slabs of a whole number of tile
    heights (pallas_render.py:1157-1160); S1 and S2 deal tile rows
    instead: S1's plain frame of a size that does not tile is each entry's
    strips placed at their rows."""
    page, table, size, _ = cr.prepare(_scene(40, ray_step=0.2), "cpu")
    whole = cr.march_plain(page, table, size)
    placed = torch.zeros_like(whole).view(size // cr.TILE_H, cr.TILE_H,
                                          size, 3)
    for i in range(2):  # entries on the CPU are dealt as two cards
        placed[i::2] = cr.march_dealt_plain(page, table, size, i, 2,
                                            5).view(-1, cr.TILE_H, size, 3)
    sharded = cr.march_rowshard_plain(page, table, size, Mesh(["cpu"] * 2))
    torch.testing.assert_close(sharded, placed.view(size, size, 3), rtol=0,
                               atol=0)
    torch.testing.assert_close(sharded, whole, rtol=1e-5, atol=1e-6)
    assert cr.march_rowshard.launch_count == 0  # no kernel on the CPU


def test_rowshard_supersample_pools_after_assembly():
    """supersample=2 at size 20 marches 40 rows: 10 tile rows dealt over 3
    entries, pooled once the frame is whole; stars go on after that."""
    scene = _scene(20, ray_step=0.1, supersample=2, no_stars=30, star_seed=5)
    frame = gt.render_scene(scene, mesh=Mesh(["cpu"] * 3))
    assert frame.shape == (20, 20, 3)
    assert _max_diff(frame, gt.render_scene(scene, device="cpu")) <= 1


def test_rowshard_matches_jax_sharded_frame():
    """S1 against ``gamer_tpu.parallel.render_scene_sharded`` (the Pallas
    kernel, interpreted, under ``shard_map`` over the 8 virtual devices)."""
    scene = _scene(16)
    ref = jparallel.render_scene_sharded(scene, jparallel.make_pixel_mesh())
    ours = tparallel.render_scene_sharded(
        scene, tparallel.make_pixel_mesh(["cpu"] * 8))
    assert ours.shape == ref.shape == (16, 16, 3) and int(ours.sum()) > 0
    assert _max_diff(ours, ref) <= 2


def test_render_scene_sharded_arguments():
    scene = _scene(8, ray_step=0.2)
    mesh = Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        tparallel.render_scene_sharded(scene, Mesh(["cpu"] * 3),
                                       method="xla")
    with pytest.raises(ValueError, match="float32"):
        tparallel.render_scene_sharded(scene, mesh, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown sharded method"):
        tparallel.render_scene_sharded(scene, mesh, method="omp")
    with pytest.raises(ValueError, match="1-D mesh"):
        gt.render_scene(scene, mesh=Mesh(["cpu"] * 4, ("batch", "rows"),
                                         (2, 2)))
    with pytest.raises(RuntimeError, match="cuda"):
        tparallel.make_pixel_mesh()  # no card here, and no quiet CPU mesh
    with pytest.raises(RuntimeError, match="is_available"):
        gt.render_scene(scene, mesh=Mesh(["cuda:0"] * 2))


def test_mesh_is_an_ordered_hashable_device_list():
    a = Mesh(["cpu"] * 4, ("batch", "rows"), (2, 2))
    b = Mesh(("cpu", "cpu", "cpu", "cpu"), ("batch", "rows"), (2, 2))
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a.size == 4 and a.axis_size("rows") == 2
    assert a.index(batch=1, rows=0) == 2 and a.stream(3) is None
    assert a != Mesh(["cpu"] * 4)
    one = Mesh(["cuda"] * 2)  # naming a card does not touch it
    assert one.devices == (torch.device("cuda", 0),) * 2
    assert one.axis_names == ("px",) and one.shape == (2,)
    with pytest.raises(ValueError, match="does not hold"):
        Mesh(["cpu"] * 3, ("batch", "rows"), (2, 2))
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])


def test_global_batch_mesh_and_2d_mesh():
    m = tparallel.global_batch_mesh(devices=["cpu"] * 8)
    assert m.size == 8 and m.axis_names == ("batch",)
    m2 = tparallel.pixel_tile_mesh_2d(rows_axis=4, devices=["cpu"] * 8)
    assert m2.shape == (2, 4) and m2.axis_names == ("batch", "rows")
    with pytest.raises(ValueError, match="not divisible"):
        tparallel.pixel_tile_mesh_2d(rows_axis=3, devices=["cpu"] * 8)


def test_init_distributed_single_process_noop():
    topo = tparallel.init_distributed()
    assert topo.process_count == 1 and topo.process_index == 0
    assert topo.local_devices == topo.global_devices == 1
    import torch.distributed as dist

    assert not dist.is_initialized()


@pytest.mark.parametrize("hosts", [1, 2, 3, 8])
def test_host_shard_matches_jax(hosts):
    """Ordered, complete, balanced, no dropped remainder, and the blocks
    ``gamer_tpu.parallel.distributed.host_shard`` gives."""
    from gamer_tpu.parallel import HostTopology as JTopology
    from gamer_tpu.parallel.distributed import host_shard as jhost_shard

    items = list(range(23))
    shards = [tparallel.host_shard(items, HostTopology(i, hosts, 1, hosts))
              for i in range(hosts)]
    assert [x for s in shards for x in s] == items
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    assert shards == [jhost_shard(items, JTopology(i, hosts, 1, hosts))
                      for i in range(hosts)]


def test_two_process_gloo_job(tmp_path):
    """init_distributed / host_shard through a real 2-process
    torch.distributed job (gloo): both join a coordinator on localhost,
    see the global device count, and take their contiguous halves. The
    workers run in the environment in which ``gamer_tpu`` would import
    jax, and import neither."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import json, sys\n"
        "from gamer_tpu_torch.parallel import host_shard, init_distributed\n"
        "pid, port = int(sys.argv[1]), sys.argv[2]\n"
        "topo = init_distributed('127.0.0.1:' + port, num_processes=2,\n"
        "                        process_id=pid, backend='gloo')\n"
        "shard = host_shard(list(range(11)), topo)\n"
        "import torch.distributed as dist\n"
        "dist.barrier()\n"
        "dist.destroy_process_group()\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'gamer_tpu'))\n"
        "print(json.dumps({'pid': topo.process_index,\n"
        "                  'procs': topo.process_count,\n"
        "                  'global': topo.global_devices,\n"
        "                  'shard': shard, 'loaded': loaded}))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed: {err[-2000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs.sort(key=lambda o: o["pid"])
    assert [o["pid"] for o in outs] == [0, 1]
    assert all(o["procs"] == 2 and o["global"] == 2 for o in outs)
    assert outs[0]["shard"] + outs[1]["shard"] == list(range(11))
    assert all(o["loaded"] == [] for o in outs)
