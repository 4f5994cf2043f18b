"""``gamer_tpu_torch.dryrun`` against the repo's ``__graft_entry__.py``:
``entry()``'s frame step within 2 uint8 LSB of JAX's (the XLA-form march
against XLA's, the ladder's XLA step) on the same galaxy;
``dryrun_multichip`` passing rungs a-h on four CPU entries (the plain
march per entry) with its ticks in order; and a failing rung cancelling
the watchdog, which would otherwise end the process later.

JAX's entry step runs in a fresh process started with the module's first
test (``__graft_entry__`` imports jax and the Pallas modules).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gamer_tpu_torch import dryrun  # noqa: E402
from gamer_tpu_torch.scene import gax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LSB = 2
N_ENTRIES = 4
RUNGS = ["a: pixel-row sharding", "b: batch sharding",
         "c: row-slab sharding", "d: 2-D batch x rows mesh",
         "e: sharded fit step", "f: mesh-backed serve burst",
         "g: sharded DatasetJob resume", "h: sharded all-sky map"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_WORKER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import __graft_entry__ as ge
from gamer_tpu.scene import gax

fn, args = ge.entry()
img, _lin = jax.jit(fn)(*args)
galaxy = ge._spiral_scene(32).instances[0].galaxy
np.savez(sys.argv[1], img=np.asarray(img),
         gax=np.frombuffer(gax.dumps(galaxy), np.uint8))
print("JAX-ENTRY-OK")
"""


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = str(REPO) + (
        (":" + env["PYTHONPATH"]) if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture(autouse=True, scope="module")
def _jax_worker(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_entry")
    worker = tmp / "worker.py"
    worker.write_text(_JAX_WORKER)
    out = tmp / "entry.npz"
    log = tmp / "worker.log"
    with open(log, "w") as fh:
        # output to a file: a full pipe would stall the worker
        proc = subprocess.Popen([sys.executable, str(worker), str(out)],
                                stdout=fh, stderr=subprocess.STDOUT,
                                env=_env(JAX_PLATFORMS="cpu"), cwd=REPO)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def test_entry_frame_is_within_2_lsb_of_jax(_jax_worker):
    """entry(device="cpu") on the galaxy JAX's entry used: the frame step
    returns a (32, 32, 3) uint8 frame and its radiance, within 2 LSB of
    JAX's jitted step."""
    proc, out, log = _jax_worker
    proc.wait(timeout=600)
    assert proc.returncode == 0 and "JAX-ENTRY-OK" in log.read_text(), \
        log.read_text()[-4000:]
    with np.load(out) as z:
        ref, galaxy = z["img"], gax.loads(z["gax"].tobytes())
    fn, args = dryrun.entry(device="cpu", galaxy=galaxy)
    assert len(args) == 8 and all(
        t.device.type == "cpu" for t in args[1:])
    img, lin = fn(*args)
    assert img.dtype == torch.uint8 and img.shape == (32, 32, 3)
    assert lin.shape == (32, 32, 3) and bool(torch.isfinite(lin).all())
    got = img.numpy()
    assert int(got.sum()) > 0
    assert int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max()) \
        <= LSB
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun.entry()


def test_dryrun_passes_every_rung_on_cpu_entries(capsys):
    ticks = dryrun.dryrun_multichip(N_ENTRIES, budget_s=600,
                                    devices=["cpu"] * N_ENTRIES)
    assert list(ticks) == RUNGS
    times = list(ticks.values())
    assert times == sorted(times)
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("[dryrun] rung ")]
    assert [line.split(" done at ")[0][len("[dryrun] rung "):]
            for line in printed] == RUNGS


def test_dryrun_arguments():
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        dryrun.dryrun_multichip(3, budget_s=60, devices=["cpu"] * 2)
    assert dryrun.main([]) == 1
    assert dryrun.main(["2", "--device", "tpu"]) == 1


_FAILING_RUNG = """
import sys, time
from gamer_tpu_torch import dryrun

def broken(*a, **k):
    raise RuntimeError("injected fault in rung a")

dryrun.render_scene_sharded = broken
try:
    dryrun.dryrun_multichip(2, budget_s=2.0, devices=["cpu"] * 2)
except RuntimeError as e:
    print("rung failed:", e, flush=True)
time.sleep(5.0)  # past the budget: an armed watchdog would end the process
print("STILL-ALIVE", flush=True)
"""


def test_a_failing_rung_cancels_the_watchdog(tmp_path):
    r = subprocess.run([sys.executable, "-c", _FAILING_RUNG], env=_env(),
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "rung failed: injected fault in rung a" in r.stdout
    assert r.stdout.rstrip().endswith("STILL-ALIVE")
