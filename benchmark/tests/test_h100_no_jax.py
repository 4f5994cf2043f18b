"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level module name: the port, gamer_tpu_torch, is allowed), and
a machine without a card gets a clear refusal and no result."""

import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

IMPORT_ALL = r"""
import sys
from pathlib import Path
bench = Path(sys.argv[1])
sys.path[:0] = [str(bench), str(bench.parent)]
import run
from harness import cell, oracle, pixels, readers, trace, work
for d in ("generators", "metrics"):
    for f in sorted((bench / d).glob("*.py")):
        cell.load_module(f)
import gamer_tpu_torch.engine.cuda_render, gamer_tpu_torch.engine.batch
import gamer_tpu_torch.engine.queue
import gamer_tpu_torch.parallel.sharding
top = sorted({m.partition(".")[0] for m in sys.modules})
print("|".join(top))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_no_jax_after_importing_the_harness():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(BENCH)],
                         capture_output=True, text=True, check=True,
                         env=_env(), cwd=ROOT)
    top = set(out.stdout.strip().splitlines()[-1].split("|"))
    assert "gamer_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "gamer_tpu"}


def test_harness_modules_name_no_jax():
    """The harness's own sources name neither JAX nor the JAX package as a
    module (the reference must not lean on them)."""
    for f in BENCH.rglob("*.py"):
        if f.parent.name == "tests":
            continue
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].partition(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "gamer_tpu"), f


def test_no_card_no_result():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "spiral-galaxy.still4096", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert p.returncode != 0
    assert "no CPU fallback" in p.stderr
    for line in p.stdout.splitlines():
        assert not line.strip().startswith("{"), line


def test_unknown_cell_is_refused():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "no-such.cell", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=300)
    assert p.returncode == 2 and "no workload" in p.stderr
