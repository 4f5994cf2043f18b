"""chip_smoke.py's CPU references run in worker processes (``CpuRefs``,
one torch thread each) while the card works: a worker's result must be
the one the calling process computes itself, bit for bit, for the plain
march, a fit and a sharded fit with its SGD probe's gradients."""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine.render import render_scene  # noqa: E402

SIZE = 8


def test_workers_compute_what_the_caller_computes():
    scene = cs.spiral_scene(SIZE)
    page, table, size, _ = cr.prepare(scene, "cpu")
    target = render_scene(scene, device="cpu")
    strong = cs.scaled(scene, "strength", 1.5)
    fits = {
        ("fit", "frozen"): ("fit_scene", (strong, target),
                            dict(steps=1, march="frozen")),
        ("mesh", "fit_scene", 2): ("fit_scene", (strong, target,
                                                 ("strength",)),
                                   dict(steps=1, lr=5e-2)),
    }
    refs = cs.CpuRefs(workers=2)
    try:
        refs.submit("plain", cr.march_plain, page, table, size)
        for key, (name, args, kw) in fits.items():
            refs.submit(key, cs.run_fit, key, name, args, kw)
        assert torch.equal(refs.get("plain"),
                           cr.march_plain(page, table, size))
        for key, (name, args, kw) in fits.items():
            got, want = refs.get(key), cs.run_fit(key, name, args, kw)
            assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
            if key[0] == "mesh":
                assert all(np.array_equal(g, w)
                           for g, w in zip(got[1][0], want[1][0]))
                assert want[1][0]
            else:
                assert got[1] is None
    finally:
        refs.close()
