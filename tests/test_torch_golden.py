"""The spec oracle's 48x48 spiral frame stored in the port
(gamer_tpu_torch/data/oracle_spiral_48.npz), which chip_smoke.py holds the
CUDA kernel against: the file must equal a fresh ``render_oracle`` run, and
the port's plain march must meet the oracle tolerance on it.

Regenerate the file after a change to the oracle or the spiral preset:

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gamer_tpu_torch.golden import (  # noqa: E402
    ORACLE_GOLDEN,
    load_oracle_golden,
    oracle_scene,
)


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


def _oracle():
    import gamer_tpu
    from gamer_tpu.oracle.reference import render_oracle
    from gamer_tpu.scene.schema import scene_to_dict

    from gamer_tpu_torch.scene.schema import scene_to_dict as t_scene_to_dict

    scene = gamer_tpu.scene_from_dict(t_scene_to_dict(oracle_scene("spiral", 48)))
    assert scene_to_dict(scene) == t_scene_to_dict(oracle_scene("spiral", 48))
    img, tim = render_oracle(scene)
    return img, tim.samples, tim.pixels


def write() -> None:
    img, samples, pixels = _oracle()
    ORACLE_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(ORACLE_GOLDEN, image=img, samples=np.int64(samples),
                        pixels=np.int64(pixels))
    print(f"wrote {ORACLE_GOLDEN}: {img.shape}, {samples / pixels:.1f} "
          "samples/px")


def test_golden_is_the_oracle_frame():
    img, samples, pixels = _oracle()
    gold = load_oracle_golden()
    np.testing.assert_array_equal(gold["image"], img)
    assert (gold["samples"], gold["pixels"]) == (samples, pixels)
    assert gold["image"].shape == (48, 48, 3) and gold["image"].sum() > 0


def test_plain_march_meets_the_oracle_gate_on_the_golden():
    """The gate chip_smoke.py applies to the kernel (<= 3 LSB, < 5 % of
    pixels), here on the plain march."""
    import gamer_tpu_torch as gt

    gold = load_oracle_golden()["image"]
    ours = gt.render_scene(oracle_scene("spiral", 48), device="cpu")
    d = np.abs(ours.astype(np.int16) - gold.astype(np.int16))
    assert int(d.max()) <= 3
    assert float((d.max(-1) > 0).mean()) < 0.05


if __name__ == "__main__":
    write()
