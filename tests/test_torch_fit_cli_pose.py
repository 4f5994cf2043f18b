"""The CLI ``fitpose`` (noise LOD, ``multiscale``, ``fd``) and ``fitjoint``
(``pose=fd``, ``pose=multiscale``) of the port on the CPU: each writes
the library call's fitted scene (and for fitjoint its galaxy), bit for
bit, and answers bad arguments as ``gamer_tpu.cli`` does
(gamer_tpu/cli.py:572-762).

The galaxy is the default galaxy's bulge at 8^2: fd steps render 7 probe
frames each through the plain march, and fitjoint fits at full sampling
(min step 0.001), as the JAX CLI does.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu import cli as jcli  # noqa: E402
from gamer_tpu_torch import cli  # noqa: E402
from gamer_tpu_torch.engine import batch as tbatch  # noqa: E402
from gamer_tpu_torch.engine import fit as tfit  # noqa: E402
from gamer_tpu_torch.io.png import read_png, write_png  # noqa: E402
from gamer_tpu_torch.scene import gax  # noqa: E402
from gamer_tpu_torch.scene.schema import scene_to_dict  # noqa: E402

SIZE = 8
START = ["0.52", "0.01", "0", "0", "0", "0", "0", "1", "0", "90", "1", "1",
         "1", "0.025"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(cam, **cfg):
    g = gt.default_galaxy(1)
    return gt.Scene(
        camera=gt.CameraParams(camera=cam, target=(0, 0, 0), up=(0, 1, 0),
                               fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=g)],
        config=gt.RenderConfig(size=SIZE, ray_step=0.025, **cfg))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The bulge's target PNG from (0.5, 0, 0), and the bulge at 0.6 x its
    strength as the start .gax."""
    tmp = tmp_path_factory.mktemp("cli_pose")
    write_png(tmp / "target.png",
              gt.render_scene(_scene((0.5, 0, 0)), device="cpu"))
    g = gt.default_galaxy(1)
    g.components[0].strength *= 0.6
    gax.save(g, tmp / "start.gax")
    return tmp


def _run(command, tmp, *extra, device=("--device", "cpu")):
    return cli.main([command, *START, str(tmp / "start.gax"),
                     str(tmp / "target.png"), str(tmp / "out.json"), *extra,
                     *device])


def _start(tmp, **cfg):
    s = _scene((0.52, 0.01, 0.0), **cfg)
    s.instances[0].galaxy = gax.load(tmp / "start.gax")
    return s


@pytest.mark.parametrize("mode", ["2", "multiscale", "fd"])
def test_cli_fitpose_is_the_library_call(mode, files, capsys, monkeypatch):
    """fitpose at noise LOD 2 (fit_pose), 'multiscale'
    (fit_pose_multiscale) and 'fd' (fit_pose_fd: one render_batch_linear
    call of 7 frames a step, one K4 launch each on the card)."""
    calls = []
    real = tbatch.render_batch_linear

    def spy(scenes, *a, **k):
        calls.append(len(scenes))
        return real(scenes, *a, **k)

    monkeypatch.setattr(tbatch, "render_batch_linear", spy)
    (files / "out.json").unlink(missing_ok=True)
    assert _run("fitpose", files, "1", "0.01", mode) == 0
    printed = capsys.readouterr().out
    assert "Saved fitted scene" in printed and "fitted camera" in printed
    got = json.loads((files / "target.png").parent.joinpath(
        "out.json").read_text())
    target = read_png(files / "target.png")
    kw = dict(steps=1, lr=1e-2, device="cpu")
    if mode == "fd":
        assert calls == [7, 7]
        lib = tfit.fit_pose_fd(_start(files, is_preview=True), target,
                               ("camera",), **kw)
    elif mode == "multiscale":
        lib = tfit.fit_pose_multiscale(_start(files, is_preview=True),
                                       target, ("camera",), **kw)
    else:
        lib = tfit.fit_pose(_start(files, is_preview=True, noise_octaves=2),
                            target, ("camera",), **kw)
    assert got == json.loads(json.dumps(scene_to_dict(lib.scene)))
    assert got["camera"]["camera"] != [0.52, 0.01, 0.0]


@pytest.mark.parametrize("pose", ["fd", "multiscale"])
def test_cli_fitjoint_is_the_library_call(pose, files, capsys):
    """fitjoint pose=fd / pose=multiscale: the fitted scene and the fitted
    galaxy (<out>.gax) of fit_joint at full sampling."""
    out = files / "out.json"
    out.unlink(missing_ok=True)
    ckpt = files / f"joint_{pose}.ckpt"
    assert _run("fitjoint", files, "1", "1", "1", f"pose={pose}",
                "fields=strength", "march=frozen", f"ckpt={ckpt}") == 0
    printed = capsys.readouterr().out
    assert f"pose={pose}" in printed and "fitted galaxy" in printed
    lib = tfit.fit_joint(_start(files), read_png(files / "target.png"),
                         ("strength",), rounds=1, pose_steps=1,
                         scene_steps=1, march="frozen", pose_method=pose,
                         device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        scene_to_dict(lib.scene)))
    fitted = gax.load(files / "out.gax")
    assert fitted.components[0].strength == \
        lib.scene.instances[0].galaxy.components[0].strength
    assert (files / f"joint_{pose}.ckpt.r0.scene").exists()


def _jax_run(command, tmp, *extra):
    return jcli.main([command, *START, str(tmp / "start.gax"),
                      str(tmp / "target.png"), str(tmp / "out.json"),
                      *extra])


@pytest.mark.parametrize("command,extra", [
    ("fitpose", ("1", "0.01", "3", "9")),        # one argument too many
    ("fitpose", ("0",)),                          # steps < 1
    ("fitjoint", ("1", "1", "1", "9")),
    ("fitjoint", ("0", "1", "1")),                # rounds < 1
    ("fitjoint", ("1", "0", "1", "pose=fd")),     # posesteps < 1
])
def test_cli_pose_usage_errors_match_jax(command, extra, files, capsys):
    """The same exit code and the same message as the JAX package's CLI
    (its first two lines: the usage text that follows names each
    package's own commands)."""
    assert _run(command, files, *extra) == 1
    ours = capsys.readouterr().out.splitlines()
    assert _jax_run(command, files, *extra) == 1
    theirs = capsys.readouterr().out.splitlines()
    # the JAX CLI greets first ("Welcome to gamer-tpu ...", a blank line)
    assert theirs[0].startswith("Welcome to") and theirs[1] == ""
    assert ours[:2] == theirs[2:4]


def test_cli_pose_non_square_target(files, capsys):
    write_png(files / "wide.png", np.zeros((4, 8, 3), np.uint8))
    for command in ("fitpose", "fitjoint"):
        rc = cli.main([command, *START, str(files / "start.gax"),
                       str(files / "wide.png"), str(files / "o.json"),
                       "--device", "cpu"])
        assert rc == 1
        assert capsys.readouterr().out.strip() == \
            f"{command}: target image must be square"


def test_cli_pose_needs_a_card_for_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path is the card's test")
    with pytest.raises(RuntimeError, match="cuda"):
        _run("fitpose", files, "1", "0.01", "fd", device=())
    with pytest.raises(RuntimeError, match="cuda"):
        _run("fitjoint", files, "1", "1", "1", "pose=fd", device=())
