"""The port's PNG decoder (``gamer_tpu_torch.io.png.decode_png``, how the
CLI reads a fit target without PIL) against PIL, and the CLI ``fit`` on
the CPU with every ``march=``.

The decoder is exact: every filter type (None, Sub, Up, Average, Paeth)
and colour type (greyscale, RGB, RGBA) decodes to PIL's pixels.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import gamer_tpu_torch as gt  # noqa: E402
from gamer_tpu_torch import cli  # noqa: E402
from gamer_tpu_torch.engine import batch as tbatch  # noqa: E402
from gamer_tpu_torch.engine.render import render_scene  # noqa: E402
from gamer_tpu_torch.io.png import decode_png, read_png, write_png  # noqa: E402
from gamer_tpu_torch.scene import gax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode(px: np.ndarray, ctype: int, ftype: int, depth: int = 8,
            interlace: int = 0) -> bytes:
    """A PNG of ``px`` (H, W, C) with every row filtered by ``ftype``."""
    h, w, c = px.shape
    bpp = c
    raw = bytearray()
    prev = [0] * (w * c)
    for y in range(h):
        row = [int(v) for v in px[y].reshape(-1)]
        out = []
        for x, v in enumerate(row):
            a = row[x - bpp] if x >= bpp else 0
            b = prev[x]
            cc = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, cc))[ftype]
            out.append((v - pred) & 0xFF)
        raw += bytes([ftype]) + bytes(out)
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def _image(channels: int) -> np.ndarray:
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (7, 11, channels), dtype=np.uint8)
    px[:, :4] = np.arange(4, dtype=np.uint8)[None, :, None] * 60  # ramps
    return px


@pytest.mark.parametrize("ctype", [0, 2, 6])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_png_matches_pil(ctype, ftype):
    px = _image({0: 1, 2: 3, 6: 4}[ctype])
    data = _encode(px, ctype, ftype)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (7, 11, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_decode_png_reads_pil_files(mode, tmp_path):
    """PIL's own files (its adaptive filters and chunking), and the port's
    writer, round trip."""
    px = _image(3)
    src = Image.fromarray(px).convert(mode)
    path = tmp_path / "x.png"
    src.save(path, optimize=True)
    np.testing.assert_array_equal(read_png(path),
                                  np.asarray(src.convert("RGB")))
    write_png(tmp_path / "y.png", px)
    np.testing.assert_array_equal(read_png(tmp_path / "y.png"), px)


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced",
                                  "not a png"])
def test_decode_png_rejects_what_it_does_not_read(kind):
    px = _image(3)
    data = {"16-bit": lambda: _encode(px, 2, 0, depth=16),
            "palette": lambda: _encode(px[..., :1], 3, 0),
            "interlaced": lambda: _encode(px, 2, 0, interlace=1),
            "not a png": lambda: b"GIF89a" + bytes(40)}[kind]()
    with pytest.raises(ValueError):
        decode_png(data)


FIT_SIZE = 8
CAMERA = ["0.5", "0", "0", "0", "0", "0", "0", "1", "0", "90", "1", "1", "1",
          "0.025"]


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A two-component galaxy's target PNG (full-render sampling, as the
    CLI fits it) and the galaxy with its strengths scaled by 1.3."""
    tmp = tmp_path_factory.mktemp("cli_fit")
    g = gt.default_galaxy(2)
    scene = gt.Scene(
        camera=gt.CameraParams(camera=(0.5, 0, 0), target=(0, 0, 0),
                               up=(0, 1, 0), fov=90.0),
        instances=[gt.GalaxyInstance(galaxy=g)],
        config=gt.RenderConfig(size=FIT_SIZE, ray_step=0.025))
    write_png(tmp / "target.png", render_scene(scene, device="cpu"))
    for c in g.components:
        c.strength *= 1.3
    gax.save(g, tmp / "start.gax")
    return tmp


def _fit(tmp, *extra):
    return cli.main(["fit", *CAMERA, str(tmp / "start.gax"),
                     str(tmp / "target.png"), str(tmp / "out.gax"), *extra,
                     "--device", "cpu"])


@pytest.mark.parametrize("march", ["tensor", "scan", "frozen", "fd"])
def test_cli_fit_on_cpu(march, cli_files, capsys):
    out = cli_files / "out.gax"
    out.unlink(missing_ok=True)
    assert _fit(cli_files, "1", "0.05", "strength", f"march={march}") == 0
    printed = capsys.readouterr().out
    assert f"march={march}" in printed and "Saved fitted galaxy" in printed
    start = gax.load(cli_files / "start.gax")
    fitted = gax.load(out)
    assert [c.strength for c in fitted.components] != \
        [c.strength for c in start.components]
    assert [c.r0 for c in fitted.components] == \
        [c.r0 for c in start.components]


def test_cli_fit_fd_is_one_batch_per_step(cli_files, monkeypatch):
    """march=fd renders each step's probes as one render_batch_linear call
    (one K4 launch on the card), plus one for the last iterate."""
    calls = []
    real = tbatch.render_batch_linear

    def spy(scenes, *a, **k):
        calls.append(len(scenes))
        return real(scenes, *a, **k)

    monkeypatch.setattr(tbatch, "render_batch_linear", spy)
    assert _fit(cli_files, "2", "0.05", "strength", "march=fd") == 0
    assert calls == [5, 5, 5]  # 2 components: the point and 2 x 2 probes


def test_cli_fit_multiscale_and_checkpoint(cli_files, capsys):
    ckpt = cli_files / "fit.ckpt"
    assert _fit(cli_files, "1", "0.05", "strength", "march=frozen",
                f"ckpt={ckpt}", "multiscale") == 0
    assert "[ step 3/3 ]" in capsys.readouterr().out
    assert (cli_files / "fit.ckpt.rung2").exists()


@pytest.mark.parametrize("extra", [
    ("1", "0.05", "strength", "march=tensor", "sweep=3"),
    ("1", "0.05", "strength", "march=fd", "multiscale"),
    ("1", "0.05", "strength", "march=adjoint"),
    ("0",),
])
def test_cli_fit_usage_errors(extra, cli_files):
    assert _fit(cli_files, *extra) == 1


def test_cli_fit_needs_a_card_for_cuda(cli_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda path is the card's test")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["fit", *CAMERA, str(cli_files / "start.gax"),
                  str(cli_files / "target.png"), str(cli_files / "o.gax"),
                  "1"])
