"""The port's animated GIF (gamer_tpu_torch/io/gif.py, a stdlib GIF89a
writer: one median-cut palette for all frames, LZW, a frame delay, loop
0) and the CLI's ``flythrough`` and ``morph``, which write <prefix>.gif
beside the PNG frames as gamer_tpu/cli.py does with PIL. The files are
decoded with PIL: the frames are the PNG frames mapped through the chosen
palette, the palette stays within a few LSB of the frames (no worse than
PIL's own adaptive palette on noise), and the CLI's GIFs have the frame
count, delays, loop and pictures of gamer_tpu's on the same .gax files."""

from __future__ import annotations

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from gamer_tpu import cli as jcli  # noqa: E402

from gamer_tpu_torch import cli  # noqa: E402
from gamer_tpu_torch.io import gif  # noqa: E402
from gamer_tpu_torch.io.png import decode_png  # noqa: E402
from gamer_tpu_torch.models import presets  # noqa: E402
from gamer_tpu_torch.scene import gax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps each worker of the parallel test run at
    its own pace (the CLI renders through the plain march here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pil_frames(data: bytes):
    """(frames, per-frame durations in ms, loop) as PIL decodes them."""
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return frames, durations, im.info.get("loop")


def _through_palette(frames):
    palette, indices = gif.quantize(frames)
    return [palette[i] for i in indices]


def _error(got, want):
    return np.abs(got.astype(np.int32) - want.astype(np.int32))


def _pil_gif_error(frame):
    """The error of PIL's own GIF (its adaptive palette) on ``frame``."""
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "GIF")
    return _error(_pil_frames(buf.getvalue())[0][0], frame)


@pytest.mark.parametrize("shape, n", [((1, 1, 3), 1), ((8, 8, 3), 3),
                                      ((37, 53, 3), 2), ((160, 160, 3), 2)])
def test_random_frames_decode_to_the_palette_mapping(shape, n):
    """Noise frames: thousands of colours, so the LZW table fills and is
    cleared (160^2), odd sizes, one pixel."""
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    data = gif.encode_gif(frames, 80)
    want = _through_palette(frames)
    got, durations, loop = _pil_frames(data)
    assert len(got) == n and durations == [80] * n and loop == 0
    many = len(np.unique(np.concatenate(frames).reshape(-1, 3), axis=0)) > 256
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        # past 256 colours no worse than PIL's palette; below, each colour
        # within its 8-LSB bin
        if many:
            assert _error(g, f).mean() <= _pil_gif_error(f).mean()
        else:
            assert _error(g, f).max() < 8


def test_many_colours_stay_close():
    """Smooth gradients, 16,384 colours a frame in three frames: one
    256-entry palette keeps every pixel within 8 LSB a channel and the
    mean within 4 (PIL's adaptive palette: 3.59 mean, 16 max here)."""
    x = np.arange(128)
    frame = np.stack(np.broadcast_arrays(2 * x[None, :], 2 * x[:, None],
                                         x[None, :] + x[:, None]),
                     axis=-1).astype(np.uint8)
    frames = [frame, frame[::-1], frame[:, ::-1]]
    got, _, _ = _pil_frames(gif.encode_gif(frames, 80))
    for g, f in zip(got, frames):
        err = _error(g, f)
        assert err.max() <= 8 and err.mean() < 4, (err.max(), err.mean())


def test_few_colours_are_kept_exactly():
    """At most 256 distinct colours, each its own 15-bit bin: the palette
    holds them all and the frames come back unchanged."""
    colours = np.arange(0, 256, 8, dtype=np.uint8)
    a = np.stack(np.meshgrid(colours, colours[::-1], indexing="ij"), -1)
    frame = np.concatenate([a, a[..., :1]], axis=-1)  # 32 x 32, 1024 px
    frame = frame[:, :8]  # 256 colours
    got, _, _ = _pil_frames(gif.encode_gif([frame, frame[::-1]], 120))
    np.testing.assert_array_equal(got[0], frame)
    np.testing.assert_array_equal(got[1], frame[::-1])


def test_refuses_mixed_sizes_and_no_frames():
    with pytest.raises(ValueError):
        gif.encode_gif([], 80)
    with pytest.raises(ValueError):
        gif.encode_gif([np.zeros((4, 4, 3), np.uint8),
                        np.zeros((4, 5, 3), np.uint8)], 80)


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    gax.save(presets.spiral(), "spiral.gax")
    gax.save(presets.spiral(winding_n=6.0, winding_b=0.8), "wound.gax")
    return tmp_path


@pytest.mark.parametrize("argv, prefix, frames, delay", [
    (["flythrough", "spiral.gax", "3", "8", "fly"], "fly", 3, 80),
    (["morph", "spiral.gax", "wound.gax", "2", "8", "mo"], "mo", 2, 120),
])
def test_cli_writes_the_gif(work, capsys, argv, prefix, frames, delay):
    """The CLI at 8^2 on the CPU: <prefix>.gif beside the PNG frames, each
    frame the PNG through the palette (within 8 LSB a channel, 2 on the
    mean: the frames hold fewer colours than the palette), the command's
    delay, loop 0; and gamer_tpu's command on the same .gax files writes a
    GIF of the same frame count, size, delays and loop, whose frames are
    the port's within 2 LSB on the mean."""
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert f"{prefix}.gif" in capsys.readouterr().out
    pngs = [decode_png((work / f"{prefix}_{i:03d}.png").read_bytes())
            for i in range(frames)]
    data = (work / f"{prefix}.gif").read_bytes()
    assert data[:6] == b"GIF89a"
    got, durations, loop = _pil_frames(data)
    assert durations == [delay] * frames and loop == 0
    for g, w, png in zip(got, _through_palette(pngs), pngs):
        np.testing.assert_array_equal(g, w)
        err = _error(g, png)
        assert err.max() < 8 and err.mean() <= 2, (err.max(), err.mean())
    # gamer_tpu's command (its handler: main also sets up jax's compile
    # cache) on the same files, writing j<prefix>.gif
    assert jcli.COMMANDS[argv[0]](argv[:-1] + [f"j{prefix}"]) == 0
    want, want_durations, want_loop = _pil_frames(
        (work / f"j{prefix}.gif").read_bytes())
    assert len(want) == len(got) == frames
    assert want_durations == durations and want_loop == loop
    for g, w in zip(got, want):
        assert g.shape == w.shape and _error(g, w).mean() <= 2
