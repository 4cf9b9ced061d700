"""render/gif.py: the GIF89a writer and block reader.

Pillow decodes what the port writes to exactly the palette-quantised
frames, with the frame count, the delay (round(100 / fps) centiseconds)
and the loop count as written; the frames are the renderers' and a frame
of random palette indices, whose LZW table fills and clears many times.
The port's own reader finds the same structure, and raises on a truncated
file. Writing 150 frames of 320 x 320 drawn by the renderers (hammer-v0)
takes 2.3 s on one core of an x86 host, 15 ms a frame: LZW is a Python
loop over the pixels, about 11 ms of it, and quantising about 4 ms; the
frames are mostly white and code to about 0.9 KB each. About 15 s in all
on one core.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from mjmpc_tpu_torch import envs, render
from mjmpc_tpu_torch.render import gif, raster

Image = pytest.importorskip("PIL.Image")
ImageSequence = pytest.importorskip("PIL.ImageSequence")

DEVICE = "cpu"   # the port defaults to the card; these tests run on the CPU


def _frames(name, n):
    env = envs.make(name, device=DEVICE)
    s = env.init(env.params, 0)
    rng = np.random.default_rng(0)
    qpos = s.qpos[None] + 0.2 * torch.as_tensor(rng.normal(size=(n,) + s.qpos.shape),
                                                dtype=s.qpos.dtype)
    st = dataclasses.replace(s, **{f.name: getattr(s, f.name)[None].expand(
        n, *getattr(s, f.name).shape) for f in dataclasses.fields(s)
        if isinstance(getattr(s, f.name), torch.Tensor)})
    return render.render_trajectory(env, [dataclasses.replace(st, qpos=qpos)])


def _decode(path):
    im = Image.open(path)
    frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
    return frames, im.info


@pytest.mark.parametrize("fps", [25, 10, 30])
def test_pillow_decodes_the_quantised_frames(tmp_path, fps):
    rng = np.random.default_rng(fps)
    noise = gif.PALETTE[rng.integers(0, len(gif.PALETTE), (320, 320))]
    off_palette = rng.integers(0, 256, (64, 320, 3)).astype(np.uint8)
    frames = _frames("door-v0", 3) + [noise] + _frames("HalfCheetah-v0", 2)
    frames.append(np.concatenate([frames[0][:256], off_palette]))
    path = gif.write_gif(str(tmp_path / "a.gif"), frames, fps=fps)
    decoded, info = _decode(path)
    assert len(decoded) == len(frames)
    for got, frame in zip(decoded, frames):
        np.testing.assert_array_equal(got, gif.PALETTE[gif.quantize(frame)])
    assert info["loop"] == 0 and info["duration"] == 10 * round(100 / fps)
    ours = gif.read_gif(path)
    assert ours == dict(width=320, height=320, loop=0, delays=[round(100 / fps)] * len(frames))


def test_quantize_keeps_palette_colours_and_takes_the_nearest():
    pal = gif.PALETTE
    exact = pal[np.arange(len(pal))][None]
    idx = gif.quantize(exact)
    np.testing.assert_array_equal(pal[idx], exact)
    assert gif.quantize(np.array([[[250, 252, 251], [2, 1, 0]]], np.uint8)).tolist() == [
        [gif.quantize(np.array([[[255, 255, 255]]], np.uint8))[0, 0],
         gif.quantize(np.array([[[0, 0, 0]]], np.uint8))[0, 0]]]
    assert set(map(tuple, raster.palette_colors())) <= set(map(tuple, pal.tolist()))


def test_150_frames_write_and_read_back(tmp_path):
    frames = _frames("hammer-v0", 5) * 30
    t0 = time.perf_counter()
    path = gif.write_gif(str(tmp_path / "b.gif"), frames, fps=25)
    seconds = time.perf_counter() - t0
    info = gif.read_gif(path)
    assert len(info["delays"]) == 150 and set(info["delays"]) == {4}
    assert seconds < 60.0
    decoded, _ = _decode(path)
    np.testing.assert_array_equal(decoded[-1], gif.PALETTE[gif.quantize(frames[-1])])


def test_read_gif_rejects_a_truncated_or_foreign_file(tmp_path):
    path = gif.write_gif(str(tmp_path / "c.gif"), [np.full((8, 8, 3), 255, np.uint8)] * 2)
    data = open(path, "rb").read()
    (tmp_path / "short.gif").write_bytes(data[:-5])
    with pytest.raises(ValueError, match="truncated"):
        gif.read_gif(str(tmp_path / "short.gif"))
    (tmp_path / "png.gif").write_bytes(b"\x89PNG" + data[4:])
    with pytest.raises(ValueError, match="not a GIF"):
        gif.read_gif(str(tmp_path / "png.gif"))
    with pytest.raises(ValueError):
        gif.write_gif(str(tmp_path / "none.gif"), [])
