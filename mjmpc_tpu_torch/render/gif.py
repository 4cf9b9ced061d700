"""A GIF89a writer and block reader by hand, in numpy.

The JAX package writes its videos with imageio: an mp4 through ffmpeg,
or a GIF where that fails (mjmpc_tpu/render/render.py dump_videos). The
port writes the GIF: one global colour table (PALETTE: the 7-bit palette
that holds every colour a frame of render/raster.py can have), the
NETSCAPE2.0 loop extension (loop forever, as imageio writes it), and per
frame a graphic control extension with the delay round(100 / fps)
centiseconds (imageio's duration=1000/fps ms) and a full-frame image
whose indices are LZW-coded: real LZW, variable code width from 8 to 12
bits, a clear code when the table is full. The coder is a Python loop
over the pixels: about 11 ms for a 320 x 320 frame on one x86 core, and
the renderers' mostly white frames code to about 1 KB each (the
byte-aligned uncompressed form would take no loop but about 100 KB a
frame).

read_gif walks the blocks of a file and returns its screen size, loop
count and one delay per image descriptor, without decoding the images:
a check of a file's structure that needs no imaging library.
"""
from __future__ import annotations

import struct
from typing import Dict, Sequence

import numpy as np

from . import raster

PALETTE_BITS = 7


def _palette() -> np.ndarray:
    colors = raster.palette_colors()
    levels = (0, 85, 170, 255)                # a 4x4x4 cube for any other colour
    colors += [c for c in ((r, g, b) for r in levels for g in levels for b in levels)
               if c not in colors]
    size = 1 << PALETTE_BITS
    if len(colors) > size:
        raise ValueError(f"{len(colors)} colours do not fit a {size}-entry palette")
    colors += [(0, 0, 0)] * (size - len(colors))
    return np.asarray(colors, np.uint8)


PALETTE = _palette()
_PALETTE_KEYS = {int(r) << 16 | int(g) << 8 | int(b): i
                 for i, (r, g, b) in reversed(list(enumerate(PALETTE)))}


def quantize(frame: np.ndarray) -> np.ndarray:
    """A [H, W, 3] uint8 frame as [H, W] palette indices: a colour of the
    palette maps to its own entry, any other to the nearest."""
    rgb = frame.astype(np.int64)
    keys = rgb[..., 0] << 16 | rgb[..., 1] << 8 | rgb[..., 2]
    uniq, inverse = np.unique(keys, return_inverse=True)
    idx = np.empty(len(uniq), np.uint8)
    pal = PALETTE.astype(np.int64)
    for j, k in enumerate(uniq.tolist()):
        hit = _PALETTE_KEYS.get(k)
        if hit is None:
            c = np.array([k >> 16, (k >> 8) & 255, k & 255])
            hit = int(np.argmin(((pal - c) ** 2).sum(1)))
        idx[j] = hit
    return idx[inverse].reshape(frame.shape[:2])


def lzw_encode(indices: np.ndarray, min_code_size: int = PALETTE_BITS) -> bytes:
    """GIF's variable-width LZW of a flat index stream, codes packed
    least significant bit first."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    data = indices.ravel().tolist()
    codes, widths = [clear], [min_code_size + 1]
    width, next_code, table = min_code_size + 1, eoi + 1, {}
    prefix = data[0]
    for px in data[1:]:
        key = prefix << 8 | px
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < 4096:
            table[key] = next_code
            if next_code == 1 << width:      # the decoder widens after this entry
                width += 1
            next_code += 1
        else:
            codes.append(clear)
            widths.append(width)
            width, next_code, table = min_code_size + 1, eoi + 1, {}
        prefix = px
    codes += [prefix, eoi]
    widths += [width, width]
    codes_a, widths_a = np.asarray(codes, np.int64), np.asarray(widths, np.int64)
    bit = np.arange(12)
    bits = ((codes_a[:, None] >> bit) & 1).astype(np.uint8)[bit[None, :] < widths_a[:, None]]
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\x00")


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 25) -> str:
    """Write [H, W, 3] uint8 frames as a looping GIF89a; returns path."""
    if not len(frames):
        raise ValueError("no frames to write")
    h, w = frames[0].shape[:2]
    delay = int(round(100.0 / fps))
    size_field = PALETTE_BITS - 1
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0x80 | size_field << 4 | size_field, 0, 0)
    out += PALETTE.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for frame in frames:
        if frame.shape[:2] != (h, w):
            raise ValueError(f"frame of shape {frame.shape}, the first is {(h, w)}")
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out += bytes([PALETTE_BITS]) + _sub_blocks(lzw_encode(quantize(frame)))
    out += b"\x3b"
    with open(path, "wb") as f:
        f.write(out)
    return path


def _skip_sub_blocks(data: bytes, pos: int) -> int:
    while data[pos]:
        pos += data[pos] + 1
    return pos + 1


def read_gif(path: str) -> Dict:
    """The structure of a GIF file: width, height, loop (None without a
    NETSCAPE2.0 extension) and `delays`, one per image descriptor, in
    centiseconds (None for an image without a graphic control extension).
    Raises ValueError on a malformed file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:6] not in (b"GIF87a", b"GIF89a"):
            raise ValueError(f"{path}: not a GIF")
        w, h, packed = struct.unpack_from("<HHB", data, 6)
        pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
        loop, delays, delay = None, [], None
        while data[pos] != 0x3B:
            block = data[pos]
            if block == 0x21:
                label = data[pos + 1]
                if label == 0xF9:
                    delay = struct.unpack_from("<H", data, pos + 4)[0]
                elif label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                    loop = struct.unpack_from("<H", data, pos + 16)[0]
                pos = _skip_sub_blocks(data, pos + 2)
            elif block == 0x2C:
                local = data[pos + 9]
                pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
                pos = _skip_sub_blocks(data, pos + 1)    # the LZW minimum code size byte
                delays.append(delay)
                delay = None
            else:
                raise ValueError(f"{path}: unknown block 0x{block:02x} at byte {pos}")
    except (IndexError, struct.error) as e:
        raise ValueError(f"{path}: truncated GIF") from e
    return dict(width=w, height=h, loop=loop, delays=delays)
