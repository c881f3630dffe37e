"""Episode videos as animated GIFs, written with numpy alone.

The JAX package writes mp4 through imageio's ffmpeg plugin and falls back
to an animated GIF (`rt1_tpu/eval/evaluate.py::_write_video`); the card's
machine has neither imageio nor PIL, so the port always writes the GIF.

* One global palette of 256 colours for the whole episode: each pixel's
  colour is binned to 5 bits a channel, the 256 most frequent bins form
  the palette (each the mean colour of its pixels), and every bin maps to
  its nearest palette colour. A flat region of one colour comes back
  exact; rarer colours (edges between shapes) take the nearest one.
* LZW with only literal codes: a clear code before every 254 literals
  keeps the code width at 9 bits, so a frame's codes pack into bits with
  array operations and no dictionary. The file is about 9/8 of the raw
  pixels.
* A NETSCAPE2.0 block loops the animation; each frame waits `1 / fps`.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

_BITS = 5                       # a channel's bits in the palette's bins
_CLEAR, _END = 256, 257         # LZW codes of an 8-bit GIF
_LITERALS_A_CLEAR = 254         # literals between clears: the width stays 9 bits
_CODE_BITS = 9


def _bins(frame: np.ndarray) -> np.ndarray:
    """Each pixel's 15-bit colour bin."""
    q = (frame >> (8 - _BITS)).astype(np.int32)
    return (q[..., 0] << (2 * _BITS)) | (q[..., 1] << _BITS) | q[..., 2]


def _bin_centres(bins: np.ndarray) -> np.ndarray:
    """(n, 3) uint8 centre colours of 15-bit bins."""
    mask = (1 << _BITS) - 1
    q = np.stack([(bins >> (2 * _BITS)) & mask, (bins >> _BITS) & mask, bins & mask], -1)
    return ((q << (8 - _BITS)) + (1 << (7 - _BITS))).astype(np.uint8)


def episode_palette(frames: Sequence[np.ndarray]):
    """(palette (256, 3) uint8, lookup from a 15-bit bin to its palette
    index) for `frames`."""
    counts = np.zeros(1 << (3 * _BITS), np.int64)
    sums = np.zeros((counts.size, 3), np.int64)
    for frame in frames:
        bins = _bins(frame).ravel()
        counts += np.bincount(bins, minlength=counts.size)
        for c in range(3):
            sums[:, c] += np.bincount(bins, weights=frame[..., c].ravel(),
                                      minlength=counts.size).astype(np.int64)
    used = np.flatnonzero(counts)
    chosen = used[np.argsort(-counts[used], kind="stable")[:256]]
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(chosen)] = np.rint(sums[chosen] / counts[chosen, None]).astype(np.uint8)
    centres = _bin_centres(np.arange(counts.size)).astype(np.int32)
    lookup = np.empty(counts.size, np.uint8)
    own = palette[:len(chosen)].astype(np.int32)
    for start in range(0, counts.size, 4096):  # nearest palette colour, in chunks
        d = ((centres[start:start + 4096, None, :] - own[None]) ** 2).sum(-1)
        lookup[start:start + 4096] = d.argmin(-1)
    return palette, lookup


def _lzw_literals(indices: np.ndarray) -> bytes:
    """GIF image data (minimum code size 8, sub-blocks, terminator) of a
    frame's palette indices as literal codes."""
    n = indices.size
    clears = -(-n // _LITERALS_A_CLEAR)
    codes = np.empty(n + clears + 1, np.uint16)
    # A clear before each run of at most 254 literals, the end code last.
    pos = np.arange(n) + np.arange(n) // _LITERALS_A_CLEAR + 1
    codes[pos] = indices.ravel()
    codes[np.arange(clears) * (_LITERALS_A_CLEAR + 1)] = _CLEAR
    codes[-1] = _END
    bits = ((codes[:, None] >> np.arange(_CODE_BITS, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little").tobytes()
    out = bytearray([8])
    for start in range(0, len(data), 255):
        chunk = data[start:start + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 10.0) -> str:
    """Write uint8 (H, W, 3) `frames` of one size to `path` as a looping
    animated GIF at `fps`; returns `path`."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("a video needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError("every frame must be (H, W, 3) of one size")
    palette, lookup = episode_palette(frames)
    delay = int(round(100.0 / fps))  # hundredths of a second
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + palette.tobytes())
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for frame in frames:
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(_lzw_literals(lookup[_bins(frame)]))
        f.write(b"\x3b")
    return path


def count_gif_frames(path: str) -> int:
    """The number of images in a GIF file, found by walking its blocks
    (header, screen descriptor and colour tables, extensions, image
    descriptors with their LZW sub-blocks, trailer) without decoding any;
    raises ValueError on a malformed file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{path} is not a GIF")
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    frames = 0
    try:
        while data[pos] != 0x3B:
            if data[pos] == 0x21:  # extension: label, then sub-blocks
                pos = skip_sub_blocks(pos + 2)
            elif data[pos] == 0x2C:  # image: descriptor, local table, LZW data
                flags = data[pos + 9]
                pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
                pos = skip_sub_blocks(pos + 1)
                frames += 1
            else:
                raise ValueError(f"{path}: unknown GIF block 0x{data[pos]:02x} at {pos}")
    except IndexError:
        raise ValueError(f"{path}: truncated GIF") from None
    return frames
