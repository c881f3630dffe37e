"""Image decoders and CRC32C for the TF-free TFDS reader (host code).

TFDS stores each `Image` feature encoded and decodes it with
`tf.image.decode_image`; the port reads the same bytes without TensorFlow:

* `decode_jpeg` — baseline JPEG in C++ (`rt1_tpu_torch/csrc/image_decode.cc`),
  computing what `tf.io.decode_jpeg` computes by default: libjpeg's IFAST
  inverse DCT (`dct_method=""`, not INTEGER_ACCURATE), fancy upsampling
  and the table-based YCbCr -> RGB, so the pixels are those JAX trains on.
  Progressive and arithmetic-coded files raise.
* `decode_png` — 8-bit gray, gray + alpha, RGB and RGBA, filters 0-4, not
  interlaced, in numpy and `zlib`; the rows are unfiltered along the
  image's anti-diagonals, each one a vectorised step, since a pixel of a
  Sub, Average or Paeth row depends on its left neighbour.
* `crc32c` — the Castagnoli CRC that frames TFRecord files.

The C++ library is built with g++ at first use into
`rt1_tpu_torch/csrc/build/` (`data/native.py`'s builder) and bound with
ctypes; a failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import functools
import os
import zlib

import numpy as np

from rt1_tpu_torch.data import native

SOURCE = os.path.join(native.REPO, "rt1_tpu_torch", "csrc", "image_decode.cc")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERR_LEN = 256


def library_path() -> str:
    """The built codec library's path, keyed by the source and the flags."""
    return native._library_path(SOURCE, "image_decode", ())


def build() -> str:
    """Compile the codec library unless this source's library exists;
    returns its path. Raises RuntimeError with g++'s output on failure."""
    return native._build(SOURCE, "image_decode", ())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.rt_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.rt_crc32c.restype = ctypes.c_uint32
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rt_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ip, ip, ip,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.rt_jpeg_info.restype = ctypes.c_int
    lib.rt_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.rt_jpeg_decode.restype = ctypes.c_int
    return lib


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data` (bytes-like), continuing from `crc`."""
    buf = np.frombuffer(data, np.uint8)
    return int(_library().rt_crc32c(buf.ctypes.data, buf.size, crc))


def masked_crc32c(data) -> int:
    """TFRecord's masked CRC: rotate right by 15, add 0xa282ead8."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class ImageDecodeError(ValueError):
    """An encoded image this module cannot or will not decode."""


def _convert_channels(img: np.ndarray, channels: int) -> np.ndarray:
    """TF's channel rules: 0 keeps the file's; gray -> RGB repeats, an
    alpha is dropped to reach 1 or 3."""
    have = img.shape[-1]
    if channels in (0, have):
        return img
    if channels == 3 and have in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    if channels == 3 and have == 4:
        return np.ascontiguousarray(img[..., :3])
    if channels == 1 and have == 2:
        return np.ascontiguousarray(img[..., :1])
    raise ImageDecodeError(f"cannot convert a {have}-channel image to {channels} channels")


def jpeg_shape(data: bytes):
    """(height, width, components) from a JPEG's frame header."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _library().rt_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                               ctypes.byref(c), err, _ERR_LEN) != 0:
        raise ImageDecodeError(f"JPEG: {err.value.decode(errors='replace')}")
    return h.value, w.value, c.value


def decode_jpeg(data: bytes, channels: int = 0) -> np.ndarray:
    """(h, w, channels) uint8, as `tf.io.decode_jpeg(data, channels)` with
    its defaults (IFAST inverse DCT, fancy upsampling). `channels` 0 keeps
    the file's components (1 or 3)."""
    if channels not in (0, 1, 3):
        raise ImageDecodeError(f"JPEG: channels must be 0, 1 or 3, got {channels}")
    data = bytes(data)
    h, w, comps = jpeg_shape(data)
    out_c = channels or comps
    out = np.empty((h, w, out_c), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _library().rt_jpeg_decode(data, len(data), out.ctypes.data, h, w, out_c,
                                 err, _ERR_LEN) != 0:
        raise ImageDecodeError(f"JPEG: {err.value.decode(errors='replace')}")
    return out


# PNG colour types this decoder takes -> samples a pixel.
_PNG_COLOUR = {0: 1, 4: 2, 2: 3, 6: 4}
_PNG_COLOUR_NAMES = {3: "palette"}


def _png_chunks(data: bytes):
    if not data.startswith(PNG_SIGNATURE):
        raise ImageDecodeError("PNG: bad signature")
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ImageDecodeError("PNG: truncated chunk")
        crc = int.from_bytes(data[pos + 8 + length:pos + 12 + length], "big")
        if zlib.crc32(kind + body) != crc:
            raise ImageDecodeError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ImageDecodeError("PNG: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filters: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Undo PNG's per-row filters: rows (h, w, bpp) uint8 -> the samples."""
    h, w, bpp = rows.shape
    if (filters > 4).any():
        raise ImageDecodeError(f"PNG: bad filter type {int(filters.max())}")
    out = np.empty_like(rows)
    if not (filters >= 3).any():
        # None, Sub and Up need no left-to-right walk: one row at a time.
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            f = filters[y]
            if f == 0:
                out[y] = rows[y]
            elif f == 1:
                out[y] = np.cumsum(rows[y], axis=0, dtype=np.uint8)
            else:
                out[y] = rows[y] + prev
            prev = out[y]
        return out
    # Average and Paeth: walk the anti-diagonals. Pixel (y, x) lies on
    # diagonal k = y + x, and its left, upper and upper-left neighbours lie
    # on diagonals k - 1, k - 1 and k - 2, so each diagonal is one step.
    # skew[y + 1, k + 1] holds pixel (y, k - y); row 0 and column 0 are the
    # zeros outside the image.
    skew_in = np.zeros((h, h + w, bpp), np.int16)
    for y in range(h):
        skew_in[y, y:y + w] = rows[y]
    skew = np.zeros((h + 1, h + w + 1, bpp), np.int16)
    f = filters.astype(np.int16)[:, None]
    for k in range(h + w - 1):
        y0, y1 = max(0, k - w + 1), min(h - 1, k)
        x = skew_in[y0:y1 + 1, k]
        a = skew[y0 + 1:y1 + 2, k]        # left: (y, x - 1) on diagonal k - 1
        b = skew[y0:y1 + 1, k]            # up: (y - 1, x) on diagonal k - 1
        c = skew[y0:y1 + 1, k - 1] if k else np.zeros_like(x)  # up-left, k - 2
        ft = f[y0:y1 + 1]
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, _paeth(a, b, c), 0))))
        skew[y0 + 1:y1 + 2, k + 1] = (x + pred) & 0xFF
    for y in range(h):
        out[y] = skew[y + 1, y + 1:y + 1 + w]
    return out


def decode_png(data: bytes, channels: int = 0) -> np.ndarray:
    """(h, w, channels) uint8, as `tf.io.decode_png(data, channels)` for
    8-bit gray, gray + alpha, RGB and RGBA files without interlacing."""
    data = bytes(data)
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or len(header) != 13:
        raise ImageDecodeError("PNG: no IHDR chunk")
    w, h = int.from_bytes(header[0:4], "big"), int.from_bytes(header[4:8], "big")
    depth, colour, _, _, interlace = header[8:13]
    if colour not in _PNG_COLOUR:
        name = _PNG_COLOUR_NAMES.get(colour, f"type {colour}")
        raise ImageDecodeError(f"PNG: colour {name} is not supported (gray, gray + alpha, "
                               "RGB and RGBA are)")
    if depth != 8:
        raise ImageDecodeError(f"PNG: bit depth {depth} is not supported (8 is)")
    if interlace != 0:
        raise ImageDecodeError("PNG: interlaced (Adam7) images are not supported")
    bpp = _PNG_COLOUR[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ImageDecodeError(f"PNG: corrupt image data: {exc}") from exc
    stride = 1 + w * bpp
    if len(raw) < h * stride:
        raise ImageDecodeError("PNG: image data too short")
    raw = np.frombuffer(raw, np.uint8, h * stride).reshape(h, stride)
    img = _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, bpp))
    return _convert_channels(img, channels)


def decode_image(data: bytes, channels: int = 0) -> np.ndarray:
    """JPEG or PNG by the file's signature, as `tf.image.decode_image(data,
    channels, expand_animations=False)` decodes those two."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, channels)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, channels)
    raise ImageDecodeError("not a JPEG or PNG file (GIF and BMP are not supported)")
