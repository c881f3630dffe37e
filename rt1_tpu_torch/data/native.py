"""The native window sampler (counterpart of the window-sampler half of
`rt1_tpu/data/native.py`).

`native/window_sampler.cc` (plain C++, no Python headers) is compiled with
g++ at first use into `rt1_tpu_torch/csrc/build/`, under a name keyed by a
digest of the source and the flags, and bound with ctypes. It is never
loaded from `native/`, and a failed build raises with g++'s output: the
port has no numpy fallback. Two entry points, both GIL-free and threaded
over frames:

* `crop_resize_batch` — crop a box out of each frame and resize it to the
  model resolution: fixed-point bilinear with 11-bit weights and cv2's
  INTER_LINEAR half-pixel convention (`crop_resize_reference` in
  `pipeline.py` is its plain version);
* `packed_gather` — cut crops out of a packed (T, ph, pw, 3) frame block
  (an mmap): a strided row memcpy when the crop is already at the output
  size, the resample above otherwise.

Concurrent builders (test workers, DataLoader workers) each compile in a
private temporary directory and rename the library into place.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO, "native", "window_sampler.cc")
BUILD_DIR = os.path.join(REPO, "rt1_tpu_torch", "csrc", "build")
# native/Makefile's flags. ISO C++17 keeps floating-point contraction off,
# so the coefficients are the separately rounded float32 products that
# `crop_resize_reference` computes.
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LINK_FLAGS = ("-lpthread",)


def library_path() -> str:
    """The built library's path, keyed by the source and the flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libwindow_sampler_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sampler unless this source's library exists; returns its
    path. Raises RuntimeError with g++'s output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = ["g++", *GXX_FLAGS, SOURCE, *LINK_FLAGS, "-o", lib]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as exc:
            raise RuntimeError(f"g++ not found; the window sampler needs it: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, path)
    return path


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.ws_crop_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ws_crop_resize_batch.restype = None
    lib.ws_packed_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ws_packed_gather.restype = None
    return lib


def _check_boxes(boxes: np.ndarray, n: int, h: int, w: int) -> np.ndarray:
    boxes = np.ascontiguousarray(boxes, np.int32)
    if boxes.shape != (n, 4):
        raise ValueError(f"boxes must be ({n}, 4), got {boxes.shape}")
    if n and ((boxes[:, :2] < 0).any() or (boxes[:, 2:] <= 0).any()
              or (boxes[:, 0] + boxes[:, 2] > h).any()
              or (boxes[:, 1] + boxes[:, 3] > w).any()):
        raise IndexError(f"crop box out of the {h}x{w} frame")
    return boxes


def crop_resize_batch(frames, boxes, out_h: int, out_w: int, threads: int = 1) -> np.ndarray:
    """Crop + bilinear-resize n frames -> (n, out_h, out_w, 3) uint8.

    frames: a sequence of (h, w, 3) uint8 arrays of one shape; boxes: (n, 4)
    int32 (top, left, crop_h, crop_w) per frame. The loaders call it with
    threads=1: they already spread windows over threads or processes.
    """
    lib = _library()
    n = len(frames)
    frames = [np.ascontiguousarray(f) for f in frames]
    if not n:
        return np.empty((0, out_h, out_w, 3), np.uint8)
    shape = frames[0].shape
    if any(f.dtype != np.uint8 or f.shape != shape for f in frames) or len(shape) != 3 \
            or shape[2] != 3:
        raise ValueError("frames must be (h, w, 3) uint8 arrays of one shape")
    boxes = _check_boxes(boxes, n, shape[0], shape[1])
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ptrs = (ctypes.c_void_p * n)(*[f.ctypes.data for f in frames])
    lib.ws_crop_resize_batch(
        ptrs, boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, shape[0], shape[1],
        out.ctypes.data_as(ctypes.c_void_p), out_h, out_w, max(1, threads))
    return out


def packed_gather(frames: np.ndarray, frame_idx: np.ndarray, boxes: np.ndarray,
                  out: np.ndarray, threads: int = 1) -> np.ndarray:
    """Gather n crops out of a packed (T, ph, pw, 3) uint8 frame block into
    `out` ((n, oh, ow, 3) uint8, C-contiguous), in place; returns `out`.
    frame_idx: (n,) frame indices; boxes: (n, 4) (top, left, crop_h,
    crop_w) in packed coordinates."""
    lib = _library()
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3 \
            or not frames.flags["C_CONTIGUOUS"]:
        raise ValueError(f"frames must be a C-contiguous (T, ph, pw, 3) uint8 block, got "
                         f"{frames.dtype} {frames.shape}")
    if out.dtype != np.uint8 or out.ndim != 4 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous (n, oh, ow, 3) uint8 array")
    n = len(frame_idx)
    t, ph, pw, _ = frames.shape
    if out.shape[0] != n:
        raise ValueError(f"out holds {out.shape[0]} crops, frame_idx {n}")
    idx = np.ascontiguousarray(frame_idx, np.int64)
    if n and (idx.min() < 0 or idx.max() >= t):
        raise IndexError(f"frame_idx out of range [0, {t})")
    boxes = _check_boxes(boxes, n, ph, pw)
    lib.ws_packed_gather(
        frames.ctypes.data_as(ctypes.c_void_p), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, ph, pw,
        out.ctypes.data_as(ctypes.c_void_p), out.shape[1], out.shape[2], max(1, threads))
    return out
