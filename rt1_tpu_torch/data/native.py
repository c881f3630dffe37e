"""The native window sampler and episode reader (counterparts of
`rt1_tpu/data/native.py`).

`native/window_sampler.cc` and `native/episode_reader.cc` (plain C++, no
Python headers) are compiled with g++ at first use into
`rt1_tpu_torch/csrc/build/`, each under a name keyed by a digest of its
source and flags, and bound with ctypes. Neither is ever loaded from
`native/`, and a failed build raises with g++'s output: the port has no
quiet fallback (the reader's numpy path is chosen only by
`RT1_TPU_NO_NATIVE=1`, in `episodes.load_episode`).

The sampler's two entry points, both GIL-free and threaded over frames:

* `crop_resize_batch` — crop a box out of each frame and resize it to the
  model resolution: fixed-point bilinear with 11-bit weights and cv2's
  INTER_LINEAR half-pixel convention (`crop_resize_reference` in
  `pipeline.py` is its plain version);
* `packed_gather` — cut crops out of a packed (T, ph, pw, 3) frame block
  (an mmap): a strided row memcpy when the crop is already at the output
  size, the resample above otherwise.

The reader (`load_episode_native`, `NativeEpisode`) mmaps an `.npz` (or
`.npy`) and parses its members' headers in C++; stored members are views
into the map, deflated ones (`np.savez_compressed`) are inflated by zlib
(`-lz`). `load_episode_native` copies every member into its own array.

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
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO, "native", "window_sampler.cc")
READER_SOURCE = os.path.join(REPO, "native", "episode_reader.cc")
BUILD_DIR = os.path.join(REPO, "rt1_tpu_torch", "csrc", "build")
# native/Makefile's flags. ISO C++17 keeps floating-point contraction off,
# so the coefficients are the separately rounded float32 products that
# `crop_resize_reference` computes.
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LINK_FLAGS = ("-lpthread",)
READER_LINK_FLAGS = ("-lz",)


def _library_path(source: str, stem: str, link_flags) -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS + tuple(link_flags)).encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def _build(source: str, stem: str, link_flags) -> str:
    path = _library_path(source, stem, link_flags)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = ["g++", *GXX_FLAGS, source, *link_flags, "-o", lib]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as exc:
            raise RuntimeError(f"g++ not found; {stem} needs it: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, path)
    return path


def library_path() -> str:
    """The built sampler's path, keyed by the source and the flags."""
    return _library_path(SOURCE, "window_sampler", LINK_FLAGS)


def build() -> str:
    """Compile the sampler unless this source's library exists; returns its
    path. Raises RuntimeError with g++'s output when the build fails."""
    return _build(SOURCE, "window_sampler", LINK_FLAGS)


def reader_library_path() -> str:
    """The built episode reader's path, keyed by the source and the flags."""
    return _library_path(READER_SOURCE, "episode_reader", READER_LINK_FLAGS)


def build_reader() -> str:
    """Compile the episode reader (g++ ... -lz) unless this source's
    library exists; returns its path. Raises RuntimeError with g++'s
    output when the build fails (no zlib, no g++)."""
    return _build(READER_SOURCE, "episode_reader", READER_LINK_FLAGS)


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


@functools.lru_cache(maxsize=None)
def _reader() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_reader())
    lib.er_open.restype = ctypes.c_void_p
    lib.er_open.argtypes = [ctypes.c_char_p]
    lib.er_num_members.argtypes = [ctypes.c_void_p]
    lib.er_member_name.restype = ctypes.c_char_p
    lib.er_member_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.er_member_dtype.restype = ctypes.c_char_p
    lib.er_member_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.er_member_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.er_member_shape.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.er_member_data.restype = ctypes.c_void_p
    lib.er_member_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.er_member_nbytes.restype = ctypes.c_int64
    lib.er_member_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.er_close.argtypes = [ctypes.c_void_p]
    return lib


# The npy descriptors the reader hands back, as JAX's binding maps them.
_DTYPES = {
    "<f4": np.float32,
    "<f8": np.float64,
    "<i4": np.int32,
    "<i8": np.int64,
    "<u4": np.uint32,
    "<u8": np.uint64,
    "|u1": np.uint8,
    "|i1": np.int8,
    "|b1": np.bool_,
    "<f2": np.float16,
}


class NativeEpisode:
    """Handle over one open episode file; arrays are materialized on read.
    Raises OSError when the reader cannot open or parse the file."""

    def __init__(self, path: str):
        self._handle = None
        self._lib = _reader()
        self._handle = self._lib.er_open(os.fsencode(path))
        if not self._handle:
            raise OSError(f"native episode reader failed to open {path} (missing, or not an "
                          ".npz/.npy of C-order arrays; RT1_TPU_NO_NATIVE=1 selects np.load)")
        self.path = path

    def keys(self):
        return [self._lib.er_member_name(self._handle, i).decode()
                for i in range(self._lib.er_num_members(self._handle))]

    def _array(self, i: int) -> np.ndarray:
        """Member i, copied out of the map (which `close` unmaps)."""
        descr = self._lib.er_member_dtype(self._handle, i).decode()
        dtype = _DTYPES.get(descr)
        if dtype is None:
            raise ValueError(f"{self.path}: member {self.keys()[i]!r} has dtype {descr!r}, which "
                             "the native reader does not read (RT1_TPU_NO_NATIVE=1 selects "
                             "np.load)")
        ndim = self._lib.er_member_ndim(self._handle, i)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        self._lib.er_member_shape(self._handle, i, shape)
        nbytes = self._lib.er_member_nbytes(self._handle, i)
        ptr = self._lib.er_member_data(self._handle, i)
        if nbytes == 0:
            return np.empty(tuple(shape[:ndim]), dtype)
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype).reshape(tuple(shape[:ndim]))
        return arr.copy()

    def to_dict(self) -> Dict[str, np.ndarray]:
        return {name: self._array(i) for i, name in enumerate(self.keys())}

    def close(self) -> None:
        if self._handle:
            self._lib.er_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def load_episode_native(path: str) -> Dict[str, np.ndarray]:
    """Every member of the `.npz` at `path`, each copied into its own
    array: `np.load`'s dict, read in C++."""
    with NativeEpisode(path) as ep:
        return ep.to_dict()
