"""The port's window sampler (`rt1_tpu_torch/data/native.py`) on the CPU.

* Built from `native/window_sampler.cc` into `rt1_tpu_torch/csrc/build/`
  under a digest name, never loaded from `native/`; a failed g++ raises
  with its output; concurrent builders leave one library.
* Crop + resize is byte-equal to its plain numpy version
  (`pipeline.crop_resize_reference`) and to the JAX package's
  `crop_resize_frames` with the native sampler forced, at small sizes and
  at the flagship's 180x320 -> 256x456; within 1 LSB of the JAX package's
  cv2 path.
* The packed gather is byte-equal to plain slicing (crops at the output
  size) and to the reference resample (other crops), and checks bounds.
"""

import ctypes
import os
import threading

import numpy as np
import pytest

from rt1_tpu.data import pipeline as jax_pipeline
from rt1_tpu_torch.data import native
from rt1_tpu_torch.data.pipeline import _crop_box, crop_resize_frames, crop_resize_reference

# (source h, w, output h, w, crop_factor): the small test geometry, the
# flagship's, the packer's full-frame resize to the flagship's packed size,
# an upscale of a tiny frame, an odd downscale.
GEOMETRIES = [
    (36, 64, 32, 56, 0.95),
    (180, 320, 256, 456, 0.95),
    (180, 320, 269, 480, None),
    (5, 7, 19, 23, 0.8),
    (40, 30, 9, 13, 0.5),
]


def _frames_and_boxes(seed, h, w, crop_factor, n=6):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    boxes = [_crop_box(h, w, crop_factor, rng) for _ in range(n)]
    return frames, boxes


def test_library_is_built_in_the_port_from_the_source():
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("rt1_tpu_torch", "csrc", "build"))
    assert native.SOURCE.endswith(os.path.join("native", "window_sampler.cc"))
    assert native.build() == path and os.path.exists(path)
    lib = native._library()
    assert lib._name == path  # the port's build, not native/libwindow_sampler.so
    assert isinstance(lib.ws_packed_gather, ctypes._CFuncPtr)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text('extern "C" void ws_crop_resize_batch( { }\n')
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        native.build()
    assert "error" in str(info.value)
    assert not os.path.exists(native.library_path())


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as exc:  # noqa: BLE001 - reported by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1
    assert sorted(os.listdir(tmp_path / "build")) == [os.path.basename(paths[0])]


@pytest.mark.parametrize("h,w,oh,ow,crop_factor", GEOMETRIES)
def test_sampler_equals_plain_reference(h, w, oh, ow, crop_factor):
    frames, boxes = _frames_and_boxes(1, h, w, crop_factor)
    got = crop_resize_frames(frames, boxes, oh, ow)
    want = crop_resize_reference(frames, boxes, oh, ow)
    assert got.shape == (len(frames), oh, ow, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,oh,ow,crop_factor", GEOMETRIES)
def test_sampler_equals_jax_native_sampler(h, w, oh, ow, crop_factor, monkeypatch):
    monkeypatch.setenv("RT1_TPU_FORCE_NATIVE_SAMPLER", "1")
    frames, boxes = _frames_and_boxes(2, h, w, crop_factor)
    np.testing.assert_array_equal(
        crop_resize_frames(frames, boxes, oh, ow),
        jax_pipeline.crop_resize_frames(frames, boxes, oh, ow))


@pytest.mark.parametrize("h,w,oh,ow,crop_factor", GEOMETRIES[:3])
def test_sampler_within_one_lsb_of_jax_cv2_path(h, w, oh, ow, crop_factor, monkeypatch):
    pytest.importorskip("cv2")
    monkeypatch.delenv("RT1_TPU_FORCE_NATIVE_SAMPLER", raising=False)
    frames, boxes = _frames_and_boxes(3, h, w, crop_factor)
    ours = crop_resize_frames(frames, boxes, oh, ow).astype(np.int16)
    cv2_out = jax_pipeline.crop_resize_frames(frames, boxes, oh, ow).astype(np.int16)
    assert np.abs(ours - cv2_out).max() <= 1


def test_packed_gather_memcpy_and_resample_paths():
    rng = np.random.default_rng(4)
    block = rng.integers(0, 256, (5, 30, 40, 3), dtype=np.uint8)
    idx = np.array([4, 0, 2, 2], np.int64)
    boxes = np.array([[0, 0, 20, 28], [10, 12, 20, 28], [3, 7, 20, 28], [1, 2, 29, 38]], np.int32)
    out = np.empty((4, 20, 28, 3), np.uint8)
    assert native.packed_gather(block, idx, boxes, out) is out
    for j in range(3):  # crops at the output size: plain slices
        top, left, ch, cw = boxes[j]
        np.testing.assert_array_equal(out[j], block[idx[j], top:top + ch, left:left + cw])
    np.testing.assert_array_equal(  # another size: the bilinear resample
        out[3], crop_resize_reference([block[2]], [tuple(boxes[3])], 20, 28)[0])
    threaded = np.empty_like(out)
    native.packed_gather(block, idx, boxes, threaded, threads=3)
    np.testing.assert_array_equal(threaded, out)


def test_packed_gather_and_crop_resize_check_their_inputs():
    block = np.zeros((2, 10, 12, 3), np.uint8)
    out = np.empty((1, 4, 4, 3), np.uint8)
    with pytest.raises(IndexError):
        native.packed_gather(block, np.array([2]), np.array([[0, 0, 4, 4]]), out)
    with pytest.raises(IndexError):
        native.packed_gather(block, np.array([0]), np.array([[8, 0, 4, 4]]), out)
    with pytest.raises(ValueError):
        native.packed_gather(block.astype(np.float32), np.array([0]),
                             np.array([[0, 0, 4, 4]]), out)
    with pytest.raises(ValueError):
        native.packed_gather(block, np.array([0]), np.array([[0, 0, 4, 4]]),
                             np.empty((1, 4, 4, 3), np.int32))
    with pytest.raises(IndexError):
        native.crop_resize_batch([block[0]], [(0, 0, 11, 4)], 4, 4)
    with pytest.raises(ValueError):
        crop_resize_frames([block[0].astype(np.float32)], [(0, 0, 4, 4)], 4, 4)
