"""The port's native episode reader (`native/episode_reader.cc`, built by
g++ -lz into `rt1_tpu_torch/csrc/build/`) against `np.load` and the JAX
package's `rt1_tpu.data.native.load_episode_native`, on the CPU.

* `np.savez` and `np.savez_compressed` episodes (deflated members go
  through zlib): every member equal to `np.load`'s, dtype and shape
  included, over every dtype the reader maps, 0-d and empty arrays, and a
  bare `.npy`; and equal to JAX's reader on the same file.
* `data.episodes.load_episode` reads through it, and `RT1_TPU_NO_NATIVE=1`
  selects `np.load`.
* The error paths: a missing file, a file that is no archive and a
  Fortran-order member raise OSError; an unmapped dtype raises ValueError
  naming it; a failed build raises RuntimeError with g++'s output (the
  deliberate difference from JAX, which falls back to `np.load` quietly).
"""

import os

import numpy as np
import pytest

from rt1_tpu.data import native as jax_native
from rt1_tpu_torch.data import episodes, native


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    out = {
        "rgb": rng.integers(0, 256, (4, 18, 32, 3), dtype=np.uint8),
        "action": rng.standard_normal((4, 2)).astype(np.float32),
        "is_first": np.array([True, False, False, False]),
        "is_terminal": np.array([False, False, False, True]),
        "instruction": rng.standard_normal((4, 512)).astype(np.float32),
        "instruction_text": episodes.encode_instruction_text("push the red moon"),
        "f8": rng.standard_normal(5), "i4": rng.integers(-9, 9, 6).astype(np.int32),
        "i8": rng.integers(-9, 9, (2, 3)), "u4": np.arange(7, dtype=np.uint32),
        "u8": np.arange(3, dtype=np.uint64), "i1": np.arange(-3, 3, dtype=np.int8),
        "f2": rng.standard_normal(4).astype(np.float16),
        "scalar": np.float32(2.5), "empty": np.zeros((0, 3), np.float32),
    }
    return out


def _assert_same(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype and ours[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("writer", ["savez", "savez_compressed"])
def test_native_equals_np_load_and_jax(tmp_path, writer):
    path = str(tmp_path / "episode_00000.npz")
    getattr(np, writer)(path, **_arrays(1))
    ours = native.load_episode_native(path)
    with np.load(path) as z:
        _assert_same(ours, {k: z[k] for k in z.files})
    _assert_same(ours, jax_native.load_episode_native(path))


def test_bare_npy_and_synthetic_episodes(tmp_path):
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.save(tmp_path / "x.npy", data)
    _assert_same(native.load_episode_native(str(tmp_path / "x.npy")), {"data": data})
    rng = np.random.default_rng(3)
    for i in range(3):
        path = str(tmp_path / f"episode_{i}.npz")
        episodes.save_episode(path, episodes.generate_synthetic_episode(rng, num_steps=5,
                                                                        height=24, width=40))
        with np.load(path) as z:
            _assert_same(episodes.load_episode(path), {k: z[k] for k in z.files})


def test_load_episode_honours_no_native(tmp_path, monkeypatch):
    path = str(tmp_path / "episode_0.npz")
    np.savez(path, **_arrays(2))

    def refuse(_):
        raise AssertionError("the native reader was called")

    monkeypatch.setattr(native, "load_episode_native", refuse)
    with pytest.raises(AssertionError, match="native reader was called"):
        episodes.load_episode(path)
    monkeypatch.setenv("RT1_TPU_NO_NATIVE", "1")
    with np.load(path) as z:
        _assert_same(episodes.load_episode(path), {k: z[k] for k in z.files})


def test_error_paths(tmp_path):
    with pytest.raises(OSError, match="RT1_TPU_NO_NATIVE"):
        native.load_episode_native(str(tmp_path / "missing.npz"))
    (tmp_path / "junk.npz").write_bytes(b"not an archive at all")
    with pytest.raises(OSError):
        native.load_episode_native(str(tmp_path / "junk.npz"))
    np.savez(tmp_path / "fortran.npz", a=np.asfortranarray(np.ones((3, 4), np.float32)))
    with pytest.raises(OSError):
        native.load_episode_native(str(tmp_path / "fortran.npz"))
    np.savez(tmp_path / "complex.npz", c=np.ones(3, np.complex64))
    with pytest.raises(ValueError, match="<c8"):
        native.load_episode_native(str(tmp_path / "complex.npz"))


def test_failed_build_raises_with_gxx_output(tmp_path, monkeypatch):
    broken = tmp_path / "episode_reader.cc"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "READER_SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native._reader.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.load_episode_native(str(tmp_path / "any.npz"))
    finally:
        native._reader.cache_clear()
    assert not os.path.exists(native.reader_library_path())
