"""The port's packed cache (`rt1_tpu_torch/data/pack.py`) against the JAX
package's (`rt1_tpu/data/pack.py`), on the CPU.

Tolerance: exact. The port's pack of a corpus is byte-equal to the JAX
package's, file by file, manifest included (both read the same source
files, so their fingerprints agree); each package's cache reads the
other's pack with equal windows and `fill_batch` batches; `append_shard`
writes the same shard and `refresh` picks it up; `pack_status` gives the
JAX package's verdict and reason for each kind of staleness; the packer
CLI writes the same pack. The JAX side resizes with its native sampler.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rt1_tpu.data import pack as jax_pack
from rt1_tpu_torch.data import episodes, pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, WINDOW = 32, 56, 3


@pytest.fixture(autouse=True)
def _native_sampler(monkeypatch):
    monkeypatch.setenv("RT1_TPU_FORCE_NATIVE_SAMPLER", "1")


def _write_episodes(directory, n, steps=8, seed=0, start=0, text=True, task=None):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(start, start + n):
        ep = episodes.generate_synthetic_episode(rng, num_steps=steps + i % 3, height=36,
                                                 width=64)
        if text:
            ep["instruction_text"] = episodes.encode_instruction_text(f"instruction {i}")
        if task is not None:
            ep["task"] = episodes.encode_instruction_text(task)
        path = os.path.join(str(directory), f"episode_{i:03d}.npz")
        episodes.save_episode(path, ep)
        paths.append(path)
    return paths


def _files(pack_dir):
    return {name: open(os.path.join(pack_dir, name), "rb").read()
            for name in sorted(os.listdir(pack_dir))}


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = tmp_path_factory.mktemp("pack_src")
    return _write_episodes(root, 3)


@pytest.mark.parametrize("crop_factor", [0.95, None])
def test_pack_is_byte_equal_to_jax(tmp_path, source, crop_factor):
    ours = pack.pack_episodes(source, str(tmp_path / "ours"), H, W, crop_factor)
    theirs = jax_pack.pack_episodes(source, str(tmp_path / "jax"), H, W, crop_factor)
    assert ours == theirs
    a, b = _files(str(tmp_path / "ours")), _files(str(tmp_path / "jax"))
    assert sorted(a) == sorted(b) and "meta_instruction_text.npy" in a
    for name in a:
        assert a[name] == b[name], name
    assert pack.pack_is_fresh(str(tmp_path / "jax"), source, H, W, crop_factor)
    assert jax_pack.pack_is_fresh(str(tmp_path / "ours"), source, H, W, crop_factor)


def test_geometry_equals_jax():
    for src_h, src_w, h, w in ((36, 64, 32, 56), (180, 320, 256, 456), (41, 77, 17, 5)):
        for cf in (0.95, 0.8, 0.5, None):
            dims = pack.packed_dims(src_h, src_w, h, w, cf)
            assert dims == jax_pack.packed_dims(src_h, src_w, h, w, cf)
            ch, cw = pack.crop_size(src_h, cf), pack.crop_size(src_w, cf)
            for top in range(0, src_h - ch + 1, 3):
                box = (top, (top * 7) % (src_w - cw + 1), ch, cw)
                assert pack.map_box_to_packed(box, src_h, src_w, *dims, h, w) == \
                    jax_pack.map_box_to_packed(box, src_h, src_w, *dims, h, w)
    assert pack.packed_dims(180, 320, 256, 456, 0.95) == (269, 480)


@pytest.mark.parametrize("builder", ["ours", "jax"])
def test_each_cache_reads_the_others_pack(tmp_path, source, builder):
    lib = pack if builder == "ours" else jax_pack
    lib.pack_episodes(source, str(tmp_path), H, W, 0.95)
    ours = pack.PackedEpisodeCache(str(tmp_path), window=WINDOW)
    theirs = jax_pack.PackedEpisodeCache(str(tmp_path), window=WINDOW)
    assert ours.index == theirs.index and ours.tasks == theirs.tasks
    for idx in (0, 3, 9, len(ours) - 1):
        a = ours.get_window(idx, np.random.default_rng(idx))
        b = theirs.get_window(idx, np.random.default_rng(idx))
        for group in a:
            for k in a[group]:
                np.testing.assert_array_equal(a[group][k], b[group][k], err_msg=k)
                assert a[group][k].dtype == b[group][k].dtype
    indices = np.array([5, 0, 17, 2, 9])
    bufs = []
    for cache in (ours, theirs):
        out = (np.empty((5, WINDOW, H, W, 3), np.uint8), np.empty((5, WINDOW, 512), np.float32),
               np.empty((5, WINDOW), np.int32), np.empty((5, WINDOW, 2), np.float32))
        cache.fill_batch(indices, np.random.default_rng(3), *out)
        bufs.append(out)
    for x, y in zip(*bufs):
        np.testing.assert_array_equal(x, y)


def test_gather_equals_plain_slices(tmp_path, source):
    pack.pack_episodes(source, str(tmp_path), H, W, 0.95)
    cache = pack.PackedEpisodeCache(str(tmp_path), window=WINDOW)
    rng = np.random.default_rng(6)
    boxes = [cache.draw_box(rng) for _ in range(WINDOW)]
    got = cache.gather_frames(1, 4, np.random.default_rng(6))
    frames = cache.frames(1)
    for j, box in enumerate(boxes):
        top, left = pack.map_box_to_packed(box, cache.src_h, cache.src_w, cache.packed_h,
                                           cache.packed_w, H, W)
        np.testing.assert_array_equal(got[j], frames[max(4 + j - (WINDOW - 1), 0),
                                                     top:top + H, left:left + W])


def test_append_shard_and_refresh_equal_jax(tmp_path, source):
    new = _write_episodes(tmp_path / "new", 2, seed=1, start=10, task="separate")
    for name, lib in (("ours", pack), ("jax", jax_pack)):
        lib.pack_episodes(source, str(tmp_path / name), H, W, 0.95)
    readers = {name: pack.PackedEpisodeCache(str(tmp_path / name), window=WINDOW)
               for name in ("ours", "jax")}
    ours = pack.append_shard(str(tmp_path / "ours"), new + source[:1])
    theirs = jax_pack.append_shard(str(tmp_path / "jax"), new + source[:1])
    assert ours == theirs and ours["freshness_epoch"] == 1 and len(ours["shards"]) == 2
    assert _files(str(tmp_path / "ours")) == _files(str(tmp_path / "jax"))
    assert pack.append_shard(str(tmp_path / "ours"), new) == ours  # already packed: unchanged
    for name, cache in readers.items():
        before = len(cache)
        assert cache.refresh() and not cache.refresh()
        assert cache.num_shards == 2 and len(cache) == before + sum(8 + i % 3 for i in (10, 11))
        assert cache.tasks[-1] == "separate" and cache.tasks[0] == pack.UNKNOWN_TASK
    jax_cache = jax_pack.PackedEpisodeCache(str(tmp_path / "ours"), window=WINDOW)
    indices = np.array([0, len(jax_cache) - 1, len(jax_cache) - 9, 4])
    bufs = []
    for cache in (readers["ours"], jax_cache):
        out = (np.empty((4, WINDOW, H, W, 3), np.uint8), np.empty((4, WINDOW, 512), np.float32),
               np.empty((4, WINDOW), np.int32), np.empty((4, WINDOW, 2), np.float32))
        cache.fill_batch(indices, np.random.default_rng(8), *out)
        bufs.append(out)
    for x, y in zip(*bufs):
        np.testing.assert_array_equal(x, y)


def test_pack_status_reasons_equal_jax(tmp_path):
    src = _write_episodes(tmp_path / "src", 3)
    out = str(tmp_path / "pack")
    pack.pack_episodes(src, out, H, W, 0.95)

    def both(paths=src, h=H, cf=0.95):
        ours = pack.pack_status(out, paths, h, W, cf)
        assert ours == jax_pack.pack_status(out, paths, h, W, cf)
        return ours

    assert both() == (True, "fresh")
    assert not both(h=H + 1)[0] and "geometry" in both(h=H + 1)[1]
    assert not both(cf=None)[0]
    assert "episodes" in both(paths=src[:2])[1]
    os.utime(src[1], (1.0, 1.0))
    assert "episode_001.npz" in both()[1] and "changed" in both()[1]
    pack.pack_episodes(src, out, H, W, 0.95, force=True)
    assert both() == (True, "fresh")
    sidecar = os.path.join(out, "meta_action.npy")
    os.rename(sidecar, sidecar + ".gone")
    assert "meta_action.npy" in both()[1]
    os.rename(sidecar + ".gone", sidecar)
    with open(os.path.join(out, "frames.bin"), "r+b") as f:
        f.truncate(100)
    assert "100 bytes on disk" in both()[1]
    with pytest.raises(ValueError, match="torn"):
        pack.PackedEpisodeCache(out)
    os.remove(os.path.join(out, "frames.bin"))
    assert "missing" in both()[1]
    os.remove(os.path.join(out, pack.MANIFEST_NAME))
    assert "manifest unreadable" in both()[1]


def test_legacy_format_2_manifest_loads(tmp_path, source):
    out = str(tmp_path)
    manifest = pack.pack_episodes(source, out, H, W, 0.95)
    legacy = {k: v for k, v in manifest.items() if k not in ("shards", "freshness_epoch")}
    legacy["format_version"] = 2
    legacy["episodes"] = [{k: v for k, v in e.items() if k != "shard"}
                          for e in manifest["episodes"]]
    with open(os.path.join(out, pack.MANIFEST_NAME), "w") as f:
        json.dump(legacy, f)
    assert pack.load_manifest(out) == jax_pack.load_manifest(out)
    cache = pack.PackedEpisodeCache(out, window=WINDOW)
    assert cache.num_shards == 1 and len(cache) == manifest["total_steps"]
    assert pack.pack_is_fresh(out, source, H, W, 0.95)
    legacy["format_version"] = 9
    with open(os.path.join(out, pack.MANIFEST_NAME), "w") as f:
        json.dump(legacy, f)
    with pytest.raises(ValueError, match="format 9"):
        pack.load_manifest(out)


def _cli(*args):
    proc = subprocess.run([sys.executable, "-m", "rt1_tpu_torch.data.pack_dataset", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    return proc.returncode, [json.loads(x) for x in proc.stdout.splitlines()], proc.stderr


def test_pack_dataset_cli_packs_and_appends(tmp_path):
    data = tmp_path / "data"
    train = _write_episodes(data / "train", 3)
    _write_episodes(data / "val", 1, seed=5)
    rc, lines, err = _cli("--data_dir", str(data), "--height", str(H), "--width", str(W))
    assert rc == 0, err
    assert [x["split"] for x in lines] == ["train", "val"]
    assert lines[0]["out_dir"] == str(data / "train_packed") and not lines[0]["already_fresh"]
    assert lines[0]["packed_hw"] == list(pack.packed_dims(36, 64, H, W, 0.95))
    jax_pack.pack_episodes(train, str(tmp_path / "jax"), H, W, 0.95)
    assert _files(str(data / "train_packed")) == _files(str(tmp_path / "jax"))
    rc, lines, _ = _cli("--data_dir", str(data), "--split", "train", "--height", str(H),
                        "--width", str(W))
    assert rc == 0 and lines[0]["already_fresh"]
    _write_episodes(tmp_path / "new", 2, seed=2, start=20)
    rc, lines, err = _cli("--append", "--out_dir", str(data / "train_packed"),
                          "--episodes_dir", str(tmp_path / "new"))
    assert rc == 0, err
    assert lines[0]["appended_episodes"] == 2 and lines[0]["shards"] == 2
    assert lines[0]["appended_shards"] == ["frames_00001.bin"]
    rc, lines, _ = _cli("--data_dir", str(data), "--split", "test")
    assert rc == 1 and lines[0]["error"] == "no_episodes"
    rc, lines, _ = _cli("--append", "--out_dir", str(tmp_path / "nothing"),
                        "--episodes_dir", str(tmp_path / "new"))
    assert rc == 1 and lines[0]["error"] == "append_failed"
