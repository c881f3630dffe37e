"""The port's windowed loader and upload (`rt1_tpu_torch/data/pipeline.py`)
against the JAX package's (`rt1_tpu/data/pipeline.py`), on the CPU.

Tolerance: exact. Under the native sampler (forced in the JAX package,
whose default here is cv2) the index, `get_window` and two epochs of
`numpy_batches` are byte-equal, at the small geometry and at the
flagship's 180x320 -> 256x456. The torch loader (shuffle off, no crop)
gives `numpy_batches`'s batches at 0 and 2 workers; with crops, each
window draws its own from its (seed, epoch, index), the same at 0 and 2
workers.
`device_feeder` on the CPU passes the batches through, `depth` ahead.
"""

import numpy as np
import pytest
import torch

from rt1_tpu.data import pipeline as jax_pipeline
from rt1_tpu_torch.data import episodes
from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset, device_feeder

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _native_sampler(monkeypatch):
    monkeypatch.setenv("RT1_TPU_FORCE_NATIVE_SAMPLER", "1")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("windowed")
    rng = np.random.default_rng(0)
    paths = []
    for i, steps in enumerate((8, 13, 20)):
        path = str(root / f"episode_{i:03d}.npz")
        episodes.save_episode(path, episodes.generate_synthetic_episode(
            rng, num_steps=steps, height=36, width=64))
        paths.append(path)
    return paths


def _pair(paths, **kwargs):
    kw = dict(window=3, height=32, width=56, **kwargs)
    return WindowedEpisodeDataset(paths, **kw), jax_pipeline.WindowedEpisodeDataset(paths, **kw)


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for group in a:
        assert sorted(a[group]) == sorted(b[group])
        for k in a[group]:
            x, y = np.asarray(a[group][k]), np.asarray(b[group][k])
            assert x.dtype == y.dtype and x.shape == y.shape, (group, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{group}/{k}")


def test_index_and_windows_equal_jax(corpus):
    ours, theirs = _pair(corpus)
    assert ours.index == theirs.index and len(ours) == 8 + 13 + 20
    for idx in (0, 1, 2, 8, 20, 40):
        _assert_trees_equal(ours.get_window(idx, np.random.default_rng(idx)),
                            theirs.get_window(idx, np.random.default_rng(idx)))
    first = ours.get_window(0, np.random.default_rng(0))
    assert first["observations"]["image"].dtype == np.uint8
    assert first["actions"]["terminate_episode"].dtype == np.int32


def test_episode_reads_are_counted_once_per_cache_miss(corpus, monkeypatch):
    from rt1_tpu_torch.data import pipeline

    monkeypatch.setattr(pipeline, "CACHE_EPISODES", 2)
    ds, _ = _pair(corpus)
    # Windows 0 and 7 lie in episode 0, 8 in episode 1, 21 in episode 2.
    for idx in (0, 7, 8):
        ds.get_window(idx, np.random.default_rng(idx))
    assert ds.episode_reads == 2 and ds.episode_read_s > 0
    ds.get_window(21, np.random.default_rng(0))  # evicts episode 0
    ds.get_window(8, np.random.default_rng(0))   # still cached
    assert ds.episode_reads == 3
    ds.get_window(0, np.random.default_rng(0))
    assert ds.episode_reads == 4


@pytest.mark.parametrize("crop_factor", [0.95, None])
@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_two_epochs_of_numpy_batches_equal_jax(corpus, crop_factor, process_index,
                                               process_count):
    ours, theirs = _pair(corpus, crop_factor=crop_factor)
    kw = dict(batch_size=4, seed=5, num_epochs=2, process_index=process_index,
              process_count=process_count)
    a, b = list(ours.numpy_batches(**kw)), list(theirs.numpy_batches(**kw))
    assert len(a) == len(b) == 2 * ((41 - process_index + process_count - 1)
                                    // process_count // 4)
    for x, y in zip(a, b):
        _assert_trees_equal(x, y)


def test_flagship_geometry_window_equals_jax(tmp_path):
    path = str(tmp_path / "episode_000.npz")
    episodes.save_episode(path, episodes.generate_synthetic_episode(
        np.random.default_rng(1), num_steps=1))
    ours = WindowedEpisodeDataset([path])
    theirs = jax_pipeline.WindowedEpisodeDataset([path])
    assert len(ours) == 1 and ours.index == theirs.index
    a = ours.get_window(0, np.random.default_rng(9))
    b = theirs.get_window(0, np.random.default_rng(9))
    assert a["observations"]["image"].shape == (6, 256, 456, 3)
    _assert_trees_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_torch_loader_equals_numpy_batches(corpus, num_workers):
    ds = WindowedEpisodeDataset(corpus, window=3, crop_factor=None, height=32, width=56)
    want = list(ds.numpy_batches(batch_size=4, shuffle=False, num_epochs=2))
    loader = ds.as_torch_loader(batch_size=4, shuffle=False, num_workers=num_workers,
                                num_epochs=2)
    got = list(loader)
    assert len(got) == len(want) == 20
    for x, y in zip(got, want):
        assert isinstance(x["observations"]["image"], torch.Tensor)
        _assert_trees_equal({g: {k: v.numpy() for k, v in leaves.items()}
                             for g, leaves in x.items()}, y)


def test_torch_loader_draws_distinct_crops_per_worker(tmp_path):
    # Every step of the episode shows one frame, so a window is its crops.
    ep = episodes.generate_synthetic_episode(np.random.default_rng(2), num_steps=12,
                                             height=36, width=64)
    ep["rgb"][:] = ep["rgb"][0]
    path = str(tmp_path / "episode_000.npz")
    episodes.save_episode(path, ep)
    ds = WindowedEpisodeDataset([path], window=3, crop_factor=0.8, height=32, width=56)

    def images(num_workers):
        loader = ds.as_torch_loader(batch_size=3, shuffle=False, seed=11,
                                    num_workers=num_workers, num_epochs=1)
        return [b["observations"]["image"] for b in loader]

    two = images(2)  # batch i comes from worker i % 2
    assert len(two) == 4
    assert not torch.equal(two[0], two[1])  # same windows' pixels, other crops
    assert not torch.equal(two[2], two[3])
    for a, b in zip(images(0), two):  # a window's crops do not depend on the worker
        np.testing.assert_array_equal(a, b)


def test_torch_loader_shuffles_from_its_seed(corpus):
    ds = WindowedEpisodeDataset(corpus, window=3, crop_factor=None, height=32, width=56)

    def actions(seed):
        loader = ds.as_torch_loader(batch_size=4, seed=seed, num_workers=0, num_epochs=2)
        return torch.cat([b["actions"]["action"] for b in loader])

    a, b = actions(3), actions(3)
    assert torch.equal(a, b) and not torch.equal(a, actions(4))
    ordered = list(ds.numpy_batches(batch_size=4, shuffle=False, num_epochs=2))
    assert not torch.equal(a, torch.cat([torch.from_numpy(x["actions"]["action"])
                                         for x in ordered]))


def test_device_feeder_on_the_cpu_reads_depth_ahead(corpus):
    ds = WindowedEpisodeDataset(corpus, window=3, height=32, width=56)
    host = list(ds.numpy_batches(batch_size=4, num_epochs=1))
    pulled = []

    def source():
        for b in host:
            pulled.append(b)
            yield b

    feed = device_feeder(source(), "cpu", depth=2)
    obs, actions = next(feed)
    assert len(pulled) == 2  # one batch handed over, one in flight
    assert obs["image"].dtype == torch.uint8 and not obs["image"].is_pinned()
    np.testing.assert_array_equal(obs["image"].numpy(), host[0]["observations"]["image"])
    np.testing.assert_array_equal(actions["action"].numpy(), host[0]["actions"]["action"])
    rest = list(feed)
    assert len(rest) == len(host) - 1 and feed.batches == len(host)
    for (o, a), h in zip(rest, host[1:]):
        np.testing.assert_array_equal(o["natural_language_embedding"].numpy(),
                                      h["observations"]["natural_language_embedding"])
        np.testing.assert_array_equal(a["terminate_episode"].numpy(),
                                      h["actions"]["terminate_episode"])
    assert feed.wait_s > 0 and feed.upload_s > 0


def test_device_feeder_close_stops_its_source(corpus):
    ds = WindowedEpisodeDataset(corpus, window=3, height=32, width=56)
    source = ds.numpy_batches(batch_size=4)
    feed = device_feeder(source, "cpu")
    next(feed)
    feed.close()
    with pytest.raises(StopIteration):
        next(feed)
    with pytest.raises(StopIteration):
        next(source)  # the generator was closed
