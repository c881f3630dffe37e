"""The port's sample-ahead feeder (`rt1_tpu_torch/data/feeder.py`) against
the JAX package's (`rt1_tpu/data/feeder.py`), on the CPU.

Tolerance: exact. For one pack and seed the two feeders give byte-equal
streams: at 1 and 3 threads on either side, with crops, with task weights,
and split over two processes (whose blocks also concatenate to the
one-process batch). A finite stream ends after exactly its batches,
`close` stops the workers promptly, a hung worker raises
`FeederStalledError`, a failing worker raises on the consumer, and a
refreshing feeder picks an appended shard up at its next epoch.
"""

import threading
import time

import numpy as np
import pytest

from rt1_tpu.data import feeder as jax_feeder
from rt1_tpu.data import pack as jax_pack
from rt1_tpu_torch.data import episodes, pack
from rt1_tpu_torch.data import feeder as port_feeder
from rt1_tpu_torch.data.feeder import FeederStalledError, SampleAheadFeeder, parse_task_weights

H, W, WINDOW = 16, 28, 3


def _write(directory, n, seed, start=0, tasks=None):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(start, start + n):
        ep = episodes.generate_synthetic_episode(rng, num_steps=6 + i % 2, height=24, width=40)
        if tasks is not None:
            ep["task"] = episodes.encode_instruction_text(tasks[i % len(tasks)])
        paths.append(str(directory / f"episode_{i:03d}.npz"))
        episodes.save_episode(paths[-1], ep)
    return paths


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    src = tmp_path_factory.mktemp("feeder_src")
    paths = _write(src, 5, 0, tasks=["block2block", "separate", "block2block"])
    out = str(tmp_path_factory.mktemp("feeder_pack"))
    pack.pack_episodes(paths, out, H, W, 0.95)
    return out


def _stream(lib_feeder, cache, n, **kwargs):
    with lib_feeder.SampleAheadFeeder(cache, 4, **kwargs) as f:
        return [next(f) for _ in range(n)]


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for group in ("observations", "actions"):
            assert sorted(x[group]) == sorted(y[group])
            for k in x[group]:
                assert x[group][k].dtype == y[group][k].dtype, k
                np.testing.assert_array_equal(x[group][k], y[group][k], err_msg=k)


@pytest.mark.parametrize("ours_threads,jax_threads", [(1, 3), (3, 1)])
def test_stream_equals_jax(packed, ours_threads, jax_threads):
    ours = pack.PackedEpisodeCache(packed, window=WINDOW)
    theirs = jax_pack.PackedEpisodeCache(packed, window=WINDOW)
    n = 2 * (len(ours) // 4) + 3  # into the third epoch
    a = _stream(port_feeder, ours, n, seed=7,
                num_threads=ours_threads)
    b = _stream(jax_feeder, theirs, n, seed=7, num_threads=jax_threads)
    _assert_streams_equal(a, b)
    assert a[0]["observations"]["image"].shape == (4, WINDOW, H, W, 3)
    assert not np.array_equal(a[0]["observations"]["image"], a[1]["observations"]["image"])


def test_task_weighted_stream_equals_jax(packed):
    ours = pack.PackedEpisodeCache(packed, window=WINDOW)
    theirs = jax_pack.PackedEpisodeCache(packed, window=WINDOW)
    weights = "separate:3,*:1"
    a = _stream(port_feeder, ours, 12, seed=2,
                num_threads=2, task_weights=weights)
    b = _stream(jax_feeder, theirs, 12, seed=2, num_threads=2, task_weights=weights)
    _assert_streams_equal(a, b)
    unweighted = _stream(port_feeder, ours, 1,
                         seed=2)
    assert not np.array_equal(a[0]["actions"]["action"], unweighted[0]["actions"]["action"])


def test_process_blocks_equal_jax_and_concatenate(packed):
    ours = pack.PackedEpisodeCache(packed, window=WINDOW)
    theirs = jax_pack.PackedEpisodeCache(packed, window=WINDOW)
    with SampleAheadFeeder(ours, 8, seed=4) as whole:
        single = [next(whole) for _ in range(3)]
    blocks = []
    for p in range(2):
        kw = dict(seed=4, process_index=p, process_count=2, num_threads=2)
        with SampleAheadFeeder(ours, 4, **kw) as f, \
                jax_feeder.SampleAheadFeeder(theirs, 4, **kw) as g:
            mine = [next(f) for _ in range(3)]
            _assert_streams_equal(mine, [next(g) for _ in range(3)])
        blocks.append(mine)
    for b, one in enumerate(single):
        for group in ("observations", "actions"):
            for k in one[group]:
                np.testing.assert_array_equal(
                    np.concatenate([blocks[0][b][group][k], blocks[1][b][group][k]]),
                    one[group][k])


def test_finite_epochs_end_exactly(packed):
    cache = pack.PackedEpisodeCache(packed, window=WINDOW)
    with SampleAheadFeeder(cache, 4, seed=0, num_epochs=2, num_threads=3) as f:
        got = list(f)
    assert len(got) == 2 * (len(cache) // 4) == 2 * f.batches_per_epoch
    with jax_feeder.SampleAheadFeeder(jax_pack.PackedEpisodeCache(packed, window=WINDOW), 4,
                                      seed=0, num_epochs=2) as g:
        _assert_streams_equal(got, list(g))
    with pytest.raises(ValueError, match="exceeds"):
        SampleAheadFeeder(cache, len(cache) + 1)


def test_close_is_prompt_from_a_full_queue(packed):
    cache = pack.PackedEpisodeCache(packed, window=WINDOW)
    f = SampleAheadFeeder(cache, 4, seed=0, num_threads=3, depth=1)
    next(f)
    time.sleep(0.3)  # let every queue fill
    t0 = time.perf_counter()
    f.close()
    assert time.perf_counter() - t0 < 2.0
    assert not any(t.is_alive() for t in f._threads)
    with pytest.raises(StopIteration):
        next(f)


def test_hung_worker_raises_stalled(packed, monkeypatch):
    cache = pack.PackedEpisodeCache(packed, window=WINDOW)
    release = threading.Event()

    def hang(self, ticket):
        release.wait(10)
        return {}

    monkeypatch.setattr(SampleAheadFeeder, "_assemble", hang)
    f = SampleAheadFeeder(cache, 4, seed=0, num_threads=2, stall_timeout_s=0.3)
    try:
        t0 = time.perf_counter()
        with pytest.raises(FeederStalledError, match="rt1-feeder-0"):
            next(f)
        assert time.perf_counter() - t0 < 3.0
    finally:
        release.set()
        f.close()


def test_failing_worker_raises_on_the_consumer(packed, monkeypatch):
    cache = pack.PackedEpisodeCache(packed, window=WINDOW)

    def fail(self, ticket):
        raise OSError("frames.bin truncated")

    monkeypatch.setattr(SampleAheadFeeder, "_assemble", fail)
    with SampleAheadFeeder(cache, 4, seed=0) as f:
        with pytest.raises(RuntimeError, match="worker failed") as info:
            next(f)
    assert isinstance(info.value.__cause__, OSError)


def test_refresh_at_epoch_picks_up_an_appended_shard(tmp_path):
    base = _write(tmp_path, 3, 1)
    out = str(tmp_path / "pack")
    pack.pack_episodes(base, out, H, W, 0.95)
    cache = pack.PackedEpisodeCache(out, window=WINDOW)
    f = SampleAheadFeeder(cache, 4, seed=1, refresh_at_epoch=True, num_threads=1, depth=1)
    try:
        first = [next(f) for _ in range(f.batches_per_epoch)]
        windows = len(cache)
        pack.append_shard(out, _write(tmp_path / "new", 2, 9, start=10))
        for _ in range(2 * f.batches_per_epoch + 2):
            next(f)
        assert len(cache) > windows and cache.refreshes == 1
        later = SampleAheadFeeder(pack.PackedEpisodeCache(out, window=WINDOW), 4, seed=1,
                                  start=False)
        assert len(later.host_order(1)) == len(f.host_order(2)) > len(first) * 4
    finally:
        f.close()


def test_parse_task_weights_equals_jax():
    for spec in (None, "", "block2block:3,separate:1", " a:1 , ,b:0 ", "unknown:foo:2,*:0.5",
                 {"x": 2}):
        assert parse_task_weights(spec) == jax_feeder.parse_task_weights(spec)
    for bad in ("nocolon", "a:x", "a:-1", "a:0,b:0", "a:inf"):
        with pytest.raises(ValueError):
            parse_task_weights(bad)
        with pytest.raises(ValueError):
            jax_feeder.parse_task_weights(bad)


def test_left_out_and_refused_options_raise(packed):
    cache = pack.PackedEpisodeCache(packed, window=WINDOW)
    # emit_task_ids is ported now: it names the tasks instead of raising
    # (its stream is held to JAX's in test_torch_obs_train.py).
    feeder = SampleAheadFeeder(cache, 4, emit_task_ids=True, start=False)
    assert feeder.health_task_names[-1] == "other"
    with pytest.raises(ValueError, match="single-process"):
        SampleAheadFeeder(cache, 4, refresh_at_epoch=True, process_count=2)
    with pytest.raises(ValueError, match="shuffle"):
        SampleAheadFeeder(cache, 4, shuffle=False, task_weights="a:1")
