"""Sweep trials and the bounded shuffle buffer, on the CPU.

* `configs.sweep("language_table")` equals the JAX config file's
  `sweep()`; a config without one raises as JAX's trainer does; the
  out-of-range message of `apply_sweep_trial` equals JAX's.
* `python -m rt1_tpu_torch.train --sweep_trial N` applies trial N before
  `--set` and logs it: trial 1 trains at lr 5e-4, trial 0 at 1e-3, and a
  later `--set learning_rate=...` wins.
* `pipeline.buffered_shuffle` has tf.data's fill-and-draw semantics:
  buffer 1 keeps the stream's order, draw t comes only from stream
  positions below t + B, no item is drawn twice, the same seed gives the
  same order. The torch loader's `shuffle_buffer` runs it over the
  repeated index stream (draws span epochs); `data.loader="tf"` passes
  `data.shuffle_buffer`, `torch` keeps a full permutation an epoch. While
  the buffer interleaves epochs, each window's crops still come from its
  own (seed, epoch, index) generator: no two windows repeat one
  generator's first draws.
"""

import itertools
import json

import numpy as np
import pytest

from rt1_tpu.train import train as jax_train
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu_torch import configs
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset, _EpochBatches, buffered_shuffle
from rt1_tpu_torch.train import train as torch_train
from rt1_tpu_torch.train.__main__ import main as train_main

TINY_MODEL = ("model.vocab_size=32", "model.token_embedding_size=16", "model.num_layers=2",
              "model.layer_size=8", "model.num_heads=2", "model.feed_forward_size=16",
              "model.time_sequence_length=3", "model.num_image_tokens=2",
              "model.image_tokenizer=tiny", "model.dtype=float32", "data.height=32",
              "data.width=56", "num_steps=1", "obs.model_health=False",
              "obs.goodput_mfu=False", "log_every_steps=1", "eval_every_steps=100",
              "checkpoint_every_steps=1", "per_host_batch_size=2")


def test_sweep_list_equals_jax():
    assert configs.sweep("language_table") == jax_language_table.sweep()
    assert configs.sweep("rt1_tpu/train/configs/language_table.py") == jax_language_table.sweep()
    with pytest.raises(ValueError, match="tiny defines no sweep"):
        configs.sweep("tiny")


@pytest.mark.parametrize("trial", [3, -1, 10])
def test_out_of_range_message_equals_jax(trial):
    with pytest.raises(ValueError) as ours:
        torch_train.apply_sweep_trial(get_config("language_table"), "language_table", trial)
    with pytest.raises(ValueError) as theirs:
        jax_train.apply_sweep_trial(jax_language_table.get_config(), jax_language_table, trial)
    assert str(ours.value) == str(theirs.value)


def test_apply_sweep_trial_sets_the_fields():
    for trial, overrides in enumerate(jax_language_table.sweep()):
        config = get_config("language_table")
        assert torch_train.apply_sweep_trial(config, "language_table", trial) == overrides
        assert (config.learning_rate, config.seed) == (overrides["learning_rate"],
                                                        overrides["seed"])


def _train_lines(tmp_path, capsys, *argv):
    capsys.readouterr()
    train_main(["--config", "language_table", "--device", "cpu", "--workdir", str(tmp_path),
                *argv, *itertools.chain.from_iterable(("--set", s) for s in TINY_MODEL)])
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("trial,lr", [(1, 5e-4), (0, 1e-3)])
def test_sweep_trial_cli_trains_at_the_trial_lr(tmp_path, capsys, trial, lr):
    lines = _train_lines(tmp_path, capsys, "--sweep_trial", str(trial))
    logged = next(r for r in lines if r.get("status") == "sweep_trial")
    assert logged == {"status": "sweep_trial", "trial": trial,
                      "overrides": jax_language_table.sweep()[trial]}
    start = next(r for r in lines if r.get("status") == "start")
    assert start["learning_rate"] == lr and start["seed"] == 42
    assert any("loss" in r for r in lines)


def test_set_after_the_sweep_trial_wins(tmp_path, capsys):
    lines = _train_lines(tmp_path, capsys, "--sweep_trial", "0", "--set", "learning_rate=2e-4")
    start = next(r for r in lines if r.get("status") == "start")
    assert start["learning_rate"] == 2e-4


def test_buffer_of_one_keeps_the_stream_order():
    assert list(buffered_shuffle(range(50), 1, seed=3)) == list(range(50))


@pytest.mark.parametrize("n,buffer", [(40, 8), (100, 32), (17, 17), (9, 30)])
def test_buffered_draws_fill_and_draw(n, buffer):
    order = list(buffered_shuffle(range(n), buffer, seed=n))
    assert sorted(order) == list(range(n))  # every item once, none twice
    for t, position in enumerate(order):
        assert position < t + buffer, (t, position)
    assert order == list(buffered_shuffle(range(n), buffer, seed=n))
    if buffer > 1:
        assert order != list(buffered_shuffle(range(n), buffer, seed=n + 1))
    with pytest.raises(ValueError):
        next(buffered_shuffle(range(3), 0, seed=0))


def test_loader_order_spans_epochs():
    n, batch, buffer = 10, 3, 4
    sampler = _EpochBatches(n, batch, shuffle=True, seed=5, num_epochs=3, shuffle_buffer=buffer)
    keys = [key for keys in sampler for key in keys]
    assert len(keys) == (3 * n // batch) * batch
    positions = [epoch * n + idx for epoch, idx in keys]
    for t, position in enumerate(positions):
        assert position < t + min(n, buffer)
    assert len(set(positions)) == len(positions)
    # One buffered shuffle of the repeated stream, not one per epoch.
    flat = list(buffered_shuffle(range(3 * n), buffer, seed=5))[:len(keys)]
    assert keys == [(p // n, p % n) for p in flat]
    endless = _EpochBatches(n, batch, True, 5, None, shuffle_buffer=buffer)
    assert list(itertools.islice(iter(endless), 9)) == list(sampler)[:9]
    # Without the buffer: one permutation an epoch, as before.
    plain = [key for keys in _EpochBatches(n, 5, True, 5, 2) for key in keys]
    assert sorted(idx for epoch, idx in plain if epoch == 0) == list(range(n))


def test_buffered_loader_crops_across_epoch_boundaries(tmp_path):
    from rt1_tpu_torch.data import episodes

    # Every step shows one frame, so a window's pixels are its crops.
    ep = episodes.generate_synthetic_episode(np.random.default_rng(4), num_steps=8,
                                             height=36, width=64)
    ep["rgb"][:] = ep["rgb"][0]
    path = str(tmp_path / "episode_000.npz")
    episodes.save_episode(path, ep)
    ds = WindowedEpisodeDataset([path], window=3, crop_factor=0.8, height=32, width=56)
    n, batch, epochs, seed = len(ds), 4, 3, 7
    loader = ds.as_torch_loader(batch_size=batch, seed=seed, num_workers=0, num_epochs=epochs,
                                shuffle_buffer=2048)  # buffer = n: epochs interleave
    got = [b["observations"]["image"] for b in loader]
    keys = list(_EpochBatches(n, batch, True, seed, epochs, shuffle_buffer=2048))
    assert len(got) == len(keys) == epochs * n // batch
    assert len({epoch for k in keys for epoch, _ in k}) == epochs
    # The interleaving is real: the key stream switches epoch many times.
    flat = [key for k in keys for key in k]
    assert sum(a[0] != b[0] for a, b in zip(flat, flat[1:])) > epochs
    windows = []
    for images, k in zip(got, keys):
        for image, (epoch, idx) in zip(images, k):
            want = ds.get_window(idx, np.random.default_rng([seed, epoch, idx]))
            np.testing.assert_array_equal(image.numpy(), want["observations"]["image"])
            windows.append(image.numpy().tobytes())
    assert len(set(windows)) == len(windows)  # no two windows share their crops


@pytest.mark.parametrize("loader,want", [("tf", 512), ("torch", None)])
def test_dataset_batches_passes_the_buffer_for_tf_only(loader, want, monkeypatch, tmp_path):
    from rt1_tpu_torch.data import episodes

    rng = np.random.default_rng(0)
    for i in range(2):
        episodes.save_episode(str(tmp_path / "train" / f"episode_{i}.npz"),
                              episodes.generate_synthetic_episode(rng, num_steps=6, height=24,
                                                                  width=40))
    seen = {}

    def fake_loader(self, *args, **kwargs):
        seen.update(kwargs)
        return []

    monkeypatch.setattr(WindowedEpisodeDataset, "as_torch_loader", fake_loader)
    config = get_config("tiny")
    config.data.data_dir, config.data.loader, config.data.shuffle_buffer = \
        str(tmp_path), loader, 512
    stream = torch_train.dataset_batches(config, "train")
    assert stream.loader == "torch" and seen["shuffle_buffer"] == want
