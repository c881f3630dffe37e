"""The port's corpus collection and normalization against the JAX package's.

* `collect_episode`, same seeds, BLOCK_4 block2block, ngram, clean and with
  DART noise (std 0.005, 160 steps): `action`, `is_first`, `is_terminal`,
  `instruction`, `instruction_text` and `task` bitwise; native `rgb` under
  the bound `tests/test_torch_envs_render.py` holds the renderer to (>= 99 %
  of every frame's pixels equal, the rest next to a colour edge); with
  `image_hw` set (32x56), `rgb` within 1/255 of the JAX episode (cv2
  against the native sampler) on an episode whose frames both renderers
  draw alike: where they differ next to an edge, the resize carries the
  difference into the small frame, so the corpora are held at 180x320.
  Attempts that fail, fail in both.
* `collect_dataset` (one process) and `collect_dataset_parallel` (2
  workers; the JAX package spawns, the port uses forkserver): the manifests
  equal as JSON, the same episode files in each split, each file's members
  as above.
* `finalize_shards` over the same shard files, and `corpus_accounting`:
  equal results, manifests and files.
* `normalization`: `ChanRunningStatistics`, `compute_dataset_statistics`
  and `get_or_compute_statistics` equal to JAX's numpy results exactly.
* The CLI, in process: one episode, and `--finalize_shards`.
"""

import json
import os

import numpy as np
import pytest

from rt1_tpu.data import collect as jax_collect
from rt1_tpu.data import normalization as jax_norm
from rt1_tpu.data.episodes import generate_synthetic_episode as jax_synthetic_episode
from rt1_tpu.data.episodes import save_episode as jax_save_episode
from rt1_tpu.envs import LanguageTable as JaxLanguageTable
from rt1_tpu.envs import blocks as jax_blocks
from rt1_tpu.envs import rewards as jax_rewards
from rt1_tpu.envs.oracles import RRTPushOracle as JaxRRTPushOracle
from rt1_tpu.eval.embedding import get_embedder as jax_get_embedder
from rt1_tpu_torch.data import collect, normalization
from rt1_tpu_torch.data.episodes import load_episode
from rt1_tpu_torch.envs import LanguageTable, blocks, rewards
from rt1_tpu_torch.envs.oracles import RRTPushOracle
from rt1_tpu_torch.eval.embedding import get_embedder
from test_torch_envs_render import _check_frame

RESIZED_TOL = 1  # uint8 levels: the native sampler against cv2.resize


def hold_episode(port, ref, what, resized=False):
    """The members bitwise, `rgb` under the renderer's bound (native) or
    within one level (resized)."""
    assert sorted(port) == sorted(ref), what
    for key in ref:
        assert port[key].dtype == ref[key].dtype and port[key].shape == ref[key].shape, \
            (what, key)
        if key != "rgb":
            assert port[key].tobytes() == ref[key].tobytes(), (what, key)
        elif resized:
            diff = np.abs(port[key].astype(np.int32) - ref[key].astype(np.int32))
            assert diff.max() <= RESIZED_TOL, (what, int(diff.max()))
        else:
            for t, (p, r) in enumerate(zip(port[key], ref[key])):
                _check_frame(p, r, f"{what} frame {t}")


def _collector_pair(seed):
    port_env = LanguageTable(block_mode=blocks.BlockMode.BLOCK_4,
                             reward_factory=rewards.get_reward_factory("block2block"), seed=seed)
    ref_env = JaxLanguageTable(block_mode=jax_blocks.BlockMode.BLOCK_4,
                               reward_factory=jax_rewards.get_reward_factory("block2block"),
                               seed=seed)
    return ((port_env, RRTPushOracle(port_env, use_ee_planner=True, seed=seed)),
            (ref_env, JaxRRTPushOracle(ref_env, use_ee_planner=True, seed=seed)))


def test_canonical_task_id_matches_jax():
    for name in ("block2block", "separate", "my_custom_reward", "", None):
        assert collect.canonical_task_id(name) == jax_collect.canonical_task_id(name)
    assert collect.canonical_task_id("nope") == "unknown:nope"


# (env seed, noise seed, DART std, max steps, image_hw). DART at 0.005
# needs the longer budget of the JAX package's DART test to finish often.
EPISODE_CASES = {
    "clean": (0, 1, 0.0, 80, None),
    "clean_resized": (0, 1, 0.0, 80, (32, 56)),
    "dart": (4, 1, 0.005, 160, None),
}


@pytest.mark.parametrize("case", sorted(EPISODE_CASES))
def test_collect_episode_matches_jax(case):
    seed, noise_seed, noise, max_steps, image_hw = EPISODE_CASES[case]
    (port_env, port_oracle), (ref_env, ref_oracle) = _collector_pair(seed)
    port_rng, ref_rng = np.random.default_rng(noise_seed), np.random.default_rng(noise_seed)
    for attempt in range(4):
        port = collect.collect_episode(port_env, port_oracle, get_embedder("ngram"),
                                       max_steps=max_steps, image_hw=image_hw,
                                       exec_noise_std=noise, noise_rng=port_rng,
                                       task="block2block")
        ref = jax_collect.collect_episode(ref_env, ref_oracle, jax_get_embedder("ngram"),
                                          max_steps=max_steps, image_hw=image_hw,
                                          exec_noise_std=noise, noise_rng=ref_rng,
                                          task="block2block")
        assert (port is None) == (ref is None), attempt
        if port is not None:
            break
    assert port is not None, "no episode succeeded in 4 attempts"
    hold_episode(port, ref, f"attempt {attempt}", resized=image_hw is not None)
    if image_hw is not None:
        assert port["rgb"].shape[1:] == (*image_hw, 3)


def test_collect_episode_noise_needs_a_generator():
    (env, oracle), _ = _collector_pair(seed=0)
    with pytest.raises(ValueError, match="noise_rng"):
        collect.collect_episode(env, oracle, get_embedder("hash"), exec_noise_std=0.01)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def hold_corpus(port_dir, ref_dir, resized):
    """Equal manifests and the same episode files in each split."""
    assert _read_json(os.path.join(port_dir, "manifest.json")) == \
        _read_json(os.path.join(ref_dir, "manifest.json"))
    splits = sorted(d for d in os.listdir(ref_dir) if os.path.isdir(os.path.join(ref_dir, d)))
    assert splits == sorted(d for d in os.listdir(port_dir)
                            if os.path.isdir(os.path.join(port_dir, d)))
    files = 0
    for split in splits:
        names = sorted(os.listdir(os.path.join(ref_dir, split)))
        assert names == sorted(os.listdir(os.path.join(port_dir, split))), split
        for name in names:
            hold_episode(load_episode(os.path.join(port_dir, split, name)),
                         load_episode(os.path.join(ref_dir, split, name)), f"{split}/{name}",
                         resized=resized)
            files += 1
    return files


def test_collect_dataset_matches_jax(tmp_path):
    kwargs = dict(reward_name="block2block", seed=0, max_steps=80, embedder="ngram",
                  splits=(("train", 0.5), ("val", 0.5)), progress_every=0)
    stats = {}
    port = collect.collect_dataset(str(tmp_path / "port"), 2,
                                   block_mode=blocks.BlockMode.BLOCK_4, stats=stats, **kwargs)
    ref = jax_collect.collect_dataset(str(tmp_path / "ref"), 2,
                                      block_mode=jax_blocks.BlockMode.BLOCK_4, **kwargs)
    assert port == ref == {"train": 1, "val": 1}
    assert stats["attempts"] >= 2
    assert hold_corpus(str(tmp_path / "port"), str(tmp_path / "ref"), resized=False) == 2


def test_collect_dataset_parallel_matches_jax(tmp_path):
    kwargs = dict(workers=2, reward_name="block2block", seed=0, max_steps=80, embedder="ngram",
                  splits=(("train", 0.5), ("val", 0.5)))
    stats = {}
    port = collect.collect_dataset_parallel(str(tmp_path / "port"), 2,
                                            block_mode=blocks.BlockMode.BLOCK_4, stats=stats,
                                            **kwargs)
    ref = jax_collect.collect_dataset_parallel(str(tmp_path / "ref"), 2,
                                               block_mode=jax_blocks.BlockMode.BLOCK_4, **kwargs)
    assert port == ref == {"train": 1, "val": 1}
    assert stats["attempts"] >= 2
    assert not os.path.exists(tmp_path / "port" / "_shards")
    assert hold_corpus(str(tmp_path / "port"), str(tmp_path / "ref"), resized=False) == 2
    assert collect.corpus_accounting(str(tmp_path / "port")) == \
        jax_collect.corpus_accounting(str(tmp_path / "ref")) == (2, port)


def _write_shards(data_dir, seed=0):
    rng = np.random.default_rng(seed)
    for w in range(2):
        shard = os.path.join(data_dir, "_shards", f"shard_{w}")
        os.makedirs(shard)
        for i in range(5):
            jax_save_episode(os.path.join(shard, f"episode_{i}.npz"),
                             jax_synthetic_episode(rng, num_steps=4, height=8, width=8))
    with open(os.path.join(data_dir, "_shards", "shard_1", "episode_9.npz"), "wb") as f:
        f.write(b"truncated")  # a worker killed inside np.savez


def test_finalize_shards_and_accounting_match_jax(tmp_path):
    fields = dict(splits=(("train", 0.8), ("val", 0.2)), seed=3, embedder="hash",
                  exec_noise_std=0.005, reward="block2block")
    for name in ("port", "ref"):
        _write_shards(str(tmp_path / name))
    port = collect.finalize_shards(str(tmp_path / "port"), **fields)
    ref = jax_collect.finalize_shards(str(tmp_path / "ref"), **fields)
    assert port == ref == {"train": 8, "val": 2}
    assert hold_corpus(str(tmp_path / "port"), str(tmp_path / "ref"), resized=False) == 10
    for manifest in (None, {"episodes": 12}):
        assert collect.corpus_accounting(str(tmp_path / "port"), manifest) == \
            jax_collect.corpus_accounting(str(tmp_path / "ref"), manifest)
    with pytest.raises(RuntimeError, match="refusing to finalize"):
        collect.finalize_shards(str(tmp_path / "port"), **fields)
    os.makedirs(tmp_path / "empty" / "_shards")
    with pytest.raises(RuntimeError, match="no intact shard episodes"):
        collect.finalize_shards(str(tmp_path / "empty"), **fields)


def test_write_manifest_matches_jax(tmp_path):
    class Named:
        name = "ngram"

    for name, write in (("port", collect.write_manifest), ("ref", jax_collect.write_manifest)):
        os.makedirs(tmp_path / name)
        write(str(tmp_path / name), embedder=Named(), episodes=3, image_hw=(32, 56), seed=1)
    with open(tmp_path / "port" / "manifest.json", "rb") as f, \
            open(tmp_path / "ref" / "manifest.json", "rb") as g:
        assert f.read() == g.read()


def test_collect_cli(tmp_path, capsys):
    out = str(tmp_path / "cli")
    assert collect.main(["--data_dir", out, "--episodes", "1", "--block_mode", "BLOCK_4",
                         "--seed", "1", "--embedder", "ngram"]) == 0
    assert "done: {'train': 1, 'val': 0, 'test': 0}" in capsys.readouterr().out
    manifest = _read_json(os.path.join(out, "manifest.json"))
    assert manifest["episodes"] == 1 and manifest["embedder"] == "ngram"
    assert manifest["block_mode"] == "BLOCK_4" and manifest["exec_noise_std"] == 0.0
    ep = load_episode(os.path.join(out, "train", "episode_0.npz"))
    assert ep["rgb"].shape[1:] == (180, 320, 3) and ep["is_terminal"][-1]
    salvage = str(tmp_path / "salvage")
    _write_shards(salvage)
    assert collect.main(["--data_dir", salvage, "--finalize_shards", "--embedder", "ngram",
                         "--block_mode", "BLOCK_4", "--workers", "2"]) == 0
    assert "finalized: {'train': 10, 'val': 0, 'test': 0}" in capsys.readouterr().out
    assert _read_json(os.path.join(salvage, "manifest.json"))["workers"] == 2


def _batches(rng, n, b=4, t=3):
    for _ in range(n):
        yield {"actions": {"action": rng.uniform(-0.1, 0.1, (b, t, 2)).astype(np.float32)},
               "observations": {"natural_language_embedding":
                                rng.standard_normal((b, t, 16)).astype(np.float32)}}


def test_normalization_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    samples = [rng.standard_normal((5, 3)), rng.standard_normal(3), rng.standard_normal((2, 4, 3))]
    port, ref = normalization.ChanRunningStatistics(), jax_norm.ChanRunningStatistics()
    for s in samples:
        port.update(s)
        ref.update(s)
        assert port.n == ref.n
        assert port.mean.tobytes() == ref.mean.tobytes()
        assert np.asarray(port.variance).tobytes() == np.asarray(ref.variance).tobytes()
    assert port.std.tobytes() == ref.std.tobytes()
    for num_samples in (10, 1000):
        got = normalization.compute_dataset_statistics(_batches(np.random.default_rng(1), 6),
                                                       num_samples)
        want = jax_norm.compute_dataset_statistics(_batches(np.random.default_rng(1), 6),
                                                   num_samples)
        assert got == want
    path = str(tmp_path / "stats" / "stats.json")
    got = normalization.get_or_compute_statistics(path, lambda: {"a": [1.0, 2.5]})
    assert got == jax_norm.get_or_compute_statistics(path, lambda: {"a": [0.0]}) == \
        {"a": [1.0, 2.5]}
    with pytest.raises(TimeoutError):
        normalization.get_or_compute_statistics(str(tmp_path / "none.json"), None,
                                                is_lead_host=False, timeout_s=0.05, poll_s=0.01)
