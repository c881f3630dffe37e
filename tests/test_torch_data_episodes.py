"""The port's episode format (`rt1_tpu_torch/data/episodes.py`) against the
JAX package's (`rt1_tpu/data/episodes.py`), on the CPU: files written by
either package load in the other with every member byte-equal, synthetic
episodes are equal for the same generator, the reference's pickled `.npy`
reads the same, and `read_manifest` reads what the collector writes.
"""

import json

import numpy as np
import pytest

from rt1_tpu.data import episodes as jax_episodes
from rt1_tpu_torch.data import episodes


def _assert_episodes_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _episode(seed, steps=8, h=36, w=64):
    ep = episodes.generate_synthetic_episode(np.random.default_rng(seed), num_steps=steps,
                                             height=h, width=w)
    ep["instruction_text"] = episodes.encode_instruction_text("push the red star left")
    ep["task"] = episodes.encode_instruction_text("block2block")
    return ep


@pytest.mark.parametrize("num_steps", [None, 1, 12])
def test_synthetic_episode_equals_jax_for_the_same_generator(num_steps):
    ours = episodes.generate_synthetic_episode(np.random.default_rng(7), num_steps=num_steps,
                                               height=18, width=32)
    theirs = jax_episodes.generate_synthetic_episode(np.random.default_rng(7),
                                                     num_steps=num_steps, height=18, width=32)
    _assert_episodes_equal(ours, theirs)


def test_flagship_schema_episode():
    ep = episodes.generate_synthetic_episode(np.random.default_rng(0), num_steps=3)
    assert ep["rgb"].shape == (3, 180, 320, 3) and ep["rgb"].dtype == np.uint8
    assert ep["instruction"].shape == (3, 512) and ep["action"].shape == (3, 2)
    assert ep["is_first"].tolist() == [True, False, False]
    assert ep["is_terminal"].tolist() == [False, False, True]
    _assert_episodes_equal(ep, jax_episodes.generate_synthetic_episode(
        np.random.default_rng(0), num_steps=3))


def test_files_cross_between_the_packages(tmp_path):
    ep = _episode(1)
    episodes.save_episode(str(tmp_path / "ours" / "episode_0.npz"), ep)
    jax_episodes.save_episode(str(tmp_path / "jax" / "episode_0.npz"), ep)
    assert (tmp_path / "ours" / "episode_0.npz").read_bytes() == \
        (tmp_path / "jax" / "episode_0.npz").read_bytes()
    for written in ("ours", "jax"):
        path = str(tmp_path / written / "episode_0.npz")
        _assert_episodes_equal(episodes.load_episode(path), ep)
        _assert_episodes_equal(jax_episodes.load_episode(path), ep)
    assert episodes.decode_instruction_text(ep["instruction_text"]) == "push the red star left"


def test_reference_npy_reads_like_jax(tmp_path):
    rng = np.random.default_rng(2)
    steps = np.empty(4, dtype=object)
    for t in range(4):
        steps[t] = {"rgb": rng.integers(0, 256, (6, 9, 3), dtype=np.uint8),
                    "action": rng.uniform(-1, 1, 2), "is_first": t == 0,
                    "is_terminal": t == 3, "instruction": rng.standard_normal(512)}
    path = str(tmp_path / "reference.npy")
    np.save(path, steps, allow_pickle=True)
    _assert_episodes_equal(episodes.read_reference_episode(path),
                           jax_episodes.read_reference_episode(path))


def test_validate_episode_rejects_what_jax_rejects():
    ep = _episode(3, steps=4)
    for broken, error in (({k: v for k, v in ep.items() if k != "action"}, KeyError),
                          ({**ep, "is_terminal": ep["is_terminal"][:3]}, ValueError)):
        with pytest.raises(error):
            episodes.validate_episode(broken)
        with pytest.raises(error):
            jax_episodes.validate_episode(broken)
    assert episodes.REQUIRED_KEYS == jax_episodes.REQUIRED_KEYS


def test_read_manifest(tmp_path):
    assert episodes.read_manifest(str(tmp_path)) is None
    fields = {"embedder": "hash", "episodes": 3, "env": {"block_mode": "BLOCK_8"}}
    (tmp_path / "manifest.json").write_text(json.dumps(fields))
    assert episodes.read_manifest(str(tmp_path)) == fields
