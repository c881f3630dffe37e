"""Checkpoint retention of the port's trainer against the JAX trainer's.

The JAX trainer builds its Orbax manager with `max_to_keep=config.
max_to_keep or None` and `keep_period=config.keep_period`
(`rt1_tpu/train/train.py:680-689`). The port's trainer builds its own
through `rt1_tpu_torch.train.train.checkpoint_manager`. Both save the
same schedule, steps 1 to 12, and must keep the same steps for every
listed (max_to_keep, keep_period); 0 keeps everything, as in JAX.
"""

import numpy as np
import pytest

from rt1_tpu.trainer.checkpoints import CheckpointConfig
from rt1_tpu.trainer.checkpoints import CheckpointManager as JaxCheckpointManager
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.trainer.checkpoints import CheckpointManager, all_steps
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.train.train import build_model, checkpoint_manager

STEPS = range(1, 13)
SETTINGS = [(None, None), (0, None), (1, None), (2, None), (2, 3), (None, 3)]


@pytest.fixture(scope="module")
def state():
    return create_train_state(build_model(get_config("tiny"), "cpu"), Adam())


def _jax_retained(directory, max_to_keep, keep_period):
    mgr = JaxCheckpointManager(CheckpointConfig(
        directory=directory, max_to_keep=max_to_keep or None, save_interval_steps=1,
        keep_period=keep_period))
    for step in STEPS:
        assert mgr.save(step, {"w": np.arange(4.0), "step": np.asarray(step, np.int32)})
        mgr.wait_until_finished()
    steps = sorted(mgr.all_steps())
    mgr.close()
    return steps


@pytest.mark.parametrize("max_to_keep,keep_period", SETTINGS)
def test_retained_steps_match_jax(tmp_path, state, max_to_keep, keep_period):
    config = get_config("tiny")
    config.max_to_keep, config.keep_period = max_to_keep, keep_period
    mgr = checkpoint_manager(config, str(tmp_path / "port"))
    for step in STEPS:
        mgr.save(step, state)
    port = all_steps(mgr.directory)
    jax = _jax_retained(str(tmp_path / "jax"), max_to_keep, keep_period)
    assert port == jax, (max_to_keep, keep_period)
    if not max_to_keep:
        assert port == list(STEPS)
    if max_to_keep == 1 and keep_period is None:
        assert port == [12]


def test_flagship_keep_period_and_refusals(tmp_path):
    assert get_config("language_table").keep_period == 9750
    for bad in ({"max_to_keep": 0}, {"max_to_keep": -1}, {"keep_period": 0}):
        with pytest.raises(ValueError):
            CheckpointManager(str(tmp_path), **bad)
