"""Reward-family base class for the Language-Table board.

Parity source: reference `language_table/environments/rewards/reward.py:24-74`.
A reward owns task sampling (`reset` → TaskInfo or FAILURE) and scoring
(`reward(state)` → (reward, done)). `state` is the flat dict the env exposes:
`block_<name>_translation` / `block_<name>_orientation` per block plus
effector keys.
"""

import numpy as np

from rt1_tpu_torch.envs import constants, language


class BoardReward:
    """Base class for all board reward/task families."""

    def __init__(self, goal_reward, rng, delay_reward_steps, block_mode):
        self._block_mode = block_mode
        self._goal_reward = goal_reward
        self._rng = rng
        # Number of consecutive in-zone steps required before the sparse
        # reward fires (0 = immediate).
        self._delay_reward_steps = delay_reward_steps
        self._in_reward_zone_steps = None
        self._target_translation = None

    def seed(self, rng):
        self._rng = rng

    def get_goal_region(self):
        """(target translation, radius) for visualization, or (None, None)."""
        return None, None

    def reset(self, state, blocks_on_table):
        raise NotImplementedError

    def reward(self, state):
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------

    def _block_pose(self, block, state):
        return (
            state[f"block_{block}_translation"],
            state[f"block_{block}_orientation"],
        )

    def _block_xy(self, block, state):
        return np.array(self._block_pose(block, state)[0])

    def _pick_block(self, blocks_on_table):
        return self._rng.choice(blocks_on_table)

    def _pick_two_blocks(self, blocks_on_table):
        return self._rng.choice(blocks_on_table, 2, replace=False)

    def _pick_synonym(self, block, blocks_on_table):
        return self._rng.choice(language.block_synonyms(block, blocks_on_table))

    def _maybe_goal(self, in_zone):
        """Sparse-reward gate with the delay-steps mechanism."""
        if in_zone:
            if self._in_reward_zone_steps >= self._delay_reward_steps:
                return self._goal_reward, True
            self._in_reward_zone_steps += 1
        return 0.0, False


def inside_bounds(target, buffer=constants.WORKSPACE_BOUNDS_BUFFER):
    """Is an (x, y) target inside the workspace, with a safety buffer?"""
    x, y = target
    return (
        constants.X_MIN + buffer < x < constants.X_MAX - buffer
        and constants.Y_MIN + buffer < y < constants.Y_MAX - buffer
    )
