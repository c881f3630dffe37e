"""'Push the block to the bottom-left corner' single-corner task.

Parity source: reference
`language_table/environments/rewards/block1_to_corner.py`.
"""

import enum

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import language, task_info
from rt1_tpu_torch.envs.rewards import base

_BUFFER = 0.08
X_MAX = 0.6
Y_MIN = -0.3048

TARGET_DISTANCE = 0.08


class Locations(enum.Enum):
    BOTTOM_LEFT = "bottom_left"


ABSOLUTE_LOCATIONS = {
    "bottom_left": [X_MAX - _BUFFER, Y_MIN + _BUFFER],
}

LOCATION_SYNONYMS = {
    "bottom_left": [
        "bottom left of the board",
        "bottom left",
        "bottom left corner",
    ],
}

VERBS = [
    "move the",
    "push the",
    "slide the",
]


def generate_all_instructions(block_mode, verbs=None, names=None):
    """Pass `verbs=language.PUSH_VERBS` / synonym names for the sampler's
    actual spaces (see `rewards.generate_runtime_instructions`)."""
    out = []
    verbs = VERBS if verbs is None else verbs
    if names is None:
        names = blocks_module.text_descriptions(block_mode)
    for block_text in names:
        for location in ABSOLUTE_LOCATIONS:
            for location_syn in LOCATION_SYNONYMS[location]:
                for verb in verbs:
                    out.append(f"{verb} {block_text} to the {location_syn}")
    return out


def runtime_instructions(block_mode):
    """Sampler-complete: PUSH_VERBS (the sampler's list) x all synonyms."""
    flat = [v for g in blocks_module.synonym_groups(block_mode) for v in g]
    return generate_all_instructions(
        block_mode, verbs=language.PUSH_VERBS, names=flat
    )


class BlockToCornerReward(base.BoardReward):
    """Sparse reward when the chosen block reaches the corner region."""

    def __init__(self, goal_reward, rng, delay_reward_steps, block_mode):
        super().__init__(goal_reward, rng, delay_reward_steps, block_mode)
        self._block = None
        self._instruction = None
        self._location = None
        self._target_translation = None

    def _sample_instruction(self, block, blocks_on_table, location):
        verb = self._rng.choice(language.PUSH_VERBS)
        block_text = self._pick_synonym(block, blocks_on_table)
        location_syn = self._rng.choice(LOCATION_SYNONYMS[location])
        return f"{verb} {block_text} to the {location_syn}"

    def reset(self, state, blocks_on_table):
        block = self._pick_block(blocks_on_table)
        location = self._rng.choice(list(sorted(ABSOLUTE_LOCATIONS.keys())))
        info = self.reset_to(state, block, location, blocks_on_table)
        # Reject boards that already satisfy the task. A plain reward() call
        # would miss this under delay_reward_steps > 0 (and bump the zone
        # counter); check the goal region directly.
        dist = np.linalg.norm(
            self._block_xy(self._block, state)
            - np.array(self._target_translation)
        )
        if dist < TARGET_DISTANCE:
            return task_info.FAILURE
        return info

    def reset_to(self, state, block, location, blocks_on_table):
        self._block = block
        self._instruction = self._sample_instruction(
            block, blocks_on_table, location
        )
        self._target_translation = np.copy(ABSOLUTE_LOCATIONS[location])
        self._location = location
        info = self.get_current_task_info(state)
        self._in_reward_zone_steps = 0
        return info

    @property
    def target_translation(self):
        return self._target_translation

    def reward(self, state):
        return self.reward_for(state, self._block, self._target_translation)

    def reward_for(self, state, pushing_block, target_translation):
        dist = np.linalg.norm(
            self._block_xy(pushing_block, state)
            - np.array(target_translation)
        )
        return self._maybe_goal(dist < TARGET_DISTANCE)

    def reward_for_info(self, state, info):
        return self.reward_for(state, info.block, info.target_translation)

    def debug_info(self, state):
        return np.linalg.norm(
            self._block_xy(self._block, state)
            - np.array(self._target_translation)
        )

    def get_current_task_info(self, state):
        return task_info.Block2LocationTaskInfo(
            instruction=self._instruction,
            block=self._block,
            location=self._location,
            target_translation=self._target_translation,
        )
