"""'Push block X to <absolute board location>' task.

Parity source: reference
`language_table/environments/rewards/block2absolutelocation.py`.
"""

import enum

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import language, task_info
from rt1_tpu_torch.envs.rewards import base

# The arm's reachable bounds are offset slightly from the board center in x;
# absolute named locations compensate (reference `block2absolutelocation.py:28-46`).
_X_BUFFER = 0.025
X_MIN = 0.15 - _X_BUFFER
X_MAX = 0.6 - _X_BUFFER
Y_MIN = -0.3048
Y_MAX = 0.3048
CENTER_X = (X_MAX - X_MIN) / 2.0 + X_MIN
CENTER_Y = (Y_MAX - Y_MIN) / 2.0 + Y_MIN

TARGET_DISTANCE = 0.115
CENTER_TARGET_DISTANCE = 0.1


class Locations(enum.Enum):
    TOP = "top"
    TOP_LEFT = "top_left"
    TOP_RIGHT = "top_right"
    CENTER = "center"
    CENTER_LEFT = "center_left"
    CENTER_RIGHT = "center_right"
    BOTTOM = "bottom"
    BOTTOM_LEFT = "bottom_left"
    BOTTOM_RIGHT = "bottom_right"


ABSOLUTE_LOCATIONS = {
    "top": [X_MIN, CENTER_Y],
    "top_left": [X_MIN, Y_MIN],
    "top_right": [X_MIN, Y_MAX],
    "center": [CENTER_X, CENTER_Y],
    "center_left": [CENTER_X, Y_MIN],
    "center_right": [CENTER_X, Y_MAX],
    "bottom": [X_MAX, CENTER_Y],
    "bottom_left": [X_MAX, Y_MIN],
    "bottom_right": [X_MAX, Y_MAX],
}

LOCATION_SYNONYMS = {
    "top": ["top side", "top", "towards your base"],
    "top_left": [
        "top left of the board",
        "top left",
        "upper left corner",
        "top left corner",
    ],
    "top_right": [
        "top right of the board",
        "top right",
        "upper right corner",
        "top right corner",
    ],
    "center": [
        "middle of the board",
        "center of the board",
        "center",
        "middle",
    ],
    "center_left": ["left side of the board", "center left", "left side"],
    "center_right": ["right side of the board", "center right", "right side"],
    "bottom": ["bottom side", "bottom"],
    "bottom_left": [
        "bottom left of the board",
        "bottom left",
        "lower left corner",
        "bottom left corner",
    ],
    "bottom_right": [
        "bottom right of the board",
        "bottom right",
        "lower right corner",
        "bottom right corner",
    ],
}

VERBS = [
    "move the",
    "push the",
    "slide the",
]


def generate_all_instructions(block_mode, verbs=None, names=None):
    """Enumeration mirrors the reference's 3-verb list and canonical names
    by default; `runtime_instructions` passes the sampler's actual spaces
    (see `rewards.generate_runtime_instructions`)."""
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


class BlockToAbsoluteLocationReward(base.BoardReward):
    """Sparse reward when the block reaches a named board region."""

    def __init__(self, goal_reward, rng, delay_reward_steps, block_mode):
        super().__init__(goal_reward, rng, delay_reward_steps, block_mode)
        self._block = None
        self._instruction = None
        self._location = None
        self._target_translation = None

    def _sample_instruction(self, block, blocks_on_table, location):
        # NOTE: samples the verb from the generic push-verb list, matching the
        # reference (`block2absolutelocation.py:127-136`), which differs from
        # the 3-verb list used for enumeration.
        verb = self._rng.choice(language.PUSH_VERBS)
        block_text = self._pick_synonym(block, blocks_on_table)
        location_syn = self._rng.choice(LOCATION_SYNONYMS[location])
        return f"{verb} {block_text} to the {location_syn}"

    def reset(self, state, blocks_on_table):
        block = self._pick_block(blocks_on_table)
        location = self._rng.choice(list(sorted(ABSOLUTE_LOCATIONS.keys())))
        info = self.reset_to(state, block, location, blocks_on_table)
        if self._in_goal_region(state, self._block, self._target_translation):
            # Board already satisfies the task; ask the env to re-randomize.
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

    def _radius(self):
        if self._location == Locations.CENTER.value:
            return CENTER_TARGET_DISTANCE
        return TARGET_DISTANCE

    def get_goal_region(self):
        return self._target_translation, self._radius()

    def _in_goal_region(self, state, block, target_translation):
        dist = np.linalg.norm(
            self._block_xy(block, state) - np.array(target_translation)
        )
        return dist < self._radius()

    def reward(self, state):
        return self.reward_for(state, self._block, self._target_translation)

    def reward_for(self, state, pushing_block, target_translation):
        return self._maybe_goal(
            self._in_goal_region(state, pushing_block, target_translation)
        )

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
