"""'Push block X <relative position> of block Y' task.

Parity source: reference
`language_table/environments/rewards/block2block_relative_location.py`.
"""

import itertools

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import language, task_info
from rt1_tpu_torch.envs.rewards import base

MAGNITUDE_X = 0.08
MAGNITUDE_Y = 0.08
MAGNITUDE_X_DIAG = 0.04
MAGNITUDE_Y_DIAG = 0.04

DRAGGED_THRESHOLD = 0.05
TARGET_DISTANCE = 0.04

UP, DOWN, LEFT, RIGHT = -1.0, 1.0, -1.0, 1.0

DIRECTIONS = {
    "up": [UP, 0.0],
    "down": [DOWN, 0.0],
    "left": [0.0, LEFT],
    "right": [0.0, RIGHT],
    "diagonal_up_left": [UP, LEFT],
    "diagonal_up_right": [UP, RIGHT],
    "diagonal_down_left": [DOWN, LEFT],
    "diagonal_down_right": [DOWN, RIGHT],
}

VERBS = [
    "move the",
    "push the",
    "put the",
    "bring the",
    "slide the",
]

DIRECTION_SYNONYMS = {
    "up": ["above the", "to the top side of the", "to the top of the"],
    "down": ["below the", "to the bottom side of the", "to the bottom of the"],
    "left": [
        "just left of the",
        "to the left of the",
        "left of the",
        "to the left side of the",
    ],
    "right": [
        "just right of the",
        "to the right of the",
        "right of the",
        "to the right side of the",
    ],
    "diagonal_up_left": [
        "to the top left side of the",
        "to the top left of the",
        "diagonally up and to the left of the",
    ],
    "diagonal_up_right": [
        "to the top right side of the",
        "to the top right of the",
        "diagonally up and to the right of the",
    ],
    "diagonal_down_left": [
        "to the bottom left side of the",
        "to the bottom left of the",
        "diagonally down and to the left of the",
    ],
    "diagonal_down_right": [
        "to the bottom right side of the",
        "to the bottom right of the",
        "diagonally down and to the right of the",
    ],
}


def task_id_table():
    """task string 'start-target-direction' -> stable numeric id."""
    strings = sorted(
        f"{start}-{target}-{direction}"
        for start in blocks_module.ALL_BLOCKS
        for target in blocks_module.ALL_BLOCKS
        for direction in DIRECTIONS
    )
    return {s: i for i, s in enumerate(strings)}


UNIQUE_TASK_STRINGS = task_id_table()
NUM_UNIQUE_TASKS = len(UNIQUE_TASK_STRINGS)


def direction_offset(direction, scale=1.0):
    mag_x = MAGNITUDE_X_DIAG if "diagonal" in direction else MAGNITUDE_X
    mag_y = MAGNITUDE_Y_DIAG if "diagonal" in direction else MAGNITUDE_Y
    return np.array(DIRECTIONS[direction]) * np.array(
        [mag_x * scale, mag_y * scale]
    )


def is_block2block_relative_pair(xy_block, xy_target):
    """Does xy_target sit at one of the canonical offsets from xy_block?"""
    for d in DIRECTIONS:
        target = np.array(xy_block) + direction_offset(d)
        if np.linalg.norm(target - xy_target) < 1e-6:
            return True
    return False


def generate_all_instructions(block_mode):
    out = []
    names = blocks_module.text_descriptions(block_mode)
    for block_syn, target_syn in itertools.permutations(names, 2):
        for verb in VERBS:
            for direction in DIRECTIONS:
                for direction_syn in DIRECTION_SYNONYMS[direction]:
                    out.append(
                        f"{verb} {block_syn} {direction_syn} {target_syn}"
                    )
    return out


def runtime_instructions(block_mode):
    """Sampler-complete: synonym pairs of distinct blocks (the sampler's
    PUSH_VERBS is a subset of the enumeration VERBS, so VERBS covers it)."""
    out = []
    for g1, g2 in itertools.permutations(
        blocks_module.synonym_groups(block_mode), 2
    ):
        for block_syn in g1:
            for target_syn in g2:
                for verb in VERBS:
                    for direction in DIRECTIONS:
                        for direction_syn in DIRECTION_SYNONYMS[direction]:
                            out.append(
                                f"{verb} {block_syn} {direction_syn} {target_syn}"
                            )
    return out


class BlockToBlockRelativeLocationReward(base.BoardReward):
    """Sparse reward when block sits on the offset ray from the target block."""

    def __init__(self, goal_reward, rng, delay_reward_steps, block_mode):
        super().__init__(goal_reward, rng, delay_reward_steps, block_mode)
        self._target_block = None
        self._block = None
        self._direction = None
        self._instruction = None
        self._target_translation = None

    def _sample_instruction(self, block, target_block, direction, blocks_on_table):
        # NOTE: samples from the generic 4-verb push list, matching the
        # reference (`block2block_relative_location.py:202`); the module's
        # 5-verb VERBS list (with 'bring the') is used only for enumeration,
        # exactly as in the reference.
        verb = self._rng.choice(language.PUSH_VERBS)
        block_syn = self._pick_synonym(block, blocks_on_table)
        target_syn = self._pick_synonym(target_block, blocks_on_table)
        direction_syn = self._rng.choice(DIRECTION_SYNONYMS[direction])
        return f"{verb} {block_syn} {direction_syn} {target_syn}"

    def target_translation_for(self, state, target_block, direction, scale=1.0):
        return np.array(
            self._block_pose(target_block, state)[0]
        ) + direction_offset(direction, scale)

    def get_current_task_info(self, state):
        if self._target_block is None:
            raise ValueError("must call .reset first")
        self._target_translation = self.target_translation_for(
            state, self._target_block, self._direction
        )
        return task_info.Block2BlockRelativeLocationTaskInfo(
            instruction=self._instruction,
            block=self._block,
            target_translation=self._target_translation,
            target_block=self._target_block,
            direction=self._direction,
        )

    def reset(self, state, blocks_on_table):
        tries = 0
        while True:
            block, target_block = self._pick_two_blocks(blocks_on_table)
            direction = self._rng.choice(list(DIRECTIONS.keys()))
            target = self.target_translation_for(state, target_block, direction)
            if base.inside_bounds(target):
                break
            tries += 1
            if tries > 100:
                return task_info.FAILURE
        info = self.reset_to(
            state, block, target_block, direction, blocks_on_table
        )
        self._in_reward_zone_steps = 0
        already_done = self.reward_for(
            state, self._block, self._target_block, self._direction,
            delay_reward_steps=0,
        )[1]
        if already_done:
            return task_info.FAILURE
        return info

    def reset_to(self, state, block, target_block, direction, blocks_on_table):
        self._block = block
        self._target_block = target_block
        # Remember where the target block started: dragging it too far
        # invalidates the task.
        self._target_block_reset_translation = np.copy(
            self._block_pose(target_block, state)[0]
        )
        self._direction = direction
        self._target_translation = self.target_translation_for(
            state, target_block, direction
        )
        self._instruction = self._sample_instruction(
            block, target_block, direction, blocks_on_table
        )
        return self.get_current_task_info(state)

    @property
    def target_translation(self):
        return self._target_translation

    def reward(self, state):
        return self.reward_for(
            state,
            self._block,
            self._target_block,
            self._direction,
            self._delay_reward_steps,
        )

    def reward_for(self, state, pushing_block, target_block, direction,
                   delay_reward_steps):
        pushing_xy = self._block_xy(pushing_block, state)
        target_xy = self._block_xy(target_block, state)
        offset_xy = self.target_translation_for(state, target_block, direction)

        # Accept any point on the ray from half the offset to 10% past it.
        diff = offset_xy - target_xy
        on_line = False
        for cand in np.linspace(diff * 0.5, diff * 1.1, 10):
            if np.linalg.norm(target_xy + cand - pushing_xy) < TARGET_DISTANCE:
                on_line = True
                break

        dragged = (
            np.linalg.norm(self._target_block_reset_translation - target_xy)
            > DRAGGED_THRESHOLD
        )

        if on_line and not dragged:
            if self._in_reward_zone_steps >= delay_reward_steps:
                return self._goal_reward, True
            self._in_reward_zone_steps += 1
        return 0.0, False

    def get_goal_region(self):
        return self._target_translation, TARGET_DISTANCE

    def reward_for_info(self, state, info):
        return self.reward_for(
            state,
            pushing_block=info.block,
            target_block=info.target_block,
            direction=info.direction,
            delay_reward_steps=self._delay_reward_steps,
        )

    def get_current_task_id(self):
        key = f"{self._block}-{self._target_block}-{self._direction}"
        return UNIQUE_TASK_STRINGS[key]

    def debug_info(self, state):
        return np.linalg.norm(
            self._block_xy(self._block, state)
            - self.target_translation_for(
                state, self._target_block, self._direction
            )
        )
