"""'Push block X <slightly> <direction>' task.

Parity source: reference
`language_table/environments/rewards/block2relativelocation.py`.
"""

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import language, task_info
from rt1_tpu_torch.envs.rewards import base

MAGNITUDES = {"near": 0.15, "far": 0.25}

# Board frame: top-left of the image is (0, 0), so "up" decreases x.
UP, DOWN, LEFT, RIGHT = -1.0, 1.0, -1.0, 1.0

DIRECTIONS = {
    "up": [UP, 0.0],
    "down": [DOWN, 0.0],
    "left": [0.0, LEFT],
    "right": [0.0, RIGHT],
    "diagonal_up_left": [UP, LEFT] / np.linalg.norm([UP, LEFT]),
    "diagonal_up_right": [UP, RIGHT] / np.linalg.norm([UP, RIGHT]),
    "diagonal_down_left": [DOWN, LEFT] / np.linalg.norm([DOWN, LEFT]),
    "diagonal_down_right": [DOWN, RIGHT] / np.linalg.norm([DOWN, RIGHT]),
}

VERBS = [
    "move the",
    "push the",
    "slide the",
]

SLIGHTLY_SYNONYMS = [
    "slightly",
    "a bit",
    "a little",
    "a little bit",
    "somewhat",
]

DIRECTION_SYNONYMS = {
    "up": ["up", "upwards"],
    "down": ["down", "downwards"],
    "left": ["to the left", "left"],
    "right": ["to the right", "right"],
}

DIAGONAL_PREPOSITIONS = [
    "%s and %s",
    "%s and then %s",
    "diagonally %s and %s",
    "%s and %s diagonally",
]

TARGET_DISTANCE = 0.1


def slightly_variants(verb, block, direction):
    """All 'slightly'-modified phrasings of a near push."""
    yield f"slightly {verb} {block} {direction}"
    for syn in SLIGHTLY_SYNONYMS:
        yield f"{verb} {block} {syn} {direction}"
        yield f"{verb} {block} {direction} {syn}"


def sample_slightly(rng, verb, block, direction):
    mode = rng.choice(["slightly_first", "prefix", "suffix"])
    if mode == "slightly_first":
        return f"slightly {verb} {block} {direction}"
    syn = rng.choice(SLIGHTLY_SYNONYMS)
    if mode == "prefix":
        return f"{verb} {block} {syn} {direction}"
    return f"{verb} {block} {direction} {syn}"


def diagonal_variants(direction):
    """All natural-language renderings of a canonical diagonal direction."""
    _, first, second = direction.split("_")
    for first_syn in DIRECTION_SYNONYMS[first]:
        for second_syn in DIRECTION_SYNONYMS[second]:
            for prep in DIAGONAL_PREPOSITIONS:
                yield prep % (first_syn, second_syn)


def sample_diagonal(rng, direction):
    _, first, second = direction.split("_")
    first_syn = rng.choice(DIRECTION_SYNONYMS[first])
    second_syn = rng.choice(DIRECTION_SYNONYMS[second])
    prep = rng.choice(DIAGONAL_PREPOSITIONS)
    return prep % (first_syn, second_syn)


def runtime_instructions(block_mode):
    """Sampler-complete: all block synonym variants (same verb list — this
    family samples from its own 3-verb VERBS, unlike block2location)."""
    flat = [
        v for g in blocks_module.synonym_groups(block_mode) for v in g
    ]
    return generate_all_instructions(block_mode, names=flat)


def generate_all_instructions(block_mode, names=None):
    out = []
    if names is None:
        names = blocks_module.text_descriptions(block_mode)
    for block_text in names:
        for verb in VERBS:
            for direction in DIRECTIONS:
                if "diagonal" in direction:
                    syns = diagonal_variants(direction)
                else:
                    syns = DIRECTION_SYNONYMS[direction]
                for direction_syn in syns:
                    out.extend(
                        slightly_variants(verb, block_text, direction_syn)
                    )
                    out.append(f"{verb} {block_text} {direction_syn}")
    return out


class BlockToRelativeLocationReward(base.BoardReward):
    """Sparse reward at an invisible offset target from the block's start."""

    def _sample_instruction(self, block, distance_mode, direction, blocks_on_table):
        verb = self._rng.choice(VERBS)
        block_syn = self._pick_synonym(block, blocks_on_table)
        if "diagonal" in direction:
            direction_text = sample_diagonal(self._rng, direction)
        else:
            direction_text = self._rng.choice(DIRECTION_SYNONYMS[direction])
        if distance_mode == "near":
            return sample_slightly(self._rng, verb, block_syn, direction_text)
        return f"{verb} {block_syn} {direction_text}"

    def reset(self, state, blocks_on_table):
        tries = 0
        while True:
            self._block = self._pick_block(blocks_on_table)
            block_xy = self._block_xy(self._block, state)
            direction = self._rng.choice(sorted(DIRECTIONS.keys()))
            distance_mode = self._rng.choice(sorted(MAGNITUDES.keys()))
            target = block_xy + (
                np.array(DIRECTIONS[direction]) * MAGNITUDES[distance_mode]
            )
            if base.inside_bounds(target):
                break
            tries += 1
            if tries > 100:
                return task_info.FAILURE
        self._instruction = self._sample_instruction(
            self._block, distance_mode, direction, blocks_on_table
        )
        self._target_translation = np.copy(target)
        self._in_reward_zone_steps = 0
        return task_info.Block2RelativeLocationTaskInfo(
            instruction=self._instruction,
            block=self._block,
            location=direction,
            target_translation=self._target_translation,
        )

    def get_goal_region(self):
        return self._target_translation, TARGET_DISTANCE

    def reward(self, state):
        dist = np.linalg.norm(
            self._block_xy(self._block, state)
            - np.array(self._target_translation)
        )
        return self._maybe_goal(dist < TARGET_DISTANCE)
