"""'Point/move the arm to block X' task.

Parity source: reference `language_table/environments/rewards/point2block.py`.
Scored on the *effector target* position, not any block motion.
"""

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import constants, language, task_info
from rt1_tpu_torch.envs.rewards import base


def generate_all_instructions(block_mode):
    out = []
    for block_text in blocks_module.text_descriptions(block_mode):
        for prep in language.POINT_PREPOSITIONS:
            out.append(f"{prep} {block_text}")
    return out


def runtime_instructions(block_mode):
    """Sampler-complete: all block synonym variants, not just canonical."""
    out = []
    for group in blocks_module.synonym_groups(block_mode):
        for block_text in group:
            for prep in language.POINT_PREPOSITIONS:
                out.append(f"{prep} {block_text}")
    return out


class PointToBlockReward(base.BoardReward):
    """Sparse reward when the effector reaches the chosen block."""

    def _sample_instruction(self, block, blocks_on_table):
        block_text = self._pick_synonym(block, blocks_on_table)
        prep = self._rng.choice(language.POINT_PREPOSITIONS)
        return f"{prep} {block_text}"

    def reset(self, state, blocks_on_table):
        attempts = 0
        while True:
            block = self._pick_block(blocks_on_table)
            dist = np.linalg.norm(
                self._block_xy(block, state)
                - np.array(state["effector_target_translation"])
            )
            if dist < constants.TARGET_BLOCK_DISTANCE + 0.01:
                attempts += 1
                if attempts > 10:
                    return task_info.FAILURE
                continue
            break
        self._block = block
        self._instruction = self._sample_instruction(block, blocks_on_table)
        self._in_reward_zone_steps = 0
        return task_info.Point2BlockTaskInfo(
            instruction=self._instruction, block_target=block
        )

    def reward(self, state):
        dist = np.linalg.norm(
            self._block_xy(self._block, state)
            - np.array(state["effector_target_translation"])
        )
        return self._maybe_goal(dist < constants.TARGET_BLOCK_DISTANCE)
