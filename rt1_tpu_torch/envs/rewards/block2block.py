"""'Push block X to block Y' task — the headline eval task.

Parity source: reference `language_table/environments/rewards/block2block.py`.
"""

import itertools

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import constants, language, task_info
from rt1_tpu_torch.envs.rewards import base


def generate_all_instructions(block_mode):
    """Every literal instruction this family can emit, canonical names only."""
    out = []
    names = blocks_module.text_descriptions(block_mode)
    for start_text, target_text in itertools.permutations(names, 2):
        for verb in language.PUSH_VERBS:
            for prep in language.PREPOSITIONS:
                out.append(f"{verb} {start_text} {prep} {target_text}")
    return out


def runtime_instructions(block_mode):
    """Sampler-complete: every synonym pairing `_sample_instruction` can
    emit (the parity enumeration above is canonical names only)."""
    out = []
    for g1, g2 in itertools.permutations(
        blocks_module.synonym_groups(block_mode), 2
    ):
        for start_text in g1:
            for target_text in g2:
                for verb in language.PUSH_VERBS:
                    for prep in language.PREPOSITIONS:
                        out.append(f"{verb} {start_text} {prep} {target_text}")
    return out


class BlockToBlockReward(base.BoardReward):
    """Sparse reward when the start block reaches the target block."""

    def _sample_instruction(self, start_block, target_block, blocks_on_table):
        verb = self._rng.choice(language.PUSH_VERBS)
        start_syn = self._pick_synonym(start_block, blocks_on_table)
        target_syn = self._pick_synonym(target_block, blocks_on_table)
        prep = self._rng.choice(language.PREPOSITIONS)
        return f"{verb} {start_syn} {prep} {target_syn}"

    def reset(self, state, blocks_on_table):
        """Pick two blocks far enough apart; FAILURE after 10 tries."""
        attempts = 0
        while True:
            start_block, target_block = self._pick_two_blocks(blocks_on_table)
            dist = np.linalg.norm(
                self._block_xy(start_block, state)
                - self._block_xy(target_block, state)
            )
            if dist < constants.TARGET_BLOCK_DISTANCE + 0.01:
                attempts += 1
                if attempts > 10:
                    return task_info.FAILURE
                continue
            break
        self._start_block = start_block
        self._target_block = target_block
        self._instruction = self._sample_instruction(
            start_block, target_block, blocks_on_table
        )
        self._in_reward_zone_steps = 0
        return task_info.Block2BlockTaskInfo(
            instruction=self._instruction,
            block1=start_block,
            block2=target_block,
        )

    def get_goal_region(self):
        return self._target_translation, constants.TARGET_BLOCK_DISTANCE

    def reward(self, state):
        start_xy = self._block_xy(self._start_block, state)
        target_xy = self._block_xy(self._target_block, state)
        self._target_translation = target_xy
        dist = np.linalg.norm(start_xy - target_xy)
        return self._maybe_goal(dist < constants.TARGET_BLOCK_DISTANCE)
